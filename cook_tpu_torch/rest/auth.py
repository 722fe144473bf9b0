"""The port's copy of ``cook_tpu/rest/auth.py`` (stdlib only;
``GssapiAuthenticator`` imports ``gssapi`` in its constructor).

Pluggable request authentication schemes.

The reference composes SPNEGO/Kerberos, HTTP basic, and open (trusted
header) authentication in its middleware stack (reference:
rest/spnego.clj, rest/basic_auth.clj, composable is-authorized-fn
rest/authorization.clj, wired at components.clj:266-284). This module is
that seam: an ordered chain of Authenticators; the first one that resolves
an identity wins, and configuring a chain makes authentication mandatory.

:class:`GssapiAuthenticator` fills the SPNEGO slot with real GSSAPI
accept-context validation (needs the gssapi package + a keytab at
runtime); :class:`HmacTokenAuthenticator` is the KDC-free alternative —
self-contained signed tickets (user, expiry, HMAC) presented as
``Authorization: Bearer`` or ``Negotiate``, the moral shape of a kerberos
service ticket: issued out of band, verified statelessly, time-bounded.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import time
from typing import Callable, Dict, Optional, Union


class AuthError(Exception):
    """Malformed or rejected credentials (maps to HTTP 401)."""

    def __init__(self, message: str, challenge: Optional[str] = None):
        super().__init__(message)
        self.message = message
        self.challenge = challenge


class Authenticator:
    """One authentication scheme. Returns the identity, or None when the
    request carries no credentials for this scheme (the chain moves on);
    raises AuthError when credentials are present but invalid.

    ``respond``, when provided, is a dict the scheme may fill with
    response headers to send on success (e.g. the GSSAPI acceptor's
    mutual-authentication token in ``WWW-Authenticate``)."""

    challenge: Optional[str] = None

    def authenticate(self, headers,
                     respond: Optional[Dict[str, str]] = None
                     ) -> Optional[str]:  # pragma: no cover
        raise NotImplementedError


class HeaderTrustAuthenticator(Authenticator):
    """Open mode: trust a proxy-provided identity header (the reference's
    one-user-per-request open auth)."""

    def __init__(self, header: str = "X-Cook-User"):
        self.header = header

    def authenticate(self, headers, respond=None) -> Optional[str]:
        return headers.get(self.header) or None


class BasicAuthenticator(Authenticator):
    """HTTP basic with a user->password table or a check callable."""

    challenge = 'Basic realm="cook"'

    def __init__(self, users: Union[Dict[str, str],
                                    Callable[[str, str], bool]]):
        if callable(users):
            self._check = users
        else:
            # constant-time compare: don't leak password prefixes via timing
            self._check = lambda u, p: hmac.compare_digest(
                users.get(u, ""), p)

    def authenticate(self, headers, respond=None) -> Optional[str]:
        auth = headers.get("Authorization", "")
        if not auth.startswith("Basic "):
            return None
        try:
            user, _, password = \
                base64.b64decode(auth[6:]).decode().partition(":")
        except Exception:
            raise AuthError("malformed basic auth", self.challenge)
        if not user or not self._check(user, password):
            raise AuthError("bad credentials", self.challenge)
        return user


class HmacTokenAuthenticator(Authenticator):
    """Signed ticket auth: ``base64(user:expiry_epoch_s:hexmac)``.

    mint() issues tickets (the KDC stand-in); authenticate() verifies them
    statelessly. Accepted under ``Authorization: Bearer <t>`` or
    ``Negotiate <t>`` (the header SPNEGO uses)."""

    challenge = "Negotiate"

    def __init__(self, secret: Union[str, bytes],
                 default_ttl_s: float = 8 * 3600.0):
        self.secret = secret.encode() if isinstance(secret, str) else secret
        self.default_ttl_s = default_ttl_s

    def _mac(self, user: str, expiry_s: int) -> str:
        msg = f"{user}:{expiry_s}".encode()
        return hmac.new(self.secret, msg, hashlib.sha256).hexdigest()

    def mint(self, user: str, ttl_s: Optional[float] = None) -> str:
        expiry = int(time.time() + (ttl_s if ttl_s is not None
                                    else self.default_ttl_s))
        raw = f"{user}:{expiry}:{self._mac(user, expiry)}"
        return base64.b64encode(raw.encode()).decode()

    def authenticate(self, headers, respond=None) -> Optional[str]:
        auth = headers.get("Authorization", "")
        scheme, _, token = auth.partition(" ")
        if scheme not in ("Bearer", "Negotiate") or not token:
            return None
        try:
            user, expiry_str, mac = \
                base64.b64decode(token).decode().rsplit(":", 2)
            expiry = int(expiry_str)
        except Exception:
            raise AuthError("malformed token", self.challenge)
        if not hmac.compare_digest(mac, self._mac(user, expiry)):
            raise AuthError("bad token signature", self.challenge)
        if time.time() > expiry:
            raise AuthError("token expired", self.challenge)
        return user


class AuthChain:
    """Ordered schemes; first resolved identity wins. A configured chain
    makes authentication mandatory (no anonymous fallthrough)."""

    def __init__(self, authenticators):
        self.authenticators = list(authenticators)

    def authenticate(self, headers,
                     respond: Optional[Dict[str, str]] = None) -> str:
        for a in self.authenticators:
            user = a.authenticate(headers, respond)
            if user:
                return user
        challenges = [a.challenge for a in self.authenticators if a.challenge]
        raise AuthError("authentication required",
                        challenges[0] if challenges else None)


class GssapiAuthenticator(Authenticator):
    """Real SPNEGO/Kerberos validation through GSSAPI (reference:
    rest/spnego.clj gss-context-from-token / authorization-fn).

    Accepts ``Authorization: Negotiate <base64 token>``, runs the token
    through the server's accept security context, and maps the initiator
    principal (``user@REALM``) to its bare user name — exactly the
    reference's ``principal->username``.  Needs the ``gssapi`` package and
    a keytab/KDC at runtime; construction takes the module as a dependency
    (injectable for tests, resolved from the environment by default) so
    the seam is exercised even where no KDC exists.
    """

    challenge = "Negotiate"

    def __init__(self, service: str = "HTTP", gssapi_module=None):
        if gssapi_module is None:
            try:
                import gssapi as gssapi_module  # type: ignore
            except ImportError as e:
                raise RuntimeError(
                    "GssapiAuthenticator needs the 'gssapi' package (and a "
                    "keytab); use HmacTokenAuthenticator where no KDC "
                    "exists") from e
        self.gssapi = gssapi_module
        self.service = service
        # acceptor credentials once, at construction: a missing/unreadable
        # keytab fails the daemon at boot (fail-fast), not per request,
        # and the hot auth path skips the per-request keytab resolution
        self._creds = None
        if service:
            # constrain acceptance to the configured service principal
            # (HTTP/<host>), matching the reference's keytab identity
            spn = self.gssapi.Name(
                service, name_type=self.gssapi.NameType.hostbased_service)
            self._creds = self.gssapi.Credentials(name=spn, usage="accept")

    def authenticate(self, headers, respond=None) -> Optional[str]:
        auth = headers.get("Authorization", "")
        scheme, _, token_b64 = auth.partition(" ")
        if scheme != "Negotiate" or not token_b64:
            return None
        try:
            token = base64.b64decode(token_b64)
        except Exception:
            raise AuthError("malformed negotiate token", self.challenge)
        # GSS-API initial context tokens are ASN.1 framed ([APPLICATION 0],
        # first byte 0x60).  Anything else under the Negotiate header is not
        # ours — pass it through so an HmacTokenAuthenticator later in the
        # chain (the KDC-free stand-in on the same header) can handle it,
        # while real-but-forged GSS tokens still fail fast below.
        if not token or token[0] != 0x60:
            return None
        try:
            ctx = self.gssapi.SecurityContext(creds=self._creds,
                                              usage="accept")
            out_token = ctx.step(token)
            principal = str(ctx.initiator_name)
        except Exception as e:  # gssapi raises its own hierarchy
            # GSS status strings can reveal principal/keytab/clock-skew
            # detail: log them, return a generic 401 to the caller
            import logging
            logging.getLogger(__name__).info(
                "GSSAPI rejected a negotiate token: %s", e)
            raise AuthError("GSSAPI rejected token", self.challenge)
        if not ctx.complete:
            # multi-round-trip negotiation is not supported over this
            # stateless seam (the reference also completes in one step
            # for standard krb5 service tickets)
            raise AuthError("GSSAPI negotiation incomplete", self.challenge)
        if out_token and respond is not None:
            # the acceptor's final token: clients requiring MUTUAL
            # authentication verify the server with it
            respond["WWW-Authenticate"] = \
                "Negotiate " + base64.b64encode(out_token).decode()
        return principal.partition("@")[0] or None
