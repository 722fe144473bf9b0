"""The port's copy of ``cook_tpu/cluster/k8s/testcerts.py``
(imports re-rooted).

Self-signed PKI for TLS tests: a CA, a server cert for 127.0.0.1, and
a client cert signed by the same CA.

Test support for the k8s wire (like :mod:`mock_apiserver`): the
reference's client stack is TLS everywhere
(scheduler/project.clj:152-156 pins an okhttp TLS client;
kubernetes/api.clj:372-475 builds it from kubeconfig/service-account
material), so the suite must execute real handshakes — server
verification against a CA, mTLS client identity, and wrong-CA rejection
— not just plaintext HTTP.
"""

from __future__ import annotations

import subprocess
from dataclasses import dataclass
from pathlib import Path


@dataclass
class TestPKI:
    ca_cert: str
    ca_key: str
    server_cert: str
    server_key: str
    client_cert: str
    client_key: str
    # a SECOND, unrelated CA: a client trusting this one must reject the
    # server's handshake
    wrong_ca_cert: str


def _run(args, cwd):
    subprocess.run(args, cwd=cwd, check=True, capture_output=True,
                   timeout=60)


def generate_pki(directory: str) -> TestPKI:
    """Generate the whole PKI under ``directory`` with the openssl CLI."""
    d = Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    ext = d / "san.ext"
    ext.write_text("subjectAltName=IP:127.0.0.1,DNS:localhost\n")

    _run(["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
          "-keyout", "ca.key", "-out", "ca.crt", "-days", "2",
          "-subj", "/CN=cook-test-ca"], d)
    _run(["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
          "-keyout", "wrong-ca.key", "-out", "wrong-ca.crt", "-days", "2",
          "-subj", "/CN=cook-wrong-ca"], d)

    for name, cn, use_ext in (("server", "127.0.0.1", True),
                              ("client", "cook-client", False)):
        _run(["openssl", "req", "-newkey", "rsa:2048", "-nodes",
              "-keyout", f"{name}.key", "-out", f"{name}.csr",
              "-subj", f"/CN={cn}"], d)
        cmd = ["openssl", "x509", "-req", "-in", f"{name}.csr",
               "-CA", "ca.crt", "-CAkey", "ca.key", "-CAcreateserial",
               "-out", f"{name}.crt", "-days", "2"]
        if use_ext:
            cmd += ["-extfile", str(ext)]
        _run(cmd, d)

    return TestPKI(ca_cert=str(d / "ca.crt"), ca_key=str(d / "ca.key"),
                   server_cert=str(d / "server.crt"),
                   server_key=str(d / "server.key"),
                   client_cert=str(d / "client.crt"),
                   client_key=str(d / "client.key"),
                   wrong_ca_cert=str(d / "wrong-ca.crt"))
