"""The port's copy of ``cook_tpu/state/replication.py``; it builds the
repo-root ``native/repl.cpp`` (host code, no card) into ``build/native``,
which git ignores, never into the JAX package's ``native/build``.

Socket journal replication: ctypes surface over ``native/repl.cpp``.

The reference framework's durable state is an out-of-process NETWORKED
store (Datomic — reference: ``scheduler/src/cook/datomic.clj:79``), so
its leader failover works from any host: the new leader just re-reads
(reference: ``scheduler/src/cook/mesos.clj:153-328``).  The port's
:class:`~cook_tpu_torch.state.store.Store` journals to a local directory; this
module streams that journal (and its compaction snapshots) to follower
processes over framed TCP so a follower holds a byte-identical mirror in
its OWN directory — no shared filesystem — and can promote with zero lost
committed transactions.

Roles:

- :class:`ReplicationServer` — runs in the leader next to an open store;
  tails ``<dir>/journal.jsonl``.  ``wait_acked(offset)`` blocks until every
  connected follower has fsynced through ``offset`` (sync replication: the
  store calls it per commit via ``Store.attach_replication``).
- :class:`ReplicationFollower` — runs in a standby; mirrors the leader's
  snapshot + journal bytes into a separate local directory.  Promotion is
  ``Store.open(local_dir, epoch=...)`` on that mirror; the journal records
  carry their election epochs, so the store's existing stale-epoch replay
  skipping applies unchanged.
"""

from __future__ import annotations

import ctypes
import os
import threading
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

from ..utils.locks import named_lock

_REPO_ROOT = Path(__file__).resolve().parent.parent.parent
_NATIVE = _REPO_ROOT / "native"
_SRC = _NATIVE / "repl.cpp"
_LIB = _REPO_ROOT / "build" / "native" / "libcookrepl.so"

_lib_handle = None
_lib_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib_handle, _lib_tried
    if _lib_tried:
        return _lib_handle
    _lib_tried = True
    from ..native.build import build_if_stale
    if build_if_stale([_SRC, _NATIVE / "framing.h"], _LIB,
                      ["-shared", "-fPIC"]) is None:
        return None
    lib = ctypes.CDLL(str(_LIB))
    lib.crp_serve.restype = ctypes.c_void_p
    lib.crp_serve.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.crp_port.argtypes = [ctypes.c_void_p]
    lib.crp_follower_count.argtypes = [ctypes.c_void_p]
    lib.crp_synced_count.argtypes = [ctypes.c_void_p]
    lib.crp_poke.argtypes = [ctypes.c_void_p]
    lib.crp_wait_acked.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                                   ctypes.c_int]
    lib.crp_min_acked.restype = ctypes.c_longlong
    lib.crp_min_acked.argtypes = [ctypes.c_void_p]
    lib.crp_status_json.restype = ctypes.c_int
    lib.crp_status_json.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                    ctypes.c_int]
    lib.crp_stop.argtypes = [ctypes.c_void_p]
    lib.crf_follow.restype = ctypes.c_void_p
    lib.crf_follow.argtypes = [ctypes.c_char_p, ctypes.c_int,
                               ctypes.c_char_p]
    lib.crf_connected.argtypes = [ctypes.c_void_p]
    lib.crf_offset.restype = ctypes.c_longlong
    lib.crf_offset.argtypes = [ctypes.c_void_p]
    lib.crf_stop.argtypes = [ctypes.c_void_p]
    _lib_handle = lib
    return lib


def replication_available() -> bool:
    return _load() is not None


#: sidecar in a mirror directory recording the election epoch of the
#: leader this mirror last followed — the first component of the
#: candidate-ranking key (Raft compares (term, log index); here
#: (followed epoch, mirrored offset), Ongaro & Ousterhout §5.4.1)
REPL_EPOCH_FILE = "repl_epoch"


def record_followed_epoch(directory: str, epoch: int) -> None:
    """Durably note which election epoch this mirror is following —
    written by the standby wiring whenever it (re)points its follower at
    a published leader address."""
    from ..utils.fsatomic import write_atomic_int
    os.makedirs(directory, exist_ok=True)
    write_atomic_int(os.path.join(directory, REPL_EPOCH_FILE), int(epoch))


def _trimmed_journal_bytes(path: str) -> int:
    """Journal bytes up to the last record boundary (the follower only
    ever acks whole lines; a torn tail from a crash doesn't count)."""
    try:
        size = os.path.getsize(path)
    except OSError:
        return 0
    if size == 0:
        return 0
    with open(path, "rb") as f:
        # scan back for the last newline in bounded chunks
        at = size
        while at > 0:
            frm = max(0, at - (1 << 16))
            f.seek(frm)
            chunk = f.read(at - frm)
            nl = chunk.rfind(b"\n")
            if nl >= 0:
                return frm + nl + 1
            at = frm
    return 0


def candidate_position(directory: str) -> Dict:
    """This mirror's replication position, as published into the
    election medium for candidate ranking: ``epoch`` (election epoch of
    the leader last followed), ``offset`` (mirrored journal bytes at a
    record boundary), ``synced`` (reached that leader's head at least
    once), ``began`` (ever was a mirror at all — False = genesis)."""
    d = Path(directory)
    from ..utils.fsatomic import read_int_file
    return {
        "epoch": read_int_file(str(d / REPL_EPOCH_FILE), 0) or 0,
        "offset": _trimmed_journal_bytes(str(d / "journal.jsonl")),
        "synced": (d / "repl_synced").exists(),
        "began": (d / "repl_token").exists()
        or (d / "repl_following").exists(),
    }


def rank_key(pos: Dict) -> Tuple[int, int, int]:
    """Total order over candidate positions: synced beats unsynced, then
    higher followed epoch (a mirror of a LATER leadership saw commits the
    earlier one cannot have), then more mirrored bytes.  The Raft
    vote-comparison rule (§5.4.1) expressed over (epoch, offset)."""
    return (1 if pos.get("synced") else 0,
            int(pos.get("epoch") or 0), int(pos.get("offset") or 0))


def choose_successor(my_pos: Dict, peers: Dict[str, Dict],
                     now: Optional[float] = None,
                     stale_s: float = 10.0) -> Optional[Tuple[str, Dict]]:
    """Given this node's position and the candidate positions collected
    from the election medium, return ``(peer_id, peer_position)`` of the
    best-synced peer STRICTLY ahead of us — the node to pull the missing
    delta from before opening our store as the new authority — or None
    when we already hold the best position.  Ghost entries (older than
    ``stale_s``) are dead nodes' leftovers and never win."""
    now = time.time() if now is None else now
    best: Optional[Tuple[str, Dict]] = None
    for peer_id, pos in peers.items():
        ts = pos.get("ts")
        if ts is not None and now - float(ts) > stale_s:
            continue
        if not pos.get("synced"):
            continue  # an unsynced mirror holds nothing we must preserve
        if rank_key(pos) <= rank_key(my_pos):
            continue
        if best is None or rank_key(pos) > rank_key(best[1]):
            best = (peer_id, pos)
    return best


def catch_up_from_peer(host: str, port: int, directory: str,
                       target_offset: int,
                       timeout_s: float = 30.0) -> bool:
    """Standby→standby catch-up over the existing framed-TCP carrier
    (Viewstamped Replication's view-change state transfer, Liskov &
    Cowling §4.2): mirror the better-synced peer's journal into
    ``directory`` until at least ``target_offset`` bytes AND the synced
    marker (HEAD) landed, then stop.  The peer's snapshot token differs
    from ours (tokens are per-directory), so this is a full resync —
    always correct, and the delta case costs one snapshot copy."""
    with ReplicationFollower(host, int(port), directory) as f:
        if not f.wait_offset(int(target_offset), timeout_s=timeout_s):
            return False
        # the HEAD marker re-arms the promotion gate; it follows the
        # last JDATA ack immediately
        deadline = time.time() + max(2.0, timeout_s / 4)
        marker = os.path.join(directory, "repl_synced")
        while time.time() < deadline:
            if os.path.exists(marker):
                return True
            time.sleep(0.005)
    return os.path.exists(marker)


def assert_promotable(directory: str) -> None:
    """Refuse to promote a mirror that BEGAN following (``repl_token``)
    but never reached the leader's head (no ``repl_synced`` marker —
    fresh catch-up or mid-resync): opening it as the new authority would
    discard commits the dead leader confirmed on its synced peers' acks.
    A never-followed directory (no token) is cluster genesis and allowed.

    A mirror that synced ONCE and then lagged keeps its marker and
    passes this gate; ordering such candidates is the job of the
    candidate-ranking layer (:func:`choose_successor` over positions
    published into the election medium) — the winner pulls the missing
    delta from the best-synced peer (:func:`catch_up_from_peer`) before
    opening its store, closing the once-synced-lag hole this gate alone
    could not express."""
    d = Path(directory)
    began_following = (d / "repl_token").exists() \
        or (d / "repl_following").exists()
    if began_following and not (d / "repl_synced").exists():
        raise RuntimeError(
            "refusing promotion: this node's mirror never reached the "
            "previous leader's head (mid-catch-up); a synced peer must "
            "take over")


def known_members(elector, self_id: Optional[str] = None,
                  self_url: Optional[str] = None, leader: bool = False,
                  extra: Optional[list] = None) -> Dict[str, Dict]:
    """The fleet-topology view every observability layer shares
    (sched/fleet.py; docs/OBSERVABILITY.md "Debugging the fleet"):
    ``{instance: {url, role, ts}}`` assembled from the election
    candidate registry (standbys publish their position + REST url each
    ``position_interval_seconds``, daemon._follow_leader_loop), this
    node itself, and any config-declared static ``extra`` members
    (FleetConfig.members — agents or processes that never campaign).

    Entries without a url are skipped (nothing to scrape); a STALE
    candidate entry is kept — the federation layer surfaces an
    unreachable member as ``up=0`` data, it never silently narrows the
    fleet.  A registry read failure degrades to the self + static view
    rather than raising into the monitor sweep."""
    out: Dict[str, Dict] = {}
    if self_id:
        out[str(self_id)] = {
            "url": self_url,
            "role": "leader" if leader else "follower",
            "ts": time.time(), "self": True}
    try:
        candidates = elector.read_candidates() if elector is not None \
            else {}
    except Exception:
        candidates = {}
    for nid, pos in candidates.items():
        nid = str(nid)
        if nid in out:
            continue
        url = (pos or {}).get("url")
        if not url:
            continue
        out[nid] = {"url": str(url), "role": "follower",
                    "ts": (pos or {}).get("ts")}
    for m in extra or []:
        inst = str(m.get("instance") or m.get("url"))
        if inst in out or not m.get("url"):
            continue
        out[inst] = {"url": str(m["url"]),
                     "role": str(m.get("role") or "member"),
                     "ts": None}
    return out


class ReplicationServer:
    """Leader side: serve ``directory``'s journal to followers.

    Every native call holds ``_mu``: ``stop()`` frees the C++ object, and
    freeing it while another thread sits inside ``crp_wait_acked`` (a
    committer blocked up to the ack timeout) would destroy the mutex and
    condvar under a waiter — the lock makes stop() wait them out."""

    def __init__(self, directory: str, port: int = 0):
        lib = _load()
        if lib is None:
            raise RuntimeError("native replication library unavailable "
                               "(g++ missing or build failed — see "
                               "stderr)")
        self._lib = lib
        # ranks ABOVE "store" (utils/locks.py): journal appends poke and
        # await this server while holding the store lock
        self._mu = named_lock("repl.server")
        self._handle = lib.crp_serve(str(directory).encode(), int(port))
        if not self._handle:
            raise RuntimeError(f"could not serve replication on port "
                               f"{port}")
        self.directory = str(directory)
        self.port = lib.crp_port(self._handle)
        #: election epoch this server serves for (set by the daemon at
        #: promotion); a superseding epoch fences the server
        self.epoch: Optional[int] = None
        #: partition this server replicates in a partitioned write
        #: plane (state/partition.py) — each partition owns its OWN
        #: topology: server, synced-standby set, lease.  Labels the
        #: replication-lag metrics; None = the classic single topology.
        self.partition: Optional[int] = None
        self.fenced = False

    def status(self) -> list:
        """Per-follower replication status: ``[{"id", "acked",
        "synced"}, ...]`` — the GET /debug/replication surface."""
        import json as _json
        with self._mu:
            if not self._handle:
                return []
            buf = ctypes.create_string_buffer(1 << 16)
            n = self._lib.crp_status_json(self._handle, buf, len(buf))
            if n < 0:
                return []
            return _json.loads(buf.value.decode())

    def fence(self) -> None:
        """A higher election epoch superseded this leader: refuse to
        serve the stale journal to followers (they must re-point at the
        new leader's published address) and fail every later ack wait so
        a racing commit cannot report determinate success."""
        self.fenced = True
        self.stop()

    @property
    def follower_count(self) -> int:
        with self._mu:
            return self._lib.crp_follower_count(self._handle) \
                if self._handle else 0

    @property
    def synced_follower_count(self) -> int:
        """Followers whose mirror has reached the journal head at least
        once — the set that participates in sync-commit acks.  The
        no-loss guarantee covers commits made after this is ≥ 1."""
        with self._mu:
            return self._lib.crp_synced_count(self._handle) \
                if self._handle else 0

    def poke(self) -> None:
        """Wake follower streams after a journal append."""
        with self._mu:
            if self._handle:
                self._lib.crp_poke(self._handle)

    def wait_acked(self, offset: int, timeout_s: float = 5.0) -> bool:
        """True once every synced follower fsynced through ``offset``
        (vacuously true with none), False on timeout."""
        with self._mu:
            if not self._handle:
                # stopped server: nothing to wait for — UNLESS it was
                # stopped by a fence, where a vacuous True would report
                # determinate success on a deposed leader (the fenced
                # flag is re-checked under _mu: fence() can race the
                # pre-lock window of a committing thread)
                return not self.fenced
            acked = bool(self._lib.crp_wait_acked(
                self._handle, int(offset), int(timeout_s * 1000)))
            # a fence that landed during the wait demotes the outcome to
            # indeterminate: the acking mirrors will resync to the
            # successor, whose replay skips this record's stale epoch
            return acked and not self.fenced

    def min_acked(self) -> int:
        """Lowest synced-follower ack offset, -1 when none."""
        with self._mu:
            return int(self._lib.crp_min_acked(self._handle)) \
                if self._handle else -1

    def stop(self) -> None:
        with self._mu:
            if self._handle:
                self._lib.crp_stop(self._handle)
                self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()


class ReplicationFollower:
    """Standby side: mirror a leader's journal into ``directory``."""

    def __init__(self, host: str, port: int, directory: str):
        lib = _load()
        if lib is None:
            raise RuntimeError("native replication library unavailable "
                               "(g++ missing or build failed — see "
                               "stderr)")
        self._lib = lib
        self._mu = named_lock("repl.follower")
        self._handle = lib.crf_follow(host.encode(), int(port),
                                      str(directory).encode())
        self.directory = str(directory)

    @property
    def connected(self) -> bool:
        with self._mu:
            return bool(self._handle
                        and self._lib.crf_connected(self._handle))

    @property
    def offset(self) -> int:
        with self._mu:
            return int(self._lib.crf_offset(self._handle)) \
                if self._handle else -1

    def wait_offset(self, offset: int, timeout_s: float = 10.0) -> bool:
        """Wait until the local mirror reaches ``offset`` journal bytes."""
        deadline = time.time() + timeout_s
        while time.time() < deadline:
            if self.offset >= offset:
                return True
            time.sleep(0.002)
        return self.offset >= offset

    def stop(self) -> None:
        with self._mu:
            if self._handle:
                self._lib.crf_stop(self._handle)
                self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
