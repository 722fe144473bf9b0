"""The port's copy of ``cook_tpu/sched/election.py`` (imports re-rooted).

Leader election and HA.

The reference elects a single active scheduler through ZooKeeper/Curator and
deliberately exits on leadership loss so a supervisor restarts the process
clean (reference: cook.mesos/start-leader-selector mesos.clj:153-328,
System/exit on loss :296-313).  Same shape here:

 - :class:`FileLeaderElector` — file-lock election for single-host /
   multi-process deployments (the interface admits a ZK/k8s-lease
   implementation later);
 - the winner's URL is published next to the lock so follower (api-only)
   nodes can 307-redirect leader-only requests (reference: api-only? nodes
   config.clj:692 + leader-redirect in rest/api.clj);
 - on leadership loss the ``on_loss`` callback fires — production wiring
   should exit the process, mirroring the reference.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Optional


def _safe_node_id(node_id: str) -> str:
    """Node ids become filenames / annotation keys: keep them tame."""
    return re.sub(r"[^A-Za-z0-9._-]+", "-", node_id).strip("-") or "node"


class LeaderElector:
    """Interface: campaign, observe, resign — plus the candidate-position
    plane coordinated promotion publishes through (each standby's
    replication position ``(epoch, offset, synced)`` rides the election
    medium so the winner can rank candidates and pull a missing delta
    before opening its store; state/replication.py choose_successor)."""

    #: monotonic election epoch minted at acquisition when the elector
    #: supports it (None otherwise; the store falls back to "auto")
    epoch = None

    def campaign(self) -> None:
        raise NotImplementedError

    def resign(self) -> None:
        raise NotImplementedError

    @property
    def is_leader(self) -> bool:
        raise NotImplementedError

    def leader_url(self) -> Optional[str]:
        raise NotImplementedError

    # ---------------------------------------------- candidate positions
    def publish_candidate(self, node_id: str, position: Dict) -> None:
        """Publish this node's replication position into the election
        medium (no-op for electors without a coordination surface)."""

    def read_candidates(self) -> Dict[str, Dict]:
        """All published candidate positions, keyed by node id."""
        return {}

    def clear_candidate(self, node_id: str) -> None:
        """Withdraw a candidacy (a promoted winner's stale position must
        not confuse the next election)."""


class LeaseLeaderElector(LeaderElector):
    """Distributed election over a renewable TTL lease — the k8s-native
    leader-election recipe (coordination.k8s.io/v1 Lease: holderIdentity,
    renewTime, leaseDurationSeconds; the ZooKeeper/Curator slot of the
    reference, mesos.clj:153-328, re-based on the cluster backend's own
    coordination object so no extra infrastructure is required).

    ``api`` is any object with the lease surface of the kubernetes API
    adapters (cluster/k8s/fake_api.py ``try_acquire_lease``/``get_lease``;
    cluster/k8s/real_api.py implements the same against a live apiserver).
    The lease's ``transitions`` counter is the fencing epoch: it bumps
    every time holdership changes, so a deposed leader's stale writes can
    be rejected exactly like the file elector's epoch fencing.

    On losing the lease (renewal discovers another holder) ``on_loss``
    fires — production wiring exits the process for a supervisor restart,
    mirroring the reference's System/exit on leadership loss."""

    def __init__(self, api, identity: str, node_url: str,
                 lease_name: str = "cook-scheduler-leader",
                 duration_s: float = 15.0,
                 renew_interval_s: float = 2.0,
                 on_leadership: Optional[Callable[[], None]] = None,
                 on_loss: Optional[Callable[[], None]] = None,
                 clock: Callable[[], float] = time.time):
        # NOTE clock must share the lease's renew_time_s timebase: a real
        # apiserver stamps wall-clock epoch seconds, hence time.time (NOT
        # monotonic) — staleness checks compare the two directly.
        self.api = api
        self.identity = identity
        self.node_url = node_url
        self.lease_name = lease_name
        self.duration_s = duration_s
        self.renew_interval_s = renew_interval_s
        self.on_leadership = on_leadership
        self.on_loss = on_loss
        self.clock = clock
        self.epoch: Optional[int] = None  # fencing: lease transitions
        self._leader = False
        self._last_renew_ok: Optional[float] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def campaign(self) -> None:
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="lease-elector")
        self._thread.start()

    def try_once(self) -> bool:
        """One acquire/renew attempt (exposed for deterministic tests and
        for external pacing)."""
        from ..utils.faults import injector as _faults
        _faults.fire("leader.lease",
                     lambda: ConnectionError("injected lease fault"))
        lease = self.api.try_acquire_lease(
            self.lease_name, self.identity, self.clock(),
            duration_s=self.duration_s, holder_url=self.node_url)
        if lease is not None:
            first = not self._leader
            self._leader = True
            self._last_renew_ok = self.clock()
            self.epoch = lease.transitions
            if first and self.on_leadership:
                self.on_leadership()
            return True
        if self._leader:
            # held it, lost it: a competitor acquired after our TTL lapsed
            self._drop_leadership()
        return False

    def _drop_leadership(self) -> None:
        self._leader = False
        if self.on_loss:
            self.on_loss()

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.try_once()
            except Exception:
                # a transient apiserver error must NOT kill the renewal
                # thread while this node believes it leads — that is how
                # split brain happens: we'd stop renewing, keep scheduling,
                # and a standby would acquire after the TTL.  Keep retrying;
                # if renewals keep failing past our own TTL, assume the
                # lease is lost and step down pre-emptively.
                import logging
                logging.getLogger(__name__).warning(
                    "lease renewal attempt failed", exc_info=True)
                if self._leader and self._last_renew_ok is not None and \
                        self.clock() - self._last_renew_ok > self.duration_s:
                    self._drop_leadership()
            self._stop.wait(self.renew_interval_s)

    def resign(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None
        if self._leader:
            self._leader = False
            try:
                self.api.release_lease(self.lease_name, self.identity)
            except Exception:
                pass  # standby will still take over after the TTL
            if self.on_loss:
                self.on_loss()

    @property
    def is_leader(self) -> bool:
        return self._leader

    def leader_url(self) -> Optional[str]:
        lease = self.api.get_lease(self.lease_name)
        if lease is None or not lease.holder:
            return None
        if self.clock() - lease.renew_time_s > lease.duration_s:
            return None  # stale hold: no live leader to redirect to
        return lease.holder_url or None

    # ---------------------------------------------- candidate positions
    # Candidate positions ride the Lease object's annotations (the same
    # coordination object that carries the election — no extra
    # infrastructure), one ``cook.io/candidate-<id>`` key per standby.
    _CAND_PREFIX = "cook.io/candidate-"

    def publish_candidate(self, node_id: str, position: Dict) -> None:
        annotate = getattr(self.api, "annotate_lease", None)
        if annotate is None:
            return  # adapter without annotation support: no-op
        annotate(self.lease_name,
                 {self._CAND_PREFIX + _safe_node_id(node_id):
                  json.dumps(position)})

    def read_candidates(self) -> Dict[str, Dict]:
        lease = self.api.get_lease(self.lease_name)
        annotations = getattr(lease, "annotations", None) or {}
        out: Dict[str, Dict] = {}
        for key, value in annotations.items():
            if not key.startswith(self._CAND_PREFIX):
                continue
            try:
                out[key[len(self._CAND_PREFIX):]] = json.loads(value)
            except (TypeError, ValueError):
                continue  # a torn/foreign annotation must not kill ranking
        return out

    def clear_candidate(self, node_id: str) -> None:
        annotate = getattr(self.api, "annotate_lease", None)
        if annotate is not None:
            annotate(self.lease_name,
                     {self._CAND_PREFIX + _safe_node_id(node_id): None})


def partition_lock_path(election_dir: str, partition: int) -> str:
    """The per-partition lease lock in a partitioned write plane
    (state/partition.py): the single ``cook-leader.lock`` election
    generalizes to N leases over P partitions — partition p's leader is
    whoever holds ``cook-leader-p<p>.lock`` in the shared election dir,
    with the same minted-epoch fencing, published-URL, and
    candidate-position machinery per lease."""
    return str(Path(election_dir) / f"cook-leader-p{int(partition)}.lock")


def acquire_shard_lease(election_dir: str, partition: int, node_url: str,
                        timeout_s: float = 10.0) -> "FileLeaderElector":
    """Synchronous acquire-or-die for a controller shard boot (one
    partition = one process).  A shard worker cannot serve a
    single cycle without its partition's lease — unlike the daemon's
    background campaign there is nothing useful to do while waiting —
    so this blocks until the flock is held and the fencing epoch is
    minted, or raises.  The returned elector holds the lease; process
    death releases it, which is exactly what the failover path (the
    candidate ranking over the same lock's sidecar files) keys on."""
    elector = FileLeaderElector(
        partition_lock_path(election_dir, partition), node_url)
    deadline = time.monotonic() + max(float(timeout_s), 0.0)
    while True:
        if elector._try_acquire():
            elector._leader = True
            return elector
        if time.monotonic() >= deadline:
            raise TimeoutError(
                f"shard worker could not acquire the partition {partition} "
                f"lease within {timeout_s}s ({elector.lock_path} is held)")
        time.sleep(0.05)


class PartitionLeaseSet:
    """N independent leader leases over P partitions: one
    :class:`FileLeaderElector` per partition lock, campaigned and
    resigned individually.  A node may lead any SUBSET of partitions —
    losing one partition's lease fires only that partition's
    ``on_loss`` while the siblings keep serving (the chaos scenario's
    "sibling partitions never stall" invariant is exactly this
    isolation)."""

    def __init__(self, election_dir: str, count: int, node_url: str,
                 on_leadership=None, on_loss=None):
        self.electors: Dict[int, FileLeaderElector] = {}
        for p in range(int(count)):
            self.electors[p] = FileLeaderElector(
                partition_lock_path(election_dir, p), node_url,
                on_leadership=(lambda pp=p: on_leadership(pp))
                if on_leadership else None,
                on_loss=(lambda pp=p: on_loss(pp)) if on_loss else None)

    def campaign(self, partition: Optional[int] = None) -> None:
        for p, elector in self.electors.items():
            if partition is None or p == partition:
                elector.campaign()

    def resign(self, partition: Optional[int] = None) -> None:
        for p, elector in self.electors.items():
            if partition is None or p == partition:
                elector.resign()

    def led_partitions(self) -> list:
        return sorted(p for p, e in self.electors.items() if e.is_leader)

    def leader_url(self, partition: int) -> Optional[str]:
        return self.electors[int(partition)].leader_url()

    def epoch(self, partition: int) -> Optional[int]:
        return self.electors[int(partition)].epoch


class FileLeaderElector(LeaderElector):
    def __init__(self, lock_path: str, node_url: str,
                 on_leadership: Optional[Callable[[], None]] = None,
                 on_loss: Optional[Callable[[], None]] = None,
                 poll_interval_s: float = 0.2):
        self.lock_path = Path(lock_path)
        self.url_path = Path(str(lock_path) + ".leader")
        self.epoch_path = Path(str(lock_path) + ".epoch")
        self.node_url = node_url
        self.on_leadership = on_leadership
        self.on_loss = on_loss
        self.poll_interval_s = poll_interval_s
        self._fd: Optional[int] = None
        self._leader = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # monotonic ELECTION EPOCH, minted under the exclusive lock on
        # every acquisition: the fencing authority for journal records in
        # the separate-directory (socket replication) topology, where a
        # node-local epoch file cannot order two hosts' claims.
        self.epoch: Optional[int] = None

    # ------------------------------------------------------------- campaign
    def campaign(self) -> None:
        self._stop.clear()
        self._thread = threading.Thread(target=self._campaign_loop,
                                        daemon=True)
        self._thread.start()

    def _try_acquire(self) -> bool:
        import fcntl

        from ..utils.faults import injector as _faults
        if _faults.should_fire("leader.lease"):
            return False  # injected election fault: this attempt loses
        # first boot on a fresh host: the shared election dir may not
        # exist yet; a missing dir must not kill the campaign loop
        os.makedirs(os.path.dirname(self.lock_path) or ".", exist_ok=True)
        fd = os.open(self.lock_path, os.O_CREAT | os.O_RDWR, 0o644)
        try:
            # flock, not lockf: flock is per open-file-description, so two
            # electors in one process (tests, embedded followers) conflict
            # correctly; lockf would silently grant both
            fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            os.close(fd)
            return False
        self._fd = fd
        # durable counter (fsync before rename): a power loss must not
        # regress it, or two leaderships would mint the SAME fencing
        # epoch and stale-record skipping could no longer order them
        from ..utils.fsatomic import read_int_file, write_atomic_int
        self.epoch = (read_int_file(str(self.epoch_path), 0) or 0) + 1
        write_atomic_int(str(self.epoch_path), self.epoch)
        self.url_path.write_text(self.node_url)
        return True

    def _campaign_loop(self) -> None:
        while not self._stop.is_set():
            if self._try_acquire():
                self._leader = True
                if self.on_leadership:
                    self.on_leadership()
                # hold leadership until resign/stop; the lock is released by
                # process death, which is what makes failover work
                while not self._stop.is_set():
                    time.sleep(self.poll_interval_s)
                return
            time.sleep(self.poll_interval_s)

    def resign(self) -> None:
        import fcntl
        self._stop.set()
        was_leader = self._leader
        self._leader = False
        if self._fd is not None:
            try:
                fcntl.flock(self._fd, fcntl.LOCK_UN)
                os.close(self._fd)
            except OSError:
                pass
            self._fd = None
            try:
                if self.url_path.read_text() == self.node_url:
                    self.url_path.unlink()
            except OSError:
                pass
        if was_leader and self.on_loss:
            self.on_loss()
        if self._thread is not None:
            self._thread.join(timeout=2)

    @property
    def is_leader(self) -> bool:
        return self._leader

    def leader_url(self) -> Optional[str]:
        try:
            return self.url_path.read_text().strip() or None
        except OSError:
            return None

    # ---------------------------------------------- candidate positions
    # Candidate positions live as sidecar files next to the lock
    # (``<lock>.cand.<node-id>``), written atomically — the same shared
    # medium that carries the lock, the minted epoch, and the published
    # replication address (docs/DEPLOY.md: the election authority).
    def _cand_path(self, node_id: str) -> Path:
        return Path(f"{self.lock_path}.cand.{_safe_node_id(node_id)}")

    def publish_candidate(self, node_id: str, position: Dict) -> None:
        from ..utils.fsatomic import write_atomic_text
        os.makedirs(os.path.dirname(self.lock_path) or ".", exist_ok=True)
        write_atomic_text(str(self._cand_path(node_id)),
                          json.dumps(position))

    def read_candidates(self) -> Dict[str, Dict]:
        out: Dict[str, Dict] = {}
        prefix = self.lock_path.name + ".cand."
        try:
            entries = list(self.lock_path.parent.iterdir())
        except OSError:
            return out
        for p in entries:
            if not p.name.startswith(prefix) or ".tmp." in p.name:
                # crash-orphaned atomic-write temps (now dot-prefixed,
                # but older layouts left `<cand>.tmp*` behind) must
                # never be parsed as a live candidate
                continue
            try:
                out[p.name[len(prefix):]] = json.loads(p.read_text())
            except (OSError, ValueError):
                continue  # a mid-write or corrupt sidecar never wins
        return out

    def clear_candidate(self, node_id: str) -> None:
        try:
            self._cand_path(node_id).unlink()
        except OSError:
            pass
