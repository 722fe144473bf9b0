"""The port's copy of ``cook_tpu/sim/crashpoint.py`` (imports re-rooted).

Exhaustive crash-point recovery harness for the persistence plane.

The CrashMonkey/ALICE discipline (Mohan et al., OSDI'18; Pillai et al.,
OSDI'14) applied to the store's WAL: run a scripted workload, crash or
corrupt it at EVERY registered disk-fault site and EVERY record byte
boundary, recover, and assert the storage contract (docs/ROBUSTNESS.md
"WAL v2"):

* **zero committed-transaction loss** — every operation that returned
  success before the crash is visible after recovery;
* **zero phantom resurrection** — every operation that FAILED (clean
  abort) is absent after recovery;
* **torn tails are excised, mid-file damage refuses** — a truncated
  final frame recovers silently; a CRC-failing complete frame (or
  garbage with valid records after it) raises
  :class:`~cook_tpu_torch.state.integrity.JournalCorruptionError` instead of
  silently truncating committed history;
* **repair converges byte-identically** — healing a corrupt journal
  from a synced peer over the framed-TCP carrier (or the in-process
  scrub self-heal) ends with state equal to the pristine run, and the
  pulled journal bytes equal to the peer's;
* **read-view rebuild parity** — a
  :class:`~cook_tpu_torch.state.read_replica.FollowerReadView` tailing the
  recovered directory reaches the same entity state as the recovered
  store.

Legs (each an independent matrix; ``python -m cook_tpu_torch.sim
--crashpoints`` runs all of them, tests/test_crashpoint.py smoke-runs a
reduced matrix in tier-1 and the full soak under ``-m slow``):

==================  =====================================================
``fault-site``      every registered store fault point
                    (``store.journal.torn_write`` / ``bitflip`` /
                    ``fsync_lie`` / ``enospc`` / ``append``) armed at
                    every append index of the workload
``byte-boundary``   the clean run's journal truncated at every record
                    boundary and at cut points inside every frame —
                    the crash-mid-append shapes
``corruption``      one bit flipped in every record of the clean run's
                    journal — replay must refuse, then heal from a
                    synced peer (byte-identical) or quarantine+copy
                    when the native carrier is unavailable
``checkpoint``      checkpoint-time crash windows: manifest mismatch
                    falls back to the previous generation; an injected
                    ``fsatomic.fsync`` failure aborts the checkpoint
                    without losing the live store
==================  =====================================================
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from ..state.integrity import JournalCorruptionError, scan_journal
from ..state.read_replica import FollowerReadView
from ..state.schema import InstanceStatus, Job, Resources
from ..state.store import AbortTransaction, StorageFullError, Store

#: everything an op is allowed to fail with while a fault is armed —
#: the injected fault itself (OSError / StorageFullError), the store's
#: clean abort (AbortTransaction), and the follow-on failures of ops
#: whose predecessor aborted (launch of a never-created job, status of
#: a never-launched instance)
_OP_ABORTS = (AbortTransaction, OSError, StorageFullError, RuntimeError,
              ValueError, KeyError)
from ..utils.faults import injector

#: the disk-fault points this harness sweeps (registered in
#: utils/faults.py and documented in docs/ROBUSTNESS.md)
DISK_FAULT_POINTS = (
    "store.journal.append",
    "store.journal.torn_write",
    "store.journal.bitflip",
    "store.journal.fsync_lie",
    "store.journal.enospc",
)


# ---------------------------------------------------------------------------
# scripted workload
# ---------------------------------------------------------------------------

def _make_job(i: int) -> Job:
    return Job(uuid=f"00000000-0000-4000-8000-{i:012d}", user=f"u{i % 3}",
               command="echo crashpoint", pool="default",
               resources=Resources(cpus=1.0, mem=64.0), priority=50,
               max_retries=1)


def build_ops(n_jobs: int) -> List[Tuple]:
    """The deterministic op script: create / launch / run / finish /
    kill, interleaved so the journal carries every record shape the
    store emits (job create, instance launch, status transitions, kill
    tombstones, audit piggybacks)."""
    ops: List[Tuple] = []
    for i in range(n_jobs):
        ops.append(("create", i))
        ops.append(("launch", i, f"task-{i}", f"host-{i % 4}"))
        ops.append(("status", f"task-{i}", InstanceStatus.RUNNING))
        if i % 3 == 0:
            ops.append(("status", f"task-{i}", InstanceStatus.SUCCESS))
        elif i % 3 == 1:
            ops.append(("kill", i))
    return ops


def apply_op(store: Store, op: Tuple) -> None:
    kind = op[0]
    if kind == "create":
        store.create_jobs([_make_job(op[1])])
    elif kind == "launch":
        store.launch_instance(_make_job(op[1]).uuid, op[2], op[3])
    elif kind == "status":
        store.update_instance_status(op[1], op[2])
    elif kind == "kill":
        store.kill_job(_make_job(op[1]).uuid)
    else:  # pragma: no cover - script bug surface
        raise ValueError(f"unknown op {kind}")


def state_digest(store: Store) -> Tuple:
    """Order-independent entity-state fingerprint: job states plus
    per-instance statuses.  Two stores with equal digests agree on
    every committed transaction's visible effect."""
    rows = []
    for job in store.jobs_where(lambda j: True):
        insts = tuple(sorted(
            (t, store.instance(t).status.name)
            for t in job.instances if store.instance(t) is not None))
        rows.append((job.uuid, job.state.name, insts))
    return tuple(sorted(rows))


# ---------------------------------------------------------------------------
# result accounting
# ---------------------------------------------------------------------------

@dataclass
class CrashPointResult:
    cases: int = 0
    violations: List[Dict[str, Any]] = field(default_factory=list)
    legs: Dict[str, int] = field(default_factory=dict)
    notes: List[str] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.violations

    def case(self, leg: str) -> None:
        self.cases += 1
        self.legs[leg] = self.legs.get(leg, 0) + 1

    def violate(self, leg: str, case: str, detail: str) -> None:
        self.violations.append({"leg": leg, "case": case,
                                "detail": detail})

    def summary(self) -> Dict[str, Any]:
        return {"ok": self.ok, "cases": self.cases, "legs": self.legs,
                "violations": self.violations,
                **({"notes": self.notes} if self.notes else {})}


class _Run:
    """One pristine workload execution: the directory, the per-op
    committed byte offsets, and the digest after each op — the ground
    truth every crash case is judged against."""

    def __init__(self, directory: str, n_jobs: int):
        self.directory = directory
        self.ops = build_ops(n_jobs)
        store = Store.open(directory, fsync=True)
        self.op_offsets: List[int] = []   # journal bytes after op i
        self.op_digests: List[Tuple] = []  # digest after op i
        for op in self.ops:
            apply_op(store, op)
            self.op_offsets.append(store._commit_offset)
            self.op_digests.append(state_digest(store))
        self.final_digest = state_digest(store)
        store.close()
        with open(os.path.join(directory, "journal.jsonl"), "rb") as f:
            self.journal = f.read()
        # record boundaries: byte offset where each journal line starts
        self.line_starts: List[int] = [0]
        at = 0
        while True:
            nl = self.journal.find(b"\n", at)
            if nl < 0 or nl + 1 >= len(self.journal):
                break
            self.line_starts.append(nl + 1)
            at = nl + 1

    def digest_at(self, byte_offset: int) -> Tuple:
        """The expected digest after recovering a journal cut at
        ``byte_offset``: the last op whose commit offset fits."""
        best: Tuple = ()
        for off, dig in zip(self.op_offsets, self.op_digests):
            if off <= byte_offset:
                best = dig
            else:
                break
        return best


def _fresh_copy(run: _Run, base: str, name: str) -> str:
    d = os.path.join(base, name)
    shutil.copytree(run.directory, d)
    return d


def _flip_mid_byte(path: str) -> None:
    """Flip one bit in the middle byte of *path* in place."""
    with open(path, "r+b") as f:
        f.seek(max(0, os.path.getsize(path) // 2))
        b = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([b[0] ^ 0x40]))


def _read_view_digest(directory: str) -> Optional[Tuple]:
    view = FollowerReadView(directory, start=False)
    try:
        view.poll()
        if view.corrupt is not None:
            return None
        return state_digest(view.store)
    finally:
        view.stop()


# ---------------------------------------------------------------------------
# legs
# ---------------------------------------------------------------------------

def _leg_fault_sites(res: CrashPointResult, base: str, n_jobs: int,
                     stride: int) -> None:
    """Arm each disk-fault point at each append index, run the
    workload around the injected failure, crash, recover, and check
    the committed/aborted ledger."""
    probe = _Run(os.path.join(base, "probe"), n_jobs)
    n_appends = len(probe.ops)
    for point in DISK_FAULT_POINTS:
        for at in range(0, n_appends, max(1, stride)):
            res.case("fault-site")
            case = f"{point}@{at}"
            d = os.path.join(base, f"fs-{point.split('.')[-1]}-{at}")
            injector.clear()
            store = Store.open(d, fsync=True)
            injector.arm(point, schedule=[at], max_fires=1)
            silent_corruption = point == "store.journal.bitflip"
            try:
                for op in probe.ops:
                    try:
                        apply_op(store, op)
                    except _OP_ABORTS as e:
                        if isinstance(e, StorageFullError) \
                                and point != "store.journal.enospc":
                            res.violate("fault-site", case,
                                        f"unexpected StorageFullError: {e}")
                        # the aborted op — and any dependent op after it
                        # (a launch whose create aborted) — drops out of
                        # the ledger; the in-memory digest below is the
                        # pre-crash truth either way
            finally:
                injector.clear()
            expected = state_digest(store)  # pre-crash truth
            del store  # crash: no close(), no checkpoint
            try:
                recovered = Store.open(d, fsync=False)
            except JournalCorruptionError:
                if not silent_corruption:
                    res.violate("fault-site", case,
                                "recovery refused a journal that held "
                                "no mid-file damage")
                    continue
                # the bit flipped inside a committed frame: refusal IS
                # the contract.  Heal via the scrub path on a live
                # store: re-run the workload with the same flip, scrub
                # detects + checkpoints from memory, then recovery
                # succeeds.
                shutil.rmtree(d)
                store = Store.open(d, fsync=True)
                injector.arm(point, schedule=[at], max_fires=1)
                try:
                    for op in probe.ops:
                        try:
                            apply_op(store, op)
                        except _OP_ABORTS:
                            pass
                finally:
                    injector.clear()
                expected = state_digest(store)
                scrub_doc = {}
                while True:
                    scrub_doc = store.scrub(max_bytes=1 << 16,
                                            repair=True)
                    if scrub_doc.get("corrupt") \
                            or not scrub_doc.get("enabled") \
                            or scrub_doc.get("verified_offset", 0) \
                            >= scrub_doc.get("journal_bytes", 0):
                        break
                if scrub_doc.get("corrupt") \
                        and not scrub_doc.get("repaired"):
                    res.violate("fault-site", case,
                                "scrub detected corruption but did not "
                                "self-heal via checkpoint")
                    continue
                del store
                try:
                    recovered = Store.open(d, fsync=False)
                except JournalCorruptionError as e:
                    res.violate("fault-site", case,
                                f"post-scrub recovery still refused: {e}")
                    continue
            got = state_digest(recovered)
            if got != expected:
                res.violate("fault-site", case,
                            f"recovered state diverged: {len(got)} rows "
                            f"vs expected {len(expected)}")
            recovered.close()


def _leg_byte_boundary(res: CrashPointResult, run: _Run, base: str,
                       cuts_per_line: int) -> None:
    """Truncate the pristine journal at every record boundary and at
    cut points inside every frame — every shape a crash mid-append can
    leave — and assert recovery lands exactly on the committed
    prefix."""
    for li, start in enumerate(run.line_starts):
        end = (run.line_starts[li + 1]
               if li + 1 < len(run.line_starts) else len(run.journal))
        width = end - start
        cuts = {0}
        if width > 2 and cuts_per_line > 1:
            cuts.add(width // 2)
            cuts.add(width - 1)
        for cut in sorted(cuts):
            at = start + cut
            res.case("byte-boundary")
            case = f"line{li}+{cut}"
            d = os.path.join(base, f"bb-{li}-{cut}")
            os.makedirs(d)
            with open(os.path.join(d, "journal.jsonl"), "wb") as f:
                f.write(run.journal[:at])
            try:
                store = Store.open(d, fsync=False)
            except JournalCorruptionError as e:
                res.violate("byte-boundary", case,
                            f"torn tail refused instead of excised: {e}")
                continue
            expected = run.digest_at(at)
            got = state_digest(store)
            if got != expected:
                res.violate(
                    "byte-boundary", case,
                    f"recovered {len(got)} rows, expected "
                    f"{len(expected)} (committed-prefix mismatch)")
            store.close()


def _leg_corruption(res: CrashPointResult, run: _Run, base: str,
                    repl_port: Optional[int]) -> None:
    """Flip one bit in every record of the pristine journal: replay
    must REFUSE (never silently truncate the committed records beyond
    the damage), and repair must converge byte-identically — from a
    synced peer over the real carrier when available, else via
    quarantine + copy."""
    for li, start in enumerate(run.line_starts):
        end = (run.line_starts[li + 1]
               if li + 1 < len(run.line_starts) else len(run.journal))
        res.case("corruption")
        case = f"line{li}"
        d = os.path.join(base, f"cr-{li}")
        os.makedirs(d)
        flip_at = start + max(0, (end - start) // 2 - 1)
        damaged = bytearray(run.journal)
        damaged[flip_at] ^= 0x40
        with open(os.path.join(d, "journal.jsonl"), "wb") as f:
            f.write(bytes(damaged))
        refused = False
        try:
            store = Store.open(d, fsync=False)
            store.close()
        except JournalCorruptionError:
            refused = True
        if not refused:
            res.violate("corruption", case,
                        "mid-file corruption replayed without refusal "
                        "(silent truncation or bad-frame acceptance)")
            continue
        # heal: real peer pull when the native carrier is built,
        # quarantine+copy otherwise — both must converge byte-identical
        if repl_port is not None:
            from ..state.repair import open_with_repair
            try:
                store = open_with_repair(
                    d, peers=[("127.0.0.1", repl_port)], timeout_s=10.0)
            except JournalCorruptionError as e:
                res.violate("corruption", case,
                            f"peer repair failed: {e}")
                continue
        else:
            from ..state.repair import quarantine
            quarantine(d)
            shutil.copyfile(os.path.join(run.directory, "journal.jsonl"),
                            os.path.join(d, "journal.jsonl"))
            store = Store.open(d, fsync=False)
        if state_digest(store) != run.final_digest:
            res.violate("corruption", case,
                        "repaired state != pristine state")
        store.close()
        with open(os.path.join(d, "journal.jsonl"), "rb") as f:
            healed = f.read()
        if healed != run.journal:
            res.violate("corruption", case,
                        "repaired journal bytes != peer journal bytes "
                        f"({len(healed)} vs {len(run.journal)})")
        # read-view parity over the healed directory
        rv_digest = _read_view_digest(d)
        if rv_digest != run.final_digest:
            res.violate("corruption", case,
                        "read-view rebuild diverged from the healed "
                        "store")


def _leg_checkpoint(res: CrashPointResult, run: _Run, base: str,
                    n_jobs: int) -> None:
    """Checkpoint-time crash windows (state/store.py checkpoint
    rotation order): a damaged current snapshot falls back to the
    previous generation + rotated journal; a manifest-less snapshot
    loads legacy; an injected temp-fsync failure aborts the checkpoint
    with the live store intact."""
    ops = build_ops(n_jobs)
    half = len(ops) // 2

    # (a) snapshot bitflip with a previous generation on disk: two
    # checkpoints so the rotation has hard-linked gen N-1 aside
    # (snapshot.prev.json + journal.prev.jsonl), then damage gen N —
    # open must fall back and replay the prev chain to full state
    res.case("checkpoint")
    d = os.path.join(base, "ck-snap")
    store = Store.open(d, fsync=True)
    third = max(1, len(ops) // 3)
    for op in ops[:third]:
        apply_op(store, op)
    store.checkpoint()
    for op in ops[third:2 * third]:
        apply_op(store, op)
    store.checkpoint()
    for op in ops[2 * third:]:
        apply_op(store, op)
    expected = state_digest(store)
    store.close()
    _flip_mid_byte(os.path.join(d, "snapshot.json"))
    try:
        reopened = Store.open(d, fsync=False)
    except JournalCorruptionError as e:
        res.violate("checkpoint", "snapshot-bitflip",
                    f"prev-generation fallback failed: {e}")
    else:
        if state_digest(reopened) != expected:
            res.violate("checkpoint", "snapshot-bitflip",
                        "fallback chain lost state")
        reopened.close()

    # (a') snapshot bitflip with NO previous generation: refusing is
    # the contract — silently proceeding would serve poisoned state
    res.case("checkpoint")
    d = os.path.join(base, "ck-snap-sole")
    store = Store.open(d, fsync=True)
    for op in ops[:half]:
        apply_op(store, op)
    store.checkpoint()
    store.close()
    _flip_mid_byte(os.path.join(d, "snapshot.json"))
    try:
        Store.open(d, fsync=False).close()
    except JournalCorruptionError:
        pass
    else:
        res.violate("checkpoint", "snapshot-sole-bitflip",
                    "open accepted a damaged snapshot with no "
                    "fallback generation")

    # (b) fsatomic.fsync failure DURING checkpoint: abort, store live,
    # reopen replays the untouched journal
    res.case("checkpoint")
    d = os.path.join(base, "ck-fsync")
    store = Store.open(d, fsync=True)
    for op in ops[:half]:
        apply_op(store, op)
    injector.arm("fsatomic.fsync", schedule=[0], max_fires=1)
    ck_failed = False
    try:
        store.checkpoint()
    except OSError:
        ck_failed = True
    finally:
        injector.clear()
    if not ck_failed:
        res.notes.append("checkpoint fsync fault did not surface "
                         "(atomic-write path absorbed it)")
    for op in ops[half:]:
        try:
            apply_op(store, op)
        except (OSError, RuntimeError):
            res.violate("checkpoint", "fsync-abort",
                        "store unusable after aborted checkpoint")
            break
    expected = state_digest(store)
    store.close()
    try:
        reopened = Store.open(d, fsync=False)
    except JournalCorruptionError as e:
        res.violate("checkpoint", "fsync-abort",
                    f"recovery refused after aborted checkpoint: {e}")
    else:
        if state_digest(reopened) != expected:
            res.violate("checkpoint", "fsync-abort",
                        "aborted checkpoint lost committed state")
        # the aborted atomic write's temp is the hygiene sweep's prey:
        # nothing dot-tmp may survive the reopen
        leftovers = [n for n in os.listdir(d)
                     if n.startswith(".") and ".tmp." in n]
        if leftovers:
            res.notes.append(f"hygiene left temps (young): {leftovers}")
        reopened.close()


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

def run_crashpoints(n_jobs: int = 4, stride: int = 1,
                    cuts_per_line: int = 3,
                    use_replication: bool = True,
                    workdir: Optional[str] = None) -> CrashPointResult:
    """Run every leg of the crash matrix.  ``n_jobs`` scales the
    scripted workload (the tier-1 smoke uses a small one; the slow
    soak and the CLI default drive the full script), ``stride``
    subsamples the fault-site append indices, ``cuts_per_line``
    bounds the intra-frame cut points (1 = boundaries only)."""
    res = CrashPointResult()
    injector.clear()
    own_tmp = workdir is None
    base = workdir or tempfile.mkdtemp(prefix="cook-crashpoint-")
    server = None
    repl_port = None
    try:
        run = _Run(os.path.join(base, "pristine"), n_jobs)
        # sanity: the pristine journal must scan clean end to end
        scan = scan_journal(os.path.join(run.directory, "journal.jsonl"))
        if scan.corrupt:
            res.violate("setup", "pristine",
                        f"clean run scanned corrupt: {scan.reason}")
            return res
        if use_replication:
            try:
                from ..state.replication import (ReplicationServer,
                                                 replication_available)
                if replication_available():
                    server = ReplicationServer(run.directory, port=0)
                    repl_port = server.port
                else:
                    res.notes.append("native replication unavailable — "
                                     "corruption leg heals via "
                                     "quarantine+copy")
            except Exception as e:
                res.notes.append(f"replication server unavailable: {e}")
        _leg_fault_sites(res, base, n_jobs, stride)
        _leg_byte_boundary(res, run, base, cuts_per_line)
        _leg_corruption(res, run, base, repl_port)
        _leg_checkpoint(res, run, base, n_jobs)
    finally:
        injector.clear()
        if server is not None:
            server.stop()
        if own_tmp:
            shutil.rmtree(base, ignore_errors=True)
    return res


def main(argv=None) -> int:  # pragma: no cover - CLI shim
    import argparse
    p = argparse.ArgumentParser(prog="cook_tpu_torch.sim.crashpoint")
    p.add_argument("--jobs", type=int, default=4)
    p.add_argument("--stride", type=int, default=1)
    p.add_argument("--no-replication", action="store_true")
    args = p.parse_args(argv)
    res = run_crashpoints(n_jobs=args.jobs, stride=args.stride,
                          use_replication=not args.no_replication)
    print(json.dumps(res.summary(), indent=2))
    return 0 if res.ok else 1


if __name__ == "__main__":  # pragma: no cover
    import sys
    sys.exit(main())
