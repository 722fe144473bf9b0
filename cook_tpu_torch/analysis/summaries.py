"""The port's copy of ``cook_tpu/analysis/summaries.py`` (source read as ASTs;
it imports nothing that it scans).

Interprocedural effect summaries + the whole-program lint passes.

Built on the call graph (callgraph.py), this module computes one
**effect summary** per function by fixpoint — the RacerD shape
(Blackshear et al., OOPSLA'18): summaries compose bottom-up over call
edges instead of re-analyzing bodies per context —

``blocks``
    blocking operations reachable by executing the function (seeded
    from the lexical pass's op table: fsync, sleep, socket, HTTP,
    subprocess, fsatomic writes, ``wait_acked``), each with one
    representative call chain;
``acquires``
    locks that may be acquired during execution (``with`` regions and
    manual ``.acquire()`` sites), again with a chain;
``spawns_thread``
    reachable ``threading.Thread`` construction;
``requires_lock``
    the lock a ``_locked``-suffix / "caller holds" function runs under
    BY CONTRACT (callgraph.py parses the docstring form) — and the
    belief-inference move (Engler et al., SOSP'01): the convention is
    *verified*, every resolved call site must hold the named lock.

On top of the summaries, four passes:

``lock-transitive-blocking``
    a blocking effect reachable through ≥1 call while a lock is held —
    the depth-0 (lexical) case stays with passes.py; findings are
    checked against the SAME ``ALLOWED_BLOCKING`` allowlist the dynamic
    monitor uses (parsed from the scanned tree's ``utils/locks.py``).
    Calls through the *unresolved* bucket contribute nothing here (a
    guess through a callback would drown the report); the dynamic
    sanitizer owns that residue, and the coverage stats say how much
    there is.
``lock-order-static`` / ``lock-sibling-static``
    the static may-be-held-at-acquisition edge set, rank-checked
    against the declared table and the sibling-family no-nesting rule.
    Same-NAME re-entrancy (``store`` held, ``store`` re-acquired — the
    RLock idiom) adds no edge; dynamic call sites over-approximate
    against the escaping-function set and contribute ``dynamic`` edges
    to the coverage diff but never violations.
``lock-contract-unverified`` / ``lock-contract-unnamed``
    the requires_lock verifier.
``journal-record-*`` / ``journal-raw-write``
    protocol completeness for the journal record kinds: every kind
    written at a ``*journal_file*.write(seal_record(...))`` site (the
    checksummed appender, state/integrity.py; legacy
    ``json.dumps(...)`` payloads still harvest) must have a replay
    handler (``_apply_journal_record`` / ``_replay_records``), be
    declared in the ``JOURNAL_RECORD_KINDS`` registry, and the
    read-replica tail must route whole records through
    ``_replay_records`` — so a new record kind can never silently
    vanish on a follower again.  ``journal-raw-write`` flags any
    journal write whose payload bypasses ``seal_record`` — an
    un-enveloped line is invisible to the torn-vs-corrupt verdict
    (docs/ROBUSTNESS.md WAL v2).

The static edge set is exported (family-normalized) for the
static-vs-dynamic coverage diff on ``cs lint --lock-coverage`` and
``GET /debug/health`` → ``locks`` (utils/locks.py owns the observed
half).
"""

from __future__ import annotations

import ast
import threading
from collections import deque
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional, Set, Tuple

from .callgraph import (CallGraph, FuncInfo, LockRef, build_callgraph,
                        family)
from .engine import Finding


# ---------------------------------------------------------------------------
# the declared contract, parsed from the scanned tree
# ---------------------------------------------------------------------------

def load_lock_contract(trees: Dict[str, ast.Module]
                       ) -> Tuple[Dict[str, int],
                                  Set[Tuple[str, str]]]:
    """(declared ranks, allowed blocking) parsed from the scanned
    tree's ``utils/locks.py`` — the analysis consults the SAME contract
    the dynamic sanitizer enforces, without importing the scanned code
    (fixture trees stay hermetic; absent file = empty contract)."""
    ranks: Dict[str, int] = {}
    allowed: Set[Tuple[str, str]] = set()
    tree = trees.get("utils/locks.py")
    if tree is None:
        return ranks, allowed
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            name, value = node.targets[0].id, node.value
        elif isinstance(node, ast.AnnAssign) \
                and isinstance(node.target, ast.Name) \
                and node.value is not None:
            name, value = node.target.id, node.value
        else:
            continue
        node = ast.Assign(targets=[ast.Name(id=name)], value=value)
        if name == "_DECLARED_ORDER" and isinstance(node.value, ast.Dict):
            for k, v in zip(node.value.keys, node.value.values):
                if isinstance(k, ast.Constant) \
                        and isinstance(v, ast.Constant):
                    ranks[str(k.value)] = int(v.value)
        elif name == "ALLOWED_BLOCKING" and isinstance(
                node.value, ast.Set):
            for elt in node.value.elts:
                if isinstance(elt, ast.Tuple) and len(elt.elts) == 2 \
                        and all(isinstance(e, ast.Constant)
                                for e in elt.elts):
                    allowed.add((str(elt.elts[0].value),
                                 str(elt.elts[1].value)))
    return ranks, allowed


# ---------------------------------------------------------------------------
# the fixpoint
# ---------------------------------------------------------------------------

@dataclass
class Summaries:
    #: fid -> {op label -> representative callee chain (fids)}
    blocks: Dict[str, Dict[str, Tuple[str, ...]]] = \
        field(default_factory=dict)
    #: fid -> {lock name -> (LockRef, representative chain)}
    acquires: Dict[str, Dict[str, Tuple[LockRef, Tuple[str, ...]]]] = \
        field(default_factory=dict)
    #: fids that may construct a thread (directly or transitively)
    spawns_thread: Set[str] = field(default_factory=set)
    iterations: int = 0

    def to_doc_for(self, fid: str) -> Dict[str, Any]:
        return {
            "blocks": sorted(self.blocks.get(fid, ())),
            "acquires": sorted(self.acquires.get(fid, ())),
            "spawns_thread": fid in self.spawns_thread,
        }


def compute_summaries(cg: CallGraph) -> Summaries:
    """Worklist fixpoint over the call graph.  Each map only grows and
    is bounded by (functions × ops) / (functions × locks), so
    termination is structural; on this tree it settles in a few
    thousand relaxations (<1 s)."""
    s = Summaries()
    callers: Dict[str, Set[str]] = {}
    for fid, fi in cg.functions.items():
        s.blocks[fid] = {op: () for (op, _name, _ln, _held) in fi.blocks}
        s.acquires[fid] = {ref.name: (ref, ())
                           for (ref, _ln, _held) in fi.acquires}
        if fi.spawns_thread:
            s.spawns_thread.add(fid)
        for cs in fi.calls:
            callers.setdefault(cs.callee, set()).add(fid)
    work = deque(cg.functions)
    while work:
        g = work.popleft()
        s.iterations += 1
        gb, ga = s.blocks.get(g), s.acquires.get(g)
        if gb is None:
            continue
        g_spawns = g in s.spawns_thread
        for f in callers.get(g, ()):
            changed = False
            fb, fa = s.blocks[f], s.acquires[f]
            for op, chain in gb.items():
                if op not in fb:
                    fb[op] = (g,) + chain
                    changed = True
            for ln, (ref, chain) in ga.items():
                if ln not in fa:
                    fa[ln] = (ref, (g,) + chain)
                    changed = True
            if g_spawns and f not in s.spawns_thread:
                s.spawns_thread.add(f)
                changed = True
            if changed:
                work.append(f)
    return s


def _short(fid: str) -> str:
    parts = fid.split(".")
    return ".".join(parts[-2:]) if len(parts) > 1 else fid


def _chain_str(fi: FuncInfo, chain: Tuple[str, ...], tail: str) -> str:
    return " -> ".join([_short(fi.fid)] + [_short(c) for c in chain]
                       + [tail])


def _allowed(lock: str, op: str,
             allowed: Set[Tuple[str, str]]) -> bool:
    return (lock, op) in allowed or (family(lock), op) in allowed


# ---------------------------------------------------------------------------
# pass: transitive blocking-under-lock
# ---------------------------------------------------------------------------

def transitive_blocking_findings(
        cg: CallGraph, s: Summaries,
        allowed: Set[Tuple[str, str]]) -> List[Finding]:
    findings: List[Finding] = []
    seen: Set[Tuple[str, str, str, str]] = set()
    for fid, fi in cg.functions.items():
        for cs in fi.calls:
            if not cs.held:
                continue
            callee = cg.functions.get(cs.callee)
            cblocks = s.blocks.get(cs.callee)
            if not cblocks:
                continue
            for op, chain in cblocks.items():
                for lock in cs.held:
                    if _allowed(lock, op, allowed):
                        continue
                    # report at the frame NEAREST the op whose contract
                    # documents the lock: when the callee itself runs
                    # under this lock by contract, its own body is the
                    # better (deeper) report site — skip the duplicate
                    if callee is not None \
                            and callee.requires_lock is not None \
                            and _lock_matches(lock,
                                              callee.requires_lock):
                        continue
                    key = (fid, lock, cs.callee, op)
                    if key in seen:
                        continue
                    seen.add(key)
                    findings.append(Finding(
                        check="lock-transitive-blocking",
                        path=fi.relpath, line=cs.line,
                        scope=fi.qualscope,
                        detail=f"{family(lock)}:{_short(cs.callee)}:{op}",
                        message=(
                            f"call chain "
                            f"{_chain_str(fi, (cs.callee,) + chain, op)}"
                            f" blocks ({op}) while holding '{lock}' — "
                            "not in locks.ALLOWED_BLOCKING; move the "
                            "blocking tail off the lock or baseline "
                            "the design")))
    return findings


def _lock_matches(held: str, req: LockRef) -> bool:
    """Does holding ``held`` satisfy a requires_lock on ``req``?  Named
    locks match by rank family; pseudo (unnamed) locks match by
    attribute tail (``~Store._lock`` vs ``~*._lock``)."""
    if held == req.name:
        return True
    if req.named and not held.startswith("~"):
        return family(held) == family(req.name)
    if held.startswith("~"):
        # pseudo holds match by attribute tail — against a pseudo
        # requirement, or against a named-token requirement whose
        # token is really an attribute the holder's class never
        # resolved (`kill_lock`)
        tail = held.rsplit(".", 1)[-1]
        if req.name.startswith("~"):
            return tail == req.name.rsplit(".", 1)[-1]
        return tail == req.name
    return False


# ---------------------------------------------------------------------------
# pass: requires_lock verification
# ---------------------------------------------------------------------------

def contract_findings(cg: CallGraph) -> List[Finding]:
    findings: List[Finding] = []
    seen: Set[Tuple[str, str]] = set()
    for fid, fi in cg.functions.items():
        if fi.contract_unnamed:
            findings.append(Finding(
                check="lock-contract-unnamed", path=fi.relpath,
                line=fi.line, scope=fi.qualscope, detail=fi.name,
                message=(f"`{fi.name}` declares a lock-held contract "
                         "(docstring/_locked suffix) without a "
                         "resolvable lock name — use the `caller holds "
                         "self._lock` idiom so the interprocedural "
                         "verifier can check every call site")))
        for cs in fi.calls:
            callee = cg.functions.get(cs.callee)
            if callee is None or callee.requires_lock is None:
                continue
            req = callee.requires_lock
            if any(_lock_matches(h, req) for h in cs.held):
                continue
            if (fid, cs.callee) in seen:
                continue
            seen.add((fid, cs.callee))
            findings.append(Finding(
                check="lock-contract-unverified", path=fi.relpath,
                line=cs.line, scope=fi.qualscope,
                detail=f"{_short(cs.callee)}:{req.name}",
                message=(
                    f"`{_short(cs.callee)}` runs with '{req.name}' "
                    "held by contract, but this call site does not "
                    "provably hold it — wrap the call in the lock, fix "
                    "the contract docstring, or baseline the design")))
    return findings


# ---------------------------------------------------------------------------
# pass: static lock-order graph
# ---------------------------------------------------------------------------

@dataclass
class LockEdge:
    src: str                    #: full lock name as held
    dst: str                    #: full lock name acquired
    kind: str                   #: "resolved" | "dynamic"
    path: str
    line: int
    scope: str
    chain: str                  #: human-readable sample chain

    @property
    def fam(self) -> Tuple[str, str]:
        return (family(self.src), family(self.dst))

    def to_doc(self) -> Dict[str, Any]:
        return {"from": family(self.src), "to": family(self.dst),
                "kind": self.kind, "via": self.chain,
                "site": f"{self.path}:{self.line}"}


def compute_lock_edges(cg: CallGraph, s: Summaries
                       ) -> Dict[Tuple[str, str], LockEdge]:
    """The static may-be-held-at-acquisition edge set over NAMED locks.

    ``resolved`` edges flow through direct/typed/unique call edges and
    lexical nesting; ``dynamic`` edges over-approximate callback call
    sites against every escaping function's acquisition summary (the
    bounded treatment of dynamic dispatch — they join the coverage
    diff, never the violation list)."""
    edges: Dict[Tuple[str, str], LockEdge] = {}

    def named(lock: str) -> bool:
        return not lock.startswith("~")

    def add(src: str, ref: LockRef, kind: str, fi: FuncInfo,
            line: int, chain: str) -> None:
        if not named(src) or not ref.named:
            return
        if src == ref.name:
            return  # same-name re-entrancy (the RLock idiom): no edge
        key = (family(src), family(ref.name))
        prev = edges.get(key)
        if prev is None or (prev.kind == "dynamic"
                            and kind == "resolved"):
            edges[key] = LockEdge(src=src, dst=ref.name, kind=kind,
                                  path=fi.relpath, line=line,
                                  scope=fi.qualscope, chain=chain)

    # escaping-set acquisition union, for dynamic sites
    esc_acquires: Dict[str, Tuple[LockRef, str]] = {}
    for efid in cg.escaping:
        for name, (ref, chain) in s.acquires.get(efid, {}).items():
            if ref.named and name not in esc_acquires:
                esc_acquires[name] = (
                    ref, _chain_str(cg.functions[efid], chain,
                                    f"acquire {name}"))

    for fid, fi in cg.functions.items():
        for (ref, line, held) in fi.acquires:
            for src in held:
                add(src, ref, "resolved", fi, line,
                    f"{_short(fid)} acquires {ref.name}")
        for cs in fi.calls:
            if not cs.held:
                continue
            for name, (ref, chain) in s.acquires.get(cs.callee,
                                                     {}).items():
                for src in cs.held:
                    add(src, ref, "resolved", fi, cs.line,
                        _chain_str(fi, (cs.callee,) + chain,
                                   f"acquire {name}"))
        for ds in fi.dynamic_calls:
            if not ds.held:
                continue
            if ds.candidates:
                # ambiguous ATTRIBUTE dispatch: the method name bounds
                # the possible callees — over-approximate against the
                # candidate set, not the whole escaping set
                pool: Dict[str, Tuple[LockRef, str]] = {}
                for cand in ds.candidates:
                    for name, (ref, chain) in s.acquires.get(
                            cand, {}).items():
                        if ref.named and name not in pool:
                            pool[name] = (ref, _chain_str(
                                cg.functions[cand], chain,
                                f"acquire {name}"))
            else:
                # a bare callback variable: anything that escaped
                pool = esc_acquires
            for name, (ref, chain) in pool.items():
                for src in ds.held:
                    add(src, ref, "dynamic", fi, ds.line,
                        f"{_short(fid)} -> <{ds.name}> ... {chain}")
    return edges


def lock_order_findings(edges: Dict[Tuple[str, str], LockEdge],
                        ranks: Dict[str, int]) -> List[Finding]:
    findings: List[Finding] = []
    for edge in edges.values():
        if edge.kind != "resolved":
            continue  # dynamic over-approximation: coverage only
        sf, df = family(edge.src), family(edge.dst)
        rs, rd = ranks.get(sf), ranks.get(df)
        if sf == df:
            # distinct names, one rank family: the sibling no-nesting
            # rule (utils/locks.py partitioned-store contract)
            findings.append(Finding(
                check="lock-sibling-static", path=edge.path,
                line=edge.line, scope=edge.scope,
                detail=f"{edge.src}->{edge.dst}",
                message=(
                    f"'{edge.dst}' may be acquired while holding "
                    f"sibling '{edge.src}' (rank family '{sf}') via "
                    f"{edge.chain} — sibling locks of a rank family "
                    "may never nest (ABBA-unorderable)")))
        elif rs is not None and rd is not None and rd < rs:
            findings.append(Finding(
                check="lock-order-static", path=edge.path,
                line=edge.line, scope=edge.scope,
                detail=f"{sf}->{df}",
                message=(
                    f"'{edge.dst}' (rank {rd}) may be acquired while "
                    f"holding '{edge.src}' (rank {rs}) via "
                    f"{edge.chain} — violates the declared lock-order "
                    "contract (utils/locks.py)")))
    return findings


# ---------------------------------------------------------------------------
# pass: journal-record protocol completeness
# ---------------------------------------------------------------------------

#: handler functions whose constant keys count as "replayed"
_HANDLER_FNS = ("_apply_journal_record", "_replay_records")
#: the declared registry's module-level name
_KIND_TABLE = "JOURNAL_RECORD_KINDS"


def _const_keys(node: ast.AST) -> Set[str]:
    out: Set[str] = set()
    if isinstance(node, ast.Dict):
        for k in node.keys:
            if isinstance(k, ast.Constant) and isinstance(k.value, str):
                out.add(k.value)
    return out


def _dotted_parts(node: ast.AST) -> str:
    parts: List[str] = []
    b = node
    while isinstance(b, ast.Attribute):
        parts.append(b.attr)
        b = b.value
    if isinstance(b, ast.Name):
        parts.append(b.id)
    return ".".join(parts)


def _call_fname(call: ast.Call) -> str:
    return call.func.attr if isinstance(call.func, ast.Attribute) else (
        call.func.id if isinstance(call.func, ast.Name) else "")


def _payload_call(arg: ast.AST,
                  local_assigns: Dict[str, ast.AST]
                  ) -> Optional[ast.Call]:
    """The outermost call feeding a journal ``write(...)`` payload
    (``seal_record(rec)`` / ``json.dumps(rec)``), following one level
    of local alias and stripping ``+ "\\n"``."""
    for _ in range(2):
        while isinstance(arg, ast.BinOp):
            arg = arg.left
        if isinstance(arg, ast.Call):
            return arg
        if isinstance(arg, ast.Name) and arg.id in local_assigns:
            arg = local_assigns[arg.id]
            continue
        return None
    return None


def _dumps_payload(arg: ast.AST,
                   local_assigns: Dict[str, ast.AST]
                   ) -> Optional[ast.AST]:
    """The dict/name inside a journal payload expression — the sealed
    form ``seal_record(rec)`` (state/integrity.py — the record rides a
    CRC32C envelope) or the legacy ``json.dumps(rec) + "\\n"`` —
    following one level of local alias."""
    call = _payload_call(arg, local_assigns)
    if call is None or not call.args:
        return None
    fname = _call_fname(call)
    if "seal" in fname:
        inner = call.args[0]
        # seal_record(json.dumps(...)) never occurs, but a sealed
        # payload may itself be aliased one level
        if isinstance(inner, ast.Call) and "dumps" in _call_fname(inner) \
                and inner.args:
            return inner.args[0]
        return inner
    if "dumps" in fname:
        return call.args[0]
    return None


def _record_keys_in_fn(fn: ast.AST, rec_names: Set[str]) -> Set[str]:
    """Keys assigned into the record dicts named in ``rec_names``
    within one writer function (dict literal init + subscript
    assignment)."""
    out: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id in rec_names:
                    out |= _const_keys(node.value)
                elif isinstance(t, ast.Subscript) \
                        and isinstance(t.value, ast.Name) \
                        and t.value.id in rec_names \
                        and isinstance(t.slice, ast.Constant) \
                        and isinstance(t.slice.value, str):
                    out.add(t.slice.value)
        elif isinstance(node, ast.AnnAssign) and node.value is not None \
                and isinstance(node.target, ast.Name) \
                and node.target.id in rec_names:
            out |= _const_keys(node.value)
    return out


def journal_record_findings(trees: Dict[str, ast.Module]
                            ) -> List[Finding]:
    """Protocol-completeness registry for the journal record kinds.

    Harvests, purely statically:

    - **written** kinds — at every ``<...journal_file...>.write(
      seal_record(rec))`` site (or the legacy ``json.dumps(rec)``
      form), the constant keys of ``rec`` (dict-literal init +
      ``rec["k"] = ...`` assignments in the same function, or an
      inline dict literal);
    - **handled** kinds — constant ``rec.get("k")`` / ``rec["k"]`` keys
      inside the replay handlers (``_apply_journal_record`` /
      ``_replay_records``);
    - **declared** kinds — the ``JOURNAL_RECORD_KINDS`` registry.

    A written kind without a handler is how a record type silently
    vanishes on replay/follower-tail; a written kind missing from the
    registry is an undocumented protocol extension; a declared kind
    never written is a stale registry entry.  The read-replica tail
    must route whole records through ``_replay_records`` (the epoch
    fence + handler table live there), or every kind is follower-lost.
    """
    written: Dict[str, Tuple[str, int]] = {}
    handled: Set[str] = set()
    declared: Dict[str, Tuple[str, int]] = {}
    raw_writes: List[Tuple[str, int]] = []
    writer_seen = False
    replica_files: List[str] = []
    replica_calls_replay = False

    for relpath, tree in sorted(trees.items()):
        if relpath.endswith("read_replica.py"):
            replica_files.append(relpath)
        for node in tree.body:
            if isinstance(node, (ast.Assign, ast.AnnAssign)):
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                if any(isinstance(t, ast.Name) and t.id == _KIND_TABLE
                       for t in targets) and node.value is not None:
                    for k in _const_keys(node.value):
                        declared[k] = (relpath, node.lineno)
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if node.name in _HANDLER_FNS:
                    for sub in ast.walk(node):
                        if isinstance(sub, ast.Call) and isinstance(
                                sub.func, ast.Attribute) \
                                and sub.func.attr == "get" and sub.args \
                                and isinstance(sub.args[0], ast.Constant) \
                                and isinstance(sub.args[0].value, str):
                            handled.add(sub.args[0].value)
                        elif isinstance(sub, ast.Subscript) \
                                and isinstance(sub.slice, ast.Constant) \
                                and isinstance(sub.slice.value, str):
                            handled.add(sub.slice.value)
                # writer sites in this function.  The repo idiom
                # aliases the handle and the line:
                #     f = self._journal_file
                #     line = seal_record(rec)
                #     f.write(line)
                # so both the write target and the payload resolve
                # through one level of local assignment.
                local_assigns: Dict[str, ast.AST] = {}
                aliases: Set[str] = set()
                for sub in ast.walk(node):
                    if isinstance(sub, ast.Assign) \
                            and len(sub.targets) == 1 \
                            and isinstance(sub.targets[0], ast.Name):
                        nm = sub.targets[0].id
                        local_assigns.setdefault(nm, sub.value)
                        if "journal_file" in _dotted_parts(sub.value):
                            aliases.add(nm)
                rec_names: Set[str] = set()
                inline_keys: Set[str] = set()
                fn_writes = False
                for sub in ast.walk(node):
                    if not (isinstance(sub, ast.Call)
                            and isinstance(sub.func, ast.Attribute)
                            and sub.func.attr == "write" and sub.args):
                        continue
                    base = sub.func.value
                    target_parts = _dotted_parts(base)
                    is_journal = "journal_file" in target_parts or (
                        isinstance(base, ast.Name)
                        and base.id in aliases)
                    if not is_journal:
                        continue
                    # every journal write must route through the
                    # checksummed appender (state/integrity.seal_record)
                    # — a bare json.dumps line has no CRC envelope, so
                    # replay can't tell a torn tail from mid-file
                    # corruption for it
                    call = _payload_call(sub.args[0], local_assigns)
                    if call is None or "seal" not in _call_fname(call):
                        raw_writes.append((relpath, sub.lineno))
                    payload = _dumps_payload(sub.args[0], local_assigns)
                    if payload is None:
                        continue
                    fn_writes = True
                    if isinstance(payload, ast.Dict):
                        inline_keys |= _const_keys(payload)
                    elif isinstance(payload, ast.Name):
                        rec_names.add(payload.id)
                if fn_writes:
                    writer_seen = True
                    keys = inline_keys | _record_keys_in_fn(
                        node, rec_names)
                    for k in keys:
                        written.setdefault(k, (relpath, node.lineno))
                if replica_files and relpath == replica_files[-1]:
                    for sub in ast.walk(node):
                        if isinstance(sub, ast.Call) and isinstance(
                                sub.func, ast.Attribute) and \
                                sub.func.attr == "_replay_records":
                            replica_calls_replay = True

    findings: List[Finding] = []
    for relpath, line in raw_writes:
        findings.append(Finding(
            check="journal-raw-write", path=relpath, line=line,
            scope="journal", detail="write",
            message=("journal write bypasses the checksummed appender — "
                     "route the record through state/integrity."
                     "seal_record so replay can tell a torn tail from "
                     "mid-file corruption (docs/ROBUSTNESS.md WAL v2)")))
    if not writer_seen:
        return findings
    for kind, (relpath, line) in sorted(written.items()):
        if kind not in handled:
            findings.append(Finding(
                check="journal-record-unhandled", path=relpath,
                line=line, scope="journal", detail=kind,
                message=(f"journal record kind '{kind}' is written but "
                         "has no handler in _apply_journal_record/"
                         "_replay_records — it would silently vanish "
                         "on replay, checkpoint re-seed, and the "
                         "read-replica tail")))
        if declared and kind not in declared:
            findings.append(Finding(
                check="journal-record-undeclared", path=relpath,
                line=line, scope="journal", detail=kind,
                message=(f"journal record kind '{kind}' is missing "
                         f"from {_KIND_TABLE} — declare its replay + "
                         "checkpoint semantics in the registry "
                         "(state/store.py)")))
    for kind, (relpath, line) in sorted(declared.items()):
        if kind not in written:
            findings.append(Finding(
                check="journal-record-stale", path=relpath, line=line,
                scope="journal", detail=kind,
                message=(f"{_KIND_TABLE} declares record kind "
                         f"'{kind}' but no journal writer emits it — "
                         "remove the stale registry entry")))
    for relpath in replica_files:
        if not replica_calls_replay:
            findings.append(Finding(
                check="journal-record-tail", path=relpath, line=1,
                scope="read_replica", detail="_replay_records",
                message=("the read-replica tail does not route records "
                         "through Store._replay_records — record "
                         "kinds and the epoch-fence skip rule would "
                         "drift from the leader's replay")))
    return findings


# ---------------------------------------------------------------------------
# the one-call bundle the engine uses
# ---------------------------------------------------------------------------

@dataclass
class InterprocResult:
    findings: List[Finding]
    edges: Dict[Tuple[str, str], LockEdge]
    stats: Dict[str, Any]


def run_interprocedural(package_root: Path,
                        trees: Dict[str, ast.Module]) -> InterprocResult:
    cg = build_callgraph(package_root, trees)
    s = compute_summaries(cg)
    ranks, allowed = load_lock_contract(trees)
    edges = compute_lock_edges(cg, s)
    findings: List[Finding] = []
    findings += transitive_blocking_findings(cg, s, allowed)
    findings += contract_findings(cg)
    findings += lock_order_findings(edges, ranks)
    findings += journal_record_findings(trees)
    stats = cg.stats()
    stats["fixpoint_iterations"] = s.iterations
    stats["static_lock_edges"] = len(edges)
    return InterprocResult(findings=findings, edges=edges, stats=stats)


# ---------------------------------------------------------------------------
# static edge export for /debug/health (lazy, cached, computed once)
# ---------------------------------------------------------------------------

_EDGE_CACHE: Dict[str, Any] = {"edges": None, "error": None,
                               "started": False}
_EDGE_MU = threading.Lock()
_EDGE_DONE = threading.Event()


def _compute_static_edges() -> List[str]:
    package_root = Path(__file__).resolve().parent.parent
    trees: Dict[str, ast.Module] = {}
    for path in sorted(package_root.rglob("*.py")):
        if "__pycache__" in path.parts:
            continue
        rel = path.relative_to(package_root).as_posix()
        try:
            trees[rel] = ast.parse(path.read_text(encoding="utf-8"))
        except (OSError, SyntaxError):
            continue
    cg = build_callgraph(package_root, trees)
    s = compute_summaries(cg)
    edges = compute_lock_edges(cg, s)
    return sorted({f"{a}->{b}" for (a, b) in edges})


def _run_edge_compute() -> None:
    try:
        got = _compute_static_edges()
        with _EDGE_MU:
            _EDGE_CACHE["edges"] = got
            _EDGE_CACHE["error"] = None
    except Exception as e:  # pragma: no cover - analysis bug surface
        # a FAILED computation must stay distinguishable from "zero
        # edges": caching [] here would make every observed edge read
        # as a phantom resolution gap on /debug/health and fail the
        # tier-1 teardown with a misleading message
        with _EDGE_MU:
            _EDGE_CACHE["error"] = repr(e)
    finally:
        _EDGE_DONE.set()


def static_edge_error() -> Optional[str]:
    """repr() of the failed static-edge computation, None while
    pending or after success — the health surface renders it."""
    with _EDGE_MU:
        return _EDGE_CACHE["error"]


def static_edge_families(wait: bool = False) -> Optional[List[str]]:
    """The package's static lock-edge set, family-normalized
    (``["store.notify->store", ...]``), for the observed-vs-static
    coverage diff.  Computed ONCE per process off a background thread;
    ``wait=False`` (the health endpoint, which must never stall on a
    ~1 s source scan) returns None until the result lands;
    ``wait=True`` (tests, the tier-1 teardown) joins the in-flight
    computation — never a duplicate run — and RAISES if it failed."""
    start = False
    with _EDGE_MU:
        if _EDGE_CACHE["edges"] is not None:
            return list(_EDGE_CACHE["edges"])
        if not _EDGE_CACHE["started"]:
            _EDGE_CACHE["started"] = True
            start = True
    if start:
        threading.Thread(target=_run_edge_compute, daemon=True,
                         name="cook-static-edges").start()
    if not wait:
        return None
    _EDGE_DONE.wait()
    with _EDGE_MU:
        if _EDGE_CACHE["edges"] is not None:
            return list(_EDGE_CACHE["edges"])
        raise RuntimeError("static lock-edge computation failed: "
                           f"{_EDGE_CACHE['error']}")
