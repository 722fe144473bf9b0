"""The port's copy of ``cook_tpu/analysis/passes.py`` (the registry
message names the scanned package).

Repo-specific AST lint passes (see package doc and docs/ANALYSIS.md).

Each pass is a callable ``(path, relpath, tree, src_lines) -> [Finding]``
registered in :data:`PASSES`.  Findings carry a line-independent
fingerprint (check:file:scope:detail) so the baseline survives edits
above the flagged site.
"""

from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .engine import Finding

# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------

#: attribute names treated as mutexes when they appear in a `with` item
LOCK_ATTRS = {"_lock", "_mu", "_notify_lock"}

#: dotted-call substrings that BLOCK (syscall/RPC/sleep) — finding one
#: inside a lock-held region is the lock-discipline violation.  Condition
#: waits (`_cv.wait`) are excluded: they release their lock while waiting.
BLOCKING_CALLS: Tuple[Tuple[str, str], ...] = (
    # (match substring of the dotted call name, canonical op label)
    ("os.fsync", "os.fsync"),
    ("time.sleep", "time.sleep"),
    ("write_atomic_text", "fsatomic.fsync"),   # fsyncs internally
    ("write_atomic_int", "fsatomic.fsync"),
    ("wait_acked", "repl.wait_acked"),         # bounded native wait
    ("socket.create_connection", "socket"),
    (".connect", "socket"),
    (".sendall", "socket"),
    (".recv", "socket"),
    (".accept", "socket"),
    ("urlopen", "http"),
    ("getresponse", "http"),
    ("subprocess.", "subprocess"),
)

#: wall-clock / RNG calls that must not appear inside jitted bodies
#: (kernel results must be pure functions of their inputs)
WALLCLOCK_CALLS = ("time.time", "time.perf_counter", "time.monotonic",
                  "datetime.now", "datetime.utcnow", "random.",
                  "np.random", "uuid.uuid")


def _dotted(node: ast.AST) -> str:
    """Best-effort dotted name of a call target ('os.fsync',
    'self._repl_server.wait_acked', ...)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    elif isinstance(node, ast.Call):
        parts.append(_dotted(node.func) + "()")
    return ".".join(reversed(parts))


def _lock_name(item: ast.withitem) -> Optional[str]:
    """The lock a `with` item guards, when its context expression is a
    mutex attribute (self._lock, store._lock, self._mu, ...)."""
    expr = item.context_expr
    if isinstance(expr, ast.Attribute) and (
            expr.attr in LOCK_ATTRS or expr.attr.endswith("_lock")):
        return _dotted(expr)
    return None


class _ScopeWalker(ast.NodeVisitor):
    """Tracks the enclosing function qualname while visiting."""

    def __init__(self):
        self.scope: List[str] = []

    def qualname(self) -> str:
        return ".".join(self.scope) or "<module>"

    def visit_FunctionDef(self, node):  # noqa: N802
        self.scope.append(node.name)
        self.generic_visit(node)
        self.scope.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_ClassDef(self, node):  # noqa: N802
        self.scope.append(node.name)
        self.generic_visit(node)
        self.scope.pop()


# --------------------------------------------------------------------------
# pass 1: lock-discipline
# --------------------------------------------------------------------------

def _is_lock_scoped_fn(node: ast.FunctionDef) -> Optional[str]:
    """Functions that run with a lock HELD by contract even though no
    `with` is lexically visible: the repo idiom is a `_locked` suffix
    or a caller-holds docstring naming the lock (the `self._lock`
    idiom).  Returns the held-lock display token (the parsed name, or
    the function name for a bare suffix), None when no contract
    applies.  The docstring parser has ONE home —
    callgraph.parse_contract_lock — shared with the interprocedural
    requires_lock verifier, which also warns (`lock-contract-unnamed`)
    when the contract names no lock."""
    from .callgraph import parse_contract_lock
    doc = ast.get_docstring(node) or ""
    has_contract, token = parse_contract_lock(doc)
    if token is not None:
        return token
    if has_contract or node.name.endswith("_locked"):
        return f"<{node.name}>"
    return None


class _LockDiscipline(_ScopeWalker):
    def __init__(self, relpath: str):
        super().__init__()
        self.relpath = relpath
        self.findings: List[Finding] = []
        # stack of lock names currently lexically held
        self._held: List[str] = []

    def visit_FunctionDef(self, node):  # noqa: N802
        self.scope.append(node.name)
        contract_lock = _is_lock_scoped_fn(node)
        if contract_lock is not None:
            self._held.append(contract_lock)
            for child in node.body:
                self.visit(child)
            self._held.pop()
        else:
            # a nested def is a NEW execution context: what it does when
            # CALLED is not "under" the enclosing with-block
            held, self._held = self._held, []
            for child in node.body:
                self.visit(child)
            self._held = held
        self.scope.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node):  # noqa: N802
        held, self._held = self._held, []
        self.generic_visit(node)
        self._held = held

    def visit_With(self, node):  # noqa: N802
        # with-items evaluate IN ORDER: `with self._lock, sock.connect()`
        # runs the connect while the lock is held, and a non-lock
        # context expression (`with socket.create_connection(...)`)
        # under an outer held lock is a blocking call like any other —
        # so each item's context_expr is visited with the locks
        # acquired so far, THEN the item's own lock (if any) joins the
        # held set for the rest of the statement
        acquired = 0
        for item in node.items:
            name = _lock_name(item)
            if name is None:
                self.visit(item.context_expr)
                if item.optional_vars is not None:
                    self.visit(item.optional_vars)
            else:
                self._held.append(name)
                acquired += 1
        for child in node.body:
            self.visit(child)
        if acquired:
            del self._held[-acquired:]

    def visit_Call(self, node):  # noqa: N802
        if self._held:
            name = _dotted(node.func)
            for sub, op in BLOCKING_CALLS:
                if sub in name:
                    self.findings.append(Finding(
                        check="lock-blocking-call",
                        path=self.relpath, line=node.lineno,
                        scope=self.qualname(), detail=name,
                        message=(f"blocking call `{name}` ({op}) while "
                                 f"holding {self._held[-1]} — move it "
                                 "off the lock or baseline it with the "
                                 "design justification")))
                    break
        self.generic_visit(node)


def lock_discipline(path: Path, relpath: str, tree: ast.Module,
                    src_lines: Sequence[str]) -> List[Finding]:
    walker = _LockDiscipline(relpath)
    walker.visit(tree)
    return walker.findings


# --------------------------------------------------------------------------
# pass 2: jit-hygiene
# --------------------------------------------------------------------------

def _is_jax_jit(node: ast.AST) -> bool:
    """`jax.jit` / `pjit` / `pjit.pjit` as a call target or decorator
    head."""
    name = _dotted(node)
    return name in ("jax.jit", "jit", "pjit", "pjit.pjit", "jax.pjit")


def _partial_jit(call: ast.Call) -> bool:
    """`functools.partial(jax.jit, ...)` decorator form."""
    return (_dotted(call.func).endswith("partial") and call.args
            and _is_jax_jit(call.args[0]))


def _static_argnames(call: Optional[ast.Call]) -> Set[str]:
    out: Set[str] = set()
    if call is None:
        return out
    for kw in call.keywords:
        if kw.arg == "static_argnames" and isinstance(
                kw.value, (ast.Tuple, ast.List)):
            for elt in kw.value.elts:
                if isinstance(elt, ast.Constant):
                    out.add(str(elt.value))
        elif kw.arg == "static_argnames" and isinstance(
                kw.value, ast.Constant):
            out.add(str(kw.value.value))
    return out


class _JitBodyChecker(_ScopeWalker):
    """Checks inside ONE jitted body: host numpy, wall-clock/RNG, and
    Python branches on (non-static) traced parameters."""

    def __init__(self, relpath: str, owner: str,
                 params: Set[str], findings: List[Finding]):
        super().__init__()
        self.relpath = relpath
        self.owner = owner
        self.params = params
        self.findings = findings

    def _flag(self, check: str, node: ast.AST, detail: str,
              message: str) -> None:
        self.findings.append(Finding(
            check=check, path=self.relpath, line=node.lineno,
            scope=self.owner, detail=detail, message=message))

    def visit_Attribute(self, node):  # noqa: N802
        if isinstance(node.value, ast.Name) and node.value.id == "np":
            self._flag("jit-host-numpy", node, f"np.{node.attr}",
                       f"host numpy call `np.{node.attr}` inside jitted "
                       f"body `{self.owner}` — runs per trace, not per "
                       "call; use jnp or hoist to staging")
        self.generic_visit(node)

    def visit_Call(self, node):  # noqa: N802
        name = _dotted(node.func)
        for sub in WALLCLOCK_CALLS:
            if name.startswith(sub) or f".{sub}" in name:
                self._flag("jit-wallclock", node, name,
                           f"wall-clock/RNG call `{name}` inside jitted "
                           f"body `{self.owner}` — kernels must be pure "
                           "functions of their inputs")
                break
        self.generic_visit(node)

    def _check_test(self, node, test: ast.expr, kind: str) -> None:
        for sub in ast.walk(test):
            if isinstance(sub, ast.Name) and sub.id in self.params:
                self._flag("jit-traced-branch", node, sub.id,
                           f"Python `{kind}` on traced parameter "
                           f"`{sub.id}` inside jitted body "
                           f"`{self.owner}` — branches on traced values "
                           "fail (or silently retrace); use lax.cond / "
                           "jnp.where or mark the arg static")
                return

    def visit_If(self, node):  # noqa: N802
        self._check_test(node, node.test, "if")
        self.generic_visit(node)

    def visit_While(self, node):  # noqa: N802
        self._check_test(node, node.test, "while")
        self.generic_visit(node)


class _JitHygiene(_ScopeWalker):
    def __init__(self, relpath: str, check_bodies: bool):
        super().__init__()
        self.relpath = relpath
        self.check_bodies = check_bodies
        self.findings: List[Finding] = []
        #: names bound to a bare jit object, keyed (name, scope) so two
        #: same-named definitions in different scopes never collide
        self.jit_names: Dict[Tuple[str, str], int] = {}
        #: names passed through instrument_jit(...) — the later-rebinding
        #: idiom (`kernel = instrument_jit("k", kernel)`) is module-level,
        #: so it only vouches for MODULE-scope definitions; nested/class
        #: scopes must instrument inline
        self.instrumented: Set[str] = set()
        self._instrument_depth = 0

    # -- collection --------------------------------------------------------
    def visit_FunctionDef(self, node):  # noqa: N802
        jit_call: Optional[ast.Call] = None
        jitted = False
        for dec in node.decorator_list:
            if _is_jax_jit(dec):
                jitted = True
            elif isinstance(dec, ast.Call) and (_is_jax_jit(dec.func)
                                                or _partial_jit(dec)):
                jitted = True
                jit_call = dec
        if jitted:
            self.jit_names[(node.name, self.qualname())] = node.lineno
            if self.check_bodies:
                statics = _static_argnames(jit_call)
                params = {a.arg for a in node.args.args
                          + node.args.kwonlyargs} - statics - {"self"}
                checker = _JitBodyChecker(
                    self.relpath, node.name, params, self.findings)
                for child in node.body:
                    checker.visit(child)
        self.scope.append(node.name)
        self.generic_visit(node)
        self.scope.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Call(self, node):  # noqa: N802
        name = _dotted(node.func)
        if name.endswith("instrument_jit"):
            for arg in node.args:
                if isinstance(arg, ast.Name):
                    self.instrumented.add(arg.id)
            self._instrument_depth += 1
            self.generic_visit(node)
            self._instrument_depth -= 1
            return
        if _is_jax_jit(node.func) and node.args:
            if self._instrument_depth == 0:
                # bare jax.jit(...) call: OK only if its bound name is
                # instrumented later in this module
                target = self._assign_target(node)
                if target is None:
                    self.findings.append(Finding(
                        check="jit-uninstrumented", path=self.relpath,
                        line=node.lineno, scope=self.qualname(),
                        detail=_dotted(node.args[0]) or "<expr>",
                        message=("`jax.jit` site not wrapped in "
                                 "ops.telemetry.instrument_jit — its "
                                 "recompiles are invisible to "
                                 "cook_jit_compile_total and the flight "
                                 "recorder")))
                else:
                    self.jit_names[(target, self.qualname())] = \
                        node.lineno
            if self.check_bodies and isinstance(node.args[0], ast.Lambda):
                lam = node.args[0]
                statics = _static_argnames(node)
                params = {a.arg for a in lam.args.args} - statics
                checker = _JitBodyChecker(
                    self.relpath, self.qualname() + ".<lambda>", params,
                    self.findings)
                checker.visit(lam.body)
        self.generic_visit(node)

    def _assign_target(self, call: ast.Call) -> Optional[str]:
        parent = getattr(call, "_parent", None)
        if isinstance(parent, ast.Assign) and len(parent.targets) == 1 \
                and isinstance(parent.targets[0], ast.Name):
            return parent.targets[0].id
        return None


def jit_hygiene(path: Path, relpath: str, tree: ast.Module,
                src_lines: Sequence[str]) -> List[Finding]:
    # parent links for the assign-target lookup
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            child._parent = node  # type: ignore[attr-defined]
    # body checks apply to kernel code: ops/ and the fused cycle
    check_bodies = relpath.startswith("ops/") or relpath in (
        "sched/fused.py",)
    walker = _JitHygiene(relpath, check_bodies)
    walker.visit(tree)
    for (name, scope), line in walker.jit_names.items():
        if name not in walker.instrumented or scope != "<module>":
            walker.findings.append(Finding(
                check="jit-uninstrumented", path=relpath, line=line,
                scope=scope, detail=name,
                message=(f"jitted callable `{name}` is never wrapped in "
                         "ops.telemetry.instrument_jit — its recompiles "
                         "are invisible to cook_jit_compile_total and "
                         "the flight recorder")))
    return walker.findings


# --------------------------------------------------------------------------
# pass 3: registry-completeness (docs diff; module-level, not per-file)
# --------------------------------------------------------------------------

def registry_completeness(package_root: Path,
                          docs_root: Optional[Path]) -> List[Finding]:
    from . import registry as _registry
    if docs_root is None or not Path(docs_root).exists():
        return []
    doc_for = {"metric": "docs/OBSERVABILITY.md",
               "span": "docs/OBSERVABILITY.md",
               "cycle-field": "docs/OBSERVABILITY.md",
               "fault-point": "docs/ROBUSTNESS.md",
               "endpoint": "docs/OBSERVABILITY.md"}
    findings: List[Finding] = []
    for surface, missing in _registry.diff_registries(
            package_root, docs_root).items():
        for name in sorted(missing):
            findings.append(Finding(
                check=f"registry-{surface}", path=doc_for[surface],
                line=1, scope=surface, detail=name,
                message=(f"{surface} `{name}` is used in "
                         f"{Path(package_root).name}/ but "
                         f"not registered in {doc_for[surface]}")))
    return findings


# --------------------------------------------------------------------------
# pass: pallas module-level jnp constants (the capture pitfall)
# --------------------------------------------------------------------------

def _expr_uses_jnp(node: ast.AST) -> bool:
    """True when an expression references jnp / jax.numpy (an array
    BUILT at import time)."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name) and sub.id == "jnp":
            return True
        if isinstance(sub, ast.Attribute):
            d = _dotted(sub)
            if d.startswith("jnp.") or d.startswith("jax.numpy."):
                return True
    return False


def pallas_module_constants(path: Path, relpath: str, tree: ast.Module,
                           src_lines: Sequence[str]) -> List[Finding]:
    """No module-level ``jnp`` constants in ``ops/pallas_*.py``: a jnp
    array built at import time is CAPTURED by every pallas kernel that
    references it — it pins a device buffer for the process lifetime,
    breaks interpret/compiled parity across backends, and (on TPU) is
    constant-folded into the Mosaic binary where a python literal would
    have stayed a scalar.  ops/pallas_match.py documents the pitfall by
    hand (`_BIG = 2**31 - 1  # python literal ...`); this pass enforces
    it for every pallas module (ISSUE 14 satellite)."""
    name = Path(relpath).name
    if not (relpath.startswith("ops/") and name.startswith("pallas_")
            and name.endswith(".py")):
        return []
    findings: List[Finding] = []
    for node in tree.body:  # module level ONLY: function bodies trace
        targets: List[ast.expr] = []
        value: Optional[ast.AST] = None
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets, value = [node.target], node.value
        if value is None or not _expr_uses_jnp(value):
            continue
        tnames = ", ".join(
            t.id for t in targets if isinstance(t, ast.Name)) or "<target>"
        findings.append(Finding(
            check="pallas-module-constant", path=relpath,
            line=node.lineno, scope="<module>", detail=tnames,
            message=(f"module-level jnp constant `{tnames}` in a pallas "
                     "module: import-time jnp arrays are captured by "
                     "every kernel trace (device-buffer pin, "
                     "interpret/compiled drift) — use a python literal "
                     "and build arrays inside the kernel/entry point")))
    return findings


# --------------------------------------------------------------------------
# pass: partition isolation (the multi-controller ownership boundary)
# --------------------------------------------------------------------------

#: modules allowed to index/iterate sibling partition stores: the
#: PartitionedStore / UserSummaryExchange facade itself
PARTITION_FACADE_FILES = ("state/partition.py",)


class _PartitionIsolation(_ScopeWalker):
    def __init__(self, relpath: str):
        super().__init__()
        self.relpath = relpath
        self.findings: List[Finding] = []

    def _is_partitions_attr(self, node: ast.AST) -> bool:
        return (isinstance(node, ast.Attribute)
                and node.attr == "partitions")

    def _iter_target(self, it: ast.AST) -> Optional[ast.AST]:
        """The `.partitions` attribute an iteration walks, unwrapping
        enumerate()/reversed()/list()."""
        if self._is_partitions_attr(it):
            return it
        if isinstance(it, ast.Call) and isinstance(it.func, ast.Name) \
                and it.func.id in ("enumerate", "reversed", "list",
                                   "tuple", "sorted"):
            for arg in it.args:
                if self._is_partitions_attr(arg):
                    return arg
        return None

    def _flag(self, node: ast.AST, attr: ast.AST, how: str) -> None:
        owner = _dotted(attr.value) or "<expr>"  # type: ignore[attr-defined]
        self.findings.append(Finding(
            check="partition-isolation", path=self.relpath,
            line=node.lineno, scope=self.qualname(),
            detail=f"{owner}.partitions",
            message=(f"direct cross-partition store access "
                     f"(`{owner}.partitions` {how}): one shard process "
                     "owns one partition's write plane — sibling state "
                     "crosses only via UserSummaryExchange / the "
                     "PartitionedStore facade (state/partition.py)")))

    def visit_Subscript(self, node):  # noqa: N802
        if self._is_partitions_attr(node.value):
            self._flag(node, node.value, "subscript")
        self.generic_visit(node)

    def visit_For(self, node):  # noqa: N802
        attr = self._iter_target(node.iter)
        if attr is not None:
            self._flag(node, attr, "iteration")
        self.generic_visit(node)

    visit_AsyncFor = visit_For

    def visit_comprehension(self, node):  # noqa: N802
        attr = self._iter_target(node.iter)
        if attr is not None:
            self._flag(node.iter, attr, "iteration")
        self.generic_visit(node)


def partition_isolation(path: Path, relpath: str, tree: ast.Module,
                        src_lines: Sequence[str]) -> List[Finding]:
    """Forbid reaching THROUGH the partition boundary: subscripting or
    iterating a ``.partitions`` store list anywhere outside the
    state/partition.py facade.  In the multi-controller deployment each
    partition's Store lives in a different PROCESS — code that indexes a
    sibling partition's store only works single-process and silently
    breaks the scale-out contract (cross-pool reads must ride the
    bounded UserSummaryExchange; routed writes go through
    PartitionedStore).  Reading a ``PartitionConfig.partitions`` field
    is fine — only indexing/iterating the store list is flagged."""
    if relpath in PARTITION_FACADE_FILES:
        return []
    walker = _PartitionIsolation(relpath)
    walker.visit(tree)
    return walker.findings


#: the per-file passes, in run order
PASSES = (
    ("lock-discipline", lock_discipline),
    ("jit-hygiene", jit_hygiene),
    ("pallas-module-constant", pallas_module_constants),
    ("partition-isolation", partition_isolation),
)
