"""The port's copy of ``cook_tpu/analysis/callgraph.py`` (source read as ASTs;
it imports nothing that it scans).

Whole-repo call graph for the interprocedural effect analysis.

The per-function lint passes (passes.py) are LEXICAL: they see only the
statements written inside one ``with self._lock`` block and must trust
the ``_locked``-suffix / "caller holds" convention.  This module builds
the call graph those passes lack, in the compositional style RacerD
(Blackshear et al., OOPSLA'18) showed scales to exactly this shape of
codebase: parse every module once, resolve calls bottom-up, and let the
summary fixpoint (summaries.py) propagate effects over the edges.

Resolution tiers, most to least precise:

``direct``
    module-level functions and imported symbols by name, class
    constructors (→ ``__init__``), ``Class.method`` classmethod form.
``self``
    ``self.m(...)`` dispatched against the enclosing class and its
    repo-known base chain.
``typed``
    ``x.m(...)`` where ``x``'s class is known — from a parameter
    annotation, a local ``x = ClassName(...)`` / ``x = self.attr``
    assignment, or a ``self.attr = ClassName(...)`` /
    ``self.attr: ClassName`` binding harvested class-wide.
``unique``
    bounded dynamic dispatch: an attribute call whose method name is
    defined by exactly ONE repo class (and is not a common stdlib-ish
    name) resolves there.
``dynamic``
    everything else that could still be repo code — callback variables
    being called (``sub(tx_id, events)``), attribute calls whose name
    matches two or more repo classes.  These land in the explicit
    **unresolved bucket** reported as coverage; the lock-edge analysis
    over-approximates them against the *escaping set* (every function
    whose reference is ever taken as a value), and the blocking
    analysis deliberately ignores them (a may-block guess through an
    unresolved callback would drown the report in noise — the dynamic
    sanitizer owns that residue).

Lock identity: attributes assigned ``named_lock("store")`` /
``named_rlock(...)`` / ``NamedLock(...)`` resolve to their declared
name (an f-string / ``"store" + sfx`` suffix keeps the literal prefix,
i.e. the rank FAMILY); plain ``threading.Lock()``-style mutex
attributes get a pseudo name ``~Class.attr`` — they participate in
blocking and contract checks but not in the named lock-order graph.
"""

from __future__ import annotations

import ast
import builtins
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional, Set, Tuple

_BUILTIN_NAMES = frozenset(dir(builtins))

#: attribute names treated as mutexes (shared with passes.py's lexical
#: pass — keep in sync)
LOCK_ATTRS = {"_lock", "_mu", "_notify_lock"}

#: method names too common to trust the unique-definition fallback on:
#: resolving `.get()` to the one repo class defining `get` would wire
#: half the codebase to it
COMMON_METHOD_NAMES = frozenset({
    "get", "put", "set", "add", "pop", "append", "extend", "items",
    "keys", "values", "update", "copy", "clear", "close", "open",
    "start", "stop", "run", "send", "recv", "read", "write", "join",
    "count", "index", "sort", "split", "strip", "encode", "decode",
    "wait", "notify", "notify_all", "acquire", "release", "submit",
    "flush", "load", "loads", "dump", "dumps", "format", "group",
    "match", "search", "findall", "sub", "info", "debug", "warning",
    "error", "exception", "exists", "mkdir", "name", "next", "reset",
    "snapshot", "poll", "fire", "step", "to_doc", "tell", "seek",
})

#: "caller holds <lock>" docstring parser (the repo contract idiom).
#: Accepts ``caller holds _lock`` / ``caller holds self._lock`` /
#: ``caller holds ``self._lock``⁠`` / ``caller holds the store lock``.
CONTRACT_RE = re.compile(
    r"caller holds\s+(?:the\s+)?`*(?:self\.)?"
    r"(?:(?P<attr>_[A-Za-z0-9_]+|[A-Za-z]\w*_lock|[A-Za-z]\w*_mu)"
    r"|(?P<named>[A-Za-z][\w.\[\]]*)`*\s+lock)", re.IGNORECASE)


def family(name: str) -> str:
    """Rank family of a lock name (utils/locks.py): the base with any
    bracketed per-instance suffix stripped (``store[p2]`` → ``store``)."""
    return name.split("[", 1)[0]


def parse_contract_lock(doc: str) -> Tuple[bool, Optional[str]]:
    """(has_caller_holds_contract, lock token or None).

    The token is the raw docstring form: an attribute (``_lock``,
    ``_mat_lock``) or a named-lock word from the "the X lock" phrasing
    (``store``).  ``(True, None)`` = the contract names no lock — the
    lexical pass warns (``lock-contract-unnamed``) and the
    interprocedural verifier has nothing to verify."""
    low = (doc or "").lower()
    if "caller holds" not in low:
        return False, None
    m = CONTRACT_RE.search(doc or "")
    if m is None:
        return True, None
    attr = m.group("attr")
    if attr:
        return True, attr
    named = m.group("named")
    # "caller holds the lock" backtracks into matching the article
    # itself as the name — an unnamed contract, not a lock called "the"
    if named and named.lower() in ("the", "a", "an", "its", "this",
                                   "that", "own", "same"):
        return True, None
    return True, named


@dataclass
class LockRef:
    """A resolved lock identity at a use site."""
    name: str          #: family name ("store") or pseudo "~Class.attr"
    named: bool        #: True when created via named_lock/NamedLock

    @property
    def attr_tail(self) -> str:
        return self.name.rsplit(".", 1)[-1]


@dataclass
class CallSite:
    callee: str                 #: resolved function id
    line: int
    kind: str                   #: direct|self|typed|unique|ctor
    held: Tuple[str, ...]       #: lock names held lexically at the site


@dataclass
class DynamicSite:
    """An unresolved call (callback variable / ambiguous dispatch).

    ``candidates`` bounds the dispatch when the method name narrows it
    (every repo method of that name) — the edge over-approximation
    uses it instead of the whole escaping set.  ``counted=False``
    marks common-name attribute calls (``.get()``, ``.poll()``) that
    are kept OUT of the coverage denominator (they would drown the
    signal) but still contribute bounded edges, so the static edge set
    stays a superset of anything runtime can observe."""
    name: str
    line: int
    held: Tuple[str, ...]
    candidates: Tuple[str, ...] = ()
    counted: bool = True


@dataclass
class FuncInfo:
    fid: str
    module: str
    relpath: str
    cls: Optional[str]          #: class id ("state.store.Store") or None
    name: str
    qualscope: str              #: file-local qualname ("Store.transact")
    line: int
    calls: List[CallSite] = field(default_factory=list)
    dynamic_calls: List[DynamicSite] = field(default_factory=list)
    external_calls: int = 0
    #: direct blocking ops: (op label, dotted call, line, held locks)
    blocks: List[Tuple[str, str, int, Tuple[str, ...]]] = \
        field(default_factory=list)
    #: direct lock acquisitions: (LockRef, line, held-at-acquisition)
    acquires: List[Tuple[LockRef, int, Tuple[str, ...]]] = \
        field(default_factory=list)
    spawns_thread: bool = False
    #: lock this function runs under BY CONTRACT (``_locked`` suffix /
    #: "caller holds" docstring), resolved to a LockRef
    requires_lock: Optional[LockRef] = None
    requires_source: Optional[str] = None   #: "suffix" | "docstring"
    #: contract present but no lock nameable (warned by the verifier)
    contract_unnamed: bool = False


@dataclass
class ClassInfo:
    cid: str
    module: str
    name: str
    base_names: List[str] = field(default_factory=list)
    bases: List[str] = field(default_factory=list)      #: resolved cids
    methods: Dict[str, str] = field(default_factory=dict)  #: name -> fid
    attr_types: Dict[str, str] = field(default_factory=dict)
    lock_attrs: Dict[str, LockRef] = field(default_factory=dict)


@dataclass
class ModuleInfo:
    module: str
    relpath: str
    tree: ast.Module
    #: name -> ("func", fid) | ("class", cid) | ("module", modname)
    symbols: Dict[str, Tuple[str, str]] = field(default_factory=dict)
    constants: Dict[str, Any] = field(default_factory=dict)


@dataclass
class CallGraph:
    package: str
    functions: Dict[str, FuncInfo] = field(default_factory=dict)
    classes: Dict[str, ClassInfo] = field(default_factory=dict)
    modules: Dict[str, ModuleInfo] = field(default_factory=dict)
    #: function ids whose reference escapes as a VALUE (callback
    #: registration, thread target, stored handler) — the bounded
    #: over-approximation target for dynamic call sites
    escaping: Set[str] = field(default_factory=set)
    #: method name -> cids defining it (dispatch fallback index)
    method_index: Dict[str, List[str]] = field(default_factory=dict)

    # ------------------------------------------------------------ lookups
    def resolve_method(self, cid: str, name: str,
                       _seen: Optional[Set[str]] = None) -> Optional[str]:
        """Method lookup through the repo-known base chain."""
        seen = _seen or set()
        while cid and cid not in seen:
            seen.add(cid)
            ci = self.classes.get(cid)
            if ci is None:
                return None
            fid = ci.methods.get(name)
            if fid is not None:
                return fid
            for base in ci.bases:
                got = self.resolve_method(base, name, seen)
                if got is not None:
                    return got
            return None
        return None

    def class_lock(self, cid: str, attr: str) -> Optional[LockRef]:
        seen: Set[str] = set()
        stack = [cid]
        while stack:
            c = stack.pop()
            if c in seen:
                continue
            seen.add(c)
            ci = self.classes.get(c)
            if ci is None:
                continue
            ref = ci.lock_attrs.get(attr)
            if ref is not None:
                return ref
            stack.extend(ci.bases)
        return None

    def class_attr_type(self, cid: str, attr: str) -> Optional[str]:
        seen: Set[str] = set()
        stack = [cid]
        while stack:
            c = stack.pop()
            if c in seen:
                continue
            seen.add(c)
            ci = self.classes.get(c)
            if ci is None:
                continue
            t = ci.attr_types.get(attr)
            if t is not None:
                return t
            stack.extend(ci.bases)
        return None

    def stats(self) -> Dict[str, Any]:
        resolved = sum(len(f.calls) for f in self.functions.values())
        dynamic = sum(1 for f in self.functions.values()
                      for ds in f.dynamic_calls if ds.counted)
        external = sum(f.external_calls for f in self.functions.values())
        total = resolved + dynamic
        return {
            "functions": len(self.functions),
            "classes": len(self.classes),
            "modules": len(self.modules),
            "calls_resolved": resolved,
            "calls_unresolved": dynamic,
            "calls_external": external,
            "escaping_functions": len(self.escaping),
            "resolution_coverage": round(resolved / total, 4)
            if total else 1.0,
        }


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _dotted(node: ast.AST) -> str:
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    elif isinstance(node, ast.Call):
        parts.append(_dotted(node.func) + "()")
    return ".".join(reversed(parts))


def _str_prefix(node: ast.AST) -> Optional[Tuple[str, bool]]:
    """Best-effort ``(literal, exact)`` of a string expression: a
    constant (exact), or the constant head of an f-string /
    ``"a" + x`` (a prefix).  This is how ``named_rlock("store" +
    _sfx)`` / ``f"store[p{i}]"`` resolve to their rank FAMILY while an
    exact ``"store[p0]"`` literal keeps its sibling-distinguishing
    suffix."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value, True
    if isinstance(node, ast.JoinedStr):
        if node.values and isinstance(node.values[0], ast.Constant):
            return str(node.values[0].value), len(node.values) == 1
        return None
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        got = _str_prefix(node.left)
        return (got[0], False) if got else None
    return None


_LOCK_CTORS = ("named_lock", "named_rlock", "NamedLock", "NamedRLock")
_PLAIN_LOCK_CTORS = ("Lock", "RLock")


def _lock_from_ctor(call: ast.Call, consts: Dict[str, Any],
                    owner: str, attr: str) -> Optional[LockRef]:
    """LockRef when ``call`` constructs a mutex, else None."""
    head = _dotted(call.func).rsplit(".", 1)[-1]
    if head in _LOCK_CTORS:
        name = None
        if call.args:
            got = _str_prefix(call.args[0])
            if got is not None:
                # an exact literal keeps its suffix (sibling checks);
                # a computed suffix collapses to the rank family
                name = got[0] if got[1] else family(got[0])
            elif isinstance(call.args[0], ast.Name):
                const = consts.get(call.args[0].id)
                if isinstance(const, str):
                    name = const
        if name is not None:
            return LockRef(name=name, named=True)
        return LockRef(name=f"~{owner}.{attr}", named=False)
    if head in _PLAIN_LOCK_CTORS:
        return LockRef(name=f"~{owner}.{attr}", named=False)
    return None


def _module_name(relpath: str) -> str:
    mod = relpath[:-3] if relpath.endswith(".py") else relpath
    mod = mod.replace("/", ".")
    if mod.endswith(".__init__"):
        mod = mod[: -len(".__init__")]
    return mod


# ---------------------------------------------------------------------------
# phase 1: modules, classes, symbols
# ---------------------------------------------------------------------------

def _collect_module(cg: CallGraph, relpath: str,
                    tree: ast.Module) -> None:
    module = _module_name(relpath)
    mi = ModuleInfo(module=module, relpath=relpath, tree=tree)
    cg.modules[module] = mi
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and isinstance(node.value, ast.Constant):
            mi.constants[node.targets[0].id] = node.value.value
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            fid = f"{module}.{node.name}"
            mi.symbols[node.name] = ("func", fid)
            cg.functions[fid] = FuncInfo(
                fid=fid, module=module, relpath=relpath, cls=None,
                name=node.name, qualscope=node.name, line=node.lineno)
        elif isinstance(node, ast.ClassDef):
            cid = f"{module}.{node.name}"
            mi.symbols[node.name] = ("class", cid)
            ci = ClassInfo(cid=cid, module=module, name=node.name,
                           base_names=[_dotted(b) for b in node.bases])
            cg.classes[cid] = ci
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef,
                                    ast.AsyncFunctionDef)):
                    fid = f"{cid}.{sub.name}"
                    ci.methods[sub.name] = fid
                    cg.functions[fid] = FuncInfo(
                        fid=fid, module=module, relpath=relpath,
                        cls=cid, name=sub.name,
                        qualscope=f"{node.name}.{sub.name}",
                        line=sub.lineno)


def _resolve_imports(cg: CallGraph) -> None:
    pkg = cg.package
    for mi in cg.modules.values():
        parts = mi.module.split(".") if mi.module else []
        is_pkg = mi.relpath.endswith("__init__.py")
        # the package a relative import anchors at: the module itself
        # for a package __init__, its parent otherwise
        pkg_parts = parts if is_pkg else parts[:-1]
        for node in ast.walk(mi.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    target = alias.name
                    if target == pkg or target.startswith(pkg + "."):
                        target = target[len(pkg):].lstrip(".")
                    bound = alias.asname or alias.name.split(".")[0]
                    if target in cg.modules:
                        mi.symbols[bound] = ("module", target)
                    else:
                        mi.symbols.setdefault(
                            bound, ("external", alias.name))
            elif isinstance(node, ast.ImportFrom):
                if node.level:
                    anchor = pkg_parts[: len(pkg_parts)
                                       - (node.level - 1)] \
                        if node.level - 1 <= len(pkg_parts) else []
                    base = ".".join(
                        anchor + ([p for p in
                                   (node.module or "").split(".") if p]))
                else:
                    base = node.module or ""
                    if base == pkg:
                        base = ""
                    elif base.startswith(pkg + "."):
                        base = base[len(pkg) + 1:]
                for alias in node.names:
                    bound = alias.asname or alias.name
                    sub = f"{base}.{alias.name}" if base else alias.name
                    src = cg.modules.get(base)
                    if src is not None and alias.name in src.symbols:
                        mi.symbols[bound] = src.symbols[alias.name]
                    elif sub in cg.modules:
                        mi.symbols[bound] = ("module", sub)
                    else:
                        mi.symbols.setdefault(
                            bound, ("external",
                                    f"{node.module or '.'}."
                                    f"{alias.name}"))

def _link_classes(cg: CallGraph) -> None:
    # class base linkage (after symbols settle)
    for ci in cg.classes.values():
        mi = cg.modules[ci.module]
        for bname in ci.base_names:
            head = bname.split(".", 1)[0]
            sym = mi.symbols.get(head)
            if sym and sym[0] == "class":
                ci.bases.append(sym[1])
            elif sym and sym[0] == "module" and "." in bname:
                tail = bname.split(".", 1)[1]
                src = cg.modules.get(sym[1])
                if src:
                    s2 = src.symbols.get(tail)
                    if s2 and s2[0] == "class":
                        ci.bases.append(s2[1])
            elif bname in [c.name for c in cg.classes.values()
                           if c.module == ci.module]:
                ci.bases.append(f"{ci.module}.{bname}")
    for ci in cg.classes.values():
        for mname in ci.methods:
            cg.method_index.setdefault(mname, []).append(ci.cid)


# ---------------------------------------------------------------------------
# phase 2: class attribute types + lock attrs
# ---------------------------------------------------------------------------

def _class_symbol(mi: ModuleInfo, cg: CallGraph,
                  node: ast.AST) -> Optional[str]:
    """cid when ``node`` names a repo class (Name or module.Attr)."""
    if isinstance(node, ast.Name):
        sym = mi.symbols.get(node.id)
        if sym and sym[0] == "class":
            return sym[1]
    elif isinstance(node, ast.Attribute) and isinstance(
            node.value, ast.Name):
        sym = mi.symbols.get(node.value.id)
        if sym and sym[0] == "module":
            src = cg.modules.get(sym[1])
            if src:
                s2 = src.symbols.get(node.attr)
                if s2 and s2[0] == "class":
                    return s2[1]
    return None


def _collect_class_attrs(cg: CallGraph) -> None:
    for ci in cg.classes.values():
        mi = cg.modules[ci.module]
        cls_node = None
        for node in mi.tree.body:
            if isinstance(node, ast.ClassDef) and node.name == ci.name:
                cls_node = node
                break
        if cls_node is None:
            continue
        for node in ast.walk(cls_node):
            target = value = None
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                target, value = node.targets[0], node.value
            elif isinstance(node, ast.AnnAssign):
                target, value = node.target, node.value
            if not (isinstance(target, ast.Attribute)
                    and isinstance(target.value, ast.Name)
                    and target.value.id == "self"):
                continue
            attr = target.attr
            if isinstance(value, ast.Call):
                ref = _lock_from_ctor(value, mi.constants,
                                      ci.name, attr)
                if ref is not None:
                    ci.lock_attrs.setdefault(attr, ref)
                    continue
                cid = _class_symbol(mi, cg, value.func)
                if cid is not None:
                    ci.attr_types.setdefault(attr, cid)
                    continue
            if isinstance(node, ast.AnnAssign):
                cid = _class_symbol(mi, cg, node.annotation)
                if cid is not None:
                    ci.attr_types.setdefault(attr, cid)


# ---------------------------------------------------------------------------
# phase 3: per-function body walk
# ---------------------------------------------------------------------------

#: imported lazily to avoid a cycle at module import time
def _blocking_table():
    from .passes import BLOCKING_CALLS
    return BLOCKING_CALLS


class _BodyWalker(ast.NodeVisitor):
    """One function body: calls (with held-lock sets), lock regions
    (``with`` items and manual ``.acquire()``), blocking ops, escaping
    references, thread spawns."""

    def __init__(self, cg: CallGraph, fi: FuncInfo,
                 params: Dict[str, str]):
        self.cg = cg
        self.fi = fi
        self.mi = cg.modules[fi.module]
        self.locals: Dict[str, str] = dict(params)  #: var -> cid
        self.held: List[str] = []
        if fi.requires_lock is not None:
            self.held.append(fi.requires_lock.name)
        self._blocking = _blocking_table()

    # ---------------------------------------------------------- type env
    def _type_of(self, node: ast.AST) -> Optional[str]:
        if isinstance(node, ast.Name):
            if node.id == "self" and self.fi.cls:
                return self.fi.cls
            return self.locals.get(node.id)
        if isinstance(node, ast.Attribute):
            base = self._type_of(node.value)
            if base is not None:
                return self.cg.class_attr_type(base, node.attr)
        if isinstance(node, ast.Call):
            cid = _class_symbol(self.mi, self.cg, node.func)
            return cid
        return None

    def _lock_of(self, node: ast.AST) -> Optional[LockRef]:
        """LockRef when ``node`` is a mutex expression."""
        if isinstance(node, ast.Attribute):
            attr = node.attr
            owner = self._type_of(node.value)
            if owner is not None:
                ref = self.cg.class_lock(owner, attr)
                if ref is not None:
                    return ref
            if attr in LOCK_ATTRS or attr.endswith("_lock"):
                oname = (self.cg.classes[owner].name
                         if owner in self.cg.classes else "*")
                return LockRef(name=f"~{oname}.{attr}", named=False)
        elif isinstance(node, ast.Name):
            # a local alias of a lock is rare; only typed attrs resolve
            pass
        return None

    # --------------------------------------------------------- assignment
    def visit_Assign(self, node):  # noqa: N802
        t = self._type_of(node.value)
        if t is not None:
            for target in node.targets:
                if isinstance(target, ast.Name):
                    self.locals[target.id] = t
        self.generic_visit(node)

    def visit_AnnAssign(self, node):  # noqa: N802
        if isinstance(node.target, ast.Name):
            cid = _class_symbol(self.mi, self.cg, node.annotation)
            if cid is not None:
                self.locals[node.target.id] = cid
        self.generic_visit(node)

    # ------------------------------------------------------------ regions
    def visit_With(self, node):  # noqa: N802
        acquired = 0
        for item in node.items:
            ref = self._lock_of(item.context_expr)
            if ref is None:
                self.visit(item.context_expr)
                if item.optional_vars is not None:
                    self.visit(item.optional_vars)
            else:
                self.fi.acquires.append(
                    (ref, item.context_expr.lineno, tuple(self.held)))
                self.held.append(ref.name)
                acquired += 1
        for child in node.body:
            self.visit(child)
        if acquired:
            del self.held[-acquired:]

    visit_AsyncWith = visit_With

    # a nested def / lambda is a NEW execution context: it is analyzed
    # as its own function node; do not descend here
    def visit_FunctionDef(self, node):  # noqa: N802
        pass

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node):  # noqa: N802
        pass

    # -------------------------------------------------------------- calls
    def visit_Call(self, node):  # noqa: N802
        name = _dotted(node.func)
        held = tuple(self.held)
        # manual lock acquisition: `self._notify_lock.acquire(...)` /
        # `cluster.kill_lock.acquire_read()` holds the lock from here
        # on; the matching `.release*()` (the try/finally idiom) ends
        # the region in visit order.  Imprecision over-holds (a
        # conditionally-failed try-acquire still counts), never
        # under-holds.
        if isinstance(node.func, ast.Attribute) and node.func.attr in (
                "acquire", "acquire_read", "acquire_write"):
            ref = self._lock_of(node.func.value)
            if ref is not None:
                self.fi.acquires.append((ref, node.lineno, held))
                if ref.name not in self.held:
                    self.held.append(ref.name)
        elif isinstance(node.func, ast.Attribute) and node.func.attr in (
                "release", "release_read", "release_write"):
            ref = self._lock_of(node.func.value)
            if ref is not None and ref.name in self.held:
                # remove the innermost hold of that name
                for i in range(len(self.held) - 1, -1, -1):
                    if self.held[i] == ref.name:
                        del self.held[i]
                        break
        # direct blocking ops (the lexical pass's table)
        for sub, op in self._blocking:
            if sub in name:
                self.fi.blocks.append((op, name, node.lineno, held))
                break
        if ".Thread" in name or name == "Thread":
            self.fi.spawns_thread = True
        self._resolve_call(node, name, held)
        # arguments may carry escaping references / nested calls
        for arg in node.args:
            self.visit(arg)
        for kw in node.keywords:
            self.visit(kw.value)
        # the func expression itself: visit attribute bases for escaping
        if isinstance(node.func, ast.Attribute):
            self.visit(node.func.value)

    def _add(self, callee: str, line: int, kind: str,
             held: Tuple[str, ...]) -> None:
        self.fi.calls.append(CallSite(callee=callee, line=line,
                                      kind=kind, held=held))

    def _resolve_call(self, node: ast.Call, name: str,
                      held: Tuple[str, ...]) -> None:
        fn = node.func
        if isinstance(fn, ast.Name):
            sym = self.mi.symbols.get(fn.id)
            if sym and sym[0] == "func":
                self._add(sym[1], node.lineno, "direct", held)
            elif sym and sym[0] == "class":
                init = self.cg.resolve_method(sym[1], "__init__")
                if init is not None:
                    self._add(init, node.lineno, "ctor", held)
                else:
                    self.fi.external_calls += 1
            elif sym is not None or fn.id in _BUILTIN_NAMES:
                # an external import or a builtin
                self.fi.external_calls += 1
            else:
                # a bare variable being called: callback dispatch —
                # the explicit unresolved bucket
                self.fi.dynamic_calls.append(
                    DynamicSite(name=fn.id, line=node.lineno, held=held))
            return
        if not isinstance(fn, ast.Attribute):
            self.fi.external_calls += 1
            return
        mname = fn.attr
        # module alias: utils.fsatomic.write_atomic_text(...)
        if isinstance(fn.value, ast.Name):
            sym = self.mi.symbols.get(fn.value.id)
            if sym and sym[0] == "module":
                src = self.cg.modules.get(sym[1])
                s2 = src.symbols.get(mname) if src else None
                if s2 and s2[0] == "func":
                    self._add(s2[1], node.lineno, "direct", held)
                    return
                if s2 and s2[0] == "class":
                    init = self.cg.resolve_method(s2[1], "__init__")
                    if init is not None:
                        self._add(init, node.lineno, "ctor", held)
                    else:
                        self.fi.external_calls += 1
                    return
                self.fi.external_calls += 1
                return
            if sym and sym[0] == "class":
                got = self.cg.resolve_method(sym[1], mname)
                if got is not None:
                    self._add(got, node.lineno, "direct", held)
                    return
        # super().__init__ / super().m()
        if isinstance(fn.value, ast.Call) and \
                _dotted(fn.value.func) == "super" and self.fi.cls:
            ci = self.cg.classes.get(self.fi.cls)
            for base in (ci.bases if ci else []):
                got = self.cg.resolve_method(base, mname)
                if got is not None:
                    self._add(got, node.lineno, "self", held)
                    return
            self.fi.external_calls += 1
            return
        owner = self._type_of(fn.value)
        if owner is not None:
            got = self.cg.resolve_method(owner, mname)
            if got is not None:
                kind = "self" if (isinstance(fn.value, ast.Name)
                                  and fn.value.id == "self") else "typed"
                self._add(got, node.lineno, kind, held)
                return
            # typed but method unknown on that class: attr fallthrough
        if mname in COMMON_METHOD_NAMES:
            # too generic to attribute either way: counting these as
            # "unresolved" would drown the coverage signal in `.get()`s
            # — but when repo classes DO define the name, they bound
            # the possible dispatch, and the edge over-approximation
            # must still see it (superset invariant)
            cands = self._method_candidates(mname)
            if cands:
                self.fi.dynamic_calls.append(DynamicSite(
                    name=name, line=node.lineno, held=held,
                    candidates=cands, counted=False))
            self.fi.external_calls += 1
            return
        candidates = self.cg.method_index.get(mname, [])
        if len(candidates) == 1:
            got = self.cg.resolve_method(candidates[0], mname)
            if got is not None:
                self._add(got, node.lineno, "unique", held)
                return
        if candidates:
            self.fi.dynamic_calls.append(DynamicSite(
                name=name, line=node.lineno, held=held,
                candidates=self._method_candidates(mname)))
        else:
            self.fi.external_calls += 1

    def _method_candidates(self, mname: str) -> Tuple[str, ...]:
        """Every repo method of this name — the bounded dispatch set
        for an ambiguous attribute call."""
        out = {self.cg.resolve_method(cid, mname)
               for cid in self.cg.method_index.get(mname, ())}
        return tuple(sorted(fid for fid in out if fid is not None))

    # ----------------------------------------------------------- escaping
    def visit_Name(self, node):  # noqa: N802
        if isinstance(node.ctx, ast.Load):
            sym = self.mi.symbols.get(node.id)
            if sym and sym[0] == "func":
                self.cg.escaping.add(sym[1])

    def visit_Attribute(self, node):  # noqa: N802
        # a bound-method reference taken as a value: self.m / obj.m
        if isinstance(node.ctx, ast.Load):
            owner = self._type_of(node.value)
            if owner is not None:
                got = self.cg.resolve_method(owner, node.attr)
                if got is not None:
                    self.cg.escaping.add(got)
        self.generic_visit(node)


def _param_types(cg: CallGraph, mi: ModuleInfo,
                 node: ast.AST) -> Dict[str, str]:
    out: Dict[str, str] = {}
    args = getattr(node, "args", None)
    if args is None:
        return out
    for a in list(args.args) + list(args.kwonlyargs):
        if a.annotation is not None:
            cid = _class_symbol(mi, cg, a.annotation)
            if cid is None and isinstance(a.annotation, ast.Constant) \
                    and isinstance(a.annotation.value, str):
                sym = mi.symbols.get(a.annotation.value.strip('"'))
                if sym and sym[0] == "class":
                    cid = sym[1]
            if cid is not None:
                out[a.arg] = cid
    return out


def _nested_functions(cg: CallGraph, fi: FuncInfo,
                      node: ast.AST) -> List[Tuple[FuncInfo, ast.AST]]:
    """Register nested defs + lambdas as their own (escaping) function
    nodes — the repo's callback idiom passes closures into subscriber
    lists, and the dynamic-call over-approximation needs their effect
    summaries."""
    out: List[Tuple[FuncInfo, ast.AST]] = []
    # IMMEDIATE nested functions only — each nested function walks its
    # own children when its turn comes (no double registration)
    found: List[ast.AST] = []
    stack = list(ast.iter_child_nodes(node))
    while stack:
        n = stack.pop()
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.Lambda)):
            found.append(n)
            continue
        stack.extend(ast.iter_child_nodes(n))
    for sub in found:
        nm = getattr(sub, "name", None) or f"<lambda@{sub.lineno}>"
        nfid = f"{fi.fid}.{nm}"
        if nfid in cg.functions:
            nfid = f"{nfid}@{sub.lineno}"
        nfi = FuncInfo(
            fid=nfid, module=fi.module, relpath=fi.relpath,
            cls=fi.cls, name=nm,
            qualscope=f"{fi.qualscope}.{nm}", line=sub.lineno)
        cg.functions[nfid] = nfi
        # a nested function is reachable only through a value
        # reference; treat it as escaping so dynamic call sites can
        # conservatively reach it
        cg.escaping.add(nfid)
        out.append((nfi, sub))
    return out


def _analyze_function(cg: CallGraph, fi: FuncInfo,
                      node: ast.AST) -> None:
    mi = cg.modules[fi.module]
    doc = ast.get_docstring(node) if not isinstance(
        node, ast.Lambda) else None
    has_contract, token = parse_contract_lock(doc or "")
    suffix = fi.name.endswith("_locked")
    if has_contract or suffix:
        if has_contract and token is None:
            # "caller holds" with no parseable lock name: the verifier
            # warns (lock-contract-unnamed) — the convention is only
            # checkable once the contract names its lock
            fi.contract_unnamed = True
        ref = _contract_lock_ref(cg, fi, token)
        if ref is not None:
            fi.requires_lock = ref
            fi.requires_source = "docstring" if token else "suffix"
        else:
            fi.contract_unnamed = True
    walker = _BodyWalker(cg, fi, _param_types(cg, mi, node))
    body = node.body if isinstance(node.body, list) else [node.body]
    for child in body:
        walker.visit(child)


def _contract_lock_ref(cg: CallGraph, fi: FuncInfo,
                       token: Optional[str]) -> Optional[LockRef]:
    """Resolve a contract token ('_lock' / 'store') — or, for a bare
    ``_locked`` suffix, the class's conventional mutex — to a LockRef."""
    cls = cg.classes.get(fi.cls) if fi.cls else None
    if token is None:
        # `_locked` suffix alone: the class's `_lock` attribute, the
        # class's SINGLE lock when unambiguous, else the conventional
        # pseudo `_lock` (the suffix names the class mutex by
        # convention; callers holding `with self._lock` verify against
        # the same pseudo name)
        if cls is not None:
            ref = cg.class_lock(cls.cid, "_lock")
            if ref is not None:
                return ref
            if len(cls.lock_attrs) == 1:
                return next(iter(cls.lock_attrs.values()))
            return LockRef(name=f"~{cls.name}._lock", named=False)
        return None
    if token.startswith("_") or token.endswith("_lock") \
            or token.endswith("_mu"):
        # ATTRIBUTE-style token ("_lock", "kill_lock", "_refresh_mu"):
        # resolve against the class's lock attrs, else a pseudo lock
        # that call-site holders of the same attribute match by tail
        if cls is not None:
            ref = cg.class_lock(cls.cid, token)
            if ref is not None:
                return ref
            return LockRef(name=f"~{cls.name}.{token}", named=False)
        return LockRef(name=f"~*.{token}", named=False)
    # named form ("the store lock"): token IS the family name
    return LockRef(name=family(token), named=True)


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------

def build_callgraph(package_root: Path,
                    trees: Dict[str, ast.Module]) -> CallGraph:
    """Build the whole-program call graph from pre-parsed modules
    (``relpath -> ast.Module``, as the lint engine already holds)."""
    cg = CallGraph(package=Path(package_root).name)
    for relpath, tree in sorted(trees.items()):
        _collect_module(cg, relpath, tree)
    # two rounds so one level of package re-export (`from .store import
    # Store` in state/__init__.py, consumed as `from .state import
    # Store` elsewhere) resolves regardless of module order
    _resolve_imports(cg)
    _resolve_imports(cg)
    _link_classes(cg)
    _collect_class_attrs(cg)
    # analyze bodies: module-level functions + methods, then nested
    for relpath, tree in sorted(trees.items()):
        module = _module_name(relpath)
        todo: List[Tuple[FuncInfo, ast.AST]] = []
        for node in tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                todo.append((cg.functions[f"{module}.{node.name}"], node))
            elif isinstance(node, ast.ClassDef):
                for sub in node.body:
                    if isinstance(sub, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                        fid = f"{module}.{node.name}.{sub.name}"
                        todo.append((cg.functions[fid], sub))
        i = 0
        while i < len(todo):
            fi, node = todo[i]
            todo.extend(_nested_functions(cg, fi, node))
            _analyze_function(cg, fi, node)
            i += 1
    return cg
