"""The port's copy of ``cook_tpu/analysis/engine.py`` (defaults re-rooted).

Lint engine: walk the package, run the passes, diff against the
checked-in baseline (see package doc and docs/ANALYSIS.md).

Suppression surfaces, in precedence order:

1. **inline pragma** — a ``# cs-lint: allow=<check-id>`` comment on the
   flagged line (or the line above) suppresses that check there; use it
   when the justification reads best at the site.
2. **baseline** — ``analysis/baseline.json`` holds
   ``{"suppressions": [{"fingerprint": ..., "justification": ...}]}``
   entries.  Fingerprints are ``check:path:scope:detail`` — line-number
   free, so edits above a flagged site don't churn the baseline.  Every
   entry MUST carry a one-line justification; stale entries (matching
   nothing) are reported so the baseline can only shrink honestly.
"""

from __future__ import annotations

import ast
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

_PRAGMA = "# cs-lint: allow="


@dataclass
class Finding:
    check: str      #: pass/check id, e.g. "lock-blocking-call"
    path: str       #: repo-relative path
    line: int
    scope: str      #: enclosing function qualname (or surface name)
    detail: str     #: stable token (dotted call, kernel name, ...)
    message: str
    suppressed_by: Optional[str] = None  #: "pragma" | "baseline"

    @property
    def fingerprint(self) -> str:
        return f"{self.check}:{self.path}:{self.scope}:{self.detail}"

    def to_doc(self) -> Dict[str, Any]:
        return {"check": self.check, "path": self.path,
                "line": self.line, "scope": self.scope,
                "detail": self.detail, "message": self.message,
                "fingerprint": self.fingerprint,
                **({"suppressed_by": self.suppressed_by}
                   if self.suppressed_by else {})}


#: machine-readable result document version (``--json`` consumers pin
#: this; bump on any breaking shape change and note it in
#: docs/ANALYSIS.md)
SCHEMA_VERSION = 2


@dataclass
class LintResult:
    findings: List[Finding] = field(default_factory=list)
    suppressed: List[Finding] = field(default_factory=list)
    stale_baseline: List[str] = field(default_factory=list)
    files_scanned: int = 0
    errors: List[str] = field(default_factory=list)
    #: whole-program analysis stats (call resolution coverage,
    #: fixpoint iterations) — the `unresolved` bucket made explicit
    callgraph: Dict[str, Any] = field(default_factory=dict)
    #: static may-be-held-at-acquisition edges (family-normalized
    #: docs), for `--lock-coverage` and the /debug/health diff
    lock_edges: List[Dict[str, Any]] = field(default_factory=list)
    #: set when findings were restricted to a changed-files set
    changed_only: bool = False

    @property
    def ok(self) -> bool:
        """Zero unsuppressed findings (the exit-0 contract).  Parse
        errors also fail (an unparseable file is an unlinted file), and
        so do STALE baseline entries — the CLI and the tier-1 self-lint
        golden must render the same verdict on the same tree, and the
        baseline may only shrink honestly.  (In ``--changed`` mode the
        stale check is skipped — entries for unchanged files are not
        stale just because those files were filtered out; the full-repo
        pass stays the gate.)"""
        return (not self.findings and not self.errors
                and not self.stale_baseline)

    def to_doc(self) -> Dict[str, Any]:
        return {"schema": SCHEMA_VERSION,
                "ok": self.ok,
                "files_scanned": self.files_scanned,
                "summary": {
                    "findings": len(self.findings),
                    "suppressed": len(self.suppressed),
                    "stale_baseline": len(self.stale_baseline),
                    "errors": len(self.errors),
                    "changed_only": self.changed_only,
                },
                "callgraph": dict(self.callgraph),
                "findings": [f.to_doc() for f in self.findings],
                "suppressed": [f.to_doc() for f in self.suppressed],
                "stale_baseline": list(self.stale_baseline),
                "lock_edges": list(self.lock_edges),
                "errors": list(self.errors)}


def default_baseline_path() -> Path:
    return Path(__file__).resolve().parent / "baseline.json"


def load_baseline(path: Optional[Path] = None) -> Dict[str, str]:
    """fingerprint -> justification."""
    path = Path(path) if path is not None else default_baseline_path()
    if not path.exists():
        return {}
    doc = json.loads(path.read_text(encoding="utf-8"))
    out: Dict[str, str] = {}
    for entry in doc.get("suppressions", []):
        out[entry["fingerprint"]] = entry.get("justification", "")
    return out


def _pragma_allows(src_lines: List[str], line: int, check: str) -> bool:
    for ln in (line, line - 1):
        if 1 <= ln <= len(src_lines):
            text = src_lines[ln - 1]
            i = text.find(_PRAGMA)
            if i >= 0:
                # a malformed pragma (nothing after allow=) suppresses
                # nothing — it must not crash the run
                tokens = text[i + len(_PRAGMA):].split()
                allowed = tokens[0].rstrip(",;") if tokens else ""
                if allowed in (check, "all"):
                    return True
    return False


def run_lint(package_root: Optional[Path] = None,
             docs_root: Optional[Path] = None,
             baseline: Optional[Path] = None,
             changed: Optional[set] = None) -> LintResult:
    """Run every pass over ``package_root`` (default: the installed
    cook_tpu_torch package) and the registry diff against ``docs_root``
    (default: ``<repo>/docs`` next to the package when present).

    ``changed`` (a set of finding paths — package-relative like
    ``state/store.py``, or doc paths like ``docs/ANALYSIS.md``)
    restricts REPORTED findings to those files: the whole-program
    analysis still runs over the full tree (interprocedural summaries
    need every module), only the report is filtered — the
    ``cs lint --changed`` sub-second inner loop.  Stale-baseline
    enforcement is skipped in that mode (docs/ANALYSIS.md exit
    contract); the full-repo pass remains the tier-1 gate."""
    from .passes import PASSES, registry_completeness
    from .summaries import run_interprocedural

    if package_root is None:
        package_root = Path(__file__).resolve().parent.parent
    package_root = Path(package_root)
    if docs_root is None:
        cand = package_root.parent / "docs"
        docs_root = cand if cand.exists() else None
    base = load_baseline(baseline)
    result = LintResult()
    raw: List[tuple] = []  # (finding, src_lines)
    trees: Dict[str, ast.Module] = {}
    sources: Dict[str, List[str]] = {}

    for path in sorted(package_root.rglob("*.py")):
        if "__pycache__" in path.parts:
            continue
        relpath = path.relative_to(package_root).as_posix()
        try:
            src = path.read_text(encoding="utf-8")
            tree = ast.parse(src, filename=str(path))
        except (OSError, SyntaxError) as e:
            result.errors.append(f"{relpath}: {e}")
            continue
        result.files_scanned += 1
        trees[relpath] = tree
        src_lines = src.splitlines()
        sources[relpath] = src_lines
        for _name, fn in PASSES:
            for f in fn(path, relpath, tree, src_lines):
                raw.append((f, src_lines))

    # whole-program passes: call graph + effect-summary fixpoint
    # (docs/ANALYSIS.md interprocedural section).  An internal failure
    # here is an ERROR, not a silent pass skip.
    try:
        interproc = run_interprocedural(package_root, trees)
    except Exception as e:  # pragma: no cover - analysis bug surface
        result.errors.append(f"interprocedural analysis failed: {e!r}")
    else:
        result.callgraph = interproc.stats
        result.lock_edges = [e.to_doc() for _k, e in
                             sorted(interproc.edges.items())]
        for f in interproc.findings:
            raw.append((f, sources.get(f.path, [])))

    for f in registry_completeness(package_root, docs_root):
        raw.append((f, []))

    seen_fingerprints = set()
    for f, src_lines in raw:
        seen_fingerprints.add(f.fingerprint)
        if src_lines and _pragma_allows(src_lines, f.line, f.check):
            f.suppressed_by = "pragma"
            result.suppressed.append(f)
        elif f.fingerprint in base:
            f.suppressed_by = "baseline"
            result.suppressed.append(f)
        else:
            result.findings.append(f)
    if changed is not None:
        result.changed_only = True
        result.findings = [f for f in result.findings
                           if f.path in changed]
        result.stale_baseline = []
    else:
        result.stale_baseline = sorted(
            fp for fp in base if fp not in seen_fingerprints)
    # deterministic order — byte-stable across runs for the same tree
    result.findings.sort(
        key=lambda f: (f.path, f.line, f.check, f.detail))
    return result
