"""The port's copy of ``cook_tpu/lint.py`` (defaults re-rooted:
the port's tree and the port's baseline).

``python -m cook_tpu_torch.lint`` — the repo-native static analysis CLI.

Exit contract (wired into tier-1 via tests/test_torch_analysis.py's
self-lint golden; documented in docs/ANALYSIS.md): **0** when the tree
has zero unsuppressed findings, **1** when any pass raises a new
finding, a file fails to parse, or a baseline entry has gone stale — the
same verdict the tier-1 golden renders. In ``--changed`` mode, findings
are restricted to files modified vs a git base (default ``HEAD``) and
the stale-baseline check is skipped (entries for unchanged files are not
stale just because they were filtered out): **0** = nothing new in YOUR
files, while the full-repo pass remains the tier-1 gate. ``cs lint`` is
the same entry point through the main CLI.

Usage::

    python -m cook_tpu_torch.lint [--json] [--root DIR] [--docs DIR]
                            [--baseline FILE] [--show-suppressed]
                            [--changed [BASE]] [--lock-coverage]
                            [--observed FILE]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path
from typing import Iterable, List, Optional, Set

from .analysis import run_lint
from .analysis.engine import LintResult


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="cs lint",
        description="repo-native static analysis: lock discipline + "
                    "interprocedural effect summaries, JIT hygiene, "
                    "docs-registry + journal-record completeness "
                    "(docs/ANALYSIS.md)")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="machine-readable result document (schema "
                        "version + summary counts)")
    p.add_argument("--root", default=None,
                   help="package root to scan (default: the "
                        "cook_tpu_torch package)")
    p.add_argument("--docs", default=None,
                   help="docs directory for the registry pass (default: "
                        "<root>/../docs when present)")
    p.add_argument("--baseline", default=None,
                   help="baseline file (default: "
                        "cook_tpu_torch/analysis/baseline.json)")
    p.add_argument("--show-suppressed", action="store_true",
                   help="also list baselined/pragma-suppressed findings")
    p.add_argument("--changed", nargs="?", const="HEAD", default=None,
                   metavar="BASE",
                   help="restrict findings to files modified vs a git "
                        "base (default HEAD) — the sub-second inner "
                        "loop; the full-repo pass stays the tier-1 "
                        "gate")
    p.add_argument("--lock-coverage", action="store_true",
                   dest="lock_coverage",
                   help="print the static-vs-observed lock-edge "
                        "coverage diff (statically possible orderings "
                        "the dynamic sanitizer never exercised, and "
                        "vice versa)")
    p.add_argument("--observed", default=None, metavar="FILE",
                   help="observed edge set for --lock-coverage: a "
                        "/debug/health JSON document (or just its "
                        "locks block, or a bare list of 'a->b' "
                        "strings); default: this process's own "
                        "lock monitor")
    return p


def changed_files(base: str, repo_root: Path,
                  package_name: str) -> Set[str]:
    """Finding-path set for files modified vs ``base``: package files
    as package-relative paths (``state/store.py``), everything else
    (docs) repo-relative — the two path shapes findings carry."""
    names: List[str] = []
    for cmd in (["git", "diff", "--name-only", base, "--"],
                ["git", "ls-files", "--others", "--exclude-standard"]):
        try:
            out = subprocess.run(
                cmd, cwd=str(repo_root), capture_output=True,
                text=True, timeout=30, check=True).stdout
        except (OSError, subprocess.SubprocessError) as e:
            raise SystemExit(
                f"cs lint --changed: git failed ({e}); run inside the "
                "repository or drop --changed")
        names.extend(line.strip() for line in out.splitlines()
                     if line.strip())
    out_set: Set[str] = set()
    prefix = package_name.rstrip("/") + "/"
    for name in names:
        out_set.add(name)
        if name.startswith(prefix):
            out_set.add(name[len(prefix):])
    return out_set


def _observed_edges(path: Optional[str]) -> List[str]:
    """The observed (dynamic) edge set for the coverage diff."""
    if path is None:
        from .utils.locks import monitor
        return monitor.observed_edges()
    doc = json.loads(Path(path).read_text(encoding="utf-8"))
    if isinstance(doc, list):
        return [str(e) for e in doc]
    locks = doc.get("locks", doc)
    edges = locks.get("observed_edges")
    if edges is None:
        # fall back to the raw edge list shape — family-normalize the
        # sibling-suffixed names (store[p0] -> store) so the diff
        # compares like with like, exactly as observed_edges() does
        from .utils.locks import family
        edges = sorted({f"{family(e['from'])}->{family(e['to'])}"
                        for e in locks.get("edges", [])})
    return [str(e) for e in edges]


def print_lock_coverage(result: LintResult,
                        observed: Iterable[str]) -> None:
    static = {f"{e['from']}->{e['to']}": e for e in result.lock_edges}
    obs = set(observed)
    exercised = sorted(set(static) & obs)
    unexercised = sorted(set(static) - obs)
    unstatic = sorted(obs - set(static))
    print("lock-order coverage (static analysis vs dynamic sanitizer):")
    print(f"  static edges:   {len(static)} "
          f"({sum(1 for e in static.values() if e['kind'] == 'resolved')}"
          f" resolved, "
          f"{sum(1 for e in static.values() if e['kind'] == 'dynamic')}"
          " via dynamic-dispatch over-approximation)")
    print(f"  observed edges: {len(obs)}")
    print(f"  exercised:      {len(exercised)}")
    for e in exercised:
        print(f"    [ok]         {e}")
    for e in unexercised:
        info = static[e]
        print(f"    [unexercised] {e}  ({info['kind']}; via "
              f"{info['via']}; {info['site']})")
    for e in unstatic:
        print(f"    [OBSERVED-ONLY] {e}  — the dynamic sanitizer saw "
              "an ordering the static analysis missed (resolution "
              "gap: report it)")


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    package_root = Path(args.root) if args.root else \
        Path(__file__).resolve().parent
    changed: Optional[Set[str]] = None
    if args.changed is not None:
        changed = changed_files(args.changed, package_root.parent,
                                package_root.name)
    result = run_lint(
        package_root=package_root,
        docs_root=Path(args.docs) if args.docs else None,
        baseline=Path(args.baseline) if args.baseline else None,
        changed=changed)
    if args.as_json:
        print(json.dumps(result.to_doc(), indent=2))
        return 0 if result.ok else 1
    for err in result.errors:
        print(f"ERROR {err}")
    for f in result.findings:
        print(f"{f.path}:{f.line}: [{f.check}] {f.message}")
        print(f"    fingerprint: {f.fingerprint}")
    if args.show_suppressed:
        for f in result.suppressed:
            print(f"suppressed ({f.suppressed_by}) {f.path}:{f.line}: "
                  f"[{f.check}] {f.detail}")
    for fp in result.stale_baseline:
        print(f"stale baseline entry (matches nothing — remove it): {fp}")
    if args.lock_coverage:
        print_lock_coverage(result, _observed_edges(args.observed))
    n, s = len(result.findings), len(result.suppressed)
    mode = f" (changed vs {args.changed})" if changed is not None else ""
    cg = result.callgraph or {}
    cov = cg.get("resolution_coverage")
    cov_txt = (f", call resolution {cov:.0%} "
               f"({cg.get('calls_unresolved', 0)} unresolved)"
               if cov is not None else "")
    print(f"{result.files_scanned} files scanned{mode}: {n} "
          f"finding(s), {s} suppressed, {len(result.stale_baseline)} "
          f"stale baseline entr(ies){cov_txt}")
    return 0 if result.ok else 1


if __name__ == "__main__":
    sys.exit(main())
