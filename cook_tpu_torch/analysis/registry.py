"""The port's copy of ``cook_tpu/analysis/registry.py`` (imports re-rooted).

Static registry extractor: harvest observability names from call
sites and diff them against the docs registries.

One implementation shared by the lint CLI's registry-completeness pass
and the tier-1 doc-check tests (tests/test_observability.py) — the three
runtime harvesters that used to live inline in the tests are retired
onto this module so the contract cannot drift between the two surfaces.

Harvested surfaces:

=====================  =====================================  =================
what                   call-site pattern                      registry
=====================  =====================================  =================
metric names           ``registry.counter_inc/gauge_set/       docs/OBSERVABILITY.md
                       observe[_many]/.time("cook_...")``
span names             ``tracing.span("...")`` /               docs/OBSERVABILITY.md
                       ``tracer.record_finished("...")``
fault points           ``injector/_faults.fire("...")`` /      docs/ROBUSTNESS.md
                       ``should_fire("...")`` / ``arm("...")``
CycleRecord fields     ``flight.CycleRecord.to_doc()`` keys    docs/OBSERVABILITY.md
debug endpoints        ``API_ROUTES`` entries under            docs/OBSERVABILITY.md
                       ``/debug`` / ``/metrics``               (endpoint table)
=====================  =====================================  =================
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, Iterable, Set

_METRIC_RE = re.compile(
    r'(?:counter_inc|gauge_set|gauge_clear|observe_many|observe|\.time)\('
    r'\s*["\'](cook_[a-z0-9_]+)')
_SPAN_RE = re.compile(
    r'(?:tracing\.span|tracer\.span|record_finished)\(\s*["\']([^"\']+)')
_FAULT_RE = re.compile(
    r'(?:\.fire|\.should_fire|injector\.arm)\(\s*\n?\s*'
    r'["\']([a-z0-9._]+)["\']')
# observability-plane route registrations (rest/api.py API_ROUTES): the
# operator-facing /debug/* and /metrics* surface must appear in the
# OBSERVABILITY.md endpoint table — a panel nobody can discover is a
# panel nobody uses
_ROUTE_RE = re.compile(
    r'\(\s*"(?:GET|POST|DELETE|PUT|PATCH)",\s*"(/(?:debug|metrics)[^"]*)"')
# a backticked endpoint row in the doc: optional method word, the path,
# optional ?query= suffix; <uuid>-style placeholders normalize to the
# route table's {uuid} form
_DOC_ROUTE_RE = re.compile(
    r'`(?:(?:GET|POST|DELETE|PUT|PATCH)\s+)?'
    r'(/(?:debug|metrics)[^`?\s]*)(?:\?[^`]*)?`')


def _py_files(root: Path) -> Iterable[Path]:
    for path in sorted(Path(root).rglob("*.py")):
        if "__pycache__" in path.parts:
            continue
        yield path


def _harvest_all(root: Path,
                 patterns: Dict[str, re.Pattern]) -> Dict[str, Set[str]]:
    """One pass over the tree: each file is read once and every pattern
    applied to it (run_lint + the four doc-check tests would otherwise
    re-read ~100 files per surface)."""
    out: Dict[str, Set[str]] = {key: set() for key in patterns}
    for path in _py_files(root):
        try:
            text = path.read_text(encoding="utf-8")
        except OSError:
            continue
        for key, pattern in patterns.items():
            for m in pattern.finditer(text):
                name = m.group(1)
                # placeholder names in docstrings/examples ("...") are
                # not real call sites
                if any(c.isalnum() for c in name):
                    out[key].add(name)
    return out


def _harvest(root: Path, pattern: re.Pattern) -> Set[str]:
    return _harvest_all(root, {"only": pattern})["only"]


def harvest_metrics(root: Path) -> Set[str]:
    """Every metric NAME emitted anywhere under ``root``."""
    return _harvest(root, _METRIC_RE)


def harvest_spans(root: Path) -> Set[str]:
    """Every span name opened (or recorded post-hoc) under ``root``."""
    return _harvest(root, _SPAN_RE)


def harvest_fault_points(root: Path) -> Set[str]:
    """Every fault-point name consulted or armed under ``root``.
    Only dotted names count (``store.journal.append``): the sim's
    ``injector.arm(point, ...)`` loops over variables, which don't
    match, and test-local synthetic points are out of scope."""
    return {n for n in _harvest(root, _FAULT_RE) if "." in n}


def harvest_endpoints(root: Path) -> Set[str]:
    """Every ``/debug*`` / ``/metrics*`` route path registered in an
    ``API_ROUTES``-style table under ``root``."""
    return _harvest(root, _ROUTE_RE)


def documented_endpoints(doc_text: str) -> Set[str]:
    """The endpoint paths the doc's tables register (backticked, method
    word and ``?query=`` suffix tolerated, ``<x>`` == ``{x}``)."""
    return {re.sub(r"<([^<>]+)>", r"{\1}", m.group(1))
            for m in _DOC_ROUTE_RE.finditer(doc_text)}


def cycle_record_fields() -> Set[str]:
    """The exported ``/debug/cycles`` schema — ``to_doc()`` keys of a
    fresh CycleRecord (some slots are renamed on export)."""
    from ..utils.flight import CycleRecord
    return set(CycleRecord(1, "fused").to_doc())


def journal_record_kinds() -> Set[str]:
    """The DECLARED journal record kinds — the protocol registry
    ``state.store.JOURNAL_RECORD_KINDS`` (docs/ROBUSTNESS.md
    replay-completeness contract).  The static diff against written /
    handled kinds lives in the journal-record pass
    (:func:`cook_tpu_torch.analysis.summaries.journal_record_findings`);
    this accessor is the runtime-facing twin for tests and tooling."""
    from ..state.store import JOURNAL_RECORD_KINDS
    return set(JOURNAL_RECORD_KINDS)


def documented(doc_text: str, name: str, metric: bool = False) -> bool:
    """Is ``name`` registered in the doc?  Registries reference names in
    backticks; counters may be registered under their exposed ``_total``
    form."""
    if f"`{name}`" in doc_text:
        return True
    return metric and f"`{name}_total`" in doc_text


def diff_registries(package_root: Path, docs_root: Path
                    ) -> Dict[str, Set[str]]:
    """All four registry diffs at once: surface -> set of names used in
    code but missing from the registry doc.  Empty sets everywhere =
    the registries are complete."""
    obs = (Path(docs_root) / "OBSERVABILITY.md")
    rob = (Path(docs_root) / "ROBUSTNESS.md")
    obs_text = obs.read_text(encoding="utf-8") if obs.exists() else ""
    rob_text = rob.read_text(encoding="utf-8") if rob.exists() else ""
    harvested = _harvest_all(package_root, {
        "metric": _METRIC_RE, "span": _SPAN_RE, "fault": _FAULT_RE,
        "endpoint": _ROUTE_RE})
    doc_endpoints = documented_endpoints(obs_text)
    out: Dict[str, Set[str]] = {
        "metric": {n for n in harvested["metric"]
                   if not documented(obs_text, n, metric=True)},
        "span": {n for n in harvested["span"]
                 if not documented(obs_text, n)},
        "fault-point": {n for n in harvested["fault"] if "." in n
                        if not documented(rob_text, n)},
        "endpoint": {n for n in harvested["endpoint"]
                     if n not in doc_endpoints},
        # the CycleRecord schema comes from the IMPORTED flight module,
        # so this surface only applies when scanning the real package
        # (fixture trees have no /debug/cycles schema to drift)
        "cycle-field": ({n for n in cycle_record_fields()
                         if not documented(obs_text, n)}
                        if (Path(package_root) / "utils"
                            / "flight.py").exists() else set()),
    }
    return out
