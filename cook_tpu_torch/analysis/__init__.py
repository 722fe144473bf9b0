"""The port's copy of ``cook_tpu/analysis/`` (imports re-rooted).

Repo-native static analysis (``cs lint`` / ``python -m cook_tpu_torch.lint``).

System-specific static checking in the Engler et al. (SOSP'01) sense:
the invariants this repo's review rounds kept re-finding by hand are
machine-checked here —

* **lock-discipline** — no blocking work (fsync, sleep, socket/RPC,
  replication ack waits) lexically inside ``with self._lock``/``_mu``
  blocks or in functions documented to run with a lock held, except the
  explicitly baselined by-design sites (the WAL fsync IS the contract);
* **jit-hygiene** — every ``jax.jit``/``pjit`` site wrapped in
  ``ops.telemetry.instrument_jit`` (recompile storms must be visible),
  no host ``np.`` calls, wall-clock/RNG, or Python branches on traced
  values inside jitted kernel bodies;
* **registry-completeness** — every metric / span / fault-point /
  CycleRecord field harvested from call sites must appear in the docs
  registries (docs/OBSERVABILITY.md, docs/ROBUSTNESS.md), replacing the
  three runtime doc-check tests with one extractor shared by test and
  CLI (:mod:`cook_tpu_torch.analysis.registry`);
* **interprocedural effect summaries** — a whole-repo call graph
  (:mod:`cook_tpu_torch.analysis.callgraph`) plus a per-function effect
  fixpoint (:mod:`cook_tpu_torch.analysis.summaries`) extend the lexical
  passes over call chains: transitive blocking-under-lock, a static
  lock-order edge set diffed against the dynamic sanitizer's observed
  edges (``cs lint --lock-coverage``, ``/debug/health`` → ``locks``),
  verified ``_locked``/"caller holds" contracts, and the
  journal-record protocol-completeness registry
  (``state.store.JOURNAL_RECORD_KINDS``).

Findings flow through a checked-in baseline (``analysis/baseline.json``)
so the repo lints clean and NEW violations fail tier-1.  The dynamic
half of the rail — the runtime lock-order sanitizer — lives in
``cook_tpu_torch/utils/locks.py``.  See docs/ANALYSIS.md.
"""

from .engine import Finding, LintResult, run_lint  # noqa: F401
