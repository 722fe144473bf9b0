"""The port's static analysis (``cook_tpu_torch/analysis``,
``cook_tpu_torch/lint.py``) against the JAX package's, on the CPU.

- **Toy trees.**  Every case of ``tests/test_analysis.py`` that lints a
  synthetic tree runs with that module's ``run_lint`` swapped for
  :func:`dual_run_lint`: each call runs both packages' ``run_lint`` on
  the same arguments, the two result documents must be equal, and the
  case's own assertions then read the port's result.
- **Real trees.**  Both analyses lint both packages' trees (module-scoped,
  one run each): the documents are equal, findings compared on check,
  path, line, scope, detail and fingerprint, and the message after the
  scanned package's name (the registry pass names it).  The port lints
  its own tree clean with the reference's seven baseline entries.
- **The CLI.**  ``python -m cook_tpu_torch.lint``'s exit contract,
  ``--json``, ``--changed`` and ``--lock-coverage``, each against the
  reference's CLI on the same arguments.
- **The lock edges.**  The port's static edges equal the reference's,
  and the port's lock monitor's observed edges after a node run are a
  subset of them (the port's twin of ``tests/conftest.py``'s teardown).

Every comparison is exact.
"""

import ast
import importlib
import inspect
import json
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import pytest

import test_analysis as ref_cases
from cook_tpu.analysis import run_lint as ref_run_lint
from cook_tpu.analysis.summaries import \
    static_edge_families as ref_static_edges
from cook_tpu.lint import main as ref_lint_main
from cook_tpu_torch.analysis import engine, run_lint as port_run_lint
from cook_tpu_torch.analysis import registry as port_registry
from cook_tpu_torch.analysis.summaries import (run_interprocedural,
                                               static_edge_families)
from cook_tpu_torch.lint import main as port_lint_main

REPO = Path(__file__).resolve().parent.parent
TREES = ("cook_tpu", "cook_tpu_torch")


def norm_doc(result, package_root):
    """The port's ``result.to_doc()`` with the scanned package's name in
    the registry pass's messages read as ``cook_tpu/``, which the
    reference's messages always say, whatever tree it scanned."""
    doc = result.to_doc()
    name = Path(package_root).name
    for key in ("findings", "suppressed"):
        for f in doc[key]:
            f["message"] = f["message"].replace(
                f" is used in {name}/ but ", " is used in cook_tpu/ but ")
    return doc


def dual_run_lint(*args, **kw):
    """Both packages' ``run_lint`` on the same arguments; the documents
    must be equal.  Returns the port's result."""
    ref = ref_run_lint(*args, **kw)
    port = port_run_lint(*args, **kw)
    root = kw.get("package_root", args[0] if args else None)
    assert norm_doc(port, root) == ref.to_doc()
    assert [f.fingerprint for f in port.findings] == \
        [f.fingerprint for f in ref.findings]
    return port


# ---------------------------------------------------------------- toy trees
def _toy_cases():
    """(class or None, test name) of every case in the reference's file
    that lints a synthetic tree under ``tmp_path`` (and not the repo)."""
    src = (REPO / "tests/test_analysis.py").read_text()
    tree = ast.parse(src)
    out = []

    def wanted(fn):
        body = ast.get_source_segment(src, fn)
        args = {a.arg for a in fn.args.args}
        return (fn.name.startswith("test_") and "tmp_path" in args
                and args <= {"self", "tmp_path"} and "REPO" not in body
                and any(k in body for k in ("lint_snippet(", "lint_tree(",
                                            "run_lint(")))

    for node in tree.body:
        if isinstance(node, ast.ClassDef):
            out += [(node.name, fn.name) for fn in node.body
                    if isinstance(fn, ast.FunctionDef) and wanted(fn)]
        elif isinstance(node, ast.FunctionDef) and wanted(node):
            out.append((None, node.name))
    return out


TOY_CASES = _toy_cases()


def test_toy_cases_cover_every_pass():
    """Non-vacuity: the harvested cases span every pass family."""
    classes = {c for c, _ in TOY_CASES}
    assert {"TestLockDisciplinePass", "TestJitHygienePass",
            "TestPartitionIsolationPass", "TestEngineMechanics",
            "TestTransitiveBlocking", "TestRequiresLockVerifier",
            "TestStaticLockOrder", "TestStaticVsDynamicEdgeDiff",
            "TestJournalRecordCompleteness", "TestJournalRawWrite",
            "TestChangedMode"} <= classes
    assert len(TOY_CASES) >= 40


@pytest.mark.parametrize("case", TOY_CASES,
                         ids=[f"{c}::{n}" if c else n for c, n in TOY_CASES])
def test_toy_tree_parity(case, tmp_path, monkeypatch):
    cls, name = case
    monkeypatch.setattr(ref_cases, "run_lint", dual_run_lint)
    fn = (getattr(getattr(ref_cases, cls)(), name) if cls
          else getattr(ref_cases, name))
    fn(tmp_path)


# --------------------------------------------------------------- real trees
@pytest.fixture(scope="module")
def real():
    """{(tree, side): result} of both analyses over both trees, each
    with its own default baseline."""
    out = {}
    for tree in TREES:
        for side, fn in (("ref", ref_run_lint), ("port", port_run_lint)):
            out[tree, side] = fn(package_root=REPO / tree,
                                 docs_root=REPO / "docs")
    return out


@pytest.mark.parametrize("tree", TREES)
def test_real_tree_parity(real, tree):
    port, ref = real[tree, "port"], real[tree, "ref"]
    assert norm_doc(port, REPO / tree) == ref.to_doc()
    assert port.ok and ref.ok
    assert len(port.lock_edges) == 18


def test_port_self_lint_is_clean(real):
    """``python -m cook_tpu_torch.lint``'s verdict on the port's tree: no
    finding, no parse error, no stale entry, and each of the seven
    baseline entries suppresses a site of the port's tree."""
    r = real["cook_tpu_torch", "port"]
    msgs = [f"{f.path}:{f.line} [{f.check}] {f.message}"
            for f in r.findings]
    assert r.ok, "\n".join(msgs)
    assert not r.stale_baseline and not r.errors
    base = engine.load_baseline()
    used = {f.fingerprint for f in r.suppressed
            if f.suppressed_by == "baseline"}
    assert used == set(base) and len(base) == 7


def test_every_baseline_entry_has_justification():
    base = engine.load_baseline()
    assert engine.default_baseline_path() == \
        REPO / "cook_tpu_torch/analysis/baseline.json"
    ref = json.loads((REPO / "cook_tpu/analysis/baseline.json").read_text())
    assert base == {e["fingerprint"]: e["justification"]
                    for e in ref["suppressions"]}
    for fp, why in base.items():
        assert why.strip(), f"baseline entry without justification: {fp}"


def test_port_tree_has_no_jit_sites(real):
    """The jit-hygiene pass runs on the port's tree as the reference has
    it, and the port's tree gives it nothing to report."""
    r = real["cook_tpu_torch", "port"]
    assert not any(f.check.startswith("jit-")
                   for f in r.findings + r.suppressed)


def test_registries_and_journal_kinds_match():
    from cook_tpu.analysis import registry as ref_registry
    assert port_registry.cycle_record_fields() == \
        ref_registry.cycle_record_fields()
    assert port_registry.journal_record_kinds() == \
        ref_registry.journal_record_kinds() == {
            "tx", "ep", "barrier", "w", "d", "lr", "lp", "a"}
    assert port_registry.diff_registries(
        REPO / "cook_tpu_torch", REPO / "docs") == \
        ref_registry.diff_registries(REPO / "cook_tpu_torch", REPO / "docs")


def _trees(root):
    return {p.relative_to(root).as_posix(): ast.parse(
        p.read_text(encoding="utf-8"))
        for p in sorted(root.rglob("*.py")) if "__pycache__" not in p.parts}


def test_port_whole_program_analysis_time_budget():
    """The reference's bound, on the port's analysis of the port's tree:
    call graph, fixpoint and every interprocedural pass in under 10 s
    on the CPU."""
    trees = _trees(REPO / "cook_tpu_torch")
    t0 = time.time()
    res = run_interprocedural(REPO / "cook_tpu_torch", trees)
    elapsed = time.time() - t0
    assert elapsed < 10.0, f"fixpoint took {elapsed:.1f}s"
    assert res.stats["functions"] > 1000
    assert res.stats["fixpoint_iterations"] > 0
    assert res.stats["static_lock_edges"] == 18


def test_contract_functions_discovered_on_port_tree():
    from cook_tpu_torch.analysis.callgraph import build_callgraph
    root = REPO / "cook_tpu_torch"
    cg = build_callgraph(root, _trees(root))
    req = {f.fid: f.requires_lock.name
           for f in cg.functions.values() if f.requires_lock}
    assert req["state.store.Store._journal_append"] == "store"
    assert req["state.store.Store._write_audit_record_locked"] == "store"
    assert req["utils.audit.AuditTrail._record_one"] == "audit"
    assert req["state.index.ColumnarIndex._rank_rows_locked"] == "index"
    assert [f.fid for f in cg.functions.values() if f.contract_unnamed] \
        == []


# ---------------------------------------------------------------- the CLI
def _both_cli(capsys, argv):
    """(rc, stdout) of the reference's and the port's CLI on ``argv``."""
    out = []
    for main in (ref_lint_main, port_lint_main):
        rc = main(list(argv))
        out.append((rc, capsys.readouterr().out))
    return out


def _dirty(tmp_path):
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    (pkg / "m.py").write_text(
        "import os\n\nclass S:\n    def bad(self):\n"
        "        with self._lock:\n            os.fsync(3)\n")
    empty = tmp_path / "b.json"
    empty.write_text('{"suppressions": []}')
    return pkg, empty


def test_lint_cli_defaults_and_exit_0(real, capsys):
    """No arguments: the port's tree, the port's baseline and the repo's
    ``docs/``; exit 0 with the summary line of a clean tree."""
    rc = port_lint_main(["--lock-coverage"])
    out = capsys.readouterr().out
    assert rc == 0
    n = real["cook_tpu_torch", "port"].files_scanned
    assert f"{n} files scanned: 0 finding(s), 22 suppressed, 0 stale" in out
    assert "lock-order coverage" in out
    assert "store.notify->store" in out


@pytest.mark.parametrize("flags", [[], ["--json"], ["--show-suppressed"]])
def test_lint_cli_dirty_tree_exits_1(tmp_path, capsys, flags):
    pkg, empty = _dirty(tmp_path)
    (ref_rc, ref_out), (rc, out) = _both_cli(
        capsys, ["--root", str(pkg), "--baseline", str(empty), *flags])
    assert rc == ref_rc == 1
    assert out == ref_out


def test_lint_cli_parse_error_and_stale_entry_exit_1(tmp_path, capsys):
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    (pkg / "bad.py").write_text("def broken(:\n")
    base = tmp_path / "b.json"
    base.write_text(json.dumps({"suppressions": [
        {"fingerprint": "lock-blocking-call:gone.py:X.y:os.fsync",
         "justification": "stale"}]}))
    (ref_rc, ref_out), (rc, out) = _both_cli(
        capsys, ["--root", str(pkg), "--baseline", str(base), "--json"])
    assert rc == ref_rc == 1
    assert out == ref_out
    doc = json.loads(out)
    assert doc["errors"] and doc["stale_baseline"]


def test_lint_cli_changed_mode(tmp_path, capsys):
    """``--changed``: only files modified against a git base are
    reported, and the stale check is skipped."""
    pkg, empty = _dirty(tmp_path)
    (pkg / "b.py").write_text(
        "import time\n\nclass B:\n    def bad(self):\n"
        "        with self._mu:\n            time.sleep(1)\n")
    git = ["git", "-c", "user.email=t@t", "-c", "user.name=t"]
    for cmd in (["init", "-q"], ["add", "-A"], ["commit", "-qm", "base"]):
        subprocess.run(git + cmd, cwd=tmp_path, check=True,
                       capture_output=True)
    argv = ["--root", str(pkg), "--baseline", str(empty), "--changed"]
    (ref_rc, ref_out), (rc, out) = _both_cli(capsys, argv)
    assert rc == ref_rc == 0 and out == ref_out
    assert "0 finding(s)" in out and "(changed vs HEAD)" in out
    (pkg / "b.py").write_text((pkg / "b.py").read_text() + "\n# edit\n")
    (ref_rc, ref_out), (rc, out) = _both_cli(capsys, argv + ["HEAD"])
    assert rc == ref_rc == 1 and out == ref_out
    assert "b.py" in out and "m.py" not in out


def test_lint_cli_lock_coverage_observed_file(tmp_path, capsys):
    """``--lock-coverage --observed``: a health document's edges against
    a toy tree's static ones, in both CLIs' words."""
    pkg = tmp_path / "pkg"
    (pkg / "utils").mkdir(parents=True)
    (pkg / "utils/locks.py").write_text(textwrap.dedent("""
        _DECLARED_ORDER = {"outer.lk": 10, "inner.lk": 20}

        def named_lock(name):
            return None
    """))
    (pkg / "m.py").write_text(textwrap.dedent("""
        from .utils.locks import named_lock

        class A:
            def __init__(self):
                self._lock = named_lock("outer.lk")
                self._in = named_lock("inner.lk")

            def nest(self):
                with self._lock:
                    with self._in:
                        pass
    """))
    empty = tmp_path / "b.json"
    empty.write_text('{"suppressions": []}')
    obs = tmp_path / "health.json"
    obs.write_text(json.dumps({"locks": {"observed_edges": [
        "outer.lk->inner.lk", "inner.lk->outer.lk"]}}))
    (ref_rc, ref_out), (rc, out) = _both_cli(capsys, [
        "--root", str(pkg), "--baseline", str(empty), "--lock-coverage",
        "--observed", str(obs)])
    assert rc == ref_rc == 0 and out == ref_out
    assert "[ok]         outer.lk->inner.lk" in out
    assert "[OBSERVED-ONLY] inner.lk->outer.lk" in out


def test_python_m_lint_runs_on_the_port_alone(tmp_path):
    """``python -m cook_tpu_torch.lint --json`` in a fresh process loads
    neither ``jax`` nor ``cook_tpu`` and exits 0 on the port's tree."""
    code = ("import sys, runpy\n"
            "sys.argv = ['lint', '--json']\n"
            "try:\n"
            "    runpy.run_module('cook_tpu_torch.lint',\n"
            "                     run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    rc = e.code\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'cook_tpu'))\n"
            "print('RC', rc, 'BAD', bad, file=sys.stderr)\n")
    run = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert "RC 0 BAD []" in run.stderr, run.stderr[-2000:]
    doc = json.loads(run.stdout)
    assert doc["ok"] is True and doc["summary"]["findings"] == 0


# ----------------------------------------------------------- the lock edges
def test_static_edges_equal_the_references():
    port = static_edge_families(wait=True)
    ref = ref_static_edges(wait=True)
    assert port == ref and len(port) == 18
    assert "store.notify->store" in port


def test_port_observed_edges_subset_of_static_after_a_node_run():
    """The port's twin of the reference's session-end check: drive the
    port's ``Store`` and a REST node through cycles on the CPU, then
    every ordering the port's lock monitor observed is a static edge."""
    from cook_tpu_torch.client import JobClient
    from cook_tpu_torch.cluster import FakeCluster, FakeHost
    from cook_tpu_torch.config import Config
    from cook_tpu_torch.rest import ApiServer, CookApi
    from cook_tpu_torch.sched import Scheduler
    from cook_tpu_torch.state import Resources, Store
    from cook_tpu_torch.utils import locks

    store = Store()
    store.ensure_index()
    cluster = FakeCluster("lk", [FakeHost(f"h{i}", Resources(cpus=4,
                                                             mem=4096))
                                 for i in range(3)])
    sched = Scheduler(store, Config(), [cluster], device="cpu")
    server = ApiServer(CookApi(store, scheduler=sched))
    server.start()
    try:
        c = JobClient(server.url, user="lk")
        uuids = c.submit([{"command": "x", "cpus": 1, "mem": 64}
                          for _ in range(8)])
        for _ in range(2):
            sched.step_cycle()
        c.kill(uuids[:2])
        assert {j["state"] for j in c.query(uuids)} >= {"running",
                                                         "failed"}
    finally:
        server.stop()
    static = set(static_edge_families(wait=True))
    observed = set(locks.monitor.observed_edges())
    assert "store.notify->store" in observed
    assert observed <= static, sorted(observed - static)
    assert locks.monitor.violations == []


def test_analysis_imports_nothing_it_scans():
    """The port's analysis reads source as ASTs: linting a tree that
    imports ``jax`` leaves ``jax`` unimported in a fresh process."""
    code = ("import sys, pathlib, tempfile\n"
            "from cook_tpu_torch.analysis import run_lint\n"
            "d = pathlib.Path(tempfile.mkdtemp()) / 'pkg'\n"
            "d.mkdir()\n"
            "(d / 'm.py').write_text('import jax\\nf = jax.jit(abs)\\n')\n"
            "r = run_lint(package_root=d, docs_root=None)\n"
            "print(sorted({f.check for f in r.findings}), "
            "'jax' in sys.modules)\n")
    run = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr
    assert run.stdout.split("]")[1].strip() == "False"
    assert "jit-uninstrumented" in run.stdout


def test_port_modules_mirror_the_reference():
    """Every module of the reference's analysis, lint and ecosystem has
    its counterpart in the port, with the same public names."""
    for mod in ("analysis", "analysis.engine", "analysis.passes",
                "analysis.callgraph", "analysis.summaries",
                "analysis.registry", "lint", "ecosystem",
                "ecosystem.service_farm", "ecosystem.dask_backend",
                "ecosystem.spark", "native.jobclient"):
        ref = importlib.import_module(f"cook_tpu.{mod}")
        port = importlib.import_module(f"cook_tpu_torch.{mod}")
        pub = {n for n, v in vars(ref).items() if not n.startswith("_")
               and (inspect.isfunction(v) or inspect.isclass(v))
               and getattr(v, "__module__", "").startswith("cook_tpu.")}
        assert pub <= set(vars(port)), (mod, pub - set(vars(port)))
