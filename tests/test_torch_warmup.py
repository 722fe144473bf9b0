"""The boot warmup and the compile cache against the JAX package on the
CPU.

``Scheduler.warmup_kernels`` (``FusedCycleDriver.warmup``) must count the
runs the reference's counts at every (sweep, gpu, caps, resident,
quantized) combination.  With ``auto`` matchers both run only the
compact cycle on the CPU.  With a ``tpu-megakernel`` pin the reference
also runs its megakernel, whose Pallas kernel cannot trace on this JAX
(the seed failures of ``tests/test_megakernel.py``), so there its
``pallas_cycle.megacycle`` is replaced by a stand-in that counts the
calls and returns a zero result: the reference's counting rule, held
against the port's megacycle runs.  The grid of every combination runs
the reference's warmup with its fused XLA cycle replaced the same way
(each XLA compile takes seconds here); a few combinations run it whole.
After a warmup the steady cycles
still equal the reference's; ``columnar_index=False`` warms nothing and
says so; ``compilation_cache_dir`` is where the kernels' library is
built and loaded.
"""

import logging
import types

import jax.numpy as jnp
import pytest

import cook_tpu.ops.pallas_cycle
import cook_tpu.sched
import cook_tpu.sched.fused
import cook_tpu_torch.sched
from cook_tpu_torch.ops import cuda_lib, telemetry
from test_torch_driver import PORT, REF, WORLDS
from test_torch_scheduler import drive


def scheduler(m, cfg, rank_backend="tpu"):
    if m is REF:
        return cook_tpu.sched.Scheduler(m.Store(), cfg, [],
                                        rank_backend=rank_backend)
    return cook_tpu_torch.sched.Scheduler(m.Store(), cfg, [],
                                          rank_backend=rank_backend,
                                          device="cpu")


def warm_config(m, *, sweep=False, gpu=False, caps=False, resident=True,
                quantized=True, backend="auto", tasks=100, hosts=100):
    cfg = m.Config()
    cfg.pipeline.depth = 0
    cfg.resident_pack = resident
    cfg.quantized_wire = quantized
    cfg.default_matcher = m.MatcherConfig(backend=backend)
    if caps:
        # a pool override whose cap buckets differently from the default
        cfg.pool_matchers = [("^beta$", m.MatcherConfig(
            backend=backend, max_jobs_considered=40))]
    pl = cfg.pipeline
    pl.warmup_tasks, pl.warmup_hosts = tasks, hosts
    pl.warmup_sweep, pl.warmup_gpu = sweep, gpu
    return cfg


@pytest.fixture
def ref_megacycle_counted(monkeypatch):
    """The reference's megacycle replaced by a counting stand-in (its
    Pallas kernel does not trace on this JAX)."""
    calls = []

    def stand_in(wire, **kw):
        calls.append((wire.rows.dtype, kw.get("considerable_cap")))
        return types.SimpleNamespace(n_queue=jnp.zeros(1, jnp.int32))
    monkeypatch.setattr(cook_tpu.ops.pallas_cycle, "megacycle", stand_in)
    return calls


@pytest.fixture
def ref_cycle_counted(monkeypatch):
    """The reference's fused XLA cycle replaced by a counting stand-in."""
    calls = []

    def cycle_fn(self, gpu_mode, cap, structured=False, compact=False):
        def run(inp):
            calls.append((gpu_mode, cap, inp.rows.shape))
            return types.SimpleNamespace(n_queue=jnp.zeros(1, jnp.int32))
        return run
    monkeypatch.setattr(cook_tpu.sched.fused.FusedCycleDriver, "_cycle_fn",
                        cycle_fn)
    return calls


COMBOS = [dict(sweep=s, gpu=g, caps=c, resident=r, quantized=q)
          for s in (False, True) for g in (False, True)
          for c in (False, True) for r, q in ((True, True), (False, False),
                                              (True, False))]


def _ids(combos):
    return ["-".join(k for k, v in c.items() if v) or "plain"
            for c in combos]


def _counts(backend, combo, tasks=100, hosts=100, calls=()):
    """Each side's ``warmup_kernels()`` after construction (which warmed
    once already); ``calls`` are the stand-ins' lists, cleared before
    the counted call."""
    counts = []
    for m in (REF, PORT):
        sched = scheduler(m, warm_config(m, backend=backend, tasks=tasks,
                                         hosts=hosts, **combo))
        if m is REF:
            for c in calls:
                c.clear()
        counts.append(sched.warmup_kernels())
    return counts


@pytest.mark.parametrize("combo", COMBOS, ids=_ids(COMBOS))
@pytest.mark.parametrize("backend", ["auto", "tpu-megakernel"])
def test_warmup_run_count_matches_the_reference(combo, backend,
                                                ref_megacycle_counted,
                                                ref_cycle_counted):
    ref, port = _counts(backend, combo,
                        calls=(ref_megacycle_counted, ref_cycle_counted))
    assert ref == port > 0
    assert len(ref_cycle_counted) + len(ref_megacycle_counted) == ref
    if backend == "tpu-megakernel":
        assert ref_megacycle_counted, "the reference warmed no megakernel"


WHOLE = [dict(sweep=False, gpu=False, caps=False, resident=True,
              quantized=True),
         dict(sweep=True, gpu=False, caps=False, resident=False,
              quantized=False),
         dict(sweep=False, gpu=True, caps=True, resident=True,
              quantized=False)]


@pytest.mark.parametrize("combo", WHOLE, ids=_ids(WHOLE))
def test_warmup_run_count_matches_the_whole_reference(combo):
    """The reference's warmup as it runs, its XLA compiles included."""
    ref, port = _counts("auto", combo, tasks=100, hosts=64)
    assert ref == port > 0


def test_warmup_runs_at_construction():
    """The constructor runs the warmup, as the reference's does, and a
    scheduler without the knobs or on the cpu rank backend warms
    nothing."""
    telemetry.reset_all()
    before = telemetry.events().get("transfer.h2d", 0)
    cfg = warm_config(PORT, tasks=64, hosts=64)
    sched = scheduler(PORT, cfg)
    assert sched._fused is not None
    assert scheduler(PORT, PORT.Config())._fused is None
    assert scheduler(PORT, warm_config(PORT),
                     rank_backend="cpu")._fused is None
    assert telemetry.events().get("transfer.h2d", 0) >= before


def _warm(w, cfg):
    cfg.pipeline.warmup_tasks = 64
    cfg.pipeline.warmup_hosts = 64
    cfg.pipeline.warmup_sweep = True


@pytest.mark.parametrize("depth", [0, 2])
@pytest.mark.parametrize("name", ["plain", "rack_gang", "rate_limit"])
def test_steady_cycles_after_warmup_match_the_reference(name, depth):
    spec = WORLDS[name]
    setup = spec.get("setup", lambda w, cfg: None)

    def both(w, cfg):
        setup(w, cfg)
        _warm(w, cfg)
    ref, port, total = drive({**spec, "setup": both}, depth, None)
    assert total > 0


def test_entity_pack_warms_nothing_and_says_so(caplog):
    for m in (REF, PORT):
        cfg = warm_config(m)
        cfg.columnar_index = False
        with caplog.at_level(logging.WARNING):
            caplog.clear()
            sched = scheduler(m, cfg)
            assert sched.warmup_kernels() == 0
        assert any("columnar_index=False" in r.getMessage()
                   for r in caplog.records)


def test_a_failed_warmup_is_a_cold_start(monkeypatch, caplog):
    """A warmup that raises is logged and counts 0, as the reference's
    does; the scheduler still cycles."""
    from cook_tpu_torch.sched import fused

    def broken(self, **kw):
        raise RuntimeError("injected warmup fault")
    monkeypatch.setattr(fused.FusedCycleDriver, "warmup", broken)
    with caplog.at_level(logging.ERROR):
        sched = scheduler(PORT, warm_config(PORT))
        assert sched.warmup_kernels() == 0
    assert any("warmup failed" in r.getMessage() for r in caplog.records)


def test_compilation_cache_dir_is_the_build_directory(tmp_path, monkeypatch):
    monkeypatch.setattr(cuda_lib, "BUILD_DIR", cuda_lib.BUILD_DIR)
    cache = tmp_path / "kernel-cache"
    cfg = PORT.Config()
    cfg.pipeline.compilation_cache_dir = str(cache)
    scheduler(PORT, cfg)
    assert cuda_lib.BUILD_DIR == cache.resolve() and cache.is_dir()
    # a library of this tree's digest in the directory is loaded as it
    # is: no nvcc runs (there is none here)
    lib = cache / f"libcook_cycle_{cuda_lib._digest()}.so"
    lib.write_bytes(b"")
    assert cuda_lib.build() == lib
    assert cuda_lib.LAST_BUILD["built"] is False
    assert cuda_lib.LAST_BUILD["path"] == str(lib)


def test_enable_compilation_cache_returns_what_the_reference_does(
        tmp_path, monkeypatch):
    from cook_tpu.ops.telemetry import enable_compilation_cache as ref_fn
    monkeypatch.setattr(cuda_lib, "BUILD_DIR", cuda_lib.BUILD_DIR)
    default = cuda_lib.BUILD_DIR
    assert telemetry.enable_compilation_cache("") is ref_fn("") is False
    assert cuda_lib.BUILD_DIR == default
    assert telemetry.enable_compilation_cache(str(tmp_path / "c")) is True
    # an uncreatable directory leaves the default in place
    blocker = tmp_path / "file"
    blocker.write_text("x")
    monkeypatch.setattr(cuda_lib, "BUILD_DIR", default)
    assert telemetry.enable_compilation_cache(str(blocker / "sub")) is False
    assert cuda_lib.BUILD_DIR == default


def test_cpu_rank_backend_leaves_the_cache_alone(tmp_path, monkeypatch):
    monkeypatch.setattr(cuda_lib, "BUILD_DIR", cuda_lib.BUILD_DIR)
    default = cuda_lib.BUILD_DIR
    cfg = PORT.Config()
    cfg.pipeline.compilation_cache_dir = str(tmp_path / "c")
    scheduler(PORT, cfg, rank_backend="cpu")
    assert cuda_lib.BUILD_DIR == default
