"""The port's native pack binding (``cook_tpu_torch/native/pack.py``, over
the repo-root ``native/pack.cpp``) against its numpy branches
(``cook_tpu_torch/ops/delta.py``) and against the JAX package's
``native/pack.py``, at edge sizes: empty, one element, all equal, all
different, and random.  The library is built with g++ into
``build/native/``; without g++ the numpy branch is what runs, and the
tests that need the library say so and skip.
"""

import numpy as np
import pytest

from cook_tpu.native import pack as ref_pack
from cook_tpu_torch.native import pack as port_pack
from cook_tpu_torch.ops import delta as numpy_branch


def needs_native():
    """Decided inside the test, never at import: the library builds on
    first use."""
    if not port_pack.native_available():
        pytest.skip("g++ did not build libcookpack here")


def _diff_case(kind, n, rng):
    rows_a = rng.integers(0, 1 << 20, n).astype(np.int32)
    flags_a = rng.integers(0, 32, n).astype(np.uint8)
    rows_b, flags_b = rows_a.copy(), flags_a.copy()
    if kind == "all_differ":
        rows_b += 1
    elif kind == "flags_only":
        flags_b ^= 1
    elif kind == "random":
        hit = rng.random(n) < 0.1
        rows_b[hit] += 7
        flags_b[rng.random(n) < 0.05] ^= 4
    return rows_a, rows_b, flags_a, flags_b


DIFF = [(k, n) for k in ("all_equal", "all_differ", "flags_only", "random")
        for n in (0, 1, 2, 1000)]


@pytest.mark.parametrize("kind,n", DIFF)
def test_pack_diff(kind, n):
    rng = np.random.default_rng(n + len(kind))
    a = _diff_case(kind, n, rng)
    want = numpy_branch.pack_diff(*a)
    got = port_pack.pack_diff(*a)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, ref_pack.pack_diff(*a))
    with port_pack.numpy_branch():
        np.testing.assert_array_equal(port_pack.pack_diff(*a), want)


def test_pack_diff_takes_any_shape():
    rng = np.random.default_rng(3)
    a = [x.reshape(4, 250) for x in _diff_case("random", 1000, rng)]
    np.testing.assert_array_equal(port_pack.pack_diff(*a),
                                  numpy_branch.pack_diff(*a))


def _merge_case(kind, n, rng, width=12):
    kb = np.sort(np.array([rng.bytes(width) for _ in range(n)],
                          dtype=f"S{width}"))
    st = rng.integers(0, 1 << 40, n).astype(np.int64)
    uid = rng.integers(0, 1 << 20, n).astype(np.int32)
    rows = rng.integers(0, 1 << 30, n).astype(np.int64)
    if kind == "delete_all":
        del_pos = np.arange(n, dtype=np.int64)
    elif kind in ("insert_only", "none"):
        del_pos = np.zeros(0, dtype=np.int64)
    else:
        del_pos = np.flatnonzero(rng.random(n) < 0.3).astype(np.int64)
    m = n - len(del_pos)
    if kind in ("delete_all", "none"):
        na = 0 if kind == "none" else 2
    else:
        na = max(1, n // 3)
    akb = np.sort(np.array([rng.bytes(width) for _ in range(na)],
                           dtype=f"S{width}"))
    ast = rng.integers(0, 1 << 40, na).astype(np.int64)
    auid = rng.integers(0, 1 << 20, na).astype(np.int32)
    arows = rng.integers(0, 1 << 30, na).astype(np.int64)
    ins = np.sort(rng.integers(0, m + 1, na)).astype(np.int64)
    if not na:
        return kb, st, uid, rows, del_pos, ins, None, None, None, None
    return kb, st, uid, rows, del_pos, ins, akb, ast, auid, arows


MERGE = [(k, n) for k in ("none", "insert_only", "delete_all", "mixed")
         for n in (0, 1, 2, 500)]


@pytest.mark.parametrize("kind,n", MERGE)
def test_order_merge(kind, n):
    rng = np.random.default_rng(17 + n)
    a = _merge_case(kind, n, rng)
    want = numpy_branch.order_merge(*a)
    got = port_pack.order_merge(*a)
    ref = ref_pack.order_merge(*a)
    for g, w, r in zip(got, want, ref):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, r)
    with port_pack.numpy_branch():
        for g, w in zip(port_pack.order_merge(*a), want):
            np.testing.assert_array_equal(g, w)


PRUNE = [(k, n) for k in ("none", "one", "all", "random")
         for n in (0, 1, 2, 1000)]


@pytest.mark.parametrize("kind,n", PRUNE)
def test_prune_rows(kind, n):
    rng = np.random.default_rng(5 + n)
    rows = rng.integers(0, 1 << 30, n).astype(np.int32)
    if kind == "none" or n == 0:
        drop = np.zeros(0, dtype=np.int64)
    elif kind == "one":
        drop = np.array([n // 2], dtype=np.int64)
    elif kind == "all":
        drop = np.arange(n, dtype=np.int64)
    else:
        drop = np.flatnonzero(rng.random(n) < 0.2).astype(np.int64)
    want = numpy_branch.prune_rows(rows, drop)
    got = port_pack.prune_rows(rows, drop)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, ref_pack.prune_rows(rows, drop))
    assert got.dtype == np.int32


def test_the_library_is_built_into_build_native():
    needs_native()
    assert port_pack._LIB.exists()
    assert port_pack._LIB.parent.name == "native"
    assert port_pack._LIB.parent.parent.name == "build"


def test_numpy_branch_is_scoped():
    needs_native()
    assert port_pack.native_available()
    with port_pack.numpy_branch():
        assert not port_pack.native_available()
    assert port_pack.native_available()


def test_callers_route_through_the_native_binding():
    """The resident diff, the queue prune and the order-cache repair
    call the binding, as the reference's do."""
    import inspect
    from cook_tpu_torch.sched import fused
    from cook_tpu_torch.state import index
    src = inspect.getsource(fused)
    assert "native_pack.pack_diff(" in src
    assert "native_pack.prune_rows(" in src
    assert "from ..native.pack import order_merge" in \
        inspect.getsource(index)
