"""K5's launch geometry (``ops/match.greedy_plan``) on the CPU: the
values csrc/greedy.cu takes for one thread-block cluster per pool, at
every host count the cycle and the split matcher give.  The kernel
itself runs only on the card (``chip_smoke.py``); its plain version is
held against the JAX package in ``test_torch_match_gang.py``.
"""

import pytest

from cook_tpu_torch.ops import match as tmatch

SMEM_PER_CTA = 232_448     # H100: shared memory a block may use


@pytest.mark.parametrize("C", [1, 64, 1024, 4096])
@pytest.mark.parametrize("H", [50, 300, 4000, 8192, 12000, 16384, 65536,
                               300000])
def test_greedy_plan_fits_and_owns_every_host(H, C):
    P = 4
    plan = tmatch.greedy_plan(P, C, H)
    cs, hpc = plan.cluster, plan.hosts_per_cta
    # shared memory per CTA, the static part included
    assert plan.smem_bytes + tmatch._STATIC_BYTES <= SMEM_PER_CTA
    # the cluster divides the grid, and takes at most 16 CTAs
    grid = P * cs
    assert grid % cs == 0 and cs in (1, 2, 4, 8, 16)
    if cs > tmatch.PORTABLE_CLUSTER:    # only where 8 CTAs cannot hold H
        hpc8 = -(-(-(-H // 8)) // 16) * 16
        assert 25 * hpc8 + 26 * 256 + tmatch._STATIC_BYTES > SMEM_PER_CTA
    # every host owned by exactly one CTA: [r * hpc, (r + 1) * hpc)
    owners = [0] * H
    for r in range(cs):
        for h in range(r * hpc, min(H, (r + 1) * hpc)):
            owners[h] += 1
    assert owners == [1] * H
    assert hpc % 16 == 0 and (cs - 1) * hpc < H <= cs * hpc
    # every host of a CTA is scored by one thread, in groups
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= 1024
    assert plan.groups * tmatch.HOSTS_PER_THREAD * plan.threads >= hpc
    assert 1 <= plan.slot_chunk <= C
    # two parities of one candidate (8 bytes) a warp of the cluster
    assert plan.exchange_bytes == 2 * cs * (plan.threads // 32) * 8
    slots = 26 * plan.slot_chunk + plan.exchange_bytes
    if plan.in_smem:
        assert plan.work_floats == 0
        assert plan.smem_bytes == 25 * hpc + slots
    else:
        assert plan.smem_bytes == slots
        assert plan.work_stride >= 6 * hpc + hpc // 4
        assert plan.work_stride % 4 == 0
        assert plan.work_floats == P * cs * plan.work_stride


def test_greedy_plan_design_point_and_split_path():
    # the fused cycle's design point: 4 pools x 8 CTAs, slices in smem
    plan = tmatch.greedy_plan(4, 1024, 8192)
    assert (plan.cluster, plan.hosts_per_cta, plan.in_smem) == (8, 1024, True)
    # the split path's greedy at H = 65,536 still fits 8 CTAs' smem
    plan = tmatch.greedy_plan(1, 1024, 65536)
    assert (plan.cluster, plan.in_smem) == (8, True)
    # past 8 CTAs' shared memory the non-portable 16
    plan = tmatch.greedy_plan(1, 1024, 100_000)
    assert (plan.cluster, plan.in_smem) == (16, True)
    # past 16 CTAs' shared memory: device memory
    plan = tmatch.greedy_plan(1, 64, 300_000)
    assert (plan.cluster, plan.in_smem) == (16, False)


def test_greedy_plan_refuses_empty_shapes():
    with pytest.raises(ValueError):
        tmatch.greedy_plan(1, 0, 10)
    with pytest.raises(ValueError):
        tmatch.greedy_plan(1, 10, 0)
