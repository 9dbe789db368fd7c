"""The RG-LRU scan backward's algorithm and plan, on the CPU.

The card's backward kernel (``rglru_scan_bwd_kernel``) walks the reverse
recurrence as a forward one in reversed time, cut as the forward's
``ops.scan_plan`` says: chunks over the blocks of a cluster, rounds of them, four quarter
folds a chunk, carries composed in chunk order. ``ref.rglru_scan_backward_chunked``
states that algorithm in plain PyTorch; here it is held to the plain reverse
recurrence (``rglru_scan_backward_reference``) and to ``jax.vjp`` of the JAX
package's scan at ``impl="ref"`` (its associative-scan oracle), both at 1e-4,
the tolerance ``test_scan_backward_matches_jax_vjp`` uses (an associative
scan and chunked carries round otherwise than a sequential loop). The plan
is held to what the kernel needs of it here: it covers S and the largest
block fits the default shared memory; that the card holds recurrentgemma-2b's
training grid in one wave is asked of the CUDA runtime on the card
(``test_rglru_backward_plan_is_resident_and_rejects_tma_where_it_cannot``).
"""
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.rglru_scan.ops import rglru_scan as jax_scan  # noqa: E402
from repro_torch.kernels.rglru_scan import ops  # noqa: E402
from repro_torch.kernels.rglru_scan.ref import (  # noqa: E402
    rglru_scan_backward_chunked, rglru_scan_backward_reference, rglru_scan_reference)

TOL = 1e-4


def _inputs(B, S, W, seed=0):
    """As the JAX kernel test draws a, b, h0 (a = sigmoid(N) 0.2 + 0.79,
    b = N 0.1, h0 = N), and dh = N."""
    rng = np.random.default_rng(seed)
    a = 1 / (1 + np.exp(-rng.standard_normal((B, S, W)))) * 0.2 + 0.79
    return [x.astype(np.float32) for x in (a, rng.standard_normal((B, S, W)) * 0.1,
                                            rng.standard_normal((B, W)),
                                            rng.standard_normal((B, S, W)))]


def _jax_grads(a, b, h0, dh):
    def scan(a, b, h0):
        return jax_scan(a, b, h0, impl="ref")
    _, vjp = jax.vjp(scan, jnp.asarray(a), jnp.asarray(b), jnp.asarray(h0))
    return [np.asarray(g) for g in vjp(jnp.asarray(dh))]


def _chunked(a, b, h0, dh, plan):
    ta, tb, th0, tdh = map(torch.from_numpy, (a, b, h0, dh))
    h = rglru_scan_reference(ta, tb, th0)
    return (rglru_scan_backward_chunked(ta, h, th0, tdh, plan),
            rglru_scan_backward_reference(ta, h, th0, tdh))


CASES = [  # (B, S, W, plan; None takes ops.scan_plan)
    (2, 37, 24, None),                          # S not a multiple of the chunk
    (3, 1, 5, None),                            # S = 1: one chunk of one step
    (2, 10, 16, None),                          # S < a chunk of the forward's plan
    (2, 90, 8, ops.ScanPlan(4, 8, 3)),          # several rounds, the last one short
    (1, 200, 7, ops.ScanPlan(8, 5, 5)),         # odd W, five rounds
    (1, 3081, 5, None),                         # the last chunk holds t = 0 alone
    (1, 64, 3, ops.ScanPlan(2, 1, 32)),         # chunks of one step: empty quarters
]


@pytest.mark.parametrize("B,S,W,plan", CASES)
def test_chunked_backward_matches_the_plain_reverse_recurrence(B, S, W, plan):
    a, b, h0, dh = _inputs(B, S, W)
    plan = plan or ops.scan_plan(S)
    got, want = _chunked(a, b, h0, dh, plan)
    for g, w, name in zip(got, want, ("da", "db", "dh0")):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, atol=TOL, rtol=0, msg=f"{name} {plan}")


@pytest.mark.parametrize("B,S,W,plan", CASES)
def test_chunked_backward_matches_jax_vjp(B, S, W, plan):
    """da, db and dh0 (from the block that holds t = 0) against jax.vjp of
    the JAX scan."""
    a, b, h0, dh = _inputs(B, S, W, seed=1)
    plan = plan or ops.scan_plan(S)
    got, _ = _chunked(a, b, h0, dh, plan)
    for g, w, name in zip(got, _jax_grads(a, b, h0, dh), ("da", "db", "dh0")):
        np.testing.assert_allclose(g.numpy(), w, atol=TOL, rtol=0, err_msg=f"d{name} {plan}")


def test_chunked_backward_cuts_the_carry_at_a_zero():
    """a_t = 0 stops every gradient from beyond t: g before t + 1 ... is only
    what dh gives from there on, as in the plain recurrence."""
    a, b, h0, dh = _inputs(1, 100, 8, seed=2)
    a[:, 40] = 0.0
    plan = ops.ScanPlan(4, 8, 4)
    got, want = _chunked(a, b, h0, dh, plan)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=TOL, rtol=0)
    dh2 = dh.copy()
    dh2[:, 40:] += 1.0                              # past the zero: no effect before t = 40
    got2, _ = _chunked(a, b, h0, dh2, plan)
    assert torch.equal(got[1][:, :40], got2[1][:, :40])


# bwd_smem_bytes in the source: three [chunk, 32] float32 tiles, the four
# quarters' and the cluster's (two buffers over several rounds) float2 maps
# of 32 channels, one mbarrier
def _smem_bytes(plan):
    return (3 * plan.chunk * 32 * 4 + 8 * 32 * (4 + (2 if plan.rounds > 1 else 1) * plan.clusters)
            + 8)


@pytest.mark.parametrize("B,S,W", [(1, 3072, 2560), (4, 512, 2560), (1, 1, 128), (2, 10, 256),
                                   (1, 5000, 64), (2, 300, 33), (8, 128, 64), (2, 3081, 64),
                                   (16, 4096, 2560), (3, 17, 1)])
def test_backward_plan_covers_S_and_fits_shared_memory(B, S, W):
    """The backward runs on the forward's plan: chunks of at most 64 steps,
    at most 8 a round; every step in one chunk and no round left empty; the
    block within the 48 KB of dynamic shared memory a launch takes without
    opting in (the source's static_assert holds the largest plan to it)."""
    plan = ops.scan_plan(S)
    assert 1 <= plan.clusters <= ops.MAX_CLUSTER and 1 <= plan.chunk <= ops.MAX_CHUNK
    n = plan.clusters * plan.chunk
    assert (plan.rounds - 1) * n < S <= plan.rounds * n
    assert _smem_bytes(plan) <= _smem_bytes(ops.ScanPlan(8, 64, 2)) <= 48 * 1024


def test_backward_plan_keeps_the_training_grid_in_one_wave():
    """recurrentgemma-2b's training shape: 80 channel tiles of 32 and 8
    chunks of 64 steps a round over 6 rounds, 640 blocks of 29,704 bytes.
    That the card holds all 80 clusters at once is asked of the CUDA
    runtime on the card (``ops.backward_residency``)."""
    plan = ops.scan_plan(3072)
    assert plan == ops.ScanPlan(8, 64, 6)
    assert -(-2560 // ops.BWD_TILE_W) == 80
    assert _smem_bytes(plan) == 29_704


def test_backward_plan_takes_the_fewest_rounds_at_batch_4():
    """[4, 512, 2560]: one round of 64-step chunks, 2,560 blocks; a
    sequence of no steps has no plan."""
    assert ops.scan_plan(512) == ops.ScanPlan(8, 64, 1)
    with pytest.raises(ValueError):
        ops.scan_plan(0)


def test_backward_shared_memory_and_constants_match_the_kernel_source():
    source = (Path(ops.__file__).parent / "csrc" / "rglru_scan.cu").read_text()
    assert f"constexpr int BWD_TILE_W = {ops.BWD_TILE_W};" in source
    assert "constexpr int BWD_THREADS = BWD_TILE_W * SUBS;" in source
    assert "static_assert(bwd_smem_bytes(MAX_CHUNK, MAX_CLUSTER, 2) <= 48 * 1024" in source
    assert "cp.async.bulk.tensor.3d" in (Path(ops.__file__).parents[1] / "common"
                                         / "hopper.cuh").read_text()
    assert "tma_load_3d(" in source and "CU_TENSOR_MAP_DATA_TYPE_FLOAT32" in source
    # bwd_smem_bytes, as _smem_bytes states it
    assert _smem_bytes(ops.ScanPlan(8, 64, 6)) == 3 * 64 * 32 * 4 + 8 * 32 * (4 + 2 * 8) + 8
    assert _smem_bytes(ops.ScanPlan(1, 10, 1)) == 3 * 10 * 32 * 4 + 8 * 32 * (4 + 1) + 8


def test_tma_staging_needs_16_byte_rows_and_aligned_bases():
    a = torch.zeros(1, 3072, 2560)
    assert ops.tma_staging(a, a, a)                               # recurrentgemma-2b
    assert ops.tma_staging(torch.zeros(2, 1000, 100))             # 400-byte rows
    assert not ops.tma_staging(torch.zeros(2, 300, 33))           # 132-byte rows
    assert not ops.tma_staging(a, torch.zeros(3 * 2560 + 1)[1:].view(1, 3, 2560))  # base + 4 B
