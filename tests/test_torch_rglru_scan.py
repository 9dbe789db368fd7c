"""Port parity: repro_torch rglru_scan (plain version, CPU tensors) vs the JAX
package's rglru_scan at impl="ref" (its associative-scan oracle; the Pallas
interpret path is broken on the installed JAX, see ROADMAP.md).

float32: 2e-4 at the JAX kernel test's shapes, its own tolerance
(tests/test_kernels.py), since a sequential loop and an associative scan
round differently; the h0 case at 1e-6, as there.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.rglru_scan.ops import rglru_scan as jax_scan  # noqa: E402
from repro_torch.kernels.rglru_scan import ops  # noqa: E402


def _inputs(B, S, W, seed=0):
    """As the JAX kernel test draws them: a = sigmoid(N) * 0.2 + 0.79,
    b = N * 0.1, h0 = N."""
    rng = np.random.default_rng(seed)
    a = (1 / (1 + np.exp(-rng.standard_normal((B, S, W)))) * 0.2 + 0.79)
    b = rng.standard_normal((B, S, W)) * 0.1
    h0 = rng.standard_normal((B, W))
    return a.astype(np.float32), b.astype(np.float32), h0.astype(np.float32)


def _port(a, b, h0):
    return ops.rglru_scan(torch.from_numpy(a), torch.from_numpy(b),
                          torch.from_numpy(h0))


@pytest.mark.parametrize("B,S,W", [(2, 512, 512), (1, 256, 1024), (3, 128, 512)])
def test_rglru_scan_plain_matches_jax_ref(B, S, W):
    a, b, h0 = _inputs(B, S, W)
    before = ops.rglru_scan.launches
    out = _port(a, b, h0)
    ref = np.asarray(jax_scan(jnp.asarray(a), jnp.asarray(b), jnp.asarray(h0),
                              impl="ref"))
    assert out.shape == (B, S, W) and out.dtype == torch.float32
    assert float(np.max(np.abs(out.numpy() - ref))) < 2e-4
    assert ops.rglru_scan.launches == before          # CPU tensors never launch


def test_rglru_scan_plain_respects_initial_state():
    a = np.full((1, 4, 256), 0.5, np.float32)
    b = np.zeros((1, 4, 256), np.float32)
    h0 = np.ones((1, 256), np.float32)
    h = _port(a, b, h0).numpy()
    assert float(np.max(np.abs(h[:, 0] - 0.5))) < 1e-6
    assert float(np.max(np.abs(h[:, 3] - 0.5 ** 4))) < 1e-6
    ref = np.asarray(jax_scan(jnp.asarray(a), jnp.asarray(b), jnp.asarray(h0),
                              impl="ref"))
    assert float(np.max(np.abs(h - ref))) < 1e-6


def test_rglru_scan_plain_bf16_inputs_match_jax_ref():
    """bf16 a, b: float32 carry, bf16 output on both sides; one bf16
    rounding of h (|h| < ~2) is at most ~8e-3."""
    a, b, h0 = _inputs(2, 64, 128, seed=1)
    ta = torch.from_numpy(a).bfloat16()
    tb = torch.from_numpy(b).bfloat16()
    out = ops.rglru_scan(ta, tb, torch.from_numpy(h0))
    ref = jax_scan(jnp.asarray(ta.float().numpy(), jnp.bfloat16),
                   jnp.asarray(tb.float().numpy(), jnp.bfloat16),
                   jnp.asarray(h0), impl="ref")
    assert out.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    err = np.max(np.abs(out.float().numpy() - np.asarray(ref, np.float32)))
    assert float(err) < 1e-2


def test_rglru_scan_wrapper_rejects_bad_inputs():
    a, b, h0 = (torch.from_numpy(x) for x in _inputs(1, 8, 16))
    with pytest.raises(ValueError):
        ops.rglru_scan(a, b[:, :4], h0)
    with pytest.raises(ValueError):
        ops.rglru_scan(a, b, h0[:, :8])
    # meta (the dry run's device) is taken since the cost tooling: the
    # kernel's output shape and no launch; a mismatch still raises there
    launches = ops.rglru_scan.launches
    h = ops.rglru_scan(a.to("meta"), b.to("meta"), h0.to("meta"))
    assert h.device.type == "meta" and h.shape == a.shape and h.dtype == b.dtype
    assert ops.rglru_scan.launches == launches
    with pytest.raises(ValueError):
        ops.rglru_scan(a.to("meta"), b[:, :4].to("meta"), h0.to("meta"))


# ---------------------------------------------------------------- split S
# The CUDA kernel splits S into chunks over the blocks of a cluster, folds
# each chunk into (prod a, h from 0), composes the carries in chunk order and
# re-runs each chunk from its carry. ``rglru_scan_chunked`` states that
# algorithm in plain PyTorch; it is held to the JAX oracle here at the
# kernel's tolerances (float32 2e-5, bf16 3e-2), since the card's kernel is
# held to the plain version at those.
from repro_torch.kernels.rglru_scan.ref import rglru_scan_chunked  # noqa: E402


def _jax_ref(a, b, h0):
    return np.asarray(jax_scan(jnp.asarray(a), jnp.asarray(b), jnp.asarray(h0),
                               impl="ref"))


def _chunked(a, b, h0, chunks):
    S = a.shape[1]
    return rglru_scan_chunked(torch.from_numpy(a), torch.from_numpy(b),
                              torch.from_numpy(h0), -(-S // chunks)).numpy()


@pytest.mark.parametrize("chunks", [1, 2, 8])
@pytest.mark.parametrize("B,S,W", [(2, 512, 512), (1, 256, 1024), (3, 128, 512),
                                   (2, 13, 64), (1, 511, 100)])      # ragged S
def test_chunked_composition_matches_jax_ref(B, S, W, chunks):
    a, b, h0 = _inputs(B, S, W)                      # h0 = N(0, 1): non-zero
    out = _chunked(a, b, h0, chunks)
    assert out.shape == (B, S, W)
    assert float(np.max(np.abs(out - _jax_ref(a, b, h0)))) < 2e-5


@pytest.mark.parametrize("chunks,zero", [(2, 0), (8, 3), (8, 7), (3, 1)])
def test_chunked_composition_cuts_the_carry_where_a_chunk_has_a_zero(chunks, zero):
    """a = 0 on a whole chunk: its product A_c is 0, so nothing of h0 or the
    earlier chunks reaches past it."""
    B, S, W = 2, 100, 64
    a, b, h0 = _inputs(B, S, W, seed=4)
    c = -(-S // chunks)
    a[:, zero * c:(zero + 1) * c] = 0.0
    out = _chunked(a, b, h0, chunks)
    assert float(np.max(np.abs(out - _jax_ref(a, b, h0)))) < 2e-5
    end = min(S, (zero + 1) * c)                     # from here on, h0 is forgotten
    other = _chunked(a, b, h0 + 5.0, chunks)
    assert np.array_equal(out[:, end - 1:], other[:, end - 1:])


@pytest.mark.parametrize("chunks", [1, 2, 8])
def test_chunked_composition_respects_initial_state(chunks):
    a = np.full((1, 16, 64), 0.5, np.float32)
    b = np.zeros((1, 16, 64), np.float32)
    h0 = np.ones((1, 64), np.float32)
    h = _chunked(a, b, h0, chunks)
    want = 0.5 ** np.arange(1, 17, dtype=np.float64)[None, :, None]
    assert float(np.max(np.abs(h - want))) < 1e-6


@pytest.mark.parametrize("chunks", [1, 2, 8])
def test_chunked_composition_bf16_matches_jax_ref(chunks):
    """bf16 a, b: float32 carry, bf16 output on both sides."""
    a, b, h0 = _inputs(2, 200, 128, seed=5)
    ta, tb = torch.from_numpy(a).bfloat16(), torch.from_numpy(b).bfloat16()
    out = rglru_scan_chunked(ta, tb, torch.from_numpy(h0), -(-200 // chunks))
    ref = jax_scan(jnp.asarray(ta.float().numpy(), jnp.bfloat16),
                   jnp.asarray(tb.float().numpy(), jnp.bfloat16),
                   jnp.asarray(h0), impl="ref")
    assert out.dtype == torch.bfloat16
    err = np.max(np.abs(out.float().numpy() - np.asarray(ref, np.float32)))
    assert float(err) < 3e-2


@pytest.mark.parametrize("S", [1, 7, 16, 17, 100, 511, 512, 520, 1024, 4096, 5000])
def test_scan_plan_covers_every_step_once(S):
    """Chunks of at most 64 steps, at most 8 a round (the portable cluster),
    every step in exactly one chunk; at least 16 steps a chunk where S has
    them."""
    plan = ops.scan_plan(S)
    assert 1 <= plan.clusters <= ops.MAX_CLUSTER and 1 <= plan.chunk <= ops.MAX_CHUNK
    n = plan.clusters * plan.rounds
    assert (n - 1) * plan.chunk < S <= n * plan.chunk
    assert plan.chunk >= min(S, ops.MIN_CHUNK)
    a, b, h0 = _inputs(1, S, 16, seed=6)             # the kernel's chunks, on the CPU
    out = rglru_scan_chunked(*map(torch.from_numpy, (a, b, h0)), plan.chunk)
    assert float(np.max(np.abs(out.numpy() - _jax_ref(a, b, h0)))) < 2e-5


def test_scan_plan_at_the_serving_shape_and_the_kernel_source():
    from pathlib import Path
    assert ops.scan_plan(512) == ops.ScanPlan(8, 64, 1)     # recurrentgemma-2b prefill
    assert ops.scan_plan(1) == ops.ScanPlan(1, 1, 1)
    assert ops.scan_plan(8) == ops.ScanPlan(1, 8, 1)        # the reduced configs' prompt
    with pytest.raises(ValueError):
        ops.scan_plan(0)
    source = (Path(ops.__file__).parent / "csrc" / "rglru_scan.cu").read_text()
    assert f"constexpr int MAX_CHUNK = {ops.MAX_CHUNK};" in source
    assert f"constexpr int MAX_CLUSTER = {ops.MAX_CLUSTER};" in source
    assert "cudaLaunchAttributeClusterDimension" in source
    assert "st.shared::cluster" in source and "bulk_load(" in source


def test_bulk_copies_need_16_byte_rows_strides_and_bases():
    a = torch.zeros(4, 512, 2560)
    assert ops.bulk_copies(a, a)                                  # the serving shape
    assert ops.bulk_copies(a.bfloat16(), a.bfloat16())
    assert not ops.bulk_copies(torch.zeros(2, 7, 33), torch.zeros(2, 7, 33))   # 132-byte rows
    assert not ops.bulk_copies(a[..., 1:2049], a[..., 1:2049])    # base off by 4 bytes
    t = torch.zeros(40, 3, 96).transpose(0, 1)                    # batch and seq swapped
    assert ops.bulk_copies(t, t)
    odd = torch.zeros(3, 40, 97)[..., :96]                        # 388-byte seq stride
    assert not ops.bulk_copies(odd, odd)
    one = torch.zeros(1, 1, 4 * 16 + 3)[..., :64]                 # size-1 dims: any stride
    assert ops.bulk_copies(one, one)
