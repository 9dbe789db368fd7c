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
    with pytest.raises(ValueError):                   # neither the CPU nor CUDA
        ops.rglru_scan(a.to("meta"), b.to("meta"), h0.to("meta"))
