"""Port parity: repro_torch flash_attention (plain version, CPU tensors) vs the
JAX package's flash attention at impl="interpret" (the Pallas kernel run by
the interpreter) and impl="ref", and vs the model's chunked attention.

float32 throughout; tolerance 2e-5, the JAX package's own kernel tolerance
(tests/test_kernels.py): the sums run in a different order on each side.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.ops import flash_attention as jax_flash  # noqa: E402
from repro.models.attention import chunked_causal_attention  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
TOL = 2e-5

SWEEP = [  # tests/test_kernels.py flash sweep
    (2, 256, 4, 2, 128, 0),
    (1, 512, 4, 4, 128, 0),
    (2, 256, 8, 2, 128, 128),
    (1, 256, 2, 1, 128, 64),      # MQA + window
]


def _inputs(B, S, H, K, hd, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, hd), dtype=np.float32),
            rng.standard_normal((B, S, K, hd), dtype=np.float32),
            rng.standard_normal((B, S, K, hd), dtype=np.float32))


def _port(q, k, v, **kw):
    return ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), **kw).numpy()


def _maxerr(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))))


@pytest.mark.parametrize("impl", ["interpret", "ref"])
@pytest.mark.parametrize("B,S,H,K,hd,win", SWEEP)
def test_flash_plain_matches_jax_kernel(B, S, H, K, hd, win, impl):
    q, k, v = _inputs(B, S, H, K, hd)
    before = ops.flash_attention.launches
    out = _port(q, k, v, window=win)
    ref = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    impl=impl, window=win, block_q=128, block_k=128)
    assert out.shape == (B, S, H, hd) and out.dtype == np.float32
    assert _maxerr(out, ref) < TOL
    assert ops.flash_attention.launches == before   # CPU tensors never launch


@pytest.mark.parametrize("B,S,H,K,hd,win", SWEEP)
def test_flash_plain_matches_model_chunked_attention(B, S, H, K, hd, win):
    q, k, v = _inputs(B, S, H, K, hd, seed=1)
    ref = chunked_causal_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), jnp.arange(S), window=win)
    assert _maxerr(_port(q, k, v, window=win), ref) < TOL


@pytest.mark.parametrize("S,causal,win", [(200, True, 0), (500, True, 96),
                                          (130, False, 0)])
def test_flash_plain_ragged_and_noncausal_match_jax_ref(S, causal, win):
    q, k, v = _inputs(1, S, 4, 2, 128, seed=2)
    ref = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    impl="ref", causal=causal, window=win)
    assert _maxerr(_port(q, k, v, causal=causal, window=win), ref) < TOL


@pytest.mark.parametrize("S,win", [(200, 0), (200, 64)])
def test_flash_plain_head_dim_256_group_10_matches_jax_ref(S, win):
    """recurrentgemma-2b's heads: 10 query heads over 1 kv head, head_dim 256."""
    q, k, v = _inputs(2, S, 10, 1, 256, seed=3)
    ref = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    impl="ref", window=win)
    assert _maxerr(_port(q, k, v, window=win), ref) < TOL


def test_flash_wrapper_rejects_bad_inputs():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 16, 4, 2, 128))
    with pytest.raises(ValueError):
        ops.flash_attention(q, k[:, :8], v[:, :8])
    with pytest.raises(ValueError):
        ops.flash_attention(q[:, :, :3], k, v)          # 3 heads over 2 kv heads
    with pytest.raises(ValueError):
        ops.flash_attention(q, k.double(), v)
