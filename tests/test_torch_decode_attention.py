"""Port parity: repro_torch decode_attention (plain version, CPU tensors) vs the
JAX package's decode attention at impl="interpret" and impl="ref".

float32; tolerance 2e-5, the JAX package's own kernel tolerance
(tests/test_kernels.py): the sums run in a different order on each side.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attention.ops import decode_attention as jax_decode  # noqa: E402
from repro_torch.kernels.decode_attention import ops  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
TOL = 2e-5


def _inputs(B, H, K, hd, L, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, hd), dtype=np.float32),
            rng.standard_normal((B, L, K, hd), dtype=np.float32),
            rng.standard_normal((B, L, K, hd), dtype=np.float32))


def _check(q, ck, cv, sp, cur, win, impl):
    before = ops.decode_attention.launches
    out = ops.decode_attention(torch.from_numpy(q), torch.from_numpy(ck),
                               torch.from_numpy(cv), torch.from_numpy(sp),
                               cur, window=win).numpy()
    kw = {"block_k": 256} if impl == "interpret" else {}
    ref = np.asarray(jax_decode(jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv),
                                jnp.asarray(sp), cur, window=win, impl=impl, **kw))
    assert out.shape == q.shape and out.dtype == np.float32
    assert float(np.max(np.abs(out - ref))) < TOL
    assert ops.decode_attention.launches == before   # CPU tensors never launch


@pytest.mark.parametrize("impl", ["interpret", "ref"])
@pytest.mark.parametrize("B,H,K,hd,L,win,fill", [  # tests/test_kernels.py sweep
    (2, 8, 2, 128, 1024, 0, 1024),
    (2, 8, 4, 128, 1024, 0, 700),       # partially-filled cache
    (1, 4, 1, 128, 512, 256, 512),      # MQA ring window
    (1, 2, 2, 128, 512, 0, 512),
])
def test_decode_plain_matches_jax_kernel(B, H, K, hd, L, win, fill, impl):
    q, ck, cv = _inputs(B, H, K, hd, L)
    sp = np.where(np.arange(L) < fill, np.arange(L), -1).astype(np.int32)
    _check(q, ck, cv, sp, fill - 1, win, impl)


@pytest.mark.parametrize("impl", ["interpret", "ref"])
def test_decode_plain_wrapped_ring_cache(impl):
    """A 256-slot ring after 700 tokens: slot s holds the newest p = s mod 256."""
    L, cur, win = 256, 699, 256
    q, ck, cv = _inputs(2, 8, 2, 128, L, seed=1)
    sp = np.array([max(p for p in range(cur + 1) if p % L == s)
                   for s in range(L)], np.int32)
    _check(q, ck, cv, sp, cur, win, impl)


@pytest.mark.parametrize("win,fill", [(0, 300), (128, 300)])
def test_decode_plain_head_dim_256_group_10_matches_jax_ref(win, fill):
    """recurrentgemma-2b's heads: 10 query heads over 1 kv head, head_dim 256;
    with a window smaller than the filled slots."""
    L = 320
    q, ck, cv = _inputs(2, 10, 1, 256, L, seed=2)
    sp = np.where(np.arange(L) < fill, np.arange(L), -1).astype(np.int32)
    _check(q, ck, cv, sp, fill - 1, win, "ref")


def test_decode_wrapper_rejects_bad_inputs():
    q, ck, cv = (torch.from_numpy(a) for a in _inputs(1, 4, 2, 128, 32))
    sp = torch.arange(32, dtype=torch.int32)
    with pytest.raises(ValueError):
        ops.decode_attention(q, ck, cv, sp[:16], 31)
    with pytest.raises(ValueError):
        ops.decode_attention(q[:, :3], ck, cv, sp, 31)
