"""Port parity: repro_torch mlstm_chunk (plain version, CPU tensors) vs the JAX
package's chunkwise mLSTM kernel at impl="interpret" (the Pallas kernel run by
the interpreter) and impl="ref", and vs ``mlstm_chunkwise`` with its final
state and an initial state, including odd chunks from the divisor loop.

float32 throughout; tolerance rel 1e-4 of max|ref|, the JAX package's own
kernel tolerance (tests/test_kernels.py): sums run in another order.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.mlstm_chunk.ops import mlstm_chunk as jax_mlstm  # noqa: E402
from repro.models.xlstm import mlstm_chunkwise  # noqa: E402
from repro_torch.kernels.mlstm_chunk import ops  # noqa: E402
from repro_torch.kernels.mlstm_chunk.ref import chunk_size  # noqa: E402

REL = 1e-4

SWEEP = [  # tests/test_kernels.py mlstm sweep: (B, S, H, dqk, dv, chunk)
    (1, 256, 2, 128, 256, 128),
    (2, 512, 4, 128, 128, 128),
    (1, 256, 2, 256, 512, 64),
]


def _inputs(B, S, H, dqk, dv, seed=0):
    """As the JAX kernel test draws them: k scaled by 1/sqrt(dqk), forget
    gates log_sigmoid(N(0,1) + 2)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, dqk), dtype=np.float32)
    k = (rng.standard_normal((B, S, H, dqk)) / np.sqrt(dqk)).astype(np.float32)
    v = rng.standard_normal((B, S, H, dv), dtype=np.float32)
    il = rng.standard_normal((B, S, H), dtype=np.float32)
    x = rng.standard_normal((B, S, H)).astype(np.float32) + 2.0
    fl = (-np.logaddexp(0.0, -x)).astype(np.float32)
    return q, k, v, il, fl


def _rel(out, ref):
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    return float(np.max(np.abs(out - ref))) / max(float(np.max(np.abs(ref))), 1e-9)


def _port(arrays, **kw):
    return ops.mlstm_chunk(*(torch.from_numpy(a) for a in arrays), **kw)


@pytest.mark.parametrize("impl", ["interpret", "ref"])
@pytest.mark.parametrize("B,S,H,dqk,dv,chunk", SWEEP)
def test_mlstm_plain_matches_jax_kernel(B, S, H, dqk, dv, chunk, impl):
    arrays = _inputs(B, S, H, dqk, dv)
    before = ops.mlstm_chunk.launches
    out = _port(arrays, chunk=chunk)
    ref = jax_mlstm(*(jnp.asarray(a) for a in arrays), impl=impl, chunk=chunk)
    assert out.shape == (B, S, H, dv) and out.dtype == torch.float32
    assert _rel(out.numpy(), ref) < REL
    assert ops.mlstm_chunk.launches == before     # CPU tensors never launch


@pytest.mark.parametrize("S,chunk", [(512, 256), (40, 256), (511, 256), (37, 16),
                                     (64, 64)])
def test_mlstm_plain_state_matches_model_chunkwise(S, chunk):
    """h and the final (C, n, m) at the model's chunk; 511 -> 73, 37 -> 1."""
    arrays = _inputs(2, S, 2, 32, 48, seed=S)
    h, (C, n, m) = _port(arrays, chunk=chunk, return_state=True)
    h_ref, (C_ref, n_ref, m_ref) = mlstm_chunkwise(
        *(jnp.asarray(a) for a in arrays), chunk=chunk, return_state=True)
    assert C.shape == (2, 2, 32, 48) and n.shape == (2, 2, 32) and m.shape == (2, 2)
    for got, want in ((h, h_ref), (C, C_ref), (n, n_ref), (m, m_ref)):
        assert got.dtype == torch.float32
        assert _rel(got.numpy(), want) < REL


def test_mlstm_plain_initial_state_matches_model_chunkwise():
    first = _inputs(1, 24, 2, 16, 32, seed=1)
    second = _inputs(1, 30, 2, 16, 32, seed=2)
    _, state = _port(first, chunk=8, return_state=True)
    _, jstate = mlstm_chunkwise(*(jnp.asarray(a) for a in first), chunk=8,
                                return_state=True)
    h, (C, n, m) = ops.mlstm_chunk_reference(
        *(torch.from_numpy(a) for a in second), chunk=10, initial_state=state,
        return_state=True)
    h_ref, (C_ref, n_ref, m_ref) = mlstm_chunkwise(
        *(jnp.asarray(a) for a in second), chunk=10, initial_state=jstate,
        return_state=True)
    for got, want in ((h, h_ref), (C, C_ref), (n, n_ref), (m, m_ref)):
        assert _rel(got.numpy(), want) < REL


@pytest.mark.parametrize("S,chunk,want", [(512, 256, 256), (40, 256, 40),
                                          (511, 256, 73), (37, 256, 37),
                                          (37, 16, 1), (100, 64, 50)])
def test_chunk_size_follows_the_model_divisor_loop(S, chunk, want):
    assert chunk_size(S, chunk) == want


def test_mlstm_wrapper_rejects_bad_inputs():
    q, k, v, il, fl = (torch.from_numpy(a) for a in _inputs(1, 16, 2, 8, 8))
    with pytest.raises(ValueError):
        ops.mlstm_chunk(q, k[:, :8], v, il, fl)
    with pytest.raises(ValueError):
        ops.mlstm_chunk(q, k, v, il[:, :, :1], fl)
    with pytest.raises(ValueError):
        ops.mlstm_chunk(q, k.double(), v, il, fl)
    with pytest.raises(ValueError):
        ops.mlstm_chunk(q, k, v, il, fl, chunk=0)
