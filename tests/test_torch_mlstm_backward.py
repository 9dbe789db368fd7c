"""The chunkwise mLSTM's backward formulas (``mlstm_chunk_backward_reference``,
what ``csrc/mlstm_chunk_bwd.cu`` computes) on the CPU, held against
``torch.autograd`` of the plain forward and against ``jax.vjp`` of
``repro.models.xlstm.mlstm_chunkwise``, the function JAX training
differentiates.

Cases: S a multiple of the chunk with three chunks, a chunk shrunk to a
divisor of S (60 at chunk 16 -> 15), one chunk (S 40 < 256), and dqk != dv.
Inputs are drawn as the JAX kernel test draws them (k / sqrt(dqk), forget
gates log_sigmoid(N(0, 1) + 2)), then scaled: q by ``q_scale`` and the input
gate shifted by ``i_shift``. A small q and a low input gate make the
denominator's floor ``exp(-m_j)`` win (``ref.floor_share``): at (1, 0) it wins
at 4-17% of the positions, at (0.3, -1) at 90-98%, so both branches of the
max are taken in every case, and the tests assert it.

Tolerances, each gradient held to a share of its own largest value:

* 2e-6 against autograd (the same float32 operations in another order;
  measured <= 5.9e-7);
* 1e-5 against ``jax.vjp`` (XLA's sums in another order, and JAX
  differentiates through the stabilisers; measured <= 2.2e-6);
* 1e-5 between autograd with the stabilisers ``m_j`` and ``m_state``
  detached and without (they cancel in exact arithmetic; measured <= 5.5e-7).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models.xlstm import mlstm_chunkwise  # noqa: E402
from repro_torch.kernels.mlstm_chunk import ops  # noqa: E402
from repro_torch.kernels.mlstm_chunk.ref import (  # noqa: E402
    floor_share, mlstm_chunk_backward_reference, mlstm_chunk_reference)

CASES = [  # (B, S, H, dqk, dv, chunk)
    (2, 96, 2, 16, 8, 32),       # three chunks
    (1, 60, 2, 8, 12, 16),       # chunk shrunk to 15
    (1, 40, 2, 16, 16, 256),     # one chunk
    (2, 64, 2, 16, 24, 16),      # dqk != dv, four chunks
]
SCALES = {"floor_at_some": (1.0, 0.0), "floor_at_most": (0.3, -1.0)}
NAMES = ("dq", "dk", "dv", "di", "df")


def _inputs(B, S, H, dqk, dv, q_scale, i_shift, seed=0):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((B, S, H, dqk)) * q_scale).astype(np.float32)
    k = (rng.standard_normal((B, S, H, dqk)) / np.sqrt(dqk)).astype(np.float32)
    v = rng.standard_normal((B, S, H, dv)).astype(np.float32)
    il = (rng.standard_normal((B, S, H)) + i_shift).astype(np.float32)
    x = rng.standard_normal((B, S, H)).astype(np.float32) + 2.0
    fl = (-np.logaddexp(0.0, -x)).astype(np.float32)
    dh = rng.standard_normal((B, S, H, dv)).astype(np.float32)
    return (q, k, v, il, fl), dh


def _autograd(arrays, dh, chunk, **kw):
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    h = mlstm_chunk_reference(*ts, chunk=chunk, **kw)
    return h.detach(), torch.autograd.grad(h, ts, torch.from_numpy(dh))


def _jax_vjp(arrays, dh, chunk):
    _, vjp = jax.vjp(lambda *a: mlstm_chunkwise(*a, chunk=chunk),
                     *(jnp.asarray(a) for a in arrays))
    return vjp(jnp.asarray(dh))


def _hold(got, want, tol):
    for name, g, w in zip(NAMES, got, want):
        g = np.asarray(g.detach() if isinstance(g, torch.Tensor) else g, np.float32)
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape, name
        err = np.abs(g - w).max() / np.abs(w).max()
        assert err <= tol, (name, err)


def _share(arrays, chunk):
    q, k, _, il, fl = (torch.from_numpy(a) for a in arrays)
    return floor_share(q, k, il, fl, chunk=chunk)


@pytest.mark.parametrize("scale", list(SCALES))
@pytest.mark.parametrize("B,S,H,dqk,dv,chunk", CASES)
def test_backward_formulas_match_autograd(B, S, H, dqk, dv, chunk, scale):
    arrays, dh = _inputs(B, S, H, dqk, dv, *SCALES[scale])
    h, want = _autograd(arrays, dh, chunk)
    got = mlstm_chunk_backward_reference(*(torch.from_numpy(a) for a in arrays), h,
                                         torch.from_numpy(dh), chunk=chunk)
    assert [g.dtype for g in got] == [torch.float32] * 5
    _hold(got, want, 2e-6)


@pytest.mark.parametrize("scale", list(SCALES))
@pytest.mark.parametrize("B,S,H,dqk,dv,chunk", CASES)
def test_backward_formulas_match_jax_vjp(B, S, H, dqk, dv, chunk, scale):
    """Both branches of the floor are taken: the share lies strictly
    between 0 and 1, near 1 at ``floor_at_most``."""
    arrays, dh = _inputs(B, S, H, dqk, dv, *SCALES[scale])
    share = _share(arrays, chunk)
    assert 0.0 < share < 1.0, share
    assert share > 0.85 if scale == "floor_at_most" else share < 0.25, share
    ts = [torch.from_numpy(a) for a in arrays]
    h = mlstm_chunk_reference(*ts, chunk=chunk)
    got = mlstm_chunk_backward_reference(*ts, h, torch.from_numpy(dh), chunk=chunk)
    _hold(got, _jax_vjp(arrays, dh, chunk), 1e-5)


@pytest.mark.parametrize("q_scale,i_shift", [(1.0, 0.0), (0.3, -1.0), (0.05, -3.0),
                                             (1.0, -6.0)])
def test_stabilisers_held_constant_give_the_same_gradient(q_scale, i_shift):
    """Autograd through the plain forward with m_j and m_state detached
    equals autograd through them, at floor shares from a few to all
    positions: the gradient through the stabilisers cancels."""
    arrays, dh = _inputs(2, 96, 2, 16, 8, q_scale, i_shift, seed=3)
    _, free = _autograd(arrays, dh, 32)
    _, held = _autograd(arrays, dh, 32, stabilisers_constant=True)
    _hold(held, free, 1e-5)


@pytest.mark.parametrize("B,S,H,dqk,dv,chunk", CASES)
def test_mlstm_chunk_under_autograd_takes_the_function_on_the_cpu(B, S, H, dqk, dv, chunk):
    """``ops.mlstm_chunk`` with inputs that require grad records
    ``MLSTMChunkFunction``, gives ``jax.vjp``'s gradients and launches no
    kernel; a state returned beside h is detached."""
    arrays, dh = _inputs(B, S, H, dqk, dv, *SCALES["floor_at_some"])
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    before = (ops.mlstm_chunk.launches, ops.mlstm_chunk_backward.launches)
    h, state = ops.mlstm_chunk(*ts, chunk=chunk, return_state=True)
    assert type(h.grad_fn).__name__ == "MLSTMChunkFunctionBackward"
    assert not any(t.requires_grad for t in state)
    got = torch.autograd.grad(h, ts, torch.from_numpy(dh))
    _hold(got, _jax_vjp(arrays, dh, chunk), 1e-5)
    assert (ops.mlstm_chunk.launches, ops.mlstm_chunk_backward.launches) == before


def test_mlstm_chunk_backward_checks_its_shapes():
    arrays, dh = _inputs(1, 32, 2, 8, 12, 1.0, 0.0)
    ts = [torch.from_numpy(a) for a in arrays]
    h = mlstm_chunk_reference(*ts, chunk=16)
    with pytest.raises(ValueError, match="h and dh"):
        ops.mlstm_chunk_backward(*ts, h, torch.from_numpy(dh)[:, :16], chunk=16)


# (B, S, H, dqk, dv, chunk, dtype) and the backward's scratch in float32
# slots, counted by hand from ``csrc/mlstm_chunk_bwd.cu``'s carving
WORKSPACE_CASES = [
    # tensor cores: B H 2, T 2, four 64-row tiles (cp 256), one 256-column
    # tile of dqk and of dv, each part rounded up to 32 slots: 8 x [BH S]
    # gate terms, N, dden, row sums; [BH T] decays; [4, BH, S] column sums;
    # [1, BH, S] x 2 row dots; [1 x 1, BH, T] and [1, BH, T] dots; [BH (T -
    # 1) dqk] x 2 n_t, dn_t; C_t, G_t hi and lo, [2, BH (T - 1), dqk, dv]
    # bf16 each; dS, W' hi and lo, [2, BH T, cp, cp] bf16 each
    ((1, 512, 2, 64, 128, 256, torch.bfloat16),
     8 * 1024 + 32 + 4096 + 2 * 1024 + 32 + 32 + 2 * 128 + 2 * 16384 + 2 * 262144),
    # CUDA cores: [BH S] x (8 + 4 column sums + 2 x 1 row dots), [BH T] x (1 +
    # 1 x 2 + 1), C and G with n (float32 [BH T dqk (dv + 1)] each), dS and
    # W (float32 [BH S c] each)
    ((1, 512, 2, 64, 128, 256, torch.float32),
     1024 * 14 + 4 * 4 + 2 * 4 * 64 * 129 + 2 * 1024 * 256),
    ((1, 512, 2, 48, 128, 256, torch.bfloat16),      # bf16 below 64 wide
     1024 * 14 + 4 * 4 + 2 * 4 * 48 * 129 + 2 * 1024 * 256),
]


@pytest.mark.parametrize("shape,floats", WORKSPACE_CASES)
def test_backward_workspace_follows_the_path(shape, floats):
    *dims, dtype = shape
    assert ops.workspace_floats(*dims, dtype) == floats


def test_backward_path_is_chosen_on_dtype_and_widths():
    bf16, f32 = torch.bfloat16, torch.float32
    assert ops.backward_path(bf16, 512, 1024) == "tensor_cores"
    assert ops.backward_path(bf16, 64, 64) == "tensor_cores"
    assert [ops.backward_path(bf16, *w) for w in ((48, 128), (64, 32), (1024, 64))] == \
        ["cuda_cores"] * 3
    assert ops.backward_path(f32, 512, 1024) == "cuda_cores"


def test_backward_on_meta_reports_the_tensor_core_work():
    """bf16 on ``meta`` takes the tensor-core path up to the launch: the
    scratch of ``workspace_floats`` in the peak, no launch, and the work
    of the design as built (each [c, dqk] x [c, dv] product of the two walks
    and the three inter terms twice, over the T - 1 chunk boundaries; over
    the causal pairs the scores and dP once, the three products with dS or
    W' twice; the vector terms), written out here."""
    from repro_torch.cost.analysis import CostCounter
    B, S, H, dqk, dv, c = 1, 512, 2, 64, 128, 256
    T, pairs = S // c, c * (c + 1) // 2
    meta = lambda *s, dtype=torch.bfloat16: torch.empty(s, dtype=dtype, device="meta")  # noqa: E731
    ins = (meta(B, S, H, dqk), meta(B, S, H, dqk), meta(B, S, H, dv),
           meta(B, S, H, dtype=torch.float32), meta(B, S, H, dtype=torch.float32))
    before = ops.mlstm_chunk_backward.launches
    with CostCounter() as counter:
        grads = ops.mlstm_chunk_backward(*ins, meta(B, S, H, dv), meta(B, S, H, dv), chunk=c)
    assert [(g.shape, g.dtype) for g in grads] == [(t.shape, t.dtype) for t in ins]
    per_head = ((T - 1) * (20 * c * dqk * dv + 10 * c * dqk)
                + T * (pairs * (10 * dqk + 6 * dv) + 2 * c * dv))
    detail = counter.totals()["kernel_detail"]["mlstm_chunk_backward"]
    assert (detail["launches"], detail["flops"]) == (1, B * H * per_head)
    assert counter.totals()["peak_bytes"] >= 4 * WORKSPACE_CASES[0][1]
    assert ops.mlstm_chunk_backward.launches == before
