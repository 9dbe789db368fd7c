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


# The card's bf16 path runs two passes: a state pass that carries C through
# the chunks on the tensor cores, dec_k k entering the product as a bf16
# pair hi + lo, and leaves the state at the start of every interior chunk
# (C in bf16, n in float32); then an output pass that computes each chunk's
# h on its own from that state, with W rounded to bf16 for the W v product.
# Rehearsed here in plain PyTorch (used by these tests only):

def _bf16(x):
    return x.to(torch.bfloat16).float()


def _chunk_gates(il, fl, m_prev):
    """b, btot, the next m and dec_k of one chunk ([B,H,c] gates)."""
    b = torch.cumsum(fl, dim=-1)
    btot = b[..., -1]
    g = btot[..., None] - b + il
    m_state = torch.maximum(btot + m_prev, g.amax(-1))
    return b, btot, m_state, torch.exp(g - m_state[..., None])


def _two_pass_mlstm(q, k, v, il, fl, chunk):
    B, S, H, dqk = q.shape
    c = chunk_size(S, chunk)
    T = S // c

    def split(x):                                  # [B,S,H,*] -> [T,B,H,c,*]
        x = x.float().reshape(B, T, c, H, *x.shape[3:])
        return x.permute(1, 0, 3, 2, *range(4, x.dim()))

    qs, ks, vs, ils, fls = (split(x) for x in (q, k, v, il, fl))
    # pass 1: boundary states
    C = torch.zeros(B, H, dqk, v.shape[-1])
    n = torch.zeros(B, H, dqk)
    m = torch.zeros(B, H)
    starts = []
    for t in range(T):
        starts.append((_bf16(C), n.clone(), m.clone()))
        _, btot, m_state, dec_k = _chunk_gates(ils[t], fls[t], m)
        decay = torch.exp(btot + m - m_state)
        kd = ks[t] * dec_k[..., None]
        hi = _bf16(kd)
        lo = _bf16(kd - hi)
        C = C * decay[..., None, None] + (hi.transpose(-1, -2) @ vs[t]
                                          + lo.transpose(-1, -2) @ vs[t])
        n = n * decay[..., None] + kd.sum(-2)
        m = m_state
    # pass 2: each chunk from its start state
    causal = torch.tril(torch.ones(c, c, dtype=torch.bool))
    hs = []
    for t in range(T):
        C_prev, n_prev, m_prev = starts[t]
        b, _, _, _ = _chunk_gates(ils[t], fls[t], m_prev)
        a = ils[t] - b                                        # i_l - b_l
        z = torch.maximum(torch.cummax(a, dim=-1).values, m_prev[..., None])  # m_j - b_j
        dec_q = torch.exp(m_prev[..., None] - z)
        s = qs[t] @ ks[t].transpose(-1, -2)
        w = torch.where(causal, s * torch.exp(a[..., None, :] - z[..., None]),
                        torch.zeros_like(s))
        num = (qs[t] @ C_prev) * dec_q[..., None] + _bf16(w) @ vs[t]
        den = (w * s).sum(-1) + (qs[t] @ n_prev[..., None])[..., 0] * dec_q
        hs.append(num / torch.maximum(den.abs(), torch.exp(-(b + z)))[..., None])
    h = torch.stack(hs).permute(1, 0, 3, 2, 4).reshape(B, S, H, -1)
    return h, (C, n, m)


@pytest.mark.parametrize("B,S,H,dqk,dv,chunk", [
    (1, 256, 2, 128, 256, 128),          # tests/test_kernels.py shapes
    (2, 256, 2, 64, 96, 64),             # a ragged dv tile
    (1, 146, 2, 64, 128, 73),            # chunk 73, as 511 gives at full width
    (1, 192, 1, 128, 64, 256),           # one chunk: no interior state
])
def test_two_pass_bf16_mlstm_matches_model_chunkwise_and_jax_ref(B, S, H, dqk, dv, chunk):
    """bf16 inputs (the same rounded values on both sides); h within 3e-2 of
    max|h| and the state within rel 1e-3, the card's bf16 tolerances."""
    arrays = list(_inputs(B, S, H, dqk, dv, seed=dqk + dv))
    for i in range(3):                   # q, k, v as bf16 values
        arrays[i] = _bf16(torch.from_numpy(arrays[i])).numpy()
    h, (C, n, m) = _two_pass_mlstm(*(torch.from_numpy(a) for a in arrays), chunk)
    h_ref, (C_ref, n_ref, m_ref) = mlstm_chunkwise(
        *(jnp.asarray(a) for a in arrays), chunk=chunk, return_state=True)
    assert _rel(h.numpy(), h_ref) < 3e-2
    for got, want in ((C, C_ref), (n, n_ref), (m, m_ref)):
        assert _rel(got.numpy(), want) < 1e-3
    c = chunk_size(S, chunk)
    ref = jax_mlstm(*(jnp.asarray(a) for a in arrays), impl="ref", chunk=c)
    assert _rel(h.numpy(), ref) < 3e-2


def test_two_pass_state_keeps_float32_accuracy_through_the_bf16_pair():
    """dec_k k as hi + lo keeps C within 1e-5 of float32, where its one bf16
    rounding would cost ~2^-9 a term."""
    arrays = [torch.from_numpy(a) for a in _inputs(1, 256, 2, 64, 128, seed=7)]
    _, (C, _, _) = _two_pass_mlstm(*arrays, 64)
    _, (C_ref, _, _) = ops.mlstm_chunk_reference(*arrays, chunk=64, return_state=True)
    assert _rel(C.numpy(), C_ref.numpy()) < 1e-5


# The bf16 kernels' tensor maps (ops.tensor_map_plans): planned on CPU tensors.

def _bf16_zeros(*shape):
    return torch.zeros(*shape, dtype=torch.bfloat16)


def test_mlstm_tensor_map_plans_at_the_serving_shape():
    B, S, H, dqk, dv = 4, 512, 4, 512, 1024
    q, v = _bf16_zeros(B, S, H, dqk), _bf16_zeros(B, S, H, dv)
    c_scr = _bf16_zeros(B * H, dqk, dv)
    plans = ops.tensor_map_plans(q, q, v, c_scr)
    assert [p.dims for p in plans] == [(dqk, H, S, B), (dqk, H, S, B), (dv, H, S, B),
                                       (dv, 1, dqk, B * H)]
    assert plans[3].strides == (2 * dv, 2 * dv, 2 * dqk * dv)
    assert all(p.box == (64, 1, ops.BLOCK, 1) for p in plans)
    h, gates = _bf16_zeros(B, S, H, dv), torch.zeros(B, S, H)
    args = list(ops.bf16_kernel_args(q, q, v, gates, gates, h, c_scr))
    assert len(args) == ops.PLANS * 11 + 9
    assert args[-9:] == [*gates.stride(), *gates.stride(), *h.stride()[:3]]
    one_chunk = list(ops.bf16_kernel_args(q, q, v, gates, gates, h, None))
    assert one_chunk[33:44] == [0] * 11      # no interior state, no map


def test_mlstm_tensor_map_plans_take_a_ragged_dv_and_reject_what_tma_cannot_take():
    q = _bf16_zeros(1, 64, 2, 128)
    ragged = ops.tensor_map_plans(q, q, _bf16_zeros(1, 64, 2, 96), None)[2]
    assert ragged.dims == (96, 2, 64, 1) and ragged.strides[0] == 192
    n = 64 * 2 * 128
    bad = {
        "16-byte aligned base": _bf16_zeros(n + 8)[1:n + 1].view(1, 64, 2, 128),
        "multiples of 16": _bf16_zeros(1, 64, 2 * 100)[..., :200].unflatten(-1, (2, 100)),
        "contiguous head dim": _bf16_zeros(1, 64, 2, 256)[..., ::2],
        "bfloat16": torch.zeros(1, 64, 2, 128),
    }
    for why, t in bad.items():
        with pytest.raises(ValueError, match=why):
            ops.tensor_map_plans(t, q, q, None)
        with pytest.raises(ValueError, match=why):
            ops.tensor_map_plans(q, q, t, None)
    with pytest.raises(ValueError, match="multiples of 16"):
        ops.tensor_map_plans(q, q, q, _bf16_zeros(2, 128, 100))


def test_mlstm_plan_constants_name_the_kernel_source():
    from pathlib import Path
    source = (Path(ops.__file__).parent / "csrc" / "mlstm_chunk.cu").read_text()
    header = (Path(ops.__file__).parents[1] / "common" / "hopper.cuh").read_text()
    assert "constexpr int TMA_PLAN_VALUES = 11;" in header
    assert f"constexpr int TC_BM = {ops.BLOCK};" in source
    assert f"constexpr int MAX_DQK = {ops.MAX_DQK};" in source
    assert f"constexpr int MAX_C = {ops.MAX_CHUNK};" in source
    for kernel in ("mlstm_state_kernel", "mlstm_out_kernel", "mlstm_chunk_kernel"):
        assert f"{kernel}(" in source
