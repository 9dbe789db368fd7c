"""Plain float32 xLSTM, as the port runs it: the benchmark's reference for
the ``xlstm`` family.

Frozen copies, taken at commit 02043fe, of the formulas of
``src/repro_torch/models/xlstm.py`` and ``models/model.py`` (pre-norm
blocks ``x + mixer(norm(x))``, LayerNorm, a final norm and an untied head),
``kernels/mlstm_chunk/ref.py`` (``mlstm_chunk_reference``: the chunkwise
mLSTM with the stabiliser m from 0, the denominator floored at exp(-m_j))
and ``kernels/slstm_scan/ref.py`` (``slstm_cell``: per-head block-diagonal
recurrent products, exponential gating, the normaliser floored at 1e-6). It
imports nothing of the program. Every product goes through ``mm``, so the
same code gives the float32 reference and the float8 control.

The xLSTM paper (arXiv:2405.04517) projects q, k and v block-diagonally; the
port, like the JAX package, projects them densely, which is what is run and
checked here (2.87 G parameters at xlstm-1.3b's widths, not ~1.3 B).
"""
from __future__ import annotations

import functools
import json
import math
from typing import List, Optional

import torch
import torch.nn.functional as F

from portbench.core import work
from portbench.reference.common import (F32, Leaf, Matmul, Params, checkpointed, dense,
                                        headnorm, layernorm, matmul, norm_leaves, select)

CHUNK = 256                 # the model's mLSTM chunk
NEG_INF = -1e30
FLOOR = 1e-6                # the sLSTM normaliser's floor


def layer_kinds(cfg: dict) -> List[str]:
    p = list(cfg["block_pattern"])
    reps = (cfg["num_layers"] + len(p) - 1) // len(p)
    return (p * reps)[: cfg["num_layers"]]


def mlstm_dims(cfg: dict):
    """(inner, heads, dqk, dv) of an mLSTM block."""
    inner = int(cfg["d_model"] * cfg["mlstm_proj_factor"])
    H = cfg["num_heads"]
    dv = inner // H
    return inner, H, dv // 2, dv


def leaves(cfg: dict) -> List[Leaf]:
    """Every parameter, in draw order, with the xLSTM paper's init (the
    official code's ``small_init``, ``wang_init`` and gate inits): every
    dense kernel that reads the residual stream, the embedding and the head
    normal with std √(2 / 5d); the blocks' output projections (mLSTM
    ``w_down``, sLSTM ``w_ff_down``) normal with std 2 / (L √d); the mLSTM's
    input- and forget-gate kernels zero, the input-gate bias normal·0.1 and
    the forget-gate bias from 3 to 6 over the heads; the causal conv
    normal·1/√width, the sLSTM's recurrent matrices normal·1/√dh; zero biases
    elsewhere, LayerNorm ones and zeros, out_scale ones. (The port's own
    ``init_params`` draws every kernel normal·1/√in with zero gate biases;
    at 48 blocks its forward is chaotic: see PERF.md.)"""
    d, V, L = cfg["d_model"], cfg["vocab_size"], cfg["num_layers"]
    dt = cfg["param_dtype"]
    small = math.sqrt(2.0 / (5.0 * d))
    wang = 2.0 / (L * math.sqrt(d))
    out = [Leaf("embed.table", (V, d), dt, "normal", small)]
    for i, kind in enumerate(layer_kinds(cfg)):
        p = f"layers.{i}."
        out += norm_leaves(p + "pre_norm", d)
        if kind == "mlstm":
            inner, H, dqk, dv = mlstm_dims(cfg)
            K = cfg["conv_width"]
            out += [Leaf(p + "mixer.conv_w", (K, inner), dt, "normal", 1.0 / math.sqrt(K)),
                    Leaf(p + "mixer.conv_b", (inner,), dt, "zeros"),
                    Leaf(p + "mixer.out_scale", (H, dv), "float32", "ones")]
            out += dense(p + "mixer.w_up", d, inner, dt, std=small)
            out += dense(p + "mixer.w_gate", d, inner, dt, std=small)
            out += dense(p + "mixer.w_q", inner, H * dqk, dt, std=small)
            out += dense(p + "mixer.w_k", inner, H * dqk, dt, std=small)
            out += dense(p + "mixer.w_v", inner, H * dv, dt, std=small)
            out += [Leaf(p + "mixer.w_i.kernel", (inner, H), "float32", "zeros"),
                    Leaf(p + "mixer.w_i.bias", (H,), "float32", "normal", 0.1),
                    Leaf(p + "mixer.w_f.kernel", (inner, H), "float32", "zeros"),
                    Leaf(p + "mixer.w_f.bias", (H,), "float32", "linspace", span=(3.0, 6.0))]
            out += dense(p + "mixer.w_down", inner, d, dt, std=wang)
        elif kind == "slstm":
            H = cfg["num_heads"]
            dh = d // H
            ff = int(d * cfg["slstm_proj_factor"])
            out += [Leaf(p + "mixer.rec", (4, H, dh, dh), "float32", "normal",
                         1.0 / math.sqrt(dh)),
                    Leaf(p + "mixer.out_scale", (H, dh), "float32", "ones")]
            for g in ("z", "i", "f", "o"):
                out += dense(p + f"mixer.w_{g}", d, d, dt, bias=True, std=small)
            out += dense(p + "mixer.w_ff_up", d, ff, dt, std=small)
            out += dense(p + "mixer.w_ff_down", ff, d, dt, std=wang)
        else:
            raise ValueError(f"the xlstm reference has no block {kind!r}")
    out += norm_leaves("final_norm", d)
    out += dense("head", d, V, dt, std=small)
    return out


# ---------------------------------------------------------------- mLSTM


def _chunk_gates(ic, fc, m):
    c = ic.shape[-1]
    causal = torch.tril(torch.ones((c, c), dtype=torch.bool, device=ic.device))
    b = torch.cumsum(fc, dim=-1)
    btot = b[..., -1]
    log_d = b[..., :, None] - b[..., None, :] + ic[..., None, :]
    log_d = torch.where(causal, log_d, torch.full_like(log_d, NEG_INF))
    m_inter = b + m[..., None]
    m_j = torch.maximum(log_d.amax(dim=-1), m_inter)
    g = btot[..., None] - b + ic
    m_state = torch.maximum(btot + m, g.amax(dim=-1))
    return (m_j, torch.exp(log_d - m_j[..., None]), torch.exp(m_inter - m_j),
            torch.exp(g - m_state[..., None]), torch.exp(btot + m - m_state), m_state)


def mlstm_chunkwise(q, k, v, i_log, f_log, mm: Matmul = matmul):
    """q, k [B,S,H,dqk]; v [B,S,H,dv]; gates [B,S,H]; float32 -> h [B,S,H,dv].
    The chunk is the model's where it divides S; otherwise the inputs are
    padded at the end to a multiple of it (causal: the padding changes no
    earlier output), where the model would shrink the chunk instead: the same
    function, in fewer chunks."""
    B, S0, H, dqk = q.shape
    dv = v.shape[-1]
    c = min(CHUNK, S0)
    S = -(-S0 // c) * c
    if S != S0:
        q, k, v, i_log, f_log = (F.pad(x, (0, 0) * (x.dim() - 2) + (0, S - S0))
                                 for x in (q, k, v, i_log, f_log))
    T = S // c

    def split(x):
        tail = tuple(x.shape[3:])
        x = x.reshape((B, T, c, H) + tail)
        return x.permute((1, 0, 3, 2) + tuple(range(4, 4 + len(tail))))

    qs, ks, vs, il, fl = (split(x) for x in (q, k, v, i_log, f_log))
    C = q.new_zeros((B, H, dqk, dv))
    n = q.new_zeros((B, H, dqk))
    m = q.new_zeros((B, H))
    hs = []
    for t in range(T):
        qc, kc, vc = qs[t], ks[t], vs[t]
        m_j, d_mat, dec_q, dec_k, decay, m_state = _chunk_gates(il[t], fl[t], m)
        w = mm(qc, kc.transpose(-1, -2)) * d_mat
        h_inter = mm(qc, C) * dec_q[..., None]
        n_inter = (qc * n[..., None, :]).sum(dim=-1) * dec_q
        num = mm(w, vc) + h_inter
        den = torch.abs((qc * mm(w, kc)).sum(dim=-1) + n_inter)
        hs.append(num / torch.maximum(den, torch.exp(-m_j))[..., None])
        kd = kc * dec_k[..., None]
        C = C * decay[..., None, None] + mm(kd.transpose(-1, -2), vc)
        n = n * decay[..., None] + kd.sum(dim=-2)
        m = m_state
    h = torch.stack(hs)                                     # [T,B,H,c,dv]
    return h.permute(1, 0, 3, 2, 4).reshape(B, S, H, dv)[:, :S0]


def causal_conv(u, w, b):
    """Depthwise causal conv over time: u [B,S,C], w [K,C], b [C]."""
    K = w.shape[0]
    out = u * w[K - 1]
    for j in range(1, K):
        out = out + F.pad(u, (0, 0, j, 0))[:, :-j] * w[K - 1 - j]
    return out + b


def mlstm_block(P: Params, p: str, x, cfg: dict, mm: Matmul):
    _, H, dqk, dv = mlstm_dims(cfg)
    B, S, _ = x.shape
    xu = mm(x, P[p + "w_up.kernel"])
    g = mm(x, P[p + "w_gate.kernel"])
    xc = F.silu(causal_conv(xu, P[p + "conv_w"], P[p + "conv_b"]))
    q = mm(xc, P[p + "w_q.kernel"]).reshape(B, S, H, dqk)
    k = mm(xc, P[p + "w_k.kernel"]).reshape(B, S, H, dqk) / math.sqrt(dqk)
    v = mm(xu, P[p + "w_v.kernel"]).reshape(B, S, H, dv)
    i_log = mm(xc, P[p + "w_i.kernel"]) + P[p + "w_i.bias"]
    f_log = F.logsigmoid(mm(xc, P[p + "w_f.kernel"]) + P[p + "w_f.bias"])
    h = headnorm(mlstm_chunkwise(q, k, v, i_log, f_log, mm), P[p + "out_scale"])
    h = (h * F.silu(g).reshape(h.shape)).reshape(g.shape)
    return mm(h, P[p + "w_down.kernel"])


# ---------------------------------------------------------------- sLSTM


def _loop(step, S: int, graphed: bool) -> None:
    """Call ``step`` S times, or, on the card, run it once (the warm-up that
    capture wants), capture it as a CUDA graph of its plain operations and
    return the graph, which the caller replays S times after resetting the
    buffers the warm-up advanced: a launch a step, not one an operation."""
    if not graphed:
        for _ in range(S):
            step()
        return
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()                          # warm-up, on a side stream as capture wants
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        step()
    return graph


def _recurrent(h, rec_t, mm: Matmul):
    """The recurrent products of h [B,H,dh] with rec_t [H,dh,4dh] -> [B,4,H,dh]."""
    B, H, dh = h.shape
    return mm(h.transpose(0, 1), rec_t).view(H, B, 4, dh).permute(1, 2, 0, 3)


def _cell(pre, c, n, m):
    """One step from the gate pre-activations pre [B,4,H,dh] and the state
    (c, n [B,H,dh], m [B,H]): (h, c, n, m, z, o, i_log, f_raw), the input
    and forget gates per head (the mean over the head's columns)."""
    z = torch.tanh(pre[:, 0])
    o = torch.sigmoid(pre[:, 3])
    g = pre[:, 1:3].mean(dim=-1)
    i_log, f_raw = g[:, 0], g[:, 1]
    f_log = F.logsigmoid(f_raw)
    m_new = torch.maximum(f_log + m, i_log)
    ibar = torch.exp(i_log - m_new)[..., None]
    fbar = torch.exp(f_log + m - m_new)[..., None]
    c_new = torch.addcmul(fbar * c, ibar, z)
    n_new = fbar * n + ibar
    return o * c_new / n_new.clamp_min(FLOOR), c_new, n_new, m_new, z, o, i_log, f_raw


def _recurrence(xz, xi, xf, xo, rec, mm: Matmul, saved: bool):
    """The loop from a zero state: h [B,S,H,dh] and, with ``saved``, each
    step's c, n, z, o and (i_log, f_raw, m) for the backward. A step reads
    its inputs and writes its outputs at the step index ``t`` (a tensor), so
    every step is the same operations on the same buffers."""
    B, S, H, dh = xz.shape
    rec_t = rec.permute(1, 2, 0, 3).reshape(H, dh, 4 * dh)
    x = torch.stack((xz, xi, xf, xo), dim=2)                 # [B,S,4,H,dh]
    h, c, n = (xz.new_zeros((B, H, dh)) for _ in range(3))
    m = xz.new_zeros((B, H))
    t = torch.zeros((1,), dtype=torch.long, device=xz.device)
    hs = xz.new_empty((B, S, H, dh))
    keep = [xz.new_empty((B, S, H, dh)) for _ in range(4)] + [xz.new_empty((B, S, H, 3))]

    def step():
        pre = x.index_select(1, t)[:, 0] + _recurrent(h, rec_t, mm)
        h_new, c_new, n_new, m_new, z, o, i_log, f_raw = _cell(pre, c, n, m)
        c.copy_(c_new)
        n.copy_(n_new)
        h.copy_(h_new)
        m.copy_(m_new)
        hs.index_copy_(1, t, h[:, None])
        if saved:
            for buf, v in zip(keep, (c, n, z, o, torch.stack((i_log, f_raw, m), dim=-1))):
                buf.index_copy_(1, t, v[:, None])
        t.add_(1)

    graph = _loop(step, S, xz.is_cuda)
    if graph is not None:
        for buf in (h, c, n, m, t):
            buf.zero_()
        for _ in range(S):
            graph.replay()
    return hs, (tuple(keep) if saved else None)


def slstm_autograd(xz, xi, xf, xo, rec, mm: Matmul = matmul):
    """The same steps (``_recurrent``, ``_cell``) as a plain loop that
    autograd records: the witness that ``_backward``'s reverse walk is the
    gradient of the loop (a launch an operation on the card, so the
    reference's own backward is ``_backward``)."""
    B, S, H, dh = xz.shape
    rec_t = rec.permute(1, 2, 0, 3).reshape(H, dh, 4 * dh)
    x = torch.stack((xz, xi, xf, xo), dim=2)
    h = c = n = xz.new_zeros((B, H, dh))
    m = xz.new_zeros((B, H))
    hs = []
    for t in range(S):
        h, c, n, m = _cell(x[:, t] + _recurrent(h, rec_t, mm), c, n, m)[:4]
        hs.append(h)
    return torch.stack(hs, dim=1)


def _half_where(a, b):
    """The share of max(a, b)'s gradient that goes to a: 1, 0, or half at a tie."""
    return torch.where(a > b, 1.0, torch.where(a == b, 0.5, 0.0)).to(a.dtype)


def _backward(rec, h, saved, dh):
    """dxz, dxi, dxf, dxo [B,S,H,dh] and drec from the saved steps (a zero
    initial state); the formulas of ``slstm_scan_backward_reference`` and
    ``recurrent_grad``, walked in reverse with the step index a tensor (as
    ``_recurrence``)."""
    B, S, H, D = h.shape
    c_all, n_all, z_all, o_all, gates = saved
    pad = lambda v: torch.cat((v.new_zeros(v[:, :1].shape), v), dim=1)   # step -1: zeros
    c_pad, n_pad, m_pad = pad(c_all), pad(n_all), pad(gates[..., 2])
    w_zo = torch.cat((rec[0], rec[3]), dim=-1).transpose(1, 2)     # [H, 2D, D]
    rsum_i, rsum_f = rec[1].sum(dim=-1), rec[2].sum(dim=-1)        # [H, D]
    dc, dn, dh_rec = (h.new_zeros((B, H, D)) for _ in range(3))
    dm = h.new_zeros((B, H))
    t = torch.full((1,), S - 1, dtype=torch.long, device=h.device)
    dx = [torch.empty_like(h) for _ in range(4)]
    at = lambda v: v.index_select(1, t)[:, 0]

    def step():
        c_prev, n_prev, m_prev = at(c_pad[:, :-1]), at(n_pad[:, :-1]), at(m_pad[:, :-1])
        c, n, z, o = at(c_all), at(n_all), at(z_all), at(o_all)
        i_log, f_raw, m = at(gates).unbind(-1)
        f_log = F.logsigmoid(f_raw)
        ib = torch.exp(i_log - m)[..., None]
        fb = torch.exp(f_log + m_prev - m)[..., None]
        g = at(dh) + dh_rec
        nd = n.clamp_min(FLOOR)
        do = g * c / nd
        dct = dc + g * o / nd
        dnt = dn + -g * o * c / (nd * nd) * _half_where(n, FLOOR)
        dpz = dct * ib * (1 - z * z)
        dpo = do * o * (1 - o)
        dib = (dct * z + dnt).sum(dim=-1)
        dfb = (dct * c_prev + dnt * n_prev).sum(dim=-1)
        dc.copy_(dct * fb)
        dn.copy_(dnt * fb)
        d_i, d_f = dib * ib[..., 0], dfb * fb[..., 0]
        dm_new = dm - d_i - d_f
        w = _half_where(f_log + m_prev, i_log)
        dil = d_i + dm_new * (1 - w)
        dfl = d_f + dm_new * w
        dm.copy_(d_f + dm_new * w)
        dpi = (dil / D)[..., None]
        dpf = (dfl * torch.sigmoid(-f_raw) / D)[..., None]
        for buf, v in zip(dx, (dpz, dpi.expand_as(dpz), dpf.expand_as(dpz), dpo)):
            buf.index_copy_(1, t, v[:, None])
        zo = torch.cat((dpz, dpo), dim=-1).transpose(0, 1)          # [H, B, 2D]
        dh_rec.copy_(torch.bmm(zo, w_zo).transpose(0, 1) + dpi * rsum_i + dpf * rsum_f)
        t.sub_(1)

    graph = _loop(step, S, h.is_cuda)
    if graph is not None:
        for buf in (dc, dn, dh_rec, dm):
            buf.zero_()
        t.fill_(S - 1)
        for _ in range(S):
            graph.replay()
    h_prev = torch.cat((h.new_zeros((B, 1, H, D)), h[:, :-1]), dim=1)
    lhs = h_prev.permute(2, 3, 0, 1).reshape(H, D, B * S)
    rhs = torch.stack(dx).permute(0, 3, 1, 2, 4).reshape(4, H, B * S, D)
    return (*dx, torch.matmul(lhs, rhs))


class _SLSTM(torch.autograd.Function):
    """The recurrence with its explicit backward: the loop runs once forward
    with nothing recorded, and once in reverse for the gradients."""

    @staticmethod
    def forward(ctx, xz, xi, xf, xo, rec, mm):
        h, saved = _recurrence(xz, xi, xf, xo, rec, mm, saved=True)
        ctx.save_for_backward(rec, h, *saved)
        return h

    @staticmethod
    def backward(ctx, dh):
        rec, h, *saved = ctx.saved_tensors
        return (*_backward(rec, h, saved, dh), None)


def slstm_recurrence(xz, xi, xf, xo, rec, mm: Matmul):
    """x* [B,S,H,dh] float32 from a zero state -> h [B,S,H,dh]. Under
    autograd the explicit backward gives the gradients (the float8 control's
    backward products stay float32)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (xz, xi, xf, xo, rec)):
        return _SLSTM.apply(xz, xi, xf, xo, rec, mm)
    return _recurrence(xz, xi, xf, xo, rec, mm, saved=False)[0]


def slstm_block(P: Params, p: str, x, cfg: dict, mm: Matmul):
    H = cfg["num_heads"]
    B, S, d = x.shape
    shape = (B, S, H, d // H)
    xs = [(mm(x, P[p + f"w_{g}.kernel"]) + P[p + f"w_{g}.bias"]).reshape(shape)
          for g in ("z", "i", "f", "o")]
    h = slstm_recurrence(*xs, P[p + "rec"], mm)
    h = headnorm(h, P[p + "out_scale"]).flatten(-2)
    up = mm(h, P[p + "w_ff_up.kernel"])
    return mm(F.gelu(up, approximate="tanh"), P[p + "w_ff_down.kernel"])


# ---------------------------------------------------------------- model


def forward(P: Params, tokens: torch.Tensor, cfg: dict, mm: Matmul = matmul,
            remat: bool = False, keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """tokens [B, S] -> float32 logits [B, S, V] (at the positions ``keep``
    [B, n] only, where given). ``remat`` recomputes each block in the
    backward pass."""
    x = P["embed.table"][tokens].to(F32)
    for i, kind in enumerate(layer_kinds(cfg)):
        p = f"layers.{i}."
        block = mlstm_block if kind == "mlstm" else slstm_block

        def run(x, p=p, block=block):
            h = layernorm(x, P[p + "pre_norm.scale"], P[p + "pre_norm.bias"])
            return mm.carry(x + block(P, p + "mixer.", h, cfg, mm))
        x = checkpointed(run, remat)(x)
    x = layernorm(select(x, keep), P["final_norm.scale"], P["final_norm.bias"])
    return mm(x, P["head.kernel"])


def loss(P: Params, batch: dict, cfg: dict, z_loss: float, mm: Matmul = matmul,
         remat: bool = True):
    from portbench.reference.common import cross_entropy
    logits = forward(P, batch["tokens"], cfg, mm, remat)
    return cross_entropy(logits, batch["labels"], z_loss)[0]


@functools.lru_cache(maxsize=None)
def _matmul_weights(key: str) -> int:
    cfg = json.loads(key)
    return sum(math.prod(leaf.shape) for leaf in leaves(cfg)
               if leaf.name.endswith(".kernel") or leaf.name.endswith(".rec"))


def matmul_weights(cfg: dict) -> int:
    """The weights that enter a product (the input embedding is a lookup)."""
    return _matmul_weights(json.dumps(cfg, sort_keys=True))


def model_flops(cfg: dict, phase: str, B: int, S: int) -> float:
    """Model FLOPs (PaLM, appendix B: 2 a weight a token forward, 3x that
    trained; recomputation not counted) of one call: ``train`` or
    ``prefill`` over [B, S], or ``decode`` of B tokens. The weights are every
    dense kernel and the sLSTM's recurrent matrices (the input embedding is a
    lookup); the mLSTM adds its chunkwise work (``work.mlstm`` forward) in a
    prefill or train step and its state update and read-out (4 dqk dv a head)
    in a decode step."""
    n_mat = matmul_weights(cfg)
    _, H, dqk, dv = mlstm_dims(cfg)
    n_mlstm = layer_kinds(cfg).count("mlstm")
    if phase == "decode":
        return float(2 * n_mat * B + n_mlstm * 4 * B * H * dqk * dv)
    fwd = 2 * n_mat * B * S + n_mlstm * work.mlstm(B, S, H, dqk, dv,
                                                   work.chunk_size(S, CHUNK))[0]
    return float(3 * fwd if phase == "train" else fwd)
