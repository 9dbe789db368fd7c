"""xLSTM blocks: mLSTM (matrix memory, chunkwise-parallel) and sLSTM (scalar
memory, strictly sequential), counterpart of ``repro.models.xlstm``.

Stabilised exponential gating as in the xLSTM paper (arXiv:2405.04517): a
running max-state m keeps exp() arguments bounded, and the stored state is
the rescaled (C·e^{-m}, n·e^{-m}) pair, so decode and the chunkwise prefill
agree. Parameter names are the JAX pytree's leaf names, so
``repro_torch.convert`` copies them by name; ``w_i``/``w_f``, ``out_scale``
and ``rec`` are float32 whatever ``param_dtype`` is, as in JAX.

The mLSTM train forward and prefill go through the port's ``mlstm_chunk``
(on the card the CUDA kernels: the forward, which also returns the final
state for the cache, and under autograd the backward). The sLSTM
recurrence, in prefill, decode and the train forward and backward, goes
through ``slstm_scan`` (on the card one kernel launch a layer and call,
where the JAX package runs a ``lax.scan``). The mLSTM decode step is plain
PyTorch, as in JAX. Decode steps update the cache dict in place: ``C`` and
``n`` are rescaled and accumulated in their own storage, ``m`` and ``conv``
(and the sLSTM ``h, c, n, m``) are replaced.

Under tensor parallelism the mixers' own leaves are replicated
(``param_specs``' ``_XLSTM``): every rank of the model group computes the
recurrence whole on the same rows, and their gradients are each rank's own,
not summed over the group. Only the mLSTM ``w_down`` (row-parallel: the
rank's block of h) and the sLSTM ``w_ff_up``/``w_ff_down`` (column then
row, where the ffn width divides) are cut.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.mlstm_chunk.ops import mlstm_chunk
from repro_torch.kernels.slstm_scan.ops import slstm_scan
from repro_torch.models.layers import Dense, _empty, activation

Cache = Dict[str, torch.Tensor]
PREFILL_CHUNK = 256                  # the model's chunk, as in JAX


def mlstm_dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    """(inner, heads, dqk, dv) of an mLSTM block."""
    inner = int(cfg.d_model * cfg.mlstm_proj_factor)
    H = cfg.num_heads
    dv = inner // H
    return inner, H, dv // 2, dv


def causal_conv(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over time: u [B,S,C], w [K,C], b [C]."""
    K = w.shape[0]
    out = u * w[K - 1].to(u.dtype)
    for j in range(1, K):
        shifted = F.pad(u, (0, 0, j, 0))[:, :-j]
        out = out + shifted * w[K - 1 - j].to(u.dtype)
    return out + b.to(u.dtype)


def headnorm(h: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Per-head RMS norm in float32. h: [..., H, d]; scale [H, d]."""
    hf = h.float()
    var = hf.square().mean(dim=-1, keepdim=True)
    return (hf * torch.rsqrt(var + eps) * scale).to(h.dtype)


def _normal(param: nn.Parameter, generator: torch.Generator, std: float) -> None:
    w = torch.randn(param.shape, generator=generator, dtype=torch.float32,
                    device=param.device)
    param.copy_(w.mul_(std))


# ====================================================================== mLSTM


def init_mlstm_cache(cfg: ModelConfig, batch: int, *, dtype=torch.bfloat16,
                     device=None) -> Cache:
    inner, H, dqk, dv = mlstm_dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros((batch, H, dqk, dv), **f32),
            "n": torch.zeros((batch, H, dqk), **f32),
            "m": torch.zeros((batch, H), **f32),
            "conv": torch.zeros((batch, cfg.conv_width - 1, inner), dtype=dtype,
                                device=device)}


class MLSTMBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, *, dtype, device):
        super().__init__()
        inner, H, dqk, dv = mlstm_dims(cfg)
        d = cfg.d_model
        f32 = torch.float32
        self.cfg = cfg
        self.w_up = Dense(d, inner, dtype=dtype, device=device)
        self.w_gate = Dense(d, inner, dtype=dtype, device=device)
        self.conv_w = _empty((cfg.conv_width, inner), dtype, device)
        self.conv_b = _empty((inner,), dtype, device)
        self.w_q = Dense(inner, H * dqk, dtype=dtype, device=device)
        self.w_k = Dense(inner, H * dqk, dtype=dtype, device=device)
        self.w_v = Dense(inner, H * dv, dtype=dtype, device=device)
        self.w_i = Dense(inner, H, bias=True, dtype=f32, device=device)
        self.w_f = Dense(inner, H, bias=True, dtype=f32, device=device)
        self.out_scale = _empty((H, dv), f32, device)
        self.w_down = Dense(inner, d, dtype=dtype, device=device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Dense kernels normal·1/√in, conv_w normal·1/√conv_width, zero
        conv_b and biases, out_scale ones (``init_mlstm_block``)."""
        for dense in (self.w_up, self.w_gate, self.w_q, self.w_k, self.w_v,
                      self.w_i, self.w_f, self.w_down):
            dense.reset_parameters(generator)
        _normal(self.conv_w, generator, 1.0 / math.sqrt(self.conv_w.shape[0]))
        self.conv_b.zero_()
        self.out_scale.fill_(1.0)

    def _gate_and_qkvif(self, x: torch.Tensor):
        _, H, dqk, dv = mlstm_dims(self.cfg)
        B, S, _ = x.shape
        xu = self.w_up(x)
        g = self.w_gate(x)
        xc = F.silu(causal_conv(xu, self.conv_w, self.conv_b))
        q = self.w_q(xc).reshape(B, S, H, dqk)
        k = self.w_k(xc).reshape(B, S, H, dqk) / math.sqrt(dqk)
        v = self.w_v(xu).reshape(B, S, H, dv)
        i_log = self.w_i(xc.float())                              # [B,S,H]
        f_log = F.logsigmoid(self.w_f(xc.float()))
        return xu, g, q, k, v, i_log, f_log

    def _out(self, h: torch.Tensor, g: torch.Tensor, seq_cut: bool = False) -> torch.Tensor:
        """headnorm, the silu(gate) product and the down projection.
        h: [..., H, dv]; g: [..., inner] (``seq_cut``: ``Dense.forward``'s)."""
        h = headnorm(h, self.out_scale)
        h = (h * F.silu(g).reshape(h.shape)).reshape(g.shape)
        return self.w_down(h, seq_cut)

    def forward(self, x: torch.Tensor, seq_cut: bool = False) -> torch.Tensor:
        """Train mode (``mlstm_block_forward``): x [B,S,D] -> [B,S,D]; under
        autograd ``mlstm_chunk``'s backward kernel (the plain formulas on the
        CPU) gives the gradients."""
        _, g, q, k, v, i_log, f_log = self._gate_and_qkvif(x)
        return self._out(mlstm_chunk(q, k, v, i_log, f_log, chunk=PREFILL_CHUNK), g,
                         seq_cut)

    def prefill(self, x: torch.Tensor, max_len: int = 0) -> Tuple[torch.Tensor, Cache]:
        """x [B,S,D] -> (y [B,S,D], cache). The cache holds the final state
        and the last conv_width-1 up-projections (zeros before the start);
        ``max_len`` is unused (the recurrent state has a fixed size)."""
        xu, g, q, k, v, i_log, f_log = self._gate_and_qkvif(x)
        h, (C, n, m) = mlstm_chunk(q, k, v, i_log, f_log, chunk=PREFILL_CHUNK,
                                   return_state=True)
        keep = self.cfg.conv_width - 1
        conv = F.pad(xu, (0, 0, max(keep - xu.shape[1], 0), 0))[:, -keep:].clone()
        return self._out(h, g), {"C": C, "n": n, "m": m, "conv": conv}

    def decode(self, x: torch.Tensor, cache: Cache,
               cur_pos: int = 0) -> Tuple[torch.Tensor, Cache]:
        """One token, x [B,1,D]: the single-step recurrence
        (``mlstm_block_decode``), updating ``cache`` in place; ``cur_pos``
        is unused (no positions in the recurrence)."""
        _, H, dqk, dv = mlstm_dims(self.cfg)
        B = x.shape[0]
        xt = x[:, 0]
        xu = self.w_up(xt)                                        # [B, inner]
        g = self.w_gate(xt)
        hist = torch.cat([cache["conv"], xu[:, None]], dim=1)
        conv = (hist.float() * self.conv_w.float()).sum(dim=1) + self.conv_b.float()
        xc = F.silu(conv).to(xt.dtype)
        q = self.w_q(xc).reshape(B, H, dqk).float()
        k = (self.w_k(xc).reshape(B, H, dqk) / math.sqrt(dqk)).float()
        v = self.w_v(xu).reshape(B, H, dv).float()
        i_log = self.w_i(xc.float())                              # [B,H]
        f_log = F.logsigmoid(self.w_f(xc.float()))
        C, n, m = cache["C"], cache["n"], cache["m"]
        m_new = torch.maximum(f_log + m, i_log)
        fbar = torch.exp(f_log + m - m_new)
        ibar = torch.exp(i_log - m_new)
        kv = k[..., :, None] * v[..., None, :]
        C.mul_(fbar[..., None, None]).add_(kv.mul_(ibar[..., None, None]))
        n.mul_(fbar[..., None]).add_(ibar[..., None] * k)
        num = (q[..., None, :] @ C)[..., 0, :]                    # [B,H,dv]
        den = (q * n).sum(dim=-1).abs()
        h = num / torch.maximum(den, torch.exp(-m_new))[..., None]
        cache["m"] = m_new
        cache["conv"] = hist[:, 1:]
        return self._out(h.to(x.dtype), g)[:, None], cache


# ====================================================================== sLSTM


def init_slstm_cache(cfg: ModelConfig, batch: int, *, device=None) -> Cache:
    H = cfg.num_heads
    dh = cfg.d_model // H
    f32 = dict(dtype=torch.float32, device=device)
    return {"h": torch.zeros((batch, H, dh), **f32),
            "c": torch.zeros((batch, H, dh), **f32),
            "n": torch.zeros((batch, H, dh), **f32),
            "m": torch.zeros((batch, H), **f32)}


class SLSTMBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, *, dtype, device):
        super().__init__()
        d = cfg.d_model
        H = cfg.num_heads
        dh = d // H
        inner = int(d * cfg.slstm_proj_factor)
        self.cfg = cfg
        self.heads = (H, dh)
        self.w_z = Dense(d, d, bias=True, dtype=dtype, device=device)
        self.w_i = Dense(d, d, bias=True, dtype=dtype, device=device)
        self.w_f = Dense(d, d, bias=True, dtype=dtype, device=device)
        self.w_o = Dense(d, d, bias=True, dtype=dtype, device=device)
        self.rec = _empty((4, H, dh, dh), torch.float32, device)
        self.out_scale = _empty((H, dh), torch.float32, device)
        self.w_ff_up = Dense(d, inner, dtype=dtype, device=device)
        self.w_ff_down = Dense(inner, d, dtype=dtype, device=device)
        self.act = activation(cfg.act)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Dense kernels normal·1/√in, zero biases, rec normal·1/√dh,
        out_scale ones (``init_slstm_block``)."""
        for dense in (self.w_z, self.w_i, self.w_f, self.w_o, self.w_ff_up,
                      self.w_ff_down):
            dense.reset_parameters(generator)
        _normal(self.rec, generator, 1.0 / math.sqrt(self.rec.shape[-1]))
        self.out_scale.fill_(1.0)

    def _inputs(self, x: torch.Tensor):
        """x [..., D] -> the four float32 gate inputs [..., H, dh]."""
        shape = x.shape[:-1] + self.heads
        return tuple(w(x).float().reshape(shape)
                     for w in (self.w_z, self.w_i, self.w_f, self.w_o))

    def _out(self, h: torch.Tensor, dtype, seq_cut: bool = False) -> torch.Tensor:
        """h [B,S,H,dh] float32 -> headnorm, then the FFN (``seq_cut``:
        ``Dense.forward``'s)."""
        h = headnorm(h, self.out_scale).flatten(-2).to(dtype)
        return self.w_ff_down(self.act(self.w_ff_up(h)), seq_cut)

    def forward(self, x: torch.Tensor, seq_cut: bool = False) -> torch.Tensor:
        """Train mode (``slstm_block_forward``): x [B,S,D] -> [B,S,D]; under
        autograd ``slstm_scan``'s backward kernel (the plain formulas on the
        CPU) gives the gradients."""
        return self._out(self._recur(x)[0], x.dtype, seq_cut)

    def _recur(self, x: torch.Tensor) -> Tuple[torch.Tensor, Cache]:
        """The recurrence over S from a zero state (``slstm_scan``: one kernel
        launch on the card): h [B,S,H,dh] and the final state."""
        state = init_slstm_cache(self.cfg, x.shape[0], device=x.device)
        return slstm_scan(*self._inputs(x), self.rec, state)

    def prefill(self, x: torch.Tensor, max_len: int = 0) -> Tuple[torch.Tensor, Cache]:
        """x [B,S,D]: the recurrence over S from a zero state
        (``slstm_block_forward``); returns y and the final state.
        ``max_len`` is unused."""
        h, state = self._recur(x)
        return self._out(h, x.dtype), state

    def decode(self, x: torch.Tensor, cache: Cache,
               cur_pos: int = 0) -> Tuple[torch.Tensor, Cache]:
        """One token, x [B,1,D]: ``slstm_scan`` at S = 1 from the cache's
        state; the new state replaces the cache's entries. ``cur_pos`` is
        unused."""
        h, state = slstm_scan(*self._inputs(x), self.rec, cache)
        cache.update(state)
        return self._out(h, x.dtype), cache
