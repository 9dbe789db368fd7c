"""RG-LRU recurrent block (Griffin / RecurrentGemma), counterpart of
``repro.models.rglru``.

Recurrence (per channel), with c = 8:

    r_t = sigmoid(W_r u_t + b_r),  i_t = sigmoid(W_i u_t + b_i)
    log a_t = -c * softplus(Lambda) * r_t
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t)

wrapped in Griffin's gated branch: ``w_out(gelu(w_gate_in x) * h)`` with
``u`` the width-4 causal conv of ``w_rnn_in x``. Parameter names are the JAX
pytree's leaf names, so ``repro_torch.convert`` copies them by name; ``lam``
is float32 whatever ``param_dtype`` is, as in JAX.

The train-mode and prefill recurrences go through the port's ``rglru_scan``
(on the card the CUDA kernel, with its backward kernel when training) with
float32 ``a`` and ``b``. The decode step is plain
PyTorch, as the JAX package has no kernel there either, and it updates the
cache dict in place: ``h`` and ``conv`` are replaced.

Under tensor parallelism (train mode) the channels are cut over the model
group: ``w_gate_in`` and ``w_rnn_in`` are column-parallel, the conv and
``lam`` hold the rank's W / model channels, the gate matrices ``w_rg`` and
``w_ig`` are row-parallel [W, W] (their product is all-reduced, then the
rank keeps its channels), the scan runs on [B, S, W / model] and
``w_out`` is row-parallel.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.rglru_scan.ops import rglru_scan
from repro_torch.models.layers import Dense, _empty, activation
from repro_torch.models.xlstm import _normal, causal_conv
from repro_torch.sharding.partitioning import NONE

Cache = Dict[str, torch.Tensor]
_C = 8.0


def init_rglru_cache(cfg: ModelConfig, batch: int, *, dtype=torch.bfloat16,
                     device=None) -> Cache:
    w = cfg.lru_width
    return {"h": torch.zeros((batch, w), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.conv_width - 1, w), dtype=dtype,
                                device=device)}


class RGLRUBlock(nn.Module):
    mp = NONE

    def __init__(self, cfg: ModelConfig, *, dtype, device):
        super().__init__()
        w, d = cfg.lru_width, cfg.d_model
        self.cfg = cfg
        self.w_gate_in = Dense(d, w, dtype=dtype, device=device)
        self.w_rnn_in = Dense(d, w, dtype=dtype, device=device)
        self.rg_conv_w = _empty((cfg.conv_width, w), dtype, device)
        self.rg_conv_b = _empty((w,), dtype, device)
        self.w_rg = Dense(w, w, bias=True, dtype=dtype, device=device)
        self.w_ig = Dense(w, w, bias=True, dtype=dtype, device=device)
        self.lam = _empty((w,), torch.float32, device)
        self.w_out = Dense(w, d, dtype=dtype, device=device)
        self.act = activation(cfg.act)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Dense kernels normal·1/√in, zero biases and rg_conv_b, rg_conv_w
        normal·1/√conv_width, and ``lam`` so that a = exp(-c·softplus(lam))
        is U(0.9, 0.999) (``init_rglru_block``)."""
        for dense in (self.w_gate_in, self.w_rnn_in, self.w_rg, self.w_ig, self.w_out):
            dense.reset_parameters(generator)
        _normal(self.rg_conv_w, generator, 1.0 / math.sqrt(self.rg_conv_w.shape[0]))
        self.rg_conv_b.zero_()
        a = torch.rand(self.lam.shape, generator=generator, dtype=torch.float32,
                       device=self.lam.device) * (0.999 - 0.9) + 0.9
        self.lam.copy_(torch.log(torch.expm1(-torch.log(a) / _C)))

    def _gates(self, u: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """u [..., W] -> float32 (a, b) of the recurrence h = a h + b. The
        dense products run in u's dtype, the rest in float32."""
        r = torch.sigmoid(self._channels(self.w_rg(u), u).float())
        i = torch.sigmoid(self._channels(self.w_ig(u), u).float())
        log_a = -_C * F.softplus(self.lam) * r
        a = torch.exp(log_a)
        multiplier = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12))
        return a, multiplier * i * u.float()

    def _channels(self, y: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """A gate's product, replicated after the all-reduce, narrowed to
        the rank's channels where u holds a block of them."""
        return self.mp.split(y, -1) if u.shape[-1] < y.shape[-1] else y

    def forward(self, x: torch.Tensor, seq_cut: bool = False) -> torch.Tensor:
        """Train mode (``rglru_block_forward``): x [B,S,D] -> [B,S,D], the
        scan from a zero state (``seq_cut``: ``Dense.forward``'s)."""
        gate = self.act(self.w_gate_in(x))
        u = causal_conv(self.w_rnn_in(x), self.rg_conv_w, self.rg_conv_b)
        a, b = self._gates(u)
        h = rglru_scan(a, b, torch.zeros_like(b[:, 0]))        # float32
        return self.w_out(gate * h.to(x.dtype), seq_cut)

    def prefill(self, x: torch.Tensor, max_len: int = 0) -> Tuple[torch.Tensor, Cache]:
        """x [B,S,D] -> (y [B,S,D], cache) from a zero state
        (``rglru_block_prefill``). The cache holds the last float32 h and the
        last conv_width-1 pre-conv inputs (zeros before the start);
        ``max_len`` is unused (the recurrent state has a fixed size)."""
        gate = self.act(self.w_gate_in(x))
        u0 = self.w_rnn_in(x)
        u = causal_conv(u0, self.rg_conv_w, self.rg_conv_b)
        a, b = self._gates(u)
        h = rglru_scan(a, b, torch.zeros_like(b[:, 0]))        # float32
        y = self.w_out(gate * h.to(x.dtype))
        keep = self.cfg.conv_width - 1
        conv = F.pad(u0, (0, 0, max(keep - u0.shape[1], 0), 0))[:, -keep:].clone()
        return y, {"h": h[:, -1].clone(), "conv": conv}

    def decode(self, x: torch.Tensor, cache: Cache,
               cur_pos: int = 0) -> Tuple[torch.Tensor, Cache]:
        """One token, x [B,1,D] (``rglru_block_decode``): the conv over the
        cached inputs in float32, then one recurrence step. Replaces the
        cache's ``h`` and ``conv`` in place; ``cur_pos`` is unused."""
        xt = x[:, 0]
        gate = self.act(self.w_gate_in(xt))
        u_t = self.w_rnn_in(xt)
        hist = torch.cat([cache["conv"], u_t[:, None]], dim=1)   # [B, cw, W]
        conv = (hist.float() * self.rg_conv_w.float()).sum(dim=1).to(xt.dtype) \
            + self.rg_conv_b.to(xt.dtype)
        a, b = self._gates(conv)
        h = a * cache["h"] + b
        cache["h"] = h
        cache["conv"] = hist[:, 1:]
        return self.w_out(gate * h.to(xt.dtype))[:, None], cache
