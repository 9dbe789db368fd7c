"""Sort-based top-k Mixture-of-Experts, capacity-bounded and dropping
(counterpart of ``repro.models.moe``).

Tokens are cut into ``G`` groups. In each group a float32 router picks each
token's ``top_k`` experts, the (token, expert) pairs are sorted by expert
(a stable sort), and each expert takes its first ``cap`` pairs into a
``[E, cap, D]`` buffer; later pairs are dropped. Every expert then runs its
gated MLP over its whole buffer (``torch.bmm``, the products the JAX package
computes outside any Pallas kernel), and each token sums its kept pairs'
outputs, weighted by their renormalised router probabilities.

Two things differ in form from the JAX code, not in what they compute:

* a dropped pair is written to a spare row ``cap`` of a ``[E, cap + 1, D]``
  buffer that is cut off before the products, and read back from a zero row
  appended after them (JAX's ``mode="drop"`` / ``mode="fill"``): nothing
  indexes out of bounds;
* the combine sums each token's ``top_k`` outputs one after another in
  ascending expert order, the order in which JAX's ``out.at[token].add``
  visits the sorted pairs, instead of a scatter-add, whose atomics on the
  card would sum in another order from run to run. The output is the same
  bits on every call.

Under tensor parallelism the experts are cut as ``param_specs`` says.
Expert-TP: ``wi_gate``/``wi_up`` on the ffn dim and ``wo`` on its input
dim over the model group; the buffer enters the cut, and the experts'
output is all-reduced before the combine (``moe_ff``). Expert parallelism
(``expert_parallel``): the expert dim over the data group; each data rank
routes its own tokens (one group), the ``[G, E, cap, D]`` buffer goes
through an all-to-all over the data group so that each rank runs its
experts on every group's slots, and a second all-to-all sends the outputs
back (``moe_ep_buf``, ``moe_ep_ff``). Routing, dispatch and the combine are
the same code, in the same order, on every layout.

Auxiliary losses, as JAX: ``moe_lb`` (Switch load balance,
``E * sum(mean prob * mean assignments) / top_k``) and ``moe_z`` (router
z-loss, the mean squared log-sum-exp of the router logits).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.models.layers import Dense, _empty, activation
from repro_torch.sharding.partitioning import NONE

Coords = Tuple[torch.Tensor, ...]


def capacity(tokens_per_group: int, m: MoEConfig) -> int:
    """Slots an expert has in a group: ``tokens * top_k * capacity_factor /
    experts`` rounded up to a multiple of 8, at least 8 (``_capacity``)."""
    cap = int(math.ceil(tokens_per_group * m.top_k * m.capacity_factor
                        / m.num_experts))
    return max(8, ((cap + 7) // 8) * 8)


def num_groups(tokens: int, requested: int, m: MoEConfig) -> int:
    """The groups ``moe_forward`` cuts ``tokens`` into: ``requested`` (else
    the config's, else 1), at most ``tokens``, lowered until it divides
    them."""
    G = max(1, min(requested or m.num_groups or 1, tokens))
    while tokens % G:
        G -= 1
    return G


def dispatch(xg: torch.Tensor, probs: torch.Tensor, eidx: torch.Tensor,
             num_experts: int, cap: int) -> Tuple[torch.Tensor, Coords]:
    """Sort-based dispatch in each group (``_dispatch_group`` over G).

    xg [G, n, D]; probs, eidx [G, n, k]. Returns the expert buffer
    ``[G, E, cap, D]`` and, for each pair in sorted order ``[G, n*k]``: its
    token, expert, slot (``cap`` if dropped), whether it is kept, and its
    probability."""
    G, n, k = eidx.shape
    flat_e = eidx.reshape(G, n * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = flat_e.gather(1, order)
    experts = torch.arange(num_experts, device=xg.device).expand(G, num_experts)
    starts = torch.searchsorted(sorted_e, experts.contiguous())
    pos_sorted = torch.arange(n * k, device=xg.device) - starts.gather(1, sorted_e)
    keep = pos_sorted < cap
    token_sorted = order // k
    pos_safe = torch.where(keep, pos_sorted, cap)
    src = torch.take_along_dim(xg, token_sorted[..., None], dim=1)
    group = torch.arange(G, device=xg.device)[:, None].expand(G, n * k)
    buf = xg.new_zeros(G, num_experts, cap + 1, xg.shape[-1])
    buf = buf.index_put((group, sorted_e, pos_safe), src)[:, :, :cap]
    probs_sorted = probs.reshape(G, n * k).gather(1, order)
    return buf, (token_sorted, sorted_e, pos_safe, keep, probs_sorted)


def combine(yb: torch.Tensor, coords: Coords, k: int) -> torch.Tensor:
    """Each token's kept outputs times their probabilities, summed in
    ascending expert order (``_combine_group`` over G): yb [G, E, cap, D] ->
    [G, n, D]."""
    token_sorted, sorted_e, pos_safe, keep, probs_sorted = coords
    G, nk = token_sorted.shape
    group = torch.arange(G, device=yb.device)[:, None].expand(G, nk)
    gathered = F.pad(yb, (0, 0, 0, 1))[group, sorted_e, pos_safe]    # slot cap: zeros
    gathered = gathered * (keep * probs_sorted)[..., None].to(yb.dtype)
    # a stable sort by token keeps each token's pairs in ascending expert order
    by_token = torch.argsort(token_sorted, dim=-1, stable=True)
    parts = torch.take_along_dim(gathered, by_token[..., None], dim=1)
    parts = parts.reshape(G, nk // k, k, -1)
    out = parts[:, :, 0]
    for j in range(1, k):
        out = out + parts[:, :, j]
    return out


class MoE(nn.Module):
    """``moe.router.kernel`` [D, E] (float32), ``moe.wi_gate`` and
    ``moe.wi_up`` [E, D, F], ``moe.wo`` [E, F, D] (``param_dtype``): the JAX
    leaves and layout."""
    mp = NONE

    def __init__(self, cfg: ModelConfig, *, dtype, device):
        super().__init__()
        m = cfg.moe
        d, e, f = cfg.d_model, m.num_experts, m.d_ff_expert
        self.m = m
        self.router = Dense(d, e, dtype=torch.float32, device=device)
        self.wi_gate = _empty((e, d, f), dtype, device)
        self.wi_up = _empty((e, d, f), dtype, device)
        self.wo = _empty((e, f, d), dtype, device)
        self.act = activation(cfg.act)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """As ``init_moe``: normal · 1/√D (1/√F for ``wo``), drawn in float32
        one leaf at a time on the leaf's device, stored in its dtype."""
        self.router.reset_parameters(generator)
        for w in (self.wi_gate, self.wi_up, self.wo):
            draw = torch.randn(w.shape, generator=generator, dtype=torch.float32,
                               device=w.device)
            w.copy_(draw.mul_(1.0 / math.sqrt(w.shape[1])))
            del draw

    def route(self, xf: torch.Tensor):
        """xf [G, n, D] -> float32 router logits and probabilities [G, n, E],
        and each token's top-k experts with their renormalised
        probabilities [G, n, k]."""
        logits = self.router(xf.float())
        probs = torch.softmax(logits, dim=-1)
        top_p, top_i = torch.topk(probs, self.m.top_k, dim=-1)
        return logits, probs, top_p / top_p.sum(dim=-1, keepdim=True), top_i

    def experts(self, buf: torch.Tensor) -> torch.Tensor:
        """Each expert's gated MLP over its slots: buf [G, E, cap, D] ->
        [G, E, cap, D]. The weights are cast only where they are not in the
        buffer's dtype already (in bf16 they are used as stored)."""
        mp = self.mp
        ep = self.wi_gate.shape[0] < self.m.num_experts
        tp = self.wi_gate.shape[-1] < self.m.d_ff_expert
        if ep:
            buf = mp.to_experts(buf)
        if tp:
            buf = mp.enter(buf)
        G, E, cap, D = buf.shape
        wg, wu, wo = (w.to(buf.dtype) for w in (self.wi_gate, self.wi_up, self.wo))
        xe = buf.transpose(0, 1).reshape(E, G * cap, D)
        h = self.act(torch.bmm(xe, wg)) * torch.bmm(xe, wu)
        out = torch.bmm(h, wo).reshape(E, G, cap, D).transpose(0, 1)
        if tp:
            out = mp.reduce(out)
        return mp.from_experts(out) if ep else out

    def forward(self, x: torch.Tensor, *, groups: int = 0, with_aux: bool = True,
                mean=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """x [B, S, D] -> (y [B, S, D], {"moe_lb", "moe_z"}) (``moe_forward``;
        ``groups`` is its ``num_groups``). Without ``with_aux`` the losses
        are not computed (prefill and decode drop them) and the dict is
        empty.

        ``mean``, where given, maps the experts' assignment shares ``ce``
        [E] of these tokens to their mean over every data-parallel rank's
        tokens (an all-reduce). The load-balance loss is then
        ``E * sum(me * mean(ce)) / top_k`` with this rank's ``me``: its mean
        over the ranks is the loss of the whole batch, and so is its
        gradient (``ce`` carries none), where every rank holds as many
        tokens."""
        m = self.m
        B, S, D = x.shape
        N = B * S
        G = num_groups(N, groups, m)
        n = N // G
        xf = x.reshape(G, n, D)
        logits, probs, top_p, top_i = self.route(xf)
        buf, coords = dispatch(xf, top_p, top_i, m.num_experts, capacity(n, m))
        y = combine(self.experts(buf), coords, m.top_k).reshape(B, S, D)
        if not with_aux:
            return y, {}
        E = m.num_experts
        me = probs.mean(dim=(0, 1))
        ce = F.one_hot(top_i, E).sum(dim=2).float().mean(dim=(0, 1))
        if mean is not None:
            ce = mean(ce)
        lb = E * torch.sum(me * ce) / m.top_k
        zl = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))
        return y, {"moe_lb": lb, "moe_z": zl}
