"""AdamW with float32 master weights and optional int8 gradient
quantize-dequantize (counterpart of ``repro.training.optimizer``).

A "tree" here is a dict of tensors keyed by the model's parameter names
(``dict(model.named_parameters())``); ``repro_torch.convert`` maps the keys
onto the JAX pytree's. One pass per leaf, as the JAX package's update. Unlike
the JAX functions, ``adamw_update`` updates the state's m, v and master and
the parameters in place: at full width a second copy of the ~35 GB of
float32 state would not fit beside the first on one card.
"""
from __future__ import annotations

from typing import Dict, Mapping, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import TrainConfig

Tree = Dict[str, torch.Tensor]


class OptState(NamedTuple):
    step: torch.Tensor         # int32 scalar
    m: Tree                    # float32
    v: Tree                    # float32
    master: Tree               # float32 master copy of the params


def init_opt_state(params: Mapping[str, torch.Tensor]) -> OptState:
    """Zero moments and an explicit float32 copy of each parameter."""
    with torch.no_grad():
        zeros = lambda: {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                         for k, p in params.items()}
        master = {k: p.detach().to(torch.float32, copy=True) for k, p in params.items()}
        step = torch.zeros((), dtype=torch.int32, device=next(iter(params.values())).device)
    return OptState(step, zeros(), zeros(), master)


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in tree.values()))


def quantize(x: torch.Tensor, peak: torch.Tensor) -> torch.Tensor:
    """Symmetric int8 quantize-dequantize of ``x`` at the scale of ``peak``,
    the largest magnitude of the tensor ``x`` is part of; rounds half to
    even (``torch.round``, as ``jnp.round``)."""
    scale = torch.clamp_min(peak, 1e-12) / 127.0
    q = torch.clamp(torch.round(x.float() / scale), -127, 127).to(torch.int8)
    return q.float() * scale


def quantize_int8(g: Mapping[str, torch.Tensor],
                  groups: Optional[Mapping[str, str]] = None) -> Tree:
    """Per-tensor symmetric int8 quantize-dequantize (``quantize``).
    ``groups`` maps each key to the tensor it is part of: leaves of one
    group share one scale, the largest magnitude over all of them, as the
    layers that the JAX model stacks into one leaf do
    (``models.model.jax_leaf``). A key it lacks is alone."""
    group = lambda k: groups.get(k, k) if groups else k
    peak: Dict[str, torch.Tensor] = {}
    for k, x in g.items():
        m = x.float().abs().max()
        peak[group(k)] = torch.maximum(peak.get(group(k), m), m)
    return {k: quantize(x, peak[group(k)]) for k, x in g.items()}


def clip_factor(gnorm: torch.Tensor, tcfg: TrainConfig):
    """The factor that clips gradients of global norm ``gnorm`` to
    ``grad_clip`` (1.0 where clipping is off)."""
    if tcfg.grad_clip <= 0:
        return 1.0
    return torch.clamp(tcfg.grad_clip / torch.clamp_min(gnorm, 1e-12), max=1.0)


def bias_corrections(step: torch.Tensor, tcfg: TrainConfig):
    """(1 - beta1^step, 1 - beta2^step) in float32."""
    def one(beta):
        return 1.0 - torch.pow(torch.tensor(beta, dtype=torch.float32, device=step.device),
                               step.float())
    return one(tcfg.beta1), one(tcfg.beta2)


@torch.no_grad()
def adamw_leaf(g: torch.Tensor, m: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
               clip, bc1, bc2, tcfg: TrainConfig) -> torch.Tensor:
    """One AdamW step of one leaf (or shard of one) in place on its float32
    m, v and master ``w``: the gradient scaled by ``clip``, bias corrections
    ``bc1``, ``bc2``, decoupled weight decay on the master. Returns ``w``."""
    b1, b2 = tcfg.beta1, tcfg.beta2
    g = g.float() * clip
    m.mul_(b1).add_(g, alpha=1 - b1)
    v.mul_(b2).add_(torch.square(g), alpha=1 - b2)
    delta = (m / bc1).div_(torch.sqrt(v / bc2).add_(tcfg.eps))
    delta.add_(w, alpha=tcfg.weight_decay)
    return w.sub_(delta, alpha=tcfg.learning_rate)


@torch.no_grad()
def adamw_update(opt: OptState, grads: Mapping[str, torch.Tensor],
                 params: Mapping[str, torch.Tensor], tcfg: TrainConfig,
                 groups: Optional[Mapping[str, str]] = None
                 ) -> Tuple[Mapping[str, torch.Tensor], OptState, dict]:
    """Returns (params, opt, {"grad_norm"}), after one step: the gradients
    clipped to ``grad_clip`` by their global norm, bias corrections in
    float32 from the incremented step, decoupled weight decay on the master,
    each parameter set to its master in its own dtype. m, v, master and the
    parameters are updated in place. ``groups`` is ``quantize_int8``'s."""
    if tcfg.grad_compression == "int8":
        grads = quantize_int8(grads, groups)
    gnorm = global_norm(grads)
    clip = clip_factor(gnorm, tcfg)
    step = opt.step + 1
    bc1, bc2 = bias_corrections(step, tcfg)
    for k, p in params.items():
        p.copy_(adamw_leaf(grads[k], opt.m[k], opt.v[k], opt.master[k], clip, bc1, bc2, tcfg))
    return params, OptState(step, opt.m, opt.v, opt.master), {"grad_norm": gnorm}
