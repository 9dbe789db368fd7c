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


def quantize_int8(g: Mapping[str, torch.Tensor],
                  groups: Optional[Mapping[str, str]] = None) -> Tree:
    """Per-tensor symmetric int8 quantize-dequantize; rounds half to even
    (``torch.round``, as ``jnp.round``). ``groups`` maps each key to the
    tensor it is part of: leaves of one group share one scale, the largest
    magnitude over all of them, as the layers that the JAX model stacks into
    one leaf do (``models.model.jax_leaf``). A key it lacks is alone."""
    group = lambda k: groups.get(k, k) if groups else k
    peak: Dict[str, torch.Tensor] = {}
    for k, x in g.items():
        m = x.float().abs().max()
        peak[group(k)] = torch.maximum(peak.get(group(k), m), m)

    def one(k, x):
        xf = x.float()
        scale = torch.clamp_min(peak[group(k)], 1e-12) / 127.0
        q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
        return q.float() * scale
    return {k: one(k, x) for k, x in g.items()}


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
    clip = (torch.clamp(tcfg.grad_clip / torch.clamp_min(gnorm, 1e-12), max=1.0)
            if tcfg.grad_clip > 0 else 1.0)
    step = opt.step + 1
    b1, b2 = tcfg.beta1, tcfg.beta2
    bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=step.device),
                          step.float())
    bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=step.device),
                          step.float())
    for k, p in params.items():
        g = grads[k].float() * clip
        m, v, w = opt.m[k], opt.v[k], opt.master[k]
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).add_(torch.square(g), alpha=1 - b2)
        delta = (m / bc1).div_(torch.sqrt(v / bc2).add_(tcfg.eps))
        delta.add_(w, alpha=tcfg.weight_decay)
        w.sub_(delta, alpha=tcfg.learning_rate)
        p.copy_(w)
    return params, OptState(step, opt.m, opt.v, opt.master), {"grad_norm": gnorm}
