"""Train step: loss, gradients (optionally microbatched), AdamW update
(counterpart of ``repro.training.train_step``).

The state's model is the port's ``CausalLM`` with gradients turned on; its
float32 optimizer state is keyed by parameter name. The step runs where the
model's parameters are: on the card the model's attention and RG-LRU layers
go through the flash-attention and scan kernels forward and backward.
Where ``cfg.moe`` is set the loss adds the MoE's auxiliary losses, summed
over the layers by the model's ``forward``: ``MOE_LB_COEF`` times the
load-balance loss and ``MOE_Z_COEF`` times the router z-loss.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import model as M
from repro_torch.training.optimizer import OptState, adamw_update, init_opt_state

Batch = Dict[str, torch.Tensor]

MOE_LB_COEF = 0.01
MOE_Z_COEF = 0.001


class TrainState(NamedTuple):
    params: M.CausalLM
    opt: OptState


def train_state(model: M.CausalLM) -> TrainState:
    """A training state around ``model``: gradients on for its parameters,
    zero moments and a float32 master copy, step 0."""
    model.requires_grad_(True)
    return TrainState(model, init_opt_state(dict(model.named_parameters())))


def init_state(cfg: ModelConfig, *, seed: int = 0, device: DeviceLike = None,
               init_device: DeviceLike = None) -> TrainState:
    """``init_params`` drawn from ``seed`` on ``init_device`` (``device`` by
    default), moved to ``device`` (the card unless ``"cpu"``), as a state.
    CUDA and CPU generators draw different numbers from one seed."""
    device = resolve_device(device)
    init_on = device if init_device is None else resolve_device(init_device)
    model = M.init_params(cfg, torch.Generator(device=init_on).manual_seed(seed), init_on)
    if init_on != device:
        model = model.copy_to(device)
    return train_state(model)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, z_loss_coef: float):
    """logits [..., V] float32; labels [...] int. (mean NLL + z-loss, NLL)."""
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = torch.mean(lse - gold)
    zl = torch.mean(torch.square(lse))
    return nll + z_loss_coef * zl, nll


def make_loss_fn(cfg: ModelConfig, tcfg: TrainConfig) -> Callable:
    def loss_fn(model: M.CausalLM, batch: Batch):
        logits, aux = model(batch["tokens"], remat=tcfg.remat)
        loss, nll = cross_entropy(logits, batch["labels"], tcfg.z_loss)
        if cfg.moe is not None:
            loss = loss + MOE_LB_COEF * aux["moe_lb"] + MOE_Z_COEF * aux["moe_z"]
        return loss, {"nll": nll}
    return loss_fn


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig) -> Callable:
    """``train_step(state, batch) -> (state, metrics)``: metrics ``loss``,
    ``nll`` and ``grad_norm`` as 0-dim float32 tensors. With ``microbatch``
    k > 1 the batch is cut into k slices along its first axis and their
    gradients summed in float32, then divided by k. The state is updated in
    place and returned."""
    loss_fn = make_loss_fn(cfg, tcfg)

    def grads_of(model, names, leaves, batch):
        loss, aux = loss_fn(model, batch)
        grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
        return loss.detach(), aux["nll"].detach(), dict(zip(names, grads))

    def train_step(state: TrainState, batch: Batch):
        model = state.params
        params = dict(model.named_parameters())
        names, leaves = list(params), list(params.values())
        k = tcfg.microbatch
        if k and k > 1:
            loss = nll = torch.zeros((), dtype=torch.float32, device=model.device)
            acc: Optional[Dict[str, torch.Tensor]] = None
            for i in range(k):
                mbatch = {n: t.reshape((k, t.shape[0] // k) + t.shape[1:])[i]
                          for n, t in batch.items()}
                l, n_, g = grads_of(model, names, leaves, mbatch)
                loss, nll = loss + l, nll + n_
                if acc is None:
                    acc = {n: x.float() for n, x in g.items()}
                else:
                    for n, x in g.items():
                        acc[n].add_(x.float())
                del g
            inv = 1.0 / k
            loss, nll = loss * inv, nll * inv
            grads = {n: a.mul_(inv) for n, a in acc.items()}
        else:
            loss, nll, grads = grads_of(model, names, leaves, batch)
        groups = {n: M.jax_leaf(n, cfg)[0] for n in names}
        _, opt, om = adamw_update(state.opt, grads, params, tcfg, groups)
        return TrainState(model, opt), {"loss": loss, "nll": nll, **om}

    return train_step
