"""Data-parallel training with ZeRO-1 over a ``torch.distributed`` group:
one rank's share of the JAX package's train step on a data × model mesh
(``repro.runtime.elastic`` jits ``make_train_step`` with the state laid out
by ``param_specs`` and ``zero1_specs``; GSPMD issues the collectives).

Every rank holds the whole model (bf16 or float32 parameters, as one
device does) and computes the loss on its rows of the global batch. The
optimizer state is held by JAX leaf (``repeats.b0.mixer.wq.kernel``: the
pattern position's layers stacked): where the leaf's ZeRO-1 spec names
``data`` on a dim, each rank keeps one contiguous cut of m, v and the
float32 master along that dim, moved to the front (where the spec cuts the
repeat dim, whole layers); a leaf with no divisible free dim is held whole
on every rank, as in JAX. A step:

1. the loss and its gradients on the rank's rows (``make_grads_fn``; the
   MoE's load-balance loss takes the experts' assignment shares averaged
   over the group, so that the ranks' mean loss is the global batch's);
2. per JAX leaf, the stacked float32 gradient reduce-scattered into the
   rank's cut (all-reduced where the leaf is whole), divided by the group's
   size: the mean of the ranks' means is the mean over the global batch;
3. under ``grad_compression="int8"``, each leaf quantized at the largest
   magnitude over the whole leaf on all ranks (an all-reduce of maxima);
4. the global norm from the cuts' sums of squares (all-reduced) and the
   whole leaves' own, the clip, AdamW on each cut (``adamw_leaf``);
5. the new parameters, cast to their dtype, all-gathered into the stacked
   leaf and copied into each layer.

The losses and norm agree with one device to float32 rounding: sums over
ranks add in another order. ``state_leaves`` gathers the cuts into the JAX
checkpoint layout and ``state_from_leaves`` narrows each leaf to a rank's
cut, so a checkpoint restores onto any world size and into the JAX package.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch import convert
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.models import model as M
from repro_torch.sharding import partitioning as pt
from repro_torch.training.optimizer import (adamw_leaf, bias_corrections, clip_factor,
                                            quantize)
from repro_torch.training.train_step import Batch, make_grads_fn

_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


class Comm(NamedTuple):
    """The data group of a mesh: its process group, extent and this rank's
    index in it."""
    group: object
    size: int
    rank: int


class Leaf(NamedTuple):
    """A JAX leaf: its dotted path, the port parameters in it (in repeat
    order; one for a leaf that is not stacked), its shape, and the dim its
    optimizer state is cut along over the data group (``None``: whole)."""
    key: str
    names: Tuple[str, ...]
    stacked: bool
    shape: Tuple[int, ...]
    dim: Optional[int]


class ShardedState(NamedTuple):
    params: M.CausalLM
    step: torch.Tensor                # int32 scalar
    m: Dict[str, torch.Tensor]        # JAX leaf path -> this rank's cut, float32
    v: Dict[str, torch.Tensor]
    master: Dict[str, torch.Tensor]


def leaf_layout(model: M.CausalLM, mesh, zero1: bool) -> List[Leaf]:
    """The JAX leaves of ``model`` and the dim of each that ``zero1_specs``
    (``param_specs`` where ``zero1`` is off) shards over ``data`` on
    ``mesh``."""
    cfg = model.cfg
    shapes = pt.param_shape_tree(model)
    specs = pt.param_specs(shapes, cfg, mesh)
    if zero1:
        specs = pt.zero1_specs(specs, shapes, mesh)
    names: Dict[str, List[str]] = {}
    stacked: Dict[str, bool] = {}
    for name, _ in model.named_parameters():
        key, r = M.jax_leaf(name, cfg)
        names.setdefault(key, []).append(name)
        stacked[key] = r is not None
    out = []
    for key, ns in names.items():
        path = key.replace(".", "/")
        out.append(Leaf(key, tuple(ns), stacked[key], shapes[path],
                        pt.data_dim(specs[path])))
    return out


def _stack(tensors: Mapping[str, torch.Tensor], leaf: Leaf) -> torch.Tensor:
    if leaf.stacked:
        return torch.stack([tensors[n] for n in leaf.names])
    return tensors[leaf.names[0]]


def _cut(full: torch.Tensor, leaf: Leaf, comm: Comm) -> torch.Tensor:
    """This rank's cut of a whole leaf (the sharded dim moved to the front)."""
    if leaf.dim is None:
        return full.contiguous()
    chunk = leaf.shape[leaf.dim] // comm.size
    return full.movedim(leaf.dim, 0).narrow(0, comm.rank * chunk, chunk).contiguous()


def _gather(cut: torch.Tensor, leaf: Leaf, comm: Comm) -> torch.Tensor:
    """The whole leaf, in its JAX layout, from every rank's cut."""
    if leaf.dim is None:
        return cut
    out = cut.new_empty((leaf.shape[leaf.dim],) + tuple(cut.shape[1:]))
    _all_gather(out, cut, group=comm.group)
    return out.movedim(0, leaf.dim)


def fresh_state(model: M.CausalLM, layout: List[Leaf], comm: Comm) -> ShardedState:
    """Step 0: zero moments and the float32 master cut from the weights."""
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    with torch.no_grad():
        master = {leaf.key: _cut(_stack(params, leaf).to(torch.float32, copy=True), leaf, comm)
                  for leaf in layout}
    zeros = lambda: {k: torch.zeros_like(w) for k, w in master.items()}  # noqa: E731
    step = torch.zeros((), dtype=torch.int32, device=model.device)
    return ShardedState(model, step, zeros(), zeros(), master)


def state_from_leaves(leaves: Mapping[str, torch.Tensor], cfg: ModelConfig, device,
                      layout_of, comm: Comm) -> ShardedState:
    """A rank's state from checkpoint leaves (``convert.state_leaves``'
    keys): the whole model, and each optimizer leaf narrowed to this rank's
    cut. ``layout_of(model)`` gives the model's ``leaf_layout``."""
    model = convert.model_from_tree(convert.leaf_tree(leaves, ".params/"), cfg, device)
    layout = layout_of(model)

    def cuts(prefix):
        tree = convert.leaf_tree(leaves, prefix)
        return {leaf.key: _cut(tree[leaf.key].to(device=device, dtype=torch.float32),
                               leaf, comm) for leaf in layout}
    step = torch.as_tensor(leaves[".opt/.step"]).to(device=device, dtype=torch.int32)
    return ShardedState(model, step, cuts(".opt/.m/"), cuts(".opt/.v/"),
                        cuts(".opt/.master/"))


def state_leaves(state: ShardedState, layout: List[Leaf], comm: Comm,
                 keep: bool = True) -> Dict[str, torch.Tensor]:
    """The checkpoint leaves of the whole state on the host, the cuts
    gathered leaf by leaf. Every rank of the group must call it; a rank
    that does not ``keep`` them gets ``{}`` (and holds no more than one
    gathered leaf at a time)."""
    params = dict(state.params.named_parameters())
    trees = {"params": {}, "m": {}, "v": {}, "master": {}}
    for leaf in layout:
        if keep:
            trees["params"][leaf.key] = _stack(params, leaf).detach().cpu()
        for name in ("m", "v", "master"):
            whole = _gather(getattr(state, name)[leaf.key], leaf, comm)
            if keep:
                trees[name][leaf.key] = whole.cpu()
            del whole
    if not keep:
        return {}
    return convert.jax_state_leaves(trees["params"], state.step.cpu(), trees["m"],
                                    trees["v"], trees["master"])


def rank_rows(global_batch: int, microbatch: int, comm: Comm) -> torch.Tensor:
    """The rows of the global batch that ``comm.rank`` trains on. The JAX
    step cuts the batch into k = ``microbatch`` slices of B/k rows and the
    MoE cuts each slice into ``comm.size`` groups of contiguous rows, one a
    rank: so rank g's rows are group g of every slice, in slice order."""
    k = microbatch if microbatch and microbatch > 1 else 1
    if global_batch % (k * comm.size):
        raise ValueError(f"global batch {global_batch} does not cut into {k} microbatches "
                         f"of {comm.size} equal groups")
    per_slice, per_rank = global_batch // k, global_batch // (k * comm.size)
    return torch.cat([torch.arange(i * per_slice + comm.rank * per_rank,
                                   i * per_slice + (comm.rank + 1) * per_rank)
                      for i in range(k)])


def make_sharded_step(cfg: ModelConfig, tcfg: TrainConfig, layout: List[Leaf], comm: Comm):
    """``step(state, batch) -> (state, metrics)`` on this rank's rows of the
    batch (``rank_rows``); metrics ``loss``, ``nll`` and ``grad_norm`` of
    the global batch as 0-dim float32 tensors, the same on every rank. Each
    rank's rows are one of the JAX step's ``moe_groups`` (the data extent)
    token groups, so its MoE routes them as one group."""
    inv = 1.0 / comm.size

    def mean_over_ranks(t: torch.Tensor) -> torch.Tensor:
        t = t.clone()
        dist.all_reduce(t, group=comm.group)
        return t * inv

    grads_fn = make_grads_fn(cfg, tcfg, moe_groups=1,
                             moe_mean=mean_over_ranks if cfg.moe is not None else None)

    @torch.no_grad()
    def reduce(g: torch.Tensor, leaf: Leaf) -> torch.Tensor:
        g = g.float()
        if leaf.dim is None:
            dist.all_reduce(g, group=comm.group)
        else:
            g = g.movedim(leaf.dim, 0).contiguous()
            out = g.new_empty((g.shape[0] // comm.size,) + tuple(g.shape[1:]))
            _reduce_scatter(out, g, group=comm.group)
            g = out
        return g.mul_(inv)

    def step(state: ShardedState, batch: Batch):
        model = state.params
        loss, nll, grads = grads_fn(model, batch)
        metrics = mean_over_ranks(torch.stack([loss, nll]))
        g = {}
        for leaf in layout:
            g[leaf.key] = reduce(_stack(grads, leaf), leaf)
            for n in leaf.names:
                del grads[n]
        keys = [leaf.key for leaf in layout]
        if tcfg.grad_compression == "int8":
            peaks = torch.stack([g[k].abs().max() for k in keys])
            dist.all_reduce(peaks, op=dist.ReduceOp.MAX, group=comm.group)
            g = {k: quantize(g[k], peaks[i]) for i, k in enumerate(keys)}
        sq = torch.stack([torch.sum(torch.square(g[k])) for k in keys])
        cut = torch.tensor([leaf.dim is not None for leaf in layout], device=sq.device)
        summed = torch.where(cut, sq, 0.0)
        dist.all_reduce(summed, group=comm.group)
        gnorm = torch.sqrt(torch.where(cut, summed, sq).sum())
        clip = clip_factor(gnorm, tcfg)
        new_step = state.step + 1
        bc1, bc2 = bias_corrections(new_step, tcfg)
        params = dict(model.named_parameters())
        with torch.no_grad():
            for leaf in layout:
                k = leaf.key
                w = adamw_leaf(g.pop(k), state.m[k], state.v[k], state.master[k],
                               clip, bc1, bc2, tcfg)
                full = _gather(w.to(params[leaf.names[0]].dtype), leaf, comm)
                if leaf.stacked:
                    for i, n in enumerate(leaf.names):
                        params[n].copy_(full[i])
                else:
                    params[leaf.names[0]].copy_(full)
        new = ShardedState(model, new_step, state.m, state.v, state.master)
        return new, {"loss": metrics[0], "nll": metrics[1], "grad_norm": gnorm}

    return step
