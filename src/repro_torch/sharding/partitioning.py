"""Parameter, optimizer-state, cache and batch partitioning rules
(counterpart of ``repro.sharding.partitioning``).

Axes:
  model : tensor parallelism (Megatron-style column/row parallel + expert-TP)
  data  : data parallelism; with ``fsdp=True`` parameters are additionally
          sharded over `data` on a free dimension (ZeRO-3 / weight-gather);
          optimizer state is always sharded over `data` (ZeRO-1) when possible
  pod   : outer data-parallel axis of the multi-pod mesh (batch only)

The rules are the JAX package's, as pure functions of shapes and of a mesh's
``shape`` dict (axis name -> extent; the port's ``launch.mesh.Mesh`` or any
object with such a ``shape``). A tree is a flat dict from the JAX leaf path
(``repeats/b0/mixer/wq/kernel``: each pattern position's layers stacked
along a leading repeat dim) to its shape; ``param_shape_tree`` gives a port
model's parameters so. A spec is a ``Spec``: one entry a dim, each an axis
name, ``None`` (not sharded) or a tuple of names (sharded over their
product).

The port lays a leaf out by its spec explicitly: ``local_cut`` (the
counterpart of ``to_shardings`` + ``jax.device_put``) narrows a whole leaf
to one rank's block, and ``gather_cut`` puts the whole leaf back together
from every rank's block, as a checkpoint needs it. The parameters of a rank
are their ``param_specs`` cut; the optimizer state is its ``zero1_specs``
cut (``training.data_parallel``).

``make_constrain``'s counterpart is ``ModelParallel``: the context the
port's model takes in place of the JAX hook. It holds the model group (its
size and this rank's index), ``sequence_parallel`` and the data group that
expert parallelism sends tokens over, and it issues, as
``torch.autograd.Function``s, the collectives that GSPMD issues for the
JAX model: ``enter`` (identity forward, all-reduce of the gradient: a
replicated tensor going into a cut computation), ``reduce`` (all-reduce
forward, identity backward: partial sums of a row-parallel product),
``gather`` / ``split`` (a dim cut over the group to whole and back),
``reduce_scatter`` (partial sums to this rank's block of the sequence,
under sequence parallelism), and the experts' all-to-all over the data
group, each through ``sharding.collectives``. A tensor is either replicated
(every model rank holds it, and in the backward pass its whole gradient)
or cut (each rank its block or its partial sum); these are the only
crossings. Over a group of one rank each is the identity: no collective is
issued.

FSDP (``fsdp_cut``): a parameter stored as its block of the data axes is
gathered whole (``_GatherShard``: all-gather forward, reduce-scatter
backward) at the start of each call of the part of the model that reads
it, and dropped at its end.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.sharding import collectives as coll

Shape = Tuple[int, ...]
Tree = Mapping[str, Shape]

# output dim -> model (column parallel); FSDP shards a free dim over data
_COL_NAMES = {"wq", "wk", "wv", "wi_gate", "wi_up", "w_gate_in", "w_rnn_in",
              "w_ff_up", "head"}
# input dim -> model (row parallel)
_ROW_NAMES = {"wo", "w_out", "w_down", "w_ff_down"}
# rglru per-channel params: last dim follows the model-sharded rnn width
_RG_CHANNEL = {"rg_conv_w", "rg_conv_b", "lam"}
# rglru gate matrices [W, W]: row-parallel (contract the sharded channel dim)
_RG_GATES = {"w_rg", "w_ig"}
# xLSTM mixer params: replicated baseline
_XLSTM = {"w_up", "w_gate", "w_q", "w_k", "w_v", "w_i", "w_f", "rec",
          "out_scale", "conv_w", "conv_b", "w_z", "w_o"}


class Spec(tuple):
    """A partition spec: ``Spec("model", None)`` shards dim 0 over the
    ``model`` axis and leaves dim 1 whole (``jax.sharding.PartitionSpec``)."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"

    def axes(self) -> set:
        """Every axis name the spec uses."""
        out = set()
        for a in self:
            out.update(a if isinstance(a, tuple) else (a,))
        out.discard(None)
        return out


def param_shape_tree(model) -> Dict[str, Shape]:
    """A port ``CausalLM``'s parameters as the JAX ``init_params`` tree:
    leaf path -> shape, each pattern position's layers stacked along a
    leading repeat dim (``models.model.jax_leaf``). Built on the meta device
    (``CausalLM(cfg, device="meta")``) it costs no memory at any width."""
    from repro_torch.models.model import jax_leaf
    cfg = model.cfg
    out: Dict[str, Shape] = {}
    for name, p in model.named_parameters():
        key, r = jax_leaf(name, cfg)
        key = key.replace(".", "/")
        if r is None:
            out[key] = tuple(p.shape)
        else:
            reps = out.get(key, (0,))[0]
            out[key] = (max(reps, r + 1),) + tuple(p.shape)
    return out


def _owner(path: str) -> str:
    """Name of the parameter (dict key above the kernel/bias/scale leaf)."""
    parts = path.split("/")
    return parts[-2] if parts[-1] in ("kernel", "bias", "scale") else parts[-1]


def _shard_free_dim(shape, spec, axis, size: int):
    best, best_dim = -1, -1
    for i, s in enumerate(shape):
        if spec[i] is None and s % size == 0 and s > best:
            best, best_dim = s, i
    if best_dim >= 0:
        spec[best_dim] = axis
    return spec


def param_specs(shape_tree: Tree, cfg: ModelConfig, mesh, *, fsdp: bool = False,
                tp: int = 0) -> Dict[str, Spec]:
    """Spec of every leaf of a params shape tree.

    tp=1 selects the pure-FSDP layout: no tensor parallelism; parameters are
    sharded over the combined (data, model) axes and the batch uses both
    axes as data parallelism (see batch_axes). Default tp=0 means full-width TP.
    """
    msz = mesh.shape["model"] if tp == 0 else tp
    dsz = mesh.shape["data"]
    if tp == 1:
        fs_axis = ("data", "model")
        fs_size = mesh.shape["data"] * mesh.shape["model"]

        def one_fsdp(path, shape):
            spec = [None] * len(shape)
            if fsdp and math.prod(shape) >= 1 << 16:
                _shard_free_dim(shape, spec, fs_axis, fs_size)
            return Spec(*spec)

        return {p: one_fsdp(p, s) for p, s in shape_tree.items()}

    def one(p, shape):
        ndim = len(shape)
        spec = [None] * ndim
        name = _owner(p)
        leafname = p.split("/")[-1]
        is_moe = "/moe/" in p
        size = math.prod(shape)

        if name == "router":
            return Spec(*spec)                                # replicated
        if name in _XLSTM and not is_moe:
            if fsdp and size >= 1 << 20:
                _shard_free_dim(shape, spec, "data", dsz)     # generic ZeRO-3
            return Spec(*spec)
        if "embed/table" in p:
            if shape[0] % msz == 0:
                spec[0] = "model"
            if fsdp and shape[1] % dsz == 0:
                spec[1] = "data"
        elif is_moe and leafname != "kernel":
            # stacked expert weights [R?, E, in, out]-style
            if name in ("wi_gate", "wi_up") and shape[-1] % msz == 0:
                spec[-1] = "model"
            elif name == "wo" and shape[-2] % msz == 0:
                spec[-2] = "model"
            if cfg.moe is not None and cfg.moe.expert_parallel:
                off = 1 if "repeats/" in p else 0
                if shape[off] % dsz == 0:
                    spec[off] = "data"       # expert parallelism
                elif fsdp:
                    _shard_free_dim(shape, spec, "data", dsz)
            elif fsdp:
                _shard_free_dim(shape, spec, "data", dsz)
        elif name in _COL_NAMES:
            if leafname == "kernel":
                if shape[-1] % msz == 0:
                    spec[-1] = "model"
                if fsdp:
                    _shard_free_dim(shape, spec, "data", dsz)
            elif leafname == "bias" and shape[-1] % msz == 0:
                spec[-1] = "model"
        elif name in _ROW_NAMES:
            if leafname == "kernel":
                if shape[-2] % msz == 0:
                    spec[-2] = "model"
                if fsdp:
                    _shard_free_dim(shape, spec, "data", dsz)
        elif name in _RG_CHANNEL or leafname in _RG_CHANNEL:
            if shape[-1] % msz == 0:
                spec[-1] = "model"
        elif name in _RG_GATES:
            if leafname == "kernel" and shape[-2] % msz == 0:
                spec[-2] = "model"
        return Spec(*spec)

    return {p: one(p, s) for p, s in shape_tree.items()}


# ----------------------------------------------------------------- batches


def batch_axes(mesh, tp: int = 0) -> Tuple[str, ...]:
    axes = ("pod", "data") if "pod" in mesh.shape else ("data",)
    if tp == 1:
        axes = axes + ("model",)
    return axes


def dp_size(mesh, tp: int = 0) -> int:
    total = 1
    for a in batch_axes(mesh, tp):
        total *= mesh.shape[a]
    return total


def data_spec(mesh, shape: Shape, *, batch_dim: int = 0, tp: int = 0) -> Spec:
    """Shard the batch dim over the widest divisible prefix of the DP axes
    (e.g. global_batch=256 on the 2x16x16 mesh with tp=1 shards over
    (data, model) = 256 and replicates over pod)."""
    axes = batch_axes(mesh, tp)
    spec = [None] * len(shape)
    candidates = [axes]
    if len(axes) > 1:
        candidates += [axes[1:], axes[:-1], axes[1:-1] or axes[-1:],
                       axes[-1:], axes[:1]]
    for cand in candidates:
        size = 1
        for a in cand:
            size *= mesh.shape[a]
        if size and shape[batch_dim] % size == 0:
            spec[batch_dim] = cand if len(cand) > 1 else cand[0]
            return Spec(*spec)
    return Spec(*spec)


def cache_specs(cache_tree: Tree, cfg: ModelConfig, mesh, *, tp: int = 0) -> Dict[str, Spec]:
    """Specs for a KV/recurrent cache tree (leaf path -> shape, as the JAX
    ``init_cache`` tree: ``repeats/b0/k`` [R, B, L, K, hd] ...).

    k/v [R?, B, L, K, hd]: batch over data axes when divisible; otherwise the
    kv-head dim (K % model == 0) or a large length dim goes over `model`.
    With tp=1 the model axis joins the batch axes instead.
    """
    msz = mesh.shape["model"] if tp == 0 else tp

    def one(p, shape):
        ndim = len(shape)
        off = 1 if "repeats/" in p else 0
        name = p.split("/")[-1]
        spec = [None] * ndim
        if name in ("k", "v"):
            bs = data_spec(mesh, shape, batch_dim=off, tp=tp)
            spec[off] = bs[off]
            L, K = shape[off + 1], shape[off + 2]
            if tp != 1:
                if K % msz == 0:
                    spec[off + 2] = "model"
                elif L % msz == 0 and L >= 8192:
                    spec[off + 1] = "model"
        elif name == "pos":
            pass
        elif name in ("h", "conv") and shape[-1] in (cfg.lru_width,):
            bs = data_spec(mesh, shape, batch_dim=off, tp=tp)
            spec[off] = bs[off]
            if tp != 1 and shape[-1] % msz == 0:
                spec[-1] = "model"
        else:  # xlstm states: batch-shard only
            bs = data_spec(mesh, shape, batch_dim=off, tp=tp)
            spec[off] = bs[off]
        return Spec(*spec)

    return {p: one(p, s) for p, s in cache_tree.items()}


# ------------------------------------------------------------ optimizer


def zero1_specs(param_spec_tree: Mapping[str, Spec], shape_tree: Tree,
                mesh) -> Dict[str, Spec]:
    """Optimizer-state specs: param spec + extra `data` sharding (ZeRO-1)."""
    dsz = mesh.shape["data"]

    def one(spec: Spec, shape):
        s = list(spec) + [None] * (len(shape) - len(spec))
        if "data" not in spec.axes():
            _shard_free_dim(shape, s, "data", dsz)
        return Spec(*s)

    return {p: one(param_spec_tree[p], s) for p, s in shape_tree.items()}


def data_dim(spec: Spec):
    """The dim a spec shards over the ``data`` axis (alone or with others),
    or ``None``."""
    for i, a in enumerate(spec):
        if a == "data" or (isinstance(a, tuple) and "data" in a):
            return i
    return None


def model_dim(spec: Spec):
    """The dim a spec shards over the ``model`` axis, or ``None``."""
    for i, a in enumerate(spec):
        if a == "model" or (isinstance(a, tuple) and "model" in a):
            return i
    return None


def layer_spec(spec: Spec, stacked: bool) -> Spec:
    """The spec of one layer of a leaf (the repeat dim dropped where the
    leaf is stacked)."""
    return Spec(*spec[1:]) if stacked else spec


# ------------------------------------------------------------- layouts


def _block(axes, coords: Mapping[str, int], shape: Mapping[str, int]) -> Tuple[int, int]:
    """(extent, index) of the mesh block that ``axes`` (a name or a tuple
    of names, row-major) gives a rank at ``coords``."""
    names = axes if isinstance(axes, tuple) else (axes,)
    n, i = 1, 0
    for a in names:
        n, i = n * shape[a], i * shape[a] + coords[a]
    return n, i


def local_cut(full: torch.Tensor, spec: Spec, coords: Mapping[str, int], mesh) -> torch.Tensor:
    """The block of ``full`` that the rank at ``coords`` (``mesh.coords()``)
    holds under ``spec``: each dim the spec names is narrowed to the rank's
    block of its axes (a view)."""
    out = full
    for dim, axes in enumerate(spec):
        if axes is not None:
            n, i = _block(axes, coords, mesh.shape)
            size = full.shape[dim] // n
            out = out.narrow(dim, i * size, size)
    return out


def gather_cut(parts: Sequence[torch.Tensor], spec: Spec, mesh) -> torch.Tensor:
    """The inverse of ``local_cut``: the whole leaf from every rank's block,
    ``parts`` in rank order (row-major over the mesh). Ranks that hold the
    same block give it once."""
    extents = [1 if a is None else _block(a, mesh.coords(0), mesh.shape)[0] for a in spec]
    first = parts[0]
    out = first.new_empty([s * n for s, n in zip(first.shape, extents)])
    for rank, part in enumerate(parts):
        coords = mesh.coords(rank)
        view = out
        for dim, axes in enumerate(spec):
            if axes is not None:
                _, i = _block(axes, coords, mesh.shape)
                view = view.narrow(dim, i * part.shape[dim], part.shape[dim])
        view.copy_(part)
    return out


# ----------------------------------------------------- model parallelism


def _all_gather(x: torch.Tensor, dim: int, group, size: int) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(size)]
    coll.all_gather_list(parts, x.contiguous(), group)
    return torch.cat(parts, dim=dim)


def _narrow(x: torch.Tensor, dim: int, rank: int, size: int) -> torch.Tensor:
    n = x.shape[dim] // size
    return x.narrow(dim, rank * n, n).contiguous()


def _reduce_scatter(x: torch.Tensor, dim: int, group, size: int) -> torch.Tensor:
    x = x.movedim(dim, 0).contiguous()
    out = x.new_empty((x.shape[0] // size,) + tuple(x.shape[1:]))
    coll.reduce_scatter_into(out, x, group)
    return out.movedim(0, dim)


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mp):
        ctx.mp = mp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return coll.all_reduce(g.contiguous().clone(), ctx.mp.group), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mp):
        return coll.all_reduce(x.contiguous().clone(), mp.group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mp, dim):
        ctx.mp, ctx.dim = mp, dim
        return _all_gather(x, dim, mp.group, mp.size)

    @staticmethod
    def backward(ctx, g):
        return _narrow(g, ctx.dim, ctx.mp.rank, ctx.mp.size), None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mp, dim):
        ctx.mp, ctx.dim = mp, dim
        return _narrow(x, dim, mp.rank, mp.size)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.mp.group, ctx.mp.size), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mp, dim):
        ctx.mp, ctx.dim = mp, dim
        return _reduce_scatter(x, dim, mp.group, mp.size)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.mp.group, ctx.mp.size), None, None


def _exchange(x: torch.Tensor, group, size: int) -> torch.Tensor:
    """[A, E, ...] with E cut into ``size`` blocks: block j goes to rank j,
    and the blocks that arrive are stacked by sender along dim 0 ->
    [size · A, E / size, ...]."""
    A, E = x.shape[:2]
    send = x.reshape((A, size, E // size) + tuple(x.shape[2:])).transpose(0, 1).contiguous()
    out = coll.all_to_all_into(torch.empty_like(send), send, group)
    return out.reshape((size * A, E // size) + tuple(x.shape[2:]))


def _unexchange(y: torch.Tensor, group, size: int) -> torch.Tensor:
    """The inverse of ``_exchange``: [size · A, E / size, ...] -> [A, E, ...]."""
    SA, e = y.shape[:2]
    A = SA // size
    y = y.contiguous()
    out = coll.all_to_all_into(torch.empty_like(y), y, group)
    out = out.reshape((size, A, e) + tuple(y.shape[2:])).transpose(0, 1)
    return out.reshape((A, size * e) + tuple(y.shape[2:]))


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size, back):
        ctx.group, ctx.size, ctx.back = group, size, back
        return (_unexchange if back else _exchange)(x, group, size)

    @staticmethod
    def backward(ctx, g):
        return (_exchange if ctx.back else _unexchange)(g, ctx.group, ctx.size), None, None, None


@dataclass(frozen=True)
class ModelParallel:
    """A rank's place in tensor and expert parallelism, and the collectives
    of both (the port's ``make_constrain``). ``group``/``size``/``rank``:
    the model group; ``data_group``/``data_size``: the data group, over
    which the experts of an ``expert_parallel`` MoE are cut (extent 1
    where they are not). ``NONE`` (one rank, no group) makes every method
    the identity. ``shape`` and ``coords()`` make it the mesh that lays
    out the rank's parameters (``param_specs``, ``local_cut``)."""
    group: Any = None
    size: int = 1
    rank: int = 0
    sequence_parallel: bool = False
    data_group: Any = None
    data_size: int = 1
    data_rank: int = 0

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.data_size, "model": self.size}

    def coords(self) -> Dict[str, int]:
        return {"data": self.data_rank, "model": self.rank}

    def seq_cut(self, seq_len: int) -> bool:
        """Whether the residual stream of a sequence of ``seq_len`` is cut
        on the sequence dim (``make_constrain``'s rule for ``residual``)."""
        return self.sequence_parallel and self.size > 1 and seq_len % self.size == 0

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """A replicated tensor into a cut computation."""
        return x if self.size == 1 else _Enter.apply(x, self)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Partial sums -> their replicated sum."""
        return x if self.size == 1 else _Reduce.apply(x, self)

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Blocks along ``dim`` -> the whole tensor, replicated."""
        return x if self.size == 1 else _Gather.apply(x, self, dim)

    def split(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """A replicated tensor -> this rank's block along ``dim``."""
        return x if self.size == 1 else _Split.apply(x, self, dim)

    def reduce_scatter(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Partial sums -> this rank's block of their sum along ``dim``."""
        return x if self.size == 1 else _ReduceScatter.apply(x, self, dim)

    def max(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise max over the group, no gradient."""
        x = x.detach().clone()
        if self.size > 1:
            coll.all_reduce(x, self.group, op=dist.ReduceOp.MAX)
        return x

    def to_experts(self, buf: torch.Tensor) -> torch.Tensor:
        """[G, E, ...] of this data rank's groups -> [G · data, E / data,
        ...]: every group's slots of this rank's experts (``all_to_all``)."""
        if self.data_size == 1:
            return buf
        return _AllToAll.apply(buf, self.data_group, self.data_size, False)

    def from_experts(self, out: torch.Tensor) -> torch.Tensor:
        """The inverse of ``to_experts``."""
        if self.data_size == 1:
            return out
        return _AllToAll.apply(out, self.data_group, self.data_size, True)


NONE = ModelParallel()


# ------------------------------------------------------------------ FSDP


class _GatherShard(torch.autograd.Function):
    """A leaf's FSDP cut -> the leaf (all-gather along ``dim``); the
    gradient back to the cut (reduce-scatter: the sum over the group)."""

    @staticmethod
    def forward(ctx, shard, dim, group, size):
        ctx.dim, ctx.group, ctx.size = dim, group, size
        x = shard.movedim(dim, 0).contiguous()
        out = x.new_empty((size * x.shape[0],) + tuple(x.shape[1:]))
        coll.all_gather_into(out, x, group)
        return out.movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.dim, ctx.group, ctx.size), None, None, None


@dataclass(frozen=True)
class ShardCut:
    """A parameter's FSDP cut: the dim, the group it is cut over, the
    group's size and this rank's block."""
    dim: int
    group: Any
    size: int
    index: int


# the methods through which a part of the model reads its parameters
_READERS = {"layers": ("forward", "prefill", "decode"), "embed": ("forward", "unembed"),
            "head": ("forward",), "final_norm": ("forward",)}


def fsdp_cut(model, cuts: Mapping[str, ShardCut]) -> None:
    """Cut ``model``'s parameters named in ``cuts`` to this rank's block
    (FSDP): each is stored as its block, and each part of the model that
    reads it (a layer, the embedding, the head, the final norm) gathers it
    whole at the start of every call of its ``forward`` (and ``prefill``,
    ``decode``, ``unembed``) and drops it at the end. Under remat the
    recomputation calls the layer again, so it gathers again; in the
    backward pass the gradient is reduce-scattered onto the block."""
    parts: Dict[Any, list] = {}
    for name, cut in cuts.items():
        owner_name, _, attr = name.rpartition(".")
        owner = model.get_submodule(owner_name)
        p = owner._parameters[attr]
        n = p.shape[cut.dim] // cut.size
        block = p.detach().narrow(cut.dim, cut.index * n, n).clone()
        shard = torch.nn.Parameter(block, requires_grad=p.requires_grad)
        owner._parameters[attr] = shard
        top = name.split(".")[0]
        part = model.layers[int(name.split(".")[1])] if top == "layers" else \
            model.get_submodule(top)
        parts.setdefault((top, part), []).append((owner, attr, cut))
    for (top, part), held in parts.items():
        for method in _READERS[top]:
            if hasattr(part, method):
                setattr(part, method, _gathering(getattr(part, method), held))


def _gathering(fn, held):
    def call(*args, **kwargs):
        shards = [owner._parameters[attr] for owner, attr, _ in held]
        for (owner, attr, cut), shard in zip(held, shards):
            owner._parameters[attr] = _GatherShard.apply(shard, cut.dim, cut.group, cut.size)
        try:
            return fn(*args, **kwargs)
        finally:
            for (owner, attr, _), shard in zip(held, shards):
                owner._parameters[attr] = shard
    return call


def model_parallel(mesh, *, sequence_parallel: bool = False,
                   expert_parallel: bool = False) -> ModelParallel:
    """The ``ModelParallel`` of this process's rank on ``mesh`` (``NONE``
    outside a world)."""
    if mesh.group("model") is None:
        return NONE
    coords = mesh.coords()
    ep = expert_parallel and mesh.shape["data"] > 1
    return ModelParallel(mesh.group("model"), mesh.shape["model"], coords["model"],
                         sequence_parallel, mesh.group("data") if ep else None,
                         mesh.shape["data"] if ep else 1, coords["data"] if ep else 0)
