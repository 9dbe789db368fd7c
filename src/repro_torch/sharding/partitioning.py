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

The port's trainer reads ``zero1_specs`` for its data axis alone: where a
leaf's spec names ``data`` on a dim, m, v and the float32 master are cut
along that dim over the data group (``training.data_parallel``). The
placement of activations for GSPMD (``make_constrain``, ``to_shardings``)
has no counterpart here: on the data axis alone it changes nothing, and it
comes with tensor parallelism over the ``model`` axis (ROADMAP.md, queue 1
item 4b).
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Tuple

from repro_torch.configs.base import ModelConfig

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
