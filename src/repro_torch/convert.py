"""Carry weights, training states and caches between the JAX package's
pytrees and the port.

The JAX model stacks each pattern position's parameters along a leading
``repeat`` axis (``params["repeats"]["b{j}"]``) and keeps the depth remainder
in ``params["tail"]["t{j}"]``; the port has one module per layer. Leaf names
match the port's parameter names (``mixer.wq.kernel`` ...), and kernels keep
their ``[in, out]`` orientation, so leaves are copied as they are. Inputs are
numpy arrays (``jax.device_get`` of the pytree); nothing here imports JAX.

Both directions: ``params_from_jax`` / ``params_to_jax`` for weights,
``state_from_jax`` / ``state_to_jax`` for a whole ``TrainState`` (params,
then the optimizer's step, m, v and master, whose trees have the params'
layout). ``state_leaves`` / ``state_from_leaves`` give the same state as the
flat leaf keys of the JAX checkpoint (``.params/...``, ``.opt/.step``,
``.opt/.m/...``), which ``repro_torch.checkpoint`` writes and reads.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import Cache
from repro_torch.models.model import CausalLM, jax_leaf
from repro_torch.training.optimizer import OptState
from repro_torch.training.train_step import TrainState


def _pattern_split(cfg: ModelConfig):
    p = cfg.block_pattern
    reps = cfg.num_layers // len(p)
    return reps, len(cfg.layer_kinds()) - reps * len(p)


def _flatten(tree: Dict[str, Any], prefix: str = "", sep: str = ".") -> Dict[str, Any]:
    """Nested dicts -> {joined path: leaf}, keys sorted at every level (the
    order in which JAX flattens a dict)."""
    out = {}
    for key in sorted(tree):
        val = tree[key]
        name = f"{prefix}{key}"
        if isinstance(val, dict):
            out.update(_flatten(val, name + sep, sep))
        else:
            out[name] = val
    return out


def to_tensor(arr) -> torch.Tensor:
    """numpy array (bfloat16 included) -> CPU tensor of the same dtype."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """Tensor -> numpy array of the same dtype; bfloat16 needs ``ml_dtypes``
    (installed wherever JAX is, the only consumer of such a pytree)."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _unstack(flat: Mapping[str, Any], cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """Dotted JAX-layout names (``repeats.b0.mixer.wq.kernel`` ...) -> the
    port's parameter names, stacked leaves cut into their layers."""
    P = len(cfg.block_pattern)
    reps, _ = _pattern_split(cfg)
    state: Dict[str, torch.Tensor] = {}
    for name, arr in flat.items():
        arr = arr if isinstance(arr, torch.Tensor) else to_tensor(arr)
        group, _, rest = name.partition(".")
        if group == "repeats":
            slot, _, leaf = rest.partition(".")
            j = int(slot[1:])
            for r in range(reps):
                state[f"layers.{r * P + j}.{leaf}"] = arr[r]
        elif group == "tail":
            slot, _, leaf = rest.partition(".")
            state[f"layers.{reps * P + int(slot[1:])}.{leaf}"] = arr
        else:
            state[name] = arr
    return state


def _stack(tree: Mapping[str, torch.Tensor], cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """The port's parameter names -> dotted JAX-layout names, each pattern
    position's layers stacked along a leading repeat axis."""
    reps, _ = _pattern_split(cfg)
    out: Dict[str, torch.Tensor] = {}
    stacks: Dict[str, List[torch.Tensor]] = {}
    for name, t in tree.items():
        key, r = jax_leaf(name, cfg)
        if r is None:
            out[key] = t.detach()
        else:
            stacks.setdefault(key, [None] * reps)[r] = t.detach()
    out.update({k: torch.stack(v) for k, v in stacks.items()})
    return out


def _nest(flat: Mapping[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for name, val in flat.items():
        *path, leaf = name.split(".")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = val
    return out


def _with_tail_groups(nested: Dict[str, Any]) -> Dict[str, Any]:
    nested.setdefault("repeats", {})
    nested.setdefault("tail", {})
    return nested


def params_from_jax(tree: Dict[str, Any], cfg: ModelConfig,
                    device=None) -> CausalLM:
    """The JAX ``init_params`` pytree (numpy leaves) as a port ``CausalLM`` on
    ``device`` (the card unless ``"cpu"``)."""
    model = CausalLM(cfg, device=device)
    model.load_state_dict(_unstack(_flatten(tree), cfg), strict=True)
    return model


def _tree_to_jax(tree: Mapping[str, torch.Tensor], cfg: ModelConfig) -> Dict[str, Any]:
    return _with_tail_groups(_nest({k: to_numpy(t) for k, t in _stack(tree, cfg).items()}))


def params_to_jax(model: CausalLM) -> Dict[str, Any]:
    """The reverse of ``params_from_jax``: the JAX params pytree (stacked
    ``repeats``, ``tail``) with numpy leaves."""
    return _tree_to_jax(dict(model.named_parameters()), model.cfg)


def state_to_jax(state: TrainState) -> Dict[str, Any]:
    """A port ``TrainState`` as ``{"params": ..., "opt": {"step", "m", "v",
    "master"}}`` of numpy leaves in the JAX pytrees' layout
    (``repro.training.train_step.TrainState(params, OptState(**opt))``)."""
    cfg = state.params.cfg
    opt = state.opt
    return {"params": params_to_jax(state.params),
            "opt": {"step": to_numpy(opt.step), "m": _tree_to_jax(opt.m, cfg),
                    "v": _tree_to_jax(opt.v, cfg), "master": _tree_to_jax(opt.master, cfg)}}


def _opt_tree(tree: Mapping[str, Any], cfg: ModelConfig, device) -> Dict[str, torch.Tensor]:
    return {k: t.to(device=device, dtype=torch.float32, memory_format=torch.contiguous_format,
                    copy=True) for k, t in _unstack(tree, cfg).items()}


def _state(params: Mapping[str, Any], step, m, v, master, cfg: ModelConfig,
           device) -> TrainState:
    model = CausalLM(cfg, device=device)
    model.load_state_dict(_unstack(params, cfg), strict=True)
    model.requires_grad_(True)
    names = [n for n, _ in model.named_parameters()]
    opt = OptState(torch.as_tensor(step).to(device=model.device, dtype=torch.int32),
                   *(_opt_tree(t, cfg, model.device) for t in (m, v, master)))
    for tree in opt[1:]:
        if sorted(tree) != sorted(names):
            raise KeyError(f"optimizer tree keys {sorted(tree)} != params {sorted(names)}")
    return TrainState(model, opt)


def state_from_jax(state: Any, cfg: ModelConfig, device=None) -> TrainState:
    """A JAX ``TrainState`` (``jax.device_get`` of it: ``.params`` and
    ``.opt.step/m/v/master`` with numpy leaves) as a port ``TrainState`` on
    ``device``."""
    opt = state.opt
    return _state(_flatten(state.params), opt.step, _flatten(opt.m), _flatten(opt.v),
                  _flatten(opt.master), cfg, device)


def state_leaves(state: TrainState) -> Dict[str, torch.Tensor]:
    """The checkpoint leaves of a port ``TrainState``, keyed and ordered as
    the JAX checkpointer keys a JAX ``TrainState``."""
    cfg = state.params.cfg
    leaves = lambda tree, prefix: _flatten(_nest(_stack(tree, cfg)), prefix, "/")  # noqa: E731
    out = leaves(dict(state.params.named_parameters()), ".params/")
    out[".opt/.step"] = state.opt.step.detach()
    for name in ("m", "v", "master"):
        out.update(leaves(getattr(state.opt, name), f".opt/.{name}/"))
    return out


def state_from_leaves(leaves: Mapping[str, torch.Tensor], cfg: ModelConfig,
                      device=None) -> TrainState:
    """The reverse of ``state_leaves`` (extra keys are ignored)."""
    def tree(prefix):
        return {k[len(prefix):].replace("/", "."): t for k, t in leaves.items()
                if k.startswith(prefix)}
    return _state(tree(".params/"), leaves[".opt/.step"], tree(".opt/.m/"),
                  tree(".opt/.v/"), tree(".opt/.master/"), cfg, device)


def cache_to_jax_layout(caches: List[Cache], cfg: ModelConfig) -> Dict[str, Any]:
    """Per-layer port caches -> the JAX cache pytree, with numpy leaves."""
    P = len(cfg.block_pattern)
    reps, n_tail = _pattern_split(cfg)
    np_caches = [{k: v.detach().float().cpu().numpy() if v.is_floating_point()
                  else v.cpu().numpy() for k, v in c.items()} for c in caches]
    out: Dict[str, Any] = {"repeats": {}, "tail": {}}
    for j in range(P):
        layers = [np_caches[r * P + j] for r in range(reps)]
        out["repeats"][f"b{j}"] = {k: np.stack([c[k] for c in layers])
                                   for k in layers[0]}
    for j in range(n_tail):
        out["tail"][f"t{j}"] = np_caches[reps * P + j]
    return out
