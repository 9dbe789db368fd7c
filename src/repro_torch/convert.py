"""Carry weights and caches between the JAX package's pytrees and the port.

The JAX model stacks each pattern position's parameters along a leading
``repeat`` axis (``params["repeats"]["b{j}"]``) and keeps the depth remainder
in ``params["tail"]["t{j}"]``; the port has one module per layer. Leaf names
match the port's parameter names (``mixer.wq.kernel`` ...), and kernels keep
their ``[in, out]`` orientation, so leaves are copied as they are. Inputs are
numpy arrays (``jax.device_get`` of the pytree); nothing here imports JAX.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import Cache
from repro_torch.models.model import CausalLM


def _pattern_split(cfg: ModelConfig):
    p = cfg.block_pattern
    reps = cfg.num_layers // len(p)
    return reps, len(cfg.layer_kinds()) - reps * len(p)


def _flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    out = {}
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, dict):
            out.update(_flatten(val, name + "."))
        else:
            out[name] = val
    return out


def to_tensor(arr) -> torch.Tensor:
    """numpy array (bfloat16 included) -> CPU tensor of the same dtype."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def params_from_jax(tree: Dict[str, Any], cfg: ModelConfig,
                    device=None) -> CausalLM:
    """The JAX ``init_params`` pytree (numpy leaves) as a port ``CausalLM`` on
    ``device`` (the card unless ``"cpu"``)."""
    P = len(cfg.block_pattern)
    reps, _ = _pattern_split(cfg)
    state: Dict[str, torch.Tensor] = {}
    for name, arr in _flatten(tree).items():
        group, _, rest = name.partition(".")
        if group == "repeats":
            slot, _, leaf = rest.partition(".")
            j = int(slot[1:])
            for r in range(reps):
                state[f"layers.{r * P + j}.{leaf}"] = to_tensor(arr[r])
        elif group == "tail":
            slot, _, leaf = rest.partition(".")
            state[f"layers.{reps * P + int(slot[1:])}.{leaf}"] = to_tensor(arr)
        else:
            state[name] = to_tensor(arr)
    model = CausalLM(cfg, device=device)
    model.load_state_dict(state, strict=True)
    return model


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
