"""Where the benchmark touches the program (``repro_torch``): its model
configuration built from the configuration's file, and the benchmark's
weights copied into the program's parameters."""
from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

import torch


def model_config(model: dict):
    """The program's ``ModelConfig`` from the ``model`` object of a
    configuration's file (every field stated there)."""
    from repro_torch.configs.base import ModelConfig
    fields = dict(model)
    fields["block_pattern"] = tuple(fields["block_pattern"])
    if fields.get("moe") is not None:
        raise ValueError("the benchmark's configurations hold no MoE yet")
    fields.pop("moe", None)
    return ModelConfig(**fields)


@torch.no_grad()
def load(named: Dict[str, torch.Tensor], drawn: Iterable[Tuple[str, torch.Tensor]],
         master: Optional[Dict[str, torch.Tensor]] = None) -> None:
    """Copy each (name, tensor) of ``drawn`` into the parameter of that name
    (and into the float32 ``master`` copy of a training state). The names,
    shapes and dtypes must be the program's, one for one."""
    seen = set()
    for name, t in drawn:
        if name not in named:
            raise KeyError(f"the program has no parameter {name!r}")
        p = named[name]
        if tuple(p.shape) != tuple(t.shape) or p.dtype != t.dtype:
            raise ValueError(f"{name}: the program holds {tuple(p.shape)} {p.dtype}, the "
                             f"benchmark draws {tuple(t.shape)} {t.dtype}")
        p.copy_(t)
        if master is not None:
            master[name].copy_(t)
        seen.add(name)
    missing = set(named) - seen
    if missing:
        raise KeyError(f"the benchmark draws no weights for {sorted(missing)[:5]} ...")
