"""The shapes of the port's kernel calls in one call into the model, from
the configuration's widths; the kernel files (``kernels/<kernel>.py``) take
their calls from here."""
from __future__ import annotations

from typing import List


def layer_kinds(model: dict) -> List[str]:
    p = list(model["block_pattern"])
    reps = (model["num_layers"] + len(p) - 1) // len(p)
    return (p * reps)[: model["num_layers"]]


def forwards(model: dict, kind: str, call) -> int:
    """Forward calls of a ``kind`` layer's kernel in ``call``: one a layer,
    two in a training step under remat (the backward recomputes each
    block), none where the phase runs no such kernel."""
    n = layer_kinds(model).count(kind)
    if call.phase == "train":
        return n * (2 if call.remat else 1)
    return n


def backwards(model: dict, kind: str, call) -> int:
    return layer_kinds(model).count(kind) if call.phase == "train" else 0


def mlstm_dims(model: dict):
    inner = int(model["d_model"] * model["mlstm_proj_factor"])
    H = model["num_heads"]
    dv = inner // H
    return H, dv // 2, dv
