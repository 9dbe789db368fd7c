"""The numbers that decide ``correct``, each set beside its limit.

Training, over the checked steps (PERF.md gives the look behind each choice):

* ``loss_gap``: the first step's loss, as a relative gap to the reference's.
  Later steps' losses are left out: AdamW's first steps move every weight by
  about the learning rate in the direction of its gradient's sign, so a
  rounding that flips the sign of a small gradient moves the loss of the
  next steps by percents in a sound run.
* ``grad_gap``: the first step's gradient, leaf by leaf, as a gap of norms
  (``|norm_program - norm_reference|``, not the norm of the difference) over
  the reference's norm of that leaf or of the median leaf, whichever is
  larger, taken at the median leaf of the head, the final norm and the last
  ``tail`` layers. The norms are before the clip (the program's from its
  first moment and its own global norm). At xlstm-1.3b's init the backward
  amplifies rounding through depth (the first positions' outputs are
  nearly zero before the per-head norm scales them up), so the first
  layers' gradients, and with them the global norm and the clip, swing
  between sound runs; the leaves nearest the loss are steady.
* ``head_grad_gap``: the same gap at the output head's leaf alone (against
  the median leaf of all), the gradient that the backward computes first,
  from the loss through the whole forward pass.
* ``change_gap``: the float32 master's change over the checked steps, leaf
  by leaf, as a gap of norms taken at the median leaf. Leaves whose
  reference gradient is under a thousandth of the median leaf's (nought to
  rounding, as the unused embedding table of an embeddings model) move by
  weight decay and round-off alone and are left out by that rule.
* ``update_gap``: the last checked step's AdamW update, recomputed from the
  optimizer's own m, v and master before and after it at sampled elements
  (``reference.common.update_gap``). It follows the program from its own
  state: the change over the steps swings with the global clip, which
  follows the first layers' gradients (PERF.md), so it cannot hold the
  update's formula to much under its own size; this number holds it to
  float32 rounding. The gradient it starts from is the other numbers'.
"""
from __future__ import annotations

import statistics
from typing import Dict, Optional

NEGLIGIBLE = 1e-3         # a reference gradient under this share of the median leaf's


def median_gap(prog: Dict[str, float], ref: Dict[str, float],
               keep: Optional[set] = None) -> float:
    """The median over leaves of |prog - ref| / max(ref, the median ref)."""
    names = [k for k in ref if keep is None or k in keep]
    med = statistics.median(ref[k] for k in names)
    return statistics.median(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in names)


def near_loss(name: str, num_layers: int, tail: int) -> bool:
    """The head, the final norm and the last ``tail`` layers' leaves."""
    if name.startswith(("head.", "final_norm.")):
        return True
    return name.startswith("layers.") and int(name.split(".")[1]) >= num_layers - tail


def train_values(prog, ref, num_layers: int, tail: int) -> Dict[str, float]:
    """Every training number; ``prog`` and ``ref`` are ``TrainReadings``."""
    gmed = statistics.median(ref.grad_norms.values())
    moved = {k for k, g in ref.grad_norms.items() if g >= NEGLIGIBLE * gmed}
    steady = {k for k in ref.grad_norms if near_loss(k, num_layers, tail)}
    head = {k for k in ref.grad_norms if k.startswith("head.")}
    return {"loss_gap": abs(prog.losses[0] - ref.losses[0]) / abs(ref.losses[0]),
            "head_grad_gap": median_gap(prog.grad_norms, ref.grad_norms, head) if head else 0.0,
            "grad_gap": median_gap(prog.grad_norms, ref.grad_norms, steady),
            "change_gap": median_gap(prog.change_norms, ref.change_norms, moved),
            "update_gap": prog.update_gap}


def train(prog, ref, limits: dict, num_layers: int, tail: int) -> Dict[str, dict]:
    """The numbers that the cell's ``limits`` name, each beside its limit."""
    values = train_values(prog, ref, num_layers, tail)
    return {k: {"value": values[k], "limit": limit} for k, limit in limits.items()}


def passed(checks: Dict[str, dict]) -> bool:
    return all(c["value"] == c["value"] and c["value"] <= c["limit"] for c in checks.values())
