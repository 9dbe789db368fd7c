"""Per-cell (arch x shape x mesh) plans and abstract input specs
(counterpart of ``repro.launch.specs``).

``input_specs`` returns ``meta`` tensors for every model input of a cell:
nothing is allocated. ``cell_plan`` picks the distribution knobs (FSDP,
microbatching, sequence parallelism, MoE groups) from the arch, shape and
mesh geometry, by the JAX package's rules; the dry run
(``launch.dryrun``) counts the step each plan gives.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.sharding import partitioning as pt

# Per-chip activation budget targeted by the microbatch heuristic (bytes).
_ACT_BUDGET = 3.0e9
# Params-per-chip threshold beyond which we turn on FSDP (ZeRO-3).
_FSDP_THRESHOLD = 4.0e9


@dataclasses.dataclass(frozen=True)
class CellPlan:
    tcfg: TrainConfig
    fsdp: bool
    moe_groups: int
    max_len: int  # serving cache length
    tp: int = 0   # 0 = full model-axis TP; 1 = pure FSDP/DP layout

    def as_dict(self):
        return {"fsdp": self.fsdp, "microbatch": self.tcfg.microbatch,
                "sequence_parallel": self.tcfg.sequence_parallel,
                "remat": self.tcfg.remat, "moe_groups": self.moe_groups,
                "tp": self.tp}


def _divisor_at_most(n: int, k: int) -> int:
    """Largest divisor of n that is <= k."""
    k = max(1, min(n, k))
    for d in range(k, 0, -1):
        if n % d == 0:
            return d
    return 1


def cell_plan(cfg: ModelConfig, shape: ShapeConfig, mesh,
              tp: int = -1) -> CellPlan:
    """tp=-1 (auto): training takes the pure-FSDP layout (tp=1), serving
    full model-axis TP (tp=0), as the JAX package chooses; an explicit 0 or
    1 forces a layout. FSDP where bf16 parameters a chip exceed 2 GB
    (training: float32 gradients, and the accumulation buffer when
    microbatching, would otherwise take the memory) or 4 GB (serving);
    microbatches that keep a rank's activations near ``_ACT_BUDGET``."""
    if tp < 0:
        tp = 1 if shape.kind == "train" else 0
    msz = mesh.shape["model"] if tp == 0 else tp
    dp = pt.dp_size(mesh, tp)
    param_bytes = cfg.param_count() * 2  # bf16
    # ssm-family mixers are replicated (no useful 16-way TP at 4 heads), so
    # their effective TP for storage is ~1.
    tp_eff = 1 if cfg.family == "ssm" else msz
    per_chip = param_bytes / tp_eff
    fsdp = (per_chip > 2.0e9) if shape.kind == "train" else \
        (per_chip > _FSDP_THRESHOLD)
    seq_par = fsdp or cfg.d_model >= 6000

    microbatch = 0
    if shape.kind == "train":
        local_b = max(1, shape.global_batch // dp)
        # saved carries: one residual per pattern repetition
        reps = max(1, cfg.num_layers // len(cfg.block_pattern))
        carry = shape.seq_len * cfg.d_model * 2 * reps
        if seq_par:
            carry /= msz
        # working set of one rematted block ~ S*d*2B*8
        work = shape.seq_len * cfg.d_model * 2 * 8
        mb_local = max(1, int(_ACT_BUDGET / max(carry + work, 1)))
        mb_local = _divisor_at_most(local_b, mb_local)
        if mb_local < local_b:
            microbatch = local_b // mb_local

    if cfg.moe is not None:
        tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                       else 1)
        moe_groups = _divisor_at_most(tokens, dp)
    else:
        moe_groups = 1

    tcfg = TrainConfig(microbatch=microbatch, remat="full",
                       sequence_parallel=seq_par, zero1=True)
    return CellPlan(tcfg=tcfg, fsdp=fsdp or tp == 1, moe_groups=moe_groups,
                    max_len=shape.seq_len, tp=tp)


# --------------------------------------------------------------- input specs


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, torch.Tensor]:
    """Abstract model inputs for one cell (``meta`` tensors)."""
    B, S = shape.global_batch, shape.seq_len
    cdt = getattr(torch, cfg.compute_dtype)

    def meta(shape_, dtype):
        return torch.empty(shape_, dtype=dtype, device="meta")

    if shape.kind == "train":
        if cfg.input_mode == "embeddings":
            batch = {"embeds": meta((B, S, cfg.d_model), cdt)}
        else:
            batch = {"tokens": meta((B, S), torch.int32)}
        lbl_shape = (B, S, cfg.num_codebooks) if cfg.num_codebooks else (B, S)
        batch["labels"] = meta(lbl_shape, torch.int32)
        return batch
    if shape.kind == "prefill":
        if cfg.input_mode == "embeddings":
            return {"batch_in": meta((B, S, cfg.d_model), cdt)}
        return {"batch_in": meta((B, S), torch.int32)}
    # decode: one new token against a cache of length S
    if cfg.input_mode == "embeddings":
        tok = meta((B, 1, cfg.d_model), cdt)
    else:
        tok = meta((B, 1), torch.int32)
    return {"tokens": tok, "cur_pos": meta((), torch.int32)}


def batch_shardings(cfg: ModelConfig, shape: ShapeConfig, mesh,
                    tp: int = 0) -> Dict[str, pt.Spec]:
    """Specs matching input_specs."""
    specs = {}
    for k, v in input_specs(cfg, shape).items():
        if k == "cur_pos":
            specs[k] = pt.Spec()
        else:
            specs[k] = pt.data_spec(mesh, tuple(v.shape), tp=tp)
    return specs
