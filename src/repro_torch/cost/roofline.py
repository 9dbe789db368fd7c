"""Roofline scoring of a rank's counted step (counterpart of
``repro.hlo.roofline``).

Three measured terms (per device, from ``cost.analysis``'s totals):
    compute_s    = counted FLOPs / peak FLOPs
    memory_s     = HBM traffic (the eager cost model) / HBM_bw
    collective_s = collective wire bytes (ring factors) / link bw

plus two physics floors used for scoring:
    ideal_compute_s = MODEL_FLOPS / (devices x peak)
    ideal_memory_s  = mandatory bytes (stored weights + activations floor +
                      caches, each touched the minimum number of times) / bw

roofline_fraction = max(ideal_compute_s, ideal_memory_s) / max(terms)
  == 1.0 when the cell runs exactly at the binding physical roofline;
  small when the implementation moves more bytes / does more flops / talks
  more than physics requires.

``bound_s`` (the largest term) is the least time the counted program can
take on the card of ``hw`` (``launch.mesh.HW`` by default); a measured step
time t reaches ``bound_s / t`` of it.
"""
from __future__ import annotations

from typing import Dict, Optional

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch.mesh import HW


def _cache_bytes_global(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """KV/state cache bytes for a decode cell (global)."""
    B, S = shape.global_batch, shape.seq_len
    total = 0.0
    for kind in cfg.layer_kinds():
        if kind == "attn":
            total += 2 * B * S * cfg.kv_dim * 2
        elif kind == "local":
            total += 2 * B * min(cfg.window_size or S, S) * cfg.kv_dim * 2
        elif kind == "rglru":
            total += B * cfg.lru_width * 4
        elif kind == "mlstm":
            inner = int(cfg.d_model * cfg.mlstm_proj_factor)
            dv = inner // cfg.num_heads
            total += B * cfg.num_heads * (dv // 2) * dv * 4
        elif kind == "slstm":
            total += 4 * B * cfg.d_model * 4
    return total


def mandatory_bytes_per_chip(cfg: ModelConfig, shape: ShapeConfig,
                             devices: int, plan: Dict) -> float:
    """Optimistic per-chip HBM floor: stored weight shard read once per pass,
    residual activations written+read once, caches read once per token."""
    msz = plan.get("tp", 16) or 16
    dp = max(1, devices // msz)
    p_total = cfg.param_count() * 2.0                       # bf16
    p_active = cfg.param_count(active_only=True) * 2.0
    stored = p_total / (devices if plan.get("fsdp") else msz)
    d, L = cfg.d_model, cfg.num_layers
    if shape.kind == "train":
        tokens_l = shape.tokens / dp
        passes = 2.0                                        # fwd + bwd reads
        opt = 3 * 4 * cfg.param_count() * 2.0 / devices     # m,v,master r+w
        act = 2.0 * L * tokens_l * d * 2.0 / (msz if
                                              plan.get("sequence_parallel")
                                              else 1)
        return stored * passes + opt + act
    if shape.kind == "prefill":
        tokens_l = shape.tokens / dp
        act = 2.0 * L * tokens_l * d * 2.0
        cache = _cache_bytes_global(cfg, shape) / devices
        return stored + act + cache
    # decode: active weights + the whole cache shard, once per token
    cache = _cache_bytes_global(cfg, shape) / devices
    return p_active / (devices if plan.get("fsdp") else msz) + cache


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    n_matmul = cfg.param_count(active_only=True) \
        - cfg.vocab_size * cfg.d_model
    if shape.kind == "train":
        return 6.0 * n_matmul * shape.tokens
    if shape.kind == "prefill":
        return 2.0 * n_matmul * shape.tokens
    return 2.0 * n_matmul * shape.global_batch


def score(cfg: ModelConfig, shape: ShapeConfig, devices: int, plan: Dict,
          totals: Dict, hw: Optional[Dict] = None) -> Dict:
    """The roofline terms of a rank's ``totals`` (``cost.analysis``; the
    JAX package's HLO totals give the same result) on the card ``hw``."""
    hw = HW if hw is None else hw
    peak, hbm_bw, ici = (hw["peak_flops_bf16"], hw["hbm_bw"], hw["ici_bw"])
    f = totals["flops"]
    h = totals.get("hbm_bytes_tpu", totals["hbm_bytes"])
    c = totals["collective_bytes"]
    terms = {
        "compute_s": f / peak,
        "memory_s": h / hbm_bw,
        "collective_s": c / ici,
    }
    mf = model_flops(cfg, shape)
    floor_bytes = mandatory_bytes_per_chip(cfg, shape, devices, plan)
    ideal_compute = mf / (devices * peak)
    ideal_memory = floor_bytes / hbm_bw
    ideal_s = max(ideal_compute, ideal_memory)
    bound_s = max(terms.values())
    hlo_global = f * devices
    return {
        **terms,
        "dominant": max(terms, key=terms.get),
        "model_flops": mf,
        "hlo_flops_global": hlo_global,
        "useful_flops_ratio": mf / hlo_global if hlo_global else 0.0,
        "ideal_compute_s": ideal_compute,
        "ideal_memory_s": ideal_memory,
        "mandatory_bytes_per_chip": floor_bytes,
        "bound_s": bound_s,
        "roofline_fraction": ideal_s / bound_s if bound_s else 0.0,
    }
