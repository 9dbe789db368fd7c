"""Plain float32 decoder-only transformer, as the port runs it: the
benchmark's reference for dense ``attn`` stacks (musicgen-large).

Frozen copies, taken at commit 02043fe, of the formulas of
``src/repro_torch/models/model.py`` (pre-norm blocks, attention then a gated
MLP, a final norm; per-frame embedding inputs taken as they are where
``input_mode`` is ``embeddings``; ``num_codebooks`` heads as one dense
``[d, C·V]`` read as ``[..., C, V]``), ``models/attention.py`` (q, k, v
projections without bias, rope on split halves, causal softmax attention at
1/√hd, grouped kv heads) and ``models/layers.py`` (the gated MLP
``wo(act(wi_gate x) · wi_up x)``). It imports nothing of the program. Every
product goes through ``mm``, so the same code gives the float32 reference
and the float8 control.
"""
from __future__ import annotations

import functools
import json
import math
from typing import List, Optional

import torch

from portbench.core import work
from portbench.reference.common import (F32, Leaf, Matmul, Params, checkpointed,
                                        cross_entropy, dense, gelu, layernorm, matmul,
                                        norm_leaves, rope, select)


def layer_kinds(cfg: dict) -> List[str]:
    p = list(cfg["block_pattern"])
    reps = (cfg["num_layers"] + len(p) - 1) // len(p)
    return (p * reps)[: cfg["num_layers"]]


def leaves(cfg: dict) -> List[Leaf]:
    """Every parameter with the init of the port's ``init_params``."""
    d, V, dt = cfg["d_model"], cfg["vocab_size"], cfg["param_dtype"]
    q_dim = cfg["num_heads"] * cfg["head_dim"]
    kv_dim = cfg["num_kv_heads"] * cfg["head_dim"]
    out = [Leaf("embed.table", (V, d), dt, "normal", 0.02)]
    for i, kind in enumerate(layer_kinds(cfg)):
        if kind != "attn":
            raise ValueError(f"the transformer reference has no block {kind!r}")
        p = f"layers.{i}."
        out += norm_leaves(p + "pre_norm", d)
        out += dense(p + "mixer.wq", d, q_dim, dt) + dense(p + "mixer.wk", d, kv_dim, dt)
        out += dense(p + "mixer.wv", d, kv_dim, dt) + dense(p + "mixer.wo", q_dim, d, dt)
        out += norm_leaves(p + "mlp_norm", d)
        out += dense(p + "mlp.wi_gate", d, cfg["d_ff"], dt)
        out += dense(p + "mlp.wi_up", d, cfg["d_ff"], dt)
        out += dense(p + "mlp.wo", cfg["d_ff"], d, dt)
    out += norm_leaves("final_norm", d)
    out += dense("head", d, V * max(cfg["num_codebooks"], 1), dt)
    return out


def attention(q, k, v, mm: Matmul):
    """Causal softmax attention: q [B,S,H,hd], k/v [B,S,K,hd] -> [B,S,H,hd]."""
    B, S, H, hd = q.shape
    G = H // k.shape[2]
    k = k.repeat_interleave(G, dim=2)
    v = v.repeat_interleave(G, dim=2)
    s = mm(q.transpose(1, 2), k.permute(0, 2, 3, 1)) / math.sqrt(hd)   # [B,H,S,S]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
    return mm(p, v.transpose(1, 2)).transpose(1, 2)


def block(P: Params, p: str, x, cfg: dict, mm: Matmul):
    B, S, _ = x.shape
    H, K, hd = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    pos = torch.arange(S, device=x.device)
    h = layernorm(x, P[p + "pre_norm.scale"], P[p + "pre_norm.bias"])
    q = rope(mm(h, P[p + "mixer.wq.kernel"]).reshape(B, S, H, hd), pos, cfg["rope_theta"])
    k = rope(mm(h, P[p + "mixer.wk.kernel"]).reshape(B, S, K, hd), pos, cfg["rope_theta"])
    v = mm(h, P[p + "mixer.wv.kernel"]).reshape(B, S, K, hd)
    x = mm.carry(x + mm(attention(q, k, v, mm).reshape(B, S, H * hd),
                        P[p + "mixer.wo.kernel"]))
    h = layernorm(x, P[p + "mlp_norm.scale"], P[p + "mlp_norm.bias"])
    up = gelu(mm(h, P[p + "mlp.wi_gate.kernel"])) * mm(h, P[p + "mlp.wi_up.kernel"])
    return mm.carry(x + mm(up, P[p + "mlp.wo.kernel"]))


def forward(P: Params, inputs: torch.Tensor, cfg: dict, mm: Matmul = matmul,
            remat: bool = False, keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """inputs: token ids [B, S], or embeddings [B, S, D] -> float32 logits
    [B, S, V] ([B, S, C, V] with codebooks), at ``keep`` [B, n] only where
    given."""
    if cfg["input_mode"] == "embeddings":
        x = inputs.to(F32)
    else:
        x = P["embed.table"][inputs].to(F32)
    for i in range(cfg["num_layers"]):
        x = checkpointed(lambda x, p=f"layers.{i}.": block(P, p, x, cfg, mm), remat)(x)
    x = layernorm(select(x, keep), P["final_norm.scale"], P["final_norm.bias"])
    logits = mm(x, P["head.kernel"])
    if cfg["num_codebooks"]:
        logits = logits.unflatten(-1, (cfg["num_codebooks"], cfg["vocab_size"]))
    return logits


def loss(P: Params, batch: dict, cfg: dict, z_loss: float, mm: Matmul = matmul,
         remat: bool = True):
    inputs = batch["embeds"] if cfg["input_mode"] == "embeddings" else batch["tokens"]
    return cross_entropy(forward(P, inputs, cfg, mm, remat), batch["labels"], z_loss)[0]


@functools.lru_cache(maxsize=None)
def _matmul_weights(key: str) -> int:
    cfg = json.loads(key)
    return sum(math.prod(leaf.shape) for leaf in leaves(cfg)
               if leaf.name.endswith(".kernel"))


def matmul_weights(cfg: dict) -> int:
    """The weights that enter a product (the input embedding is a lookup)."""
    return _matmul_weights(json.dumps(cfg, sort_keys=True))


def model_flops(cfg: dict, phase: str, B: int, S: int) -> float:
    """Model FLOPs (PaLM, appendix B, with the causal pairs only: 2 a weight
    a token and 4 hd a visible (query, key) pair and head forward, 3x that
    trained; recomputation not counted) of one call: ``train`` or
    ``prefill`` over [B, S], or ``decode`` of B tokens at cache length S.
    The weights are every dense kernel (the input embedding is a lookup, or
    unused)."""
    n_mat = matmul_weights(cfg)
    H, hd, L = cfg["num_heads"], cfg["head_dim"], cfg["num_layers"]
    if phase == "decode":
        return float(2 * n_mat * B + L * 4 * B * H * hd * S)
    fwd = 2 * n_mat * B * S + L * 4 * B * H * hd * work.visible_pairs(S)
    return float(3 * fwd if phase == "train" else fwd)
