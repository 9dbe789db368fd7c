"""Model and training configuration dataclasses (the port's own copy of
``repro.configs.base``).

Every architecture is a ``ModelConfig``: a decoder-only stack whose per-layer
*kind* is ``block_pattern`` repeated over ``num_layers``. Block kinds:

  ``attn``   global causal self-attention + gated MLP
  ``local``  sliding-window causal self-attention + gated MLP
  ``rglru``  RG-LRU recurrent block (Griffin-style) + gated MLP
  ``mlstm``  mLSTM block (matrix memory, chunkwise-parallel), self-contained
  ``slstm``  sLSTM block (scalar memory, sequential recurrence), self-contained

The fields are those of the JAX package, so a config converts field by field;
the port's model raises ``ValueError`` on a block kind it does not know.
``param_count`` (the analytic count behind MODEL_FLOPS = 6 N D) and the dry
run's cell shapes (``ShapeConfig``, ``shapes_for``) are the JAX module's.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    num_groups: int = 0
    expert_parallel: bool = False


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | hybrid | ssm | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    block_pattern: Tuple[str, ...] = ("attn",)
    window_size: int = 0              # sliding window for "local" blocks
    qkv_bias: bool = False
    qk_norm: bool = False
    logit_softcap: float = 0.0
    rope_theta: float = 10_000.0
    rope_theta_local: float = 0.0
    norm: str = "rmsnorm"             # rmsnorm | layernorm
    act: str = "silu"                 # silu | gelu
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    num_codebooks: int = 0
    input_mode: str = "tokens"        # tokens | embeddings
    rnn_width: int = 0
    conv_width: int = 4
    mlstm_proj_factor: float = 2.0
    slstm_proj_factor: float = 4.0 / 3.0
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    supports_long_context: bool = False

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def lru_width(self) -> int:
        return self.rnn_width or self.d_model

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer block kinds, pattern repeated/truncated to num_layers."""
        p = self.block_pattern
        reps = (self.num_layers + len(p) - 1) // len(p)
        return tuple((p * reps)[: self.num_layers])

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ---- parameter count (analytic; used for MODEL_FLOPS = 6 N D) ----
    def param_count(self, active_only: bool = False) -> int:
        d, ff = self.d_model, self.d_ff
        n = 0
        emb = self.vocab_size * d
        n += emb  # input embedding
        if not self.tie_embeddings:
            if self.num_codebooks > 0:
                n += self.num_codebooks * self.vocab_size * d
            else:
                n += emb
        for kind in self.layer_kinds():
            if kind in ("attn", "local"):
                n += d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
                if self.qkv_bias:
                    n += self.q_dim + 2 * self.kv_dim
                if self.moe is not None:
                    e = self.moe.top_k if active_only else self.moe.num_experts
                    n += d * self.moe.num_experts  # router
                    n += e * 3 * d * self.moe.d_ff_expert
                else:
                    n += 3 * d * ff
                n += 2 * d  # norms
            elif kind == "rglru":
                w = self.lru_width
                n += 2 * d * w + w * d          # branch in/out projections
                n += self.conv_width * w         # temporal conv
                n += 2 * w * w                   # gate projections (block-diag approx)
                n += 2 * w                       # Lambda + input-gate params
                n += 3 * d * ff + 2 * d          # MLP + norms
            elif kind == "mlstm":
                inner = int(self.d_model * self.mlstm_proj_factor)
                n += 2 * d * inner               # up (x and gate)
                n += 3 * inner * inner // 1      # q,k,v projections (inner->inner)
                n += 2 * inner                   # i,f gate projections (per-dim)
                n += inner * d                   # down
                n += 2 * d
            elif kind == "slstm":
                inner = int(self.d_model * self.slstm_proj_factor)
                n += 4 * d * d                   # z,i,f,o input projections
                n += 4 * d * self.head_dim       # block-diag recurrent weights
                n += 4 * d                       # biases
                n += d * inner + inner * d       # post-FFN
                n += 2 * d
        return n


@dataclass(frozen=True)
class ShapeConfig:
    """One (workload shape) cell: what the dry run traces."""
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524_288, 1, "decode")

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in ALL_SHAPES}


def shapes_for(cfg: ModelConfig) -> Tuple[ShapeConfig, ...]:
    """Shapes applicable to this architecture (long_500k needs sub-quadratic)."""
    out = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if cfg.supports_long_context:
        out.append(LONG_500K)
    return tuple(out)


@dataclass(frozen=True)
class TrainConfig:
    """Per-run training hyperparameters / distribution knobs (the JAX
    package's fields and defaults). ``zero1`` cuts m, v and the float32
    master over the data-parallel ranks (nothing to cut on one device);
    ``sequence_parallel`` cuts the residual stream on the sequence over the
    model group where the trainer's ``model_size`` is above 1 and divides
    the sequence (a change of layout, not of the loss); ``remat`` other
    than ``"none"`` recomputes each pattern repetition in the backward
    pass."""
    microbatch: int = 0            # 0 -> no gradient accumulation
    remat: str = "block"           # none | block | full
    zero1: bool = True             # shard optimizer state over data axis
    sequence_parallel: bool = False
    grad_compression: str = "none" # none | int8
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    z_loss: float = 1e-4
