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


@dataclass(frozen=True)
class TrainConfig:
    """Per-run training hyperparameters / distribution knobs (the JAX
    package's fields and defaults). ``zero1`` cuts m, v and the float32
    master over the data-parallel ranks (nothing to cut on one device);
    ``sequence_parallel`` waits for tensor parallelism (ROADMAP.md, queue 1
    item 4b) and changes nothing; ``remat`` other than ``"none"``
    recomputes each pattern repetition in the backward pass."""
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
