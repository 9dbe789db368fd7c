"""Deterministic synthetic data pipeline (counterpart of
``repro.data.pipeline``).

Step-indexed: ``batch(step)`` is a pure function of (seed, step, shape),
drawn with the JAX package's numpy generator and seeds, so the port and the
JAX package see the same bytes; a restarted or resized job regenerates the
batches it would have seen.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike


class SyntheticLM:
    """Zipf-ish token stream + next-token labels, as torch tensors on
    ``device`` (the CPU unless given)."""

    def __init__(self, cfg: ModelConfig, *, seed: int = 0, device: DeviceLike = "cpu"):
        self.cfg = cfg
        self.seed = seed
        self.device = torch.device(device)

    def batch(self, step: int, global_batch: int, seq_len: int, *, host_id: int = 0,
              host_count: int = 1) -> Dict[str, torch.Tensor]:
        assert global_batch % host_count == 0
        rows = global_batch // host_count
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 7919 + host_id)
        # zipf-like marginal over the vocab (clipped)
        z = rng.zipf(1.3, size=(rows, seq_len + 1))
        toks = np.minimum(z - 1, self.cfg.vocab_size - 1).astype(np.int32)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if self.cfg.num_codebooks:
            batch["labels"] = np.stack(
                [batch["labels"]] * self.cfg.num_codebooks, axis=-1)
        if self.cfg.input_mode == "embeddings":
            emb = rng.standard_normal(
                (rows, seq_len, self.cfg.d_model)).astype(np.float32)
            batch = {"embeds": emb, "labels": batch["labels"]}
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in batch.items()}

    def data_fn(self, step: int, global_batch: int, seq_len: int) -> Dict[str, torch.Tensor]:
        return self.batch(step, global_batch, seq_len)
