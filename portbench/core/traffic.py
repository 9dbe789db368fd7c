"""The one traffic generator: it reads a mix's parameters (``traffic/<mix>.json``)
and makes the cell's inputs from the seed. Kinds:

* ``tokens``: ``distinct_batches`` training batches of ``batch`` rows of
  ``seq_len`` + 1 token ids, Zipf-like with exponent ``zipf`` over the
  vocabulary (truncated and normalised over it), made on the device and
  cycled: ``tokens`` the first ``seq_len``, ``labels`` the next.
* ``embeds``: as many batches of per-frame embeddings [batch, seq_len,
  d_model], standard normal in the compute dtype, and codebook labels
  [batch, seq_len, num_codebooks], Zipf-like over the codebook's vocabulary.

The ``tokens`` generator is modelled on ``src/repro_torch/data/pipeline.py``
(``SyntheticLM``: ``np.random.zipf(1.3)`` clipped to the vocabulary), drawn
here on the device and normalised over the vocabulary instead.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch


def zipf_cdf(vocab: int, a: float) -> np.ndarray:
    """The cumulative distribution of ids 0..vocab-1 with weight (id + 1)^-a."""
    w = np.arange(1, vocab + 1, dtype=np.float64) ** -a
    cdf = np.cumsum(w)
    return cdf / cdf[-1]


def zipf_ids(shape, vocab: int, a: float, gen: torch.Generator, device) -> torch.Tensor:
    cdf = torch.as_tensor(zipf_cdf(vocab, a), device=device)
    u = torch.rand(shape, generator=gen, dtype=torch.float64, device=device)
    return torch.searchsorted(cdf, u).clamp_max(vocab - 1)


def train_batches(traffic: dict, model: dict, seed: int, device) -> List[dict]:
    """The ``distinct_batches`` training batches of a ``tokens`` or
    ``embeds`` mix, on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    K, B, S = traffic["distinct_batches"], traffic["batch"], traffic["seq_len"]
    if traffic["kind"] == "tokens":
        t = zipf_ids((K, B, S + 1), model["vocab_size"], traffic["zipf"], gen, device)
        return [{"tokens": t[i, :, :-1].contiguous(), "labels": t[i, :, 1:].contiguous()}
                for i in range(K)]
    if traffic["kind"] == "embeds":
        dtype = getattr(torch, model["compute_dtype"])
        out = []
        for _ in range(K):
            emb = torch.randn((B, S, model["d_model"]), generator=gen, dtype=torch.float32,
                              device=device).to(dtype)
            labels = zipf_ids((B, S, model["num_codebooks"]), model["vocab_size"],
                              traffic["zipf"], gen, device)
            out.append({"embeds": emb, "labels": labels})
        return out
    raise ValueError(f"no training traffic of kind {traffic['kind']!r}")
