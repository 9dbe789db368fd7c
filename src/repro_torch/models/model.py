"""Decoder-only causal LM of the port (counterpart of ``repro.models.model``).

Ported block kinds: dense ``attn``/``local``, RecurrentGemma ``rglru`` and
xLSTM ``mlstm``/``slstm``; also tied embeddings (the table as the head, the
input scaled by √d) and the logit softcap. Layers are an ``nn.ModuleList``
in depth order, where the JAX package scans over stacked pattern repeats;
``repro_torch.convert`` maps one layout onto the other. The model serves
(prefill and decode), so parameters carry no gradient.

  prefill      full prompt -> logits of the last position, filled caches
  decode_step  one token against the caches, which it updates in place
"""
from __future__ import annotations

import math
from typing import List, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.attention import Attention, Cache, init_kv_cache
from repro_torch.models.layers import MLP, Dense, Embedding, make_norm, softcap
from repro_torch.models.rglru import RGLRUBlock, init_rglru_cache
from repro_torch.models.xlstm import (MLSTMBlock, SLSTMBlock, init_mlstm_cache,
                                      init_slstm_cache)

_PORTED = ("attn", "local", "rglru", "mlstm", "slstm")
_WITH_MLP = ("attn", "local", "rglru")


def _check_supported(cfg: ModelConfig) -> None:
    for kind in cfg.layer_kinds():
        if kind not in _PORTED:
            raise ValueError(kind)
    unported = {
        "moe": cfg.moe is not None,
        "num_codebooks": cfg.num_codebooks > 0,
        "input_mode=embeddings": cfg.input_mode != "tokens",
    }
    missing = [k for k, v in unported.items() if v]
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not ported yet "
            "(ROADMAP.md, queue 1: other model families)")


def _theta(cfg: ModelConfig, kind: str) -> float:
    if kind == "local" and cfg.rope_theta_local:
        return cfg.rope_theta_local
    return cfg.rope_theta


class Block(nn.Module):
    """Pre-norm block (``apply_block``): the mixer (attention or the RG-LRU
    branch) then a gated MLP for ``attn``/``local``/``rglru``; for
    ``mlstm``/``slstm`` the mixer alone, ``x + mixer(pre_norm(x))``."""

    def __init__(self, kind: str, cfg: ModelConfig, *, dtype, device):
        super().__init__()
        self.kind = kind
        self.pre_norm = make_norm(cfg.norm, cfg.d_model, device=device)
        if kind in ("attn", "local"):
            window = cfg.window_size if kind == "local" else 0
            self.mixer = Attention(cfg, window=window, theta=_theta(cfg, kind),
                                   dtype=dtype, device=device)
        else:
            mixer = {"rglru": RGLRUBlock, "mlstm": MLSTMBlock, "slstm": SLSTMBlock}[kind]
            self.mixer = mixer(cfg, dtype=dtype, device=device)
        self.mlp = None
        if kind in _WITH_MLP:
            self.mlp_norm = make_norm(cfg.norm, cfg.d_model, device=device)
            self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.act, dtype=dtype, device=device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.pre_norm.reset_parameters()
        self.mixer.reset_parameters(generator)
        if self.mlp is not None:
            self.mlp_norm.reset_parameters()
            self.mlp.reset_parameters(generator)

    def _finish(self, x, y):
        x = x + y
        if self.mlp is None:
            return x
        return x + self.mlp(self.mlp_norm(x))

    def prefill(self, x, max_len: int):
        y, cache = self.mixer.prefill(self.pre_norm(x), max_len)
        return self._finish(x, y), cache

    def decode(self, x, cache: Cache, cur_pos: int):
        y, cache = self.mixer.decode(self.pre_norm(x), cache, cur_pos)
        return self._finish(x, y), cache


class CausalLM(nn.Module):
    """Parameters are allocated uninitialised, on ``device`` (the card unless
    ``"cpu"``); see ``init_params``. With ``tie_embeddings`` there is no
    ``head``: the logits are ``x @ embed.table.T``."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        _check_supported(cfg)
        device = resolve_device(device)
        self.cfg = cfg
        dtype = getattr(torch, cfg.param_dtype)
        self.compute_dtype = getattr(torch, cfg.compute_dtype)
        self.embed = Embedding(cfg.vocab_size, cfg.d_model, dtype=dtype,
                               device=device)
        self.layers = nn.ModuleList(
            Block(kind, cfg, dtype=dtype, device=device)
            for kind in cfg.layer_kinds())
        self.final_norm = make_norm(cfg.norm, cfg.d_model, device=device)
        self.head = None if cfg.tie_embeddings else Dense(
            cfg.d_model, cfg.vocab_size, dtype=dtype, device=device)
        # the input scale √d, rounded to the compute dtype first (50.5 in bf16
        # for d 2560), as JAX multiplies by a compute-dtype scalar
        self.embed_scale = torch.tensor(math.sqrt(cfg.d_model),
                                        dtype=self.compute_dtype).item()

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    def copy_to(self, device) -> "CausalLM":
        """A copy of this model with its parameters on ``device``."""
        other = CausalLM(self.cfg, device=device)
        other.load_state_dict(self.state_dict())
        return other

    def _embed_in(self, tokens):
        x = self.embed(tokens, self.compute_dtype)
        return x * self.embed_scale if self.cfg.tie_embeddings else x

    def _head_out(self, x):
        x = self.final_norm(x)
        logits = self.embed.unembed(x) if self.head is None else self.head(x)
        return softcap(logits.float(), self.cfg.logit_softcap)


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> CausalLM:
    """Random weights drawn on ``device`` (the card unless ``"cpu"``) as
    ``repro.models.model.init_params`` draws them: dense kernels normal·1/√in,
    embedding normal·0.02 (both drawn in float32, stored in ``param_dtype``),
    zero biases, RMSNorm scales zero, LayerNorm scales one; the xLSTM blocks'
    own leaves as their ``reset_parameters`` say."""
    model = CausalLM(cfg, device=device)
    with torch.no_grad():
        model.embed.reset_parameters(generator)
        model.final_norm.reset_parameters()
        if model.head is not None:
            model.head.reset_parameters(generator)
        for block in model.layers:
            block.reset_parameters(generator)
    return model


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               dtype=torch.bfloat16, device=None) -> List[Cache]:
    """One empty cache per layer, by its kind, on ``device`` (the card unless
    ``"cpu"``)."""
    device = resolve_device(device)

    def one(kind: str) -> Cache:
        if kind == "mlstm":
            return init_mlstm_cache(cfg, batch, dtype=dtype, device=device)
        if kind == "slstm":
            return init_slstm_cache(cfg, batch, device=device)
        if kind == "rglru":
            return init_rglru_cache(cfg, batch, dtype=dtype, device=device)
        return init_kv_cache(cfg, batch, max_len,
                             window=cfg.window_size if kind == "local" else 0,
                             dtype=dtype, device=device)

    return [one(kind) for kind in cfg.layer_kinds()]


def prefill(model: CausalLM, tokens: torch.Tensor, *,
            max_len: int = 0) -> Tuple[torch.Tensor, List[Cache]]:
    """tokens [B, S] -> (float32 logits of the last position [B, V], caches)."""
    x = model._embed_in(tokens)
    caches = []
    for block in model.layers:
        x, cache = block.prefill(x, max_len)
        caches.append(cache)
    return model._head_out(x[:, -1:])[:, 0], caches


def decode_step(model: CausalLM, caches: List[Cache], tokens: torch.Tensor,
                cur_pos: int) -> Tuple[torch.Tensor, List[Cache]]:
    """tokens [B, 1] at position ``cur_pos`` (uniform over the batch) ->
    (float32 logits [B, V], caches). The caches are updated in place."""
    x = model._embed_in(tokens)
    for block, cache in zip(model.layers, caches):
        x, _ = block.decode(x, cache, cur_pos)
    return model._head_out(x)[:, 0], caches
