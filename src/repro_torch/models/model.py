"""Decoder-only causal LM of the port (counterpart of ``repro.models.model``).

Ported block kinds: dense ``attn``/``local`` (with QK-norm, and with the
sort-based MoE in place of the MLP where ``cfg.moe`` is set), RecurrentGemma
``rglru`` and xLSTM ``mlstm``/``slstm``; also tied embeddings (the table as
the head, the input scaled by √d), the logit softcap, and musicgen-large's
embedding inputs (``input_mode="embeddings"``: the input is a float
``[B, S, D]`` taken as it is, no table lookup) and codebook heads
(``num_codebooks`` C > 0: one ``Dense(d, C·V)``, logits ``[..., C, V]``).
Layers are an ``nn.ModuleList`` in depth order, where the JAX package scans over stacked
pattern repeats; ``repro_torch.convert`` maps one layout onto the other.
Parameters carry no gradient, so serving records no graph; a training state
(``repro_torch.training.train_step.init_state``) turns gradients on for its
own model.

  forward      train mode: full sequence -> float32 logits of every position
               and the MoE auxiliary losses summed over layers
  prefill      full prompt -> logits of the last position, filled caches
  decode_step  one token against the caches, which it updates in place

Each takes token ids ``[B, S]`` (``[B, 1]`` a decode step), or for an
embeddings arch float inputs ``[B, S, D]`` (``[B, 1, D]``).

Tensor parallelism (``CausalLM(cfg, mp=...)``, train mode): the model of a
rank holds every leaf cut as ``param_specs`` says on the rank's mesh
(``ModelParallel``), and its layers issue the collectives (see
``models.layers``). The residual stream stays replicated over the model
group. Under ``sequence_parallel`` (where S divides by the group, as
``make_constrain`` cuts ``residual``) it is cut on the sequence: each block
norms its block of the sequence, all-gathers it before the mixer (and the
MLP or MoE) and takes its block of the output back by a reduce-scatter
after a row-parallel product (by ``split`` after a replicated one: the
xLSTM mixers, the MoE). The head is column-parallel, or ``unembed`` for
tied embeddings, so the logits are this rank's block of the vocabulary; the
logit softcap acts on the block.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.attention import Attention, Cache, init_kv_cache
from repro_torch.models.layers import MLP, Dense, Embedding, make_norm, softcap
from repro_torch.models.moe import MoE
from repro_torch.models.rglru import RGLRUBlock, init_rglru_cache
from repro_torch.models.xlstm import (MLSTMBlock, SLSTMBlock, init_mlstm_cache,
                                      init_slstm_cache)
from repro_torch.sharding.partitioning import NONE, ModelParallel

_PORTED = ("attn", "local", "rglru", "mlstm", "slstm")
_WITH_MLP = ("attn", "local", "rglru")


def _check_supported(cfg: ModelConfig) -> None:
    for kind in cfg.layer_kinds():
        if kind not in _PORTED:
            raise ValueError(kind)


def _theta(cfg: ModelConfig, kind: str) -> float:
    if kind == "local" and cfg.rope_theta_local:
        return cfg.rope_theta_local
    return cfg.rope_theta


Aux = Dict[str, torch.Tensor]


class Block(nn.Module):
    """Pre-norm block (``apply_block``): the mixer (attention or the RG-LRU
    branch) then a gated MLP for ``attn``/``local``/``rglru``, or the MoE
    (``moe``; in train mode over ``moe_groups`` token groups, as the JAX
    model's argument, one group in prefill and decode) for ``attn``/``local``
    when ``cfg.moe`` is set; for ``mlstm``/``slstm`` the mixer alone,
    ``x + mixer(pre_norm(x))``."""
    mp = NONE

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
        self.mlp = self.moe = None
        if kind in ("attn", "local") and cfg.moe is not None:
            self.mlp_norm = make_norm(cfg.norm, cfg.d_model, device=device)
            self.moe = MoE(cfg, dtype=dtype, device=device)
        elif kind in _WITH_MLP:
            self.mlp_norm = make_norm(cfg.norm, cfg.d_model, device=device)
            self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.act, dtype=dtype, device=device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.pre_norm.reset_parameters()
        self.mixer.reset_parameters(generator)
        for ffn in (self.mlp, self.moe):
            if ffn is not None:
                self.mlp_norm.reset_parameters()
                ffn.reset_parameters(generator)

    def forward(self, x, moe_groups: int = 1, moe_mean=None,
                seq_cut: bool = False) -> Tuple[torch.Tensor, Aux]:
        """Train mode (``apply_block(mode="train")``): x [B,S,D] -> ([B,S,D],
        the MoE's auxiliary losses, or {}). ``moe_mean`` is ``MoE.forward``'s
        ``mean``. ``seq_cut``: x is this rank's block of the sequence
        (sequence parallelism), and so is the output."""
        y = self.mixer(self._whole(self.pre_norm(x), seq_cut), seq_cut)
        return self._finish(x, y, with_aux=True, groups=moe_groups, mean=moe_mean,
                            seq_cut=seq_cut)

    def _whole(self, h, seq_cut: bool):
        return self.mp.gather(h, 1) if seq_cut else h

    def _finish(self, x, y, with_aux: bool, groups: int = 1,
                mean=None, seq_cut: bool = False) -> Tuple[torch.Tensor, Aux]:
        x = x + y
        if self.moe is not None:
            y2, aux = self.moe(self._whole(self.mlp_norm(x), seq_cut), groups=groups,
                               with_aux=with_aux, mean=mean)
            return x + (self.mp.split(y2, 1) if seq_cut else y2), aux
        if self.mlp is None:
            return x, {}
        return x + self.mlp(self._whole(self.mlp_norm(x), seq_cut), seq_cut), {}

    def prefill(self, x, max_len: int):
        y, cache = self.mixer.prefill(self.pre_norm(x), max_len)
        return self._finish(x, y, with_aux=False)[0], cache

    def decode(self, x, cache: Cache, cur_pos: int):
        y, cache = self.mixer.decode(self.pre_norm(x), cache, cur_pos)
        return self._finish(x, y, with_aux=False)[0], cache


class CausalLM(nn.Module):
    """Parameters are allocated uninitialised, on ``device`` (the card unless
    ``"cpu"``); see ``init_params``. With ``tie_embeddings`` there is no
    ``head``: the logits are ``x @ embed.table.T``. With codebooks the head
    is ``[d, C·V]`` (whatever ``tie_embeddings``), and an embeddings arch
    still has the ``embed`` table, unused, as the JAX ``init_params`` draws
    it and a checkpoint carries it."""

    def __init__(self, cfg: ModelConfig, *, device=None, mp: ModelParallel = NONE):
        super().__init__()
        _check_supported(cfg)
        device = resolve_device(device)
        self.cfg, self.mp = cfg, mp
        cut = mp.size > 1 or mp.data_size > 1
        final, device = device, (torch.device("meta") if cut else device)
        dtype = getattr(torch, cfg.param_dtype)
        self.compute_dtype = getattr(torch, cfg.compute_dtype)
        self.embed = Embedding(cfg.vocab_size, cfg.d_model, dtype=dtype,
                               device=device)
        self.layers = nn.ModuleList(
            Block(kind, cfg, dtype=dtype, device=device)
            for kind in cfg.layer_kinds())
        self.final_norm = make_norm(cfg.norm, cfg.d_model, device=device)
        out = cfg.vocab_size * max(cfg.num_codebooks, 1)
        self.head = None if cfg.tie_embeddings and not cfg.num_codebooks else Dense(
            cfg.d_model, out, dtype=dtype, device=device)
        # the input scale √d, rounded to the compute dtype first (50.5 in bf16
        # for d 2560), as JAX multiplies by a compute-dtype scalar
        self.embed_scale = torch.tensor(math.sqrt(cfg.d_model),
                                        dtype=self.compute_dtype).item()
        if cut:
            self._cut_parameters(final)

    def _cut_parameters(self, device) -> None:
        """Re-allocate every parameter at this rank's cut (``param_specs``
        on the rank's ``ModelParallel``), on ``device``, and give every
        module the context."""
        from repro_torch.sharding import partitioning as pt
        specs = pt.param_specs(pt.param_shape_tree(self), self.cfg, self.mp)
        for name, p in list(self.named_parameters()):
            key, r = jax_leaf(name, self.cfg)
            spec = pt.layer_spec(specs[key.replace(".", "/")], r is not None)
            shape = pt.local_cut(p, spec, self.mp.coords(), self.mp).shape
            owner, _, leaf = name.rpartition(".")
            setattr(self.get_submodule(owner), leaf, nn.Parameter(
                torch.empty(shape, dtype=p.dtype, device=device), requires_grad=False))
        for module in self.modules():
            module.mp = self.mp

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    def copy_to(self, device) -> "CausalLM":
        """A copy of this model with its parameters on ``device``."""
        other = CausalLM(self.cfg, device=device, mp=self.mp)
        other.load_state_dict(self.state_dict())
        return other

    def _embed_in(self, inputs):
        if self.cfg.input_mode == "embeddings":
            x = inputs.to(self.compute_dtype)
        else:
            x = self.embed(inputs, self.compute_dtype)
        return x * self.embed_scale if self.cfg.tie_embeddings else x

    def _head_out(self, x, seq_cut: bool = False):
        """Logits in float32, softcapped: this rank's block of the
        vocabulary where the head (or the tied table) is cut, except with
        codebooks, whose logits are gathered whole."""
        x = self.final_norm(x)
        if seq_cut:
            x = self.mp.gather(x, 1)
        logits = self.embed.unembed(x) if self.head is None else self.head(x)
        if self.cfg.num_codebooks:
            if self.head.column:
                logits = self.mp.gather(logits, -1)
            logits = logits.unflatten(-1, (self.cfg.num_codebooks, self.cfg.vocab_size))
        return softcap(logits.float(), self.cfg.logit_softcap)

    def seq_cut_parameters(self) -> List[str]:
        """The replicated parameters that act on the sequence-cut residual
        under sequence parallelism (the blocks' norms and the final norm):
        each rank's gradient of them is a partial sum."""
        return [n for n, _ in self.named_parameters()
                if n.startswith("final_norm.") or ".pre_norm." in n or ".mlp_norm." in n]

    def _repeat(self, x, r: int, moe_groups: int = 1, moe_mean=None,
                seq_cut: bool = False) -> Tuple[torch.Tensor, List[Aux]]:
        P = len(self.cfg.block_pattern)
        auxs = []
        for block in self.layers[r * P:(r + 1) * P]:
            x, aux = block(x, moe_groups, moe_mean, seq_cut)
            auxs.append(aux)
        return x, auxs

    def forward(self, tokens: torch.Tensor, *, remat: str = "none", moe_groups: int = 1,
                moe_mean=None):
        """Train-mode forward (``repro.models.model.forward``): tokens [B, S]
        (or embeddings [B, S, D]) -> (float32 logits [B, S, V] (or
        [B, S, C, V]), aux). ``remat`` other than ``"none"``
        runs each pattern repetition, and each tail layer, under
        non-reentrant activation checkpointing (``jax.checkpoint`` of the
        scan body): its activations are recomputed in the backward pass, so
        its kernels launch twice a step. aux holds ``moe_lb`` and ``moe_z``
        summed over the layers in depth order when ``cfg.moe`` is set, and
        is empty otherwise. The MoE cuts the tokens into ``moe_groups``
        groups (the JAX ``forward``'s argument); ``moe_mean`` is
        ``MoE.forward``'s ``mean``, for a data-parallel rank's share of
        the batch."""
        x = self._embed_in(tokens)
        seq_cut = self.mp.seq_cut(x.shape[1])
        if seq_cut:
            x = self.mp.split(x, 1)
        P = len(self.cfg.block_pattern)
        reps = self.cfg.num_layers // P
        ckpt = remat != "none"
        auxs: List[Aux] = []
        for r in range(reps):
            args = (x, r, moe_groups, moe_mean, seq_cut)
            x, a = (checkpoint(self._repeat, *args, use_reentrant=False) if ckpt
                    else self._repeat(*args))
            auxs.extend(a)
        for block in self.layers[reps * P:]:
            args = (x, moe_groups, moe_mean, seq_cut)
            x, a = checkpoint(block, *args, use_reentrant=False) if ckpt else block(*args)
            auxs.append(a)
        total: Aux = {}
        for a in auxs:
            for k, v in a.items():
                total[k] = total[k] + v if k in total else v
        return self._head_out(x, seq_cut), total


def jax_leaf(name: str, cfg: ModelConfig) -> Tuple[str, Optional[int]]:
    """The JAX pytree leaf that the port's parameter ``name`` lives in, as a
    dotted path, and its index along that leaf's leading repeat axis: a
    pattern repetition's layer ``layers.{r*P + j}.<leaf>`` is row r of
    ``repeats.b{j}.<leaf>``, a tail layer is ``tail.t{j}.<leaf>`` (no repeat
    axis), anything else keeps its name."""
    if not name.startswith("layers."):
        return name, None
    _, i, leaf = name.split(".", 2)
    i, P = int(i), len(cfg.block_pattern)
    reps = cfg.num_layers // P
    if i < reps * P:
        return f"repeats.b{i % P}.{leaf}", i // P
    return f"tail.t{i - reps * P}.{leaf}", None


def _draw_order(model: CausalLM):
    """``init_params``' order: (part, whether it draws from the generator)."""
    yield "embed", True
    yield "final_norm", False
    if model.head is not None:
        yield "head", True
    for i in range(len(model.layers)):
        yield f"layers.{i}", True


def init_params(cfg: ModelConfig, generator: torch.Generator, device=None, *,
                mp: ModelParallel = NONE, init_device=None) -> CausalLM:
    """Random weights, on ``device`` (the card unless ``"cpu"``), drawn as
    ``repro.models.model.init_params`` draws them: dense kernels normal·1/√in,
    embedding normal·0.02 (both drawn in float32, stored in ``param_dtype``),
    zero biases, RMSNorm scales zero (QK-norm's too), LayerNorm scales one;
    the MoE's router (float32) and expert leaves, and the xLSTM blocks' own
    leaves, as their ``reset_parameters`` say. With ``mp``, cut to its rank.

    Each part (the embedding, the final norm, the head, a block) is drawn
    whole on ``init_device`` (``device`` by default; ``generator``'s
    device), in that order, its cut copied into the model and the part
    dropped: beside the model a rank holds one whole part, never the whole
    model."""
    from repro_torch.sharding import partitioning as pt
    model = CausalLM(cfg, device=device, mp=mp)
    init_device = model.device if init_device is None else resolve_device(init_device)
    whole = CausalLM(cfg, device="meta")
    specs = pt.param_specs(pt.param_shape_tree(whole), cfg, mp)
    with torch.no_grad():
        for name, draws in _draw_order(whole):
            part = whole.get_submodule(name).to_empty(device=init_device)
            part.reset_parameters(generator) if draws else part.reset_parameters()
            for leaf, p in part.named_parameters(prefix=name):
                key, r = jax_leaf(leaf, cfg)
                spec = pt.layer_spec(specs[key.replace(".", "/")], r is not None)
                model.get_parameter(leaf).copy_(pt.local_cut(p, spec, mp.coords(), mp))
            part.to_empty(device="meta")
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
    """tokens [B, S] (or embeddings [B, S, D]) -> (float32 logits of the
    last position [B, V] (or [B, C, V]), caches)."""
    x = model._embed_in(tokens)
    caches = []
    for block in model.layers:
        x, cache = block.prefill(x, max_len)
        caches.append(cache)
    return model._head_out(x[:, -1:])[:, 0], caches


def decode_step(model: CausalLM, caches: List[Cache], tokens: torch.Tensor,
                cur_pos: int) -> Tuple[torch.Tensor, List[Cache]]:
    """tokens [B, 1] (or embeddings [B, 1, D]) at position ``cur_pos``
    (uniform over the batch) -> (float32 logits [B, V] (or [B, C, V]),
    caches). The caches are updated in place."""
    x = model._embed_in(tokens)
    for block, cache in zip(model.layers, caches):
        x, _ = block.decode(x, cache, cur_pos)
    return model._head_out(x)[:, 0], caches
