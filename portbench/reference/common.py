"""Plain float32 pieces shared by the benchmark's reference models.

Frozen copies, taken at commit 02043fe, of the formulas of
``src/repro_torch/models/layers.py`` (LayerNorm with eps 1e-6 and biased
variance, GELU with the tanh approximation, rope on split halves),
``models/xlstm.py`` (the per-head RMS norm) and ``training/optimizer.py`` and
``training/train_step.py`` (AdamW with a float32 master, the global-norm
clip, the cross-entropy with the z-loss). This package imports nothing of the
program: it works from the configuration's file, the seed and the inputs the
benchmark made.

Every product of two operands goes through a ``Matmul``: ``matmul`` is the
reference's float32 product (TF32 off), ``fp8_matmul`` rounds both operands
and the result to float8 e4m3 with a per-tensor scale, the control's
precision. A
``Matmul``'s ``carry`` is applied to what passes from one residual add to the
next (the residual stream, which the program carries in bf16): the identity
for the reference, the same float8 rounding for the control.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, List, NamedTuple, Optional

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
Matmul = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
F32 = torch.float32
E4M3_MAX = 448.0


class Leaf(NamedTuple):
    """One parameter: its name (the program's), shape, the dtype it is
    served in, and how it is drawn: ``normal`` with ``std``, ``zeros``,
    ``ones``, or ``linspace`` from ``span[0]`` to ``span[1]``."""
    name: str
    shape: tuple
    dtype: str
    init: str
    std: float = 0.0
    span: tuple = ()


def dense(name: str, fan_in: int, fan_out: int, dtype: str, bias: bool = False,
          std: Optional[float] = None) -> List[Leaf]:
    """A dense kernel [in, out], normal with ``std`` (1/√in by default), and a
    zero bias."""
    std = 1.0 / math.sqrt(fan_in) if std is None else std
    out = [Leaf(f"{name}.kernel", (fan_in, fan_out), dtype, "normal", std)]
    if bias:
        out.append(Leaf(f"{name}.bias", (fan_out,), dtype, "zeros"))
    return out


def norm_leaves(name: str, dim: int) -> List[Leaf]:
    """A LayerNorm's float32 scale (ones) and bias (zeros)."""
    return [Leaf(f"{name}.scale", (dim,), "float32", "ones"),
            Leaf(f"{name}.bias", (dim,), "float32", "zeros")]


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a, b)


matmul.carry = lambda x: x


def to_fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 at a per-tensor scale, back in float32; the
    gradient passes the rounding unchanged (so a product's backward takes
    the rounded operands)."""
    xd = x.detach()
    scale = E4M3_MAX / xd.abs().amax().clamp_min(1e-30)
    q = (xd * scale).to(torch.float8_e4m3fn).to(F32) / scale
    return x + (q - xd) if x.requires_grad else q


def fp8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A product computed in float8: its operands and its result rounded."""
    return to_fp8(torch.matmul(to_fp8(a), to_fp8(b)))


fp8_matmul.carry = to_fp8


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-6) -> torch.Tensor:
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, unbiased=False, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def headnorm(h: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Per-head RMS norm: h [..., H, d], scale [H, d]."""
    var = h.square().mean(dim=-1, keepdim=True)
    return h * torch.rsqrt(var + eps) * scale


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x [B, S, heads, hd], positions [S]: rotation on split halves."""
    half = x.shape[-1] // 2
    exps = torch.arange(0, x.shape[-1], 2, dtype=F32, device=x.device) / x.shape[-1]
    freqs = 1.0 / torch.pow(torch.tensor(theta, dtype=F32, device=x.device), exps)
    angles = positions[:, None].to(F32) * freqs
    cos, sin = torch.cos(angles)[:, None, :], torch.sin(angles)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, z_loss: float):
    """(mean NLL + z_loss · mean lse², mean NLL) over every label."""
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = torch.mean(lse - gold)
    return nll + z_loss * torch.mean(torch.square(lse)), nll


class Hyper(NamedTuple):
    """The optimizer's settings, as the cell's file states them."""
    learning_rate: float
    weight_decay: float
    beta1: float
    beta2: float
    eps: float
    grad_clip: float
    z_loss: float


class TrainReadings(NamedTuple):
    """What a training check compares: each step's loss, the first step's
    gradient norm by leaf (before the clip), the norm by leaf of the float32
    master's change over the steps, each step's global gradient norm before
    the clip, and the last step's AdamW update checked against the
    optimizer's own state (``update_gap``)."""
    losses: List[float]
    grad_norms: Dict[str, float]
    change_norms: Dict[str, float]
    global_norms: List[float]
    update_gap: float


Sample = Dict[str, torch.Tensor]
SAMPLE = 1024             # elements a leaf at which the last update is recomputed


@torch.no_grad()
def sample_state(m: Params, v: Params, w: Params, seed: int) -> Sample:
    """Each leaf's m, v and float32 master at ``SAMPLE`` elements drawn from
    ``seed`` (the same elements on every call with that seed), as float64
    [3, n] on the host."""
    out = {}
    gen = None
    for k, mk in m.items():
        if gen is None:
            gen = torch.Generator(device=mk.device)
            gen.manual_seed(seed)
        n = mk.numel()
        idx = torch.randint(n, (min(SAMPLE, n),), generator=gen, device=mk.device)
        out[k] = torch.stack([t.reshape(-1)[idx].double() for t in (mk, v[k], w[k])]).cpu()
    return out


def half_ulp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Half the float32 spacing at the larger magnitude of ``a`` and ``b``:
    what storing a float32 master can round away."""
    w = torch.maximum(a.abs(), b.abs()).float()
    return (torch.nextafter(w, torch.full_like(w, math.inf)) - w).double() / 2


def update_gap(before: Sample, after: Sample, step: int, hp: Hyper) -> float:
    """The largest gap, over leaves, between the optimizer's step ``step`` as
    its state records it and AdamW recomputed from that state: the clipped
    gradient g that the first moment implies, g = (m' - beta1 m) / (1 -
    beta1); the second moment it implies, v' = beta2 v + (1 - beta2) g²; the
    master's step w - w' = lr (m'/bc1 / (sqrt(v'/bc2) + eps) + wd w). Each
    gap is a norm over the leaf's sampled elements relative to the norm of
    v' or of the step; the master's leaves out, element by element, the half
    float32 spacing that storing w' rounds away (a step of 1e-5 on a bias of
    4.5 rounds by 2%). A leaf that neither moves nor should is left out; a
    state left unchanged reads 1."""
    b1, b2 = hp.beta1, hp.beta2
    bc1, bc2 = 1.0 - b1 ** step, 1.0 - b2 ** step
    worst = 0.0
    for k, (m0, v0, w0) in before.items():
        m1, v1, w1 = after[k]
        g = (m1 - b1 * m0) / (1.0 - b1)
        v_want = b2 * v0 + (1.0 - b2) * g * g
        step_want = hp.learning_rate * ((m1 / bc1) / (torch.sqrt(v1 / bc2) + hp.eps)
                                        + hp.weight_decay * w0)
        w_off = torch.clamp_min((w0 - w1 - step_want).abs() - half_ulp(w0, w1), 0.0)
        for off, scale in ((w_off, step_want), (v1 - v_want, v_want)):
            norm = float(torch.linalg.vector_norm(scale))
            if norm > 0:
                worst = max(worst, float(torch.linalg.vector_norm(off)) / norm)
            elif float(torch.linalg.vector_norm(off)) > 0:
                worst = max(worst, 1.0)
    return worst


@torch.no_grad()
def adamw_step(params: Params, grads: Params, m: Params, v: Params, step: int,
               hp: Hyper):
    """One AdamW step in place: gradients clipped by their global norm (in
    place), float32 bias corrections, decoupled weight decay. Returns each
    gradient's norm and the global norm, before the clip."""
    norms = {k: torch.linalg.vector_norm(g) for k, g in grads.items()}
    gnorm = torch.sqrt(sum(torch.square(n) for n in norms.values()))
    clip = torch.clamp(hp.grad_clip / torch.clamp_min(gnorm, 1e-12), max=1.0) \
        if hp.grad_clip > 0 else torch.ones((), device=gnorm.device)
    bc1 = 1.0 - hp.beta1 ** step
    bc2 = 1.0 - hp.beta2 ** step
    for k, p in params.items():
        g = grads[k].mul_(clip)
        m[k].mul_(hp.beta1).add_(g, alpha=1 - hp.beta1)
        v[k].mul_(hp.beta2).add_(torch.square(g), alpha=1 - hp.beta2)
        delta = (m[k] / bc1).div_(torch.sqrt(v[k] / bc2).add_(hp.eps))
        delta.add_(p, alpha=hp.weight_decay)
        p.sub_(delta, alpha=hp.learning_rate)
    return {k: float(n) for k, n in norms.items()}, float(gnorm)


def train_readings(params0: Callable[[], Iterable], batches: List[dict],
                   loss_fn: Callable, hp: Hyper, steps: int, seed: int = 0) -> TrainReadings:
    """``steps`` AdamW steps of ``loss_fn(params, batch) -> loss`` from the
    (name, tensor) pairs that ``params0()`` yields, on ``batches[0..steps-1]``,
    all in float32. ``params0`` is called again at the end for the change (the
    weights are drawn anew rather than kept); ``seed`` draws the elements of
    ``update_gap``. Returns the readings a training check compares."""
    params = {k: t.detach().to(F32).clone() for k, t in params0()}
    m = {k: torch.zeros_like(t) for k, t in params.items()}
    v = {k: torch.zeros_like(t) for k, t in params.items()}
    losses: List[float] = []
    grad_norms: Dict[str, float] = {}
    global_norms: List[float] = []
    names = list(params)
    before: Sample = {}
    for step in range(1, steps + 1):
        leaves = [params[k].requires_grad_(True) for k in names]
        loss = loss_fn(params, batches[step - 1])
        grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
        losses.append(float(loss.detach()))
        del loss
        for t in leaves:
            t.requires_grad_(False)
        if step == steps:
            before = sample_state(m, v, params, seed)
        norms, gnorm = adamw_step(params, dict(zip(names, grads)), m, v, step, hp)
        global_norms.append(gnorm)
        if step == 1:
            grad_norms = norms
        del grads
    gap = update_gap(before, sample_state(m, v, params, seed), steps, hp)
    del m, v
    change = {k: float(torch.linalg.vector_norm(params[k] - t.to(F32)))
              for k, t in params0()}
    return TrainReadings(losses, grad_norms, change, global_norms, gap)


def checkpointed(fn: Callable, remat: bool):
    """``fn`` under non-reentrant activation checkpointing when ``remat``."""
    if not remat:
        return fn
    from torch.utils.checkpoint import checkpoint
    return lambda *args: checkpoint(fn, *args, use_reentrant=False)


def no_tf32():
    """Float32 products in float32: TF32 off for cuBLAS and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def select(x: torch.Tensor, keep: Optional[torch.Tensor]) -> torch.Tensor:
    """x [B, S, ...] at the positions ``keep`` ([B, n] indices), or whole."""
    if keep is None:
        return x
    idx = keep.reshape(keep.shape + (1,) * (x.dim() - 2)).expand(
        keep.shape + x.shape[2:])
    return torch.gather(x, 1, idx)
