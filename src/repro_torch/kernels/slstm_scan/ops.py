"""sLSTM recurrence wrapper: plain version on the CPU, CUDA kernels on the card.

``slstm_scan(xz, xi, xf, xo, rec, state)`` runs the recurrence of one sLSTM
layer over a whole sequence: the float32 gate inputs ``[B, S, H, dh]``, the
recurrent weights ``rec [4, H, dh, dh]`` in the JAX layout (z, i, f, o) and
the ``h, c, n, m`` state of ``init_slstm_cache``; it returns h
``[B, S, H, dh]`` and the final state. A CPU tensor goes to the plain
version (``ref.py``). A CUDA tensor launches ``csrc/slstm_scan.cu``'s
forward kernel, one launch a call (decode is the same launch at S = 1), or
raises. The kernel runs one thread-block cluster a head and group of batch
rows: ``scan_plan`` picks the blocks a cluster (the smallest power of two
up to 16 whose blocks fit in shared memory), the columns a block and the
rows a cluster, and raises ``ValueError`` where no cluster holds a head.
Clusters never wait on one another, so the grid need not be resident.

Training: where autograd records (grad mode on and an input that requires
grad), ``slstm_scan`` runs through ``SLSTMScanFunction``. Its forward is the
same kernel (or plain version), which then also keeps c, n, z, o and the
head's i_log, f_raw and m of every step (``ref.Saved``); its backward calls
``slstm_scan_backward``: on the card ``csrc/slstm_scan.cu``'s backward
kernel, one launch walking t from S - 1 to 0, for dxz, dxi, dxf and dxo,
then drec as one float32 ``torch.matmul`` (``ref.recurrent_grad``); on the
CPU the explicit formulas of ``ref.slstm_scan_backward_reference``, so the
CPU tests check what the kernel computes. The initial state takes no
gradient, and the final state returned under autograd is detached. No
atomics on floats: a second call gives the same bits.

``slstm_scan.launches`` counts forward kernel launches and
``slstm_scan_backward.launches`` backward ones.

A ``meta`` tensor (the dry run's) takes the CUDA path up to the launch,
forward and backward: outputs and saved values of the kernels' shapes (the
plan, of an H100's ``H100_SMS`` SMs, is made and checked), and no launch.
On ``meta`` and on the card each kernel call reports its work
(``cost.kernels.slstm``, ``cost.kernels.slstm_backward``) to an active
cost counter.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.cost import analysis, kernels as work
from repro_torch.kernels import _build
from repro_torch.kernels.slstm_scan.ref import (Saved, State, recurrent_grad,
                                                slstm_scan_backward_reference,
                                                slstm_scan_reference)

THREADS = 256             # threads a block (csrc/slstm_scan.cu)
WARPS = THREADS // 32     # slices of a block's products
MAX_CLUSTER = 16          # blocks a cluster: Hopper's non-portable maximum
MAX_ROWS = 8              # batch rows a cluster
RING = 4                  # steps of inputs a thread keeps in flight, plus one
SMEM_LIMIT = 232448       # dynamic shared bytes a block may take on Hopper
H100_SMS = 132            # the plan on meta (no card to ask)
STATE = ("h", "c", "n", "m")


class ScanPlan(NamedTuple):
    """``columns`` of a head a block (C = ceil(dh / P)), ``blocks`` a
    cluster (P), batch ``rows`` a cluster (Bc) and row ``groups``
    (ceil(B / Bc)); the grid is H x groups clusters of P blocks."""
    columns: int
    blocks: int
    rows: int
    groups: int


def _r4(n: int) -> int:
    return -(-n // 4) * 4


def forward_smem_floats(Bc: int, dh: int, C: int, P: int) -> int:
    """Shared floats of a forward block (``FwdSmem``): rec's z and o
    columns [dh, 2C], h_{t-1} of the head [2, Bc, dh] by parity, the
    products' slice sums, the blocks' partials [2, P, Bc, 2], rho_i and
    rho_f, a row's terms [2, Bc C] and the ring of gate inputs (dh rounded
    up to a multiple of 4, every region to 16 bytes)."""
    D4, O = _r4(dh), 2 * C
    return (D4 * O + 2 * Bc * D4 + _r4(WARPS * Bc * O) + _r4(4 * P * Bc) + _r4(2 * C)
            + _r4(2 * Bc * C) + RING * 4 * THREADS)


def backward_smem_floats(Bc: int, dh: int, C: int, P: int) -> int:
    """Shared floats of a backward block (``BwdSmem``): its rows of rec's
    z and o gates [2 dh, C], the i and f gates' row sums, dpre_z and dpre_o
    of the head [2, Bc, 2 dh] by parity, the products' slice sums, the
    partials, a row's terms and the ring of saved values."""
    D4 = _r4(dh)
    return (2 * D4 * C + _r4(2 * C) + 4 * Bc * D4 + _r4(WARPS * Bc * C) + _r4(4 * P * Bc)
            + _r4(2 * Bc * C) + RING * 8 * THREADS)


def _fits(Bc: int, dh: int, C: int, P: int) -> bool:
    return Bc * C <= THREADS and 4 * max(forward_smem_floats(Bc, dh, C, P),
                                         backward_smem_floats(Bc, dh, C, P)) <= SMEM_LIMIT


@functools.lru_cache(maxsize=256)
def scan_plan(B: int, H: int, dh: int, sms: int) -> ScanPlan:
    """The kernels' plan on a card of ``sms`` SMs: P the smallest power of
    two up to 16 for which a block of C = ceil(dh / P) columns fits in
    shared memory, forward and backward, with one batch row (16 blocks of
    32 columns at xlstm-1.3b's dh 512; one block at dh 128 or less); then
    the most rows a cluster that fit, up to 8 and one thread a (row,
    column), spread evenly over the fewest groups. Raises ``ValueError``
    where no cluster holds a head.

    ``sms`` only caps P. Whether a card runs a cluster of P such blocks at
    all depends on how its SMs are grouped, which the plan cannot see;
    ``residency`` asks the CUDA runtime on the card. The H100 SXM (132
    SMs) runs 7 of the 16-block clusters at once; the 114-SM H100 PCIe's
    plan is the same, but no such card has run it."""
    if min(B, H, dh, sms) < 1:
        raise ValueError(f"no sLSTM plan for B {B}, H {H}, dh {dh} on {sms} SMs")
    P, limit = 1, min(MAX_CLUSTER, sms)
    while not _fits(1, dh, -(-dh // P), P):
        P *= 2
        if P > limit:
            raise ValueError(f"no sLSTM cluster of at most {limit} blocks holds a head of "
                             f"dh {dh}")
    C = -(-dh // P)
    cap = max(r for r in range(1, MAX_ROWS + 1) if _fits(r, dh, C, P))
    groups = -(-B // cap)
    return ScanPlan(C, P, -(-B // groups), groups)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the entry points' argument and result types on a build of
    ``csrc/slstm_scan.cu`` (the served one or a diagnostic one)."""
    lib.slstm_scan_fwd.argtypes = [ctypes.c_void_p] * 19 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    lib.slstm_scan_bwd.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    lib.slstm_scan_residency.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)] * 2
    lib.slstm_barrier_probe.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    for fn in (lib.slstm_scan_fwd, lib.slstm_scan_bwd, lib.slstm_scan_residency,
               lib.slstm_barrier_probe):
        fn.restype = ctypes.c_int
    return lib


@functools.cache
def _lib() -> ctypes.CDLL:
    return _bind(_build.load("slstm_scan"))


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def card_plan(B: int, H: int, dh: int, device: torch.device) -> ScanPlan:
    """``scan_plan`` on ``device``'s SMs (an H100's on meta)."""
    if device.type == "meta":
        return scan_plan(B, H, dh, H100_SMS)
    if not torch.cuda.is_available():
        raise RuntimeError("slstm_scan: no CUDA device")
    return scan_plan(B, H, dh, _sms(torch.cuda.current_device() if device.index is None
                                     else device.index))


def _check_inputs(xz, xi, xf, xo, rec, state: State) -> None:
    if xz.dim() != 4 or any(t.shape != xz.shape for t in (xi, xf, xo)):
        raise ValueError(f"slstm_scan expects xz, xi, xf, xo [B,S,H,dh] of one shape, got "
                         f"{[tuple(t.shape) for t in (xz, xi, xf, xo)]}")
    B, S, H, dh = xz.shape
    if rec.shape != (4, H, dh, dh):
        raise ValueError(f"rec must be [4,H,dh,dh] = {(4, H, dh, dh)}, got {tuple(rec.shape)}")
    if not set(STATE) <= set(state):
        raise ValueError(f"state must hold {STATE}, got {sorted(state)}")
    want = {"h": (B, H, dh), "c": (B, H, dh), "n": (B, H, dh), "m": (B, H)}
    for k, shape in want.items():
        if state[k].shape != shape:
            raise ValueError(f"state {k!r} must be {shape}, got {tuple(state[k].shape)}")
    tensors = (xz, xi, xf, xo, rec, *(state[k] for k in STATE))
    if len({t.device for t in tensors}) != 1:
        raise ValueError("the gate inputs, rec and the state must be on one device")
    if xz.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"unsupported device {xz.device}")
    if xz.device.type != "cpu":
        if any(t.dtype != torch.float32 for t in tensors):
            raise ValueError("the slstm_scan kernels take float32 inputs, rec and state, got "
                             f"{sorted({str(t.dtype) for t in tensors})}")
        if not all(t.is_contiguous() for t in tensors):
            raise ValueError("the slstm_scan kernels take contiguous tensors")


def _launch(xz, xi, xf, xo, rec, state: State, with_saved: bool,
            lib: Optional[ctypes.CDLL] = None):
    """The forward kernel for CUDA (or meta) tensors: h, the final state and,
    ``with_saved``, the ``Saved`` values (else None). ``lib``: another
    build of the kernels (the phase tool's)."""
    B, S, H, dh = xz.shape
    plan = card_plan(B, H, dh, xz.device)
    new = functools.partial(torch.empty, dtype=torch.float32, device=xz.device)
    h = new((B, S, H, dh))
    final = {k: new(tuple(state[k].shape)) for k in STATE}
    saved = (Saved(*(new((B, S, H, dh)) for _ in range(4)), new((B, S, H, 3)))
             if with_saved else None)
    if analysis.counting():
        analysis.report_kernel("slstm_scan", *work.slstm(B, S, H, dh, saved=with_saved))
    if xz.device.type == "meta":
        return h, final, saved
    lib = lib or _lib()
    kept = saved if saved is not None else (None,) * 5
    ptrs = [t.data_ptr() if t is not None else None for t in (
        xz, xi, xf, xo, rec, *(state[k] for k in STATE), h, *(final[k] for k in STATE),
        *kept)]
    with torch.cuda.device(xz.device):
        err = lib.slstm_scan_fwd(*ptrs, B, S, H, dh, *plan[:3],
                                 torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "slstm_scan")
    slstm_scan.launches += 1
    return h, final, saved


def _forward(xz, xi, xf, xo, rec, state: State, with_saved: bool):
    if xz.device.type == "cpu":
        out = slstm_scan_reference(xz, xi, xf, xo, rec, state, with_saved=with_saved)
        return out if with_saved else (*out, None)
    return _launch(xz, xi, xf, xo, rec, state, with_saved)


def slstm_scan_backward(rec: torch.Tensor, state: State, h: torch.Tensor, saved: Saved,
                        dh: torch.Tensor):
    """dxz, dxi, dxf, dxo [B,S,H,dh] and drec [4,H,dh,dh], float32, of
    ``slstm_scan`` from rec, the initial state, its output h, its ``Saved``
    values and the gradient dh of h. The plain formulas on the CPU; on the
    card the backward kernel and one product for drec, or an error."""
    if h.shape != dh.shape or saved.c.shape != h.shape or saved.gates.shape != h.shape[:3] + (3,):
        raise ValueError(f"h, dh and the saved values must be {tuple(h.shape)} (gates "
                         f"{tuple(h.shape[:3]) + (3,)}), got {tuple(dh.shape)}, "
                         f"{tuple(saved.c.shape)}, {tuple(saved.gates.shape)}")
    if h.device.type == "cpu":
        return slstm_scan_backward_reference(rec, state, h, saved, dh)
    if h.device.type not in ("cuda", "meta"):
        raise ValueError(f"unsupported device {h.device}")
    dx = _launch_backward(rec, state, h, saved, dh)
    return (*dx, recurrent_grad(state["h"], h, dx))


def _launch_backward(rec, state: State, h, saved: Saved, dh,
                     lib: Optional[ctypes.CDLL] = None):
    """The backward kernel for CUDA (or meta) tensors: dxz, dxi, dxf, dxo;
    ``lib`` as for ``_launch``."""
    B, S, H, D = h.shape
    plan = card_plan(B, H, D, h.device)
    dh = dh.float().contiguous()        # autograd may hand over another layout
    dx = [torch.empty_like(h) for _ in range(4)]
    if analysis.counting():
        analysis.report_kernel("slstm_scan_backward", *work.slstm_backward(B, S, H, D))
    if h.device.type != "meta":
        lib = lib or _lib()
        ptrs = [t.data_ptr() for t in (rec, state["c"], state["n"], state["m"], *saved, dh,
                                       *dx)]
        with torch.cuda.device(h.device):
            err = lib.slstm_scan_bwd(*ptrs, B, S, H, D, *plan[:3],
                                     torch.cuda.current_stream().cuda_stream)
        _build.check(lib, err, "slstm_scan_backward")
        slstm_scan_backward.launches += 1
    return dx


def residency(plan: ScanPlan, dh: int, forward: bool = True) -> Tuple[int, int]:
    """A forward (or backward) block's shared bytes under ``plan`` at dh,
    and the clusters of P such blocks the card runs at once
    (``cudaOccupancyMaxActiveClusters``; 0 would mean none fits)."""
    lib, out = _lib(), [ctypes.c_int(0) for _ in range(2)]
    C, P, Bc, _ = plan
    _build.check(lib, lib.slstm_scan_residency(int(forward), Bc, dh, C, P,
                                               *(ctypes.byref(v) for v in out)),
                 "slstm_scan_residency")
    return tuple(v.value for v in out)


def barrier_probe(plan: ScanPlan, H: int, dh: int, n: int,
                  device: Optional[torch.device] = None) -> None:
    """Launch ``n`` cluster barriers on the forward's grid under ``plan``
    (H x groups clusters of P blocks with the forward's shared memory): the
    chain bound's unit, timed by the caller."""
    lib = _lib()
    C, P, Bc, groups = plan
    with torch.cuda.device(device or torch.cuda.current_device()):
        err = lib.slstm_barrier_probe(H * groups, P, 4 * forward_smem_floats(Bc, dh, C, P), n,
                                      torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "slstm_barrier_probe")


class SLSTMScanFunction(torch.autograd.Function):
    """``slstm_scan`` with a gradient: the forward kernel (or plain version)
    keeping its ``Saved`` values, then the backward kernel (or the plain
    formulas) for the gate inputs and rec. Returns h and the final state
    (h, c, n, m), which is detached."""

    @staticmethod
    def forward(ctx, xz, xi, xf, xo, rec, h0, c0, n0, m0):
        state = dict(zip(STATE, (h0, c0, n0, m0)))
        h, final, saved = _forward(xz, xi, xf, xo, rec, state, with_saved=True)
        ctx.save_for_backward(rec, h0, c0, n0, m0, h, *saved)
        out = tuple(final[k] for k in STATE)
        ctx.mark_non_differentiable(*out)
        return (h, *out)

    @staticmethod
    def backward(ctx, dh, *_):
        rec, h0, c0, n0, m0, h, *saved = ctx.saved_tensors
        state = dict(zip(STATE, (h0, c0, n0, m0)))
        grads = slstm_scan_backward(rec, state, h, Saved(*saved), dh)
        return (*grads, None, None, None, None)


def slstm_scan(xz: torch.Tensor, xi: torch.Tensor, xf: torch.Tensor, xo: torch.Tensor,
               rec: torch.Tensor, state: State):
    """xz, xi, xf, xo: [B,S,H,dh] float32 gate inputs; rec [4,H,dh,dh];
    state the ``h, c, n, m`` of ``init_slstm_cache`` (or a cache).

    Returns h [B,S,H,dh] float32 and the final state as a new dict
    (detached under autograd). ``rec`` is taken in any layout (an FSDP
    gather hands over a strided one) and copied contiguous where it is
    not; the gate inputs and the state must be contiguous on the card."""
    rec = rec.contiguous()
    _check_inputs(xz, xi, xf, xo, rec, state)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (xz, xi, xf, xo, rec)):
        h, *final = SLSTMScanFunction.apply(xz, xi, xf, xo, rec,
                                             *(state[k] for k in STATE))
        return h, dict(zip(STATE, final))
    h, final, _ = _forward(xz, xi, xf, xo, rec, state, with_saved=False)
    return h, final


slstm_scan.launches = 0
slstm_scan_backward.launches = 0
