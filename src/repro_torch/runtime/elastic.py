"""Elastic training runtime: the port's payload of the paper's ST CMS
(counterpart of ``repro.runtime.elastic``).

An ``ElasticTrainer`` trains a model on a data × model mesh over the
devices the provision policy grants its job. When devices are reclaimed or
granted it

  1. checkpoints at the current step (synchronous, atomic),
  2. rebuilds the mesh over the new device set (the data axis grows or
     shrinks; ``_mesh_from_devices`` rounds it down to a divisor of the
     global batch),
  3. restores the state from that checkpoint onto the new mesh,
  4. continues from the same step counter.

The checkpoint is the JAX package's layout and the only hand-off between
two meshes, so either package restores the other's, at any world size.

World of one device (a card, or ``"cpu"``): the trainer runs in the
caller's process with no process group, and no collective is issued, as
XLA issues none over an axis of extent 1.

World of N > 1 (``["cpu"] * N`` for N CPU ranks, or N distinct cards): N
worker processes, spawned with ``torch.multiprocessing``, rank r on the
r-th device of the mesh, join one process group (``gloo`` on the CPU,
``nccl`` on cards) through a ``FileStore`` under ``<ckpt_dir>/.ranks/``.
The trainer in the caller's process commands them over pipes (train n
steps, checkpoint, stop) and gets rank 0's metrics back. Each rank trains
on its rows of the global batch with ZeRO-1 (``training.data_parallel``).
A fresh start draws the weights from ``seed`` the same way on every rank.
Every wait has a timeout (``TIMEOUT_S``, the process group's too); a rank
that raises or dies fails the caller's call with its traceback or exit
code, and the trainer stops the other ranks.

``model_size`` > 1 (tensor parallelism over the ``model`` axis) raises
``NotImplementedError``: ROADMAP.md, queue 1 item 4b.
"""
from __future__ import annotations

import datetime
import os
import shutil
import time
import traceback
import uuid
import weakref
from multiprocessing.connection import wait
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch import convert
from repro_torch.checkpoint import checkpointer as ckpt
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.device import DeviceLike
from repro_torch.launch.mesh import Mesh, make_mesh
from repro_torch.training import data_parallel as dp
from repro_torch.training.train_step import (TrainState, init_model, init_state,
                                             make_train_step)

TIMEOUT_S = 600.0     # each wait on a rank, and each collective of the group


def _mesh_from_devices(devices: Sequence[DeviceLike], model_size: int,
                       global_batch: Optional[int] = None) -> Mesh:
    """Largest usable rectangular mesh over `devices`.

    The DP extent is rounded DOWN to a divisor of the global batch (an
    elastic grant is rarely a perfect divisor; surplus devices idle until
    the next resize — they are not lost, just unused this interval).
    """
    if model_size != 1:
        raise NotImplementedError(
            f"model_size {model_size}: tensor parallelism over the model axis waits for "
            "ROADMAP.md, queue 1 item 4b")
    devices = list(devices)
    n = len(devices)
    dp = n // model_size
    if dp < 1:
        raise ValueError(f"{n} device(s) for model_size {model_size}")
    if global_batch is not None:
        while dp > 1 and global_batch % dp:
            dp -= 1
    return make_mesh((dp, model_size), ("data", "model"), devices)


class _Job(NamedTuple):
    """What every rank needs to build its share of the trainer."""
    cfg: ModelConfig
    tcfg: TrainConfig
    global_batch: int
    seq_len: int
    ckpt_dir: str
    data_fn: Optional[Callable]
    seed: int
    init_device: DeviceLike


def _global_batch(job: _Job, step: int) -> Dict[str, torch.Tensor]:
    """The whole batch of ``step`` on the host (``data_fn``'s, else random
    tokens drawn as the JAX trainer draws them)."""
    if job.data_fn is not None:
        batch = job.data_fn(step, job.global_batch, job.seq_len)
    else:
        rng = np.random.default_rng(job.seed * 1_000_003 + step)
        toks = rng.integers(0, job.cfg.vocab_size, (job.global_batch, job.seq_len),
                            dtype=np.int32)
        batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    return {k: torch.as_tensor(v) for k, v in batch.items()}


class ElasticTrainer:
    """``init_device``: where a fresh state's weights are drawn (the training
    device by default); the launcher draws a reduced model on the CPU, so
    that the card and ``--device cpu`` start from the same weights.

    At world size 1 ``state`` and ``device`` are the trainer's own; at N
    the state lives in the ranks and both are ``None``. ``close()`` stops
    the ranks (a world that is dropped is stopped too)."""

    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig, *,
                 global_batch: int, seq_len: int, ckpt_dir: str,
                 model_size: int = 1, data_fn: Optional[Callable] = None,
                 seed: int = 0, init_device: DeviceLike = None):
        self.cfg = cfg
        self.tcfg = tcfg
        self.global_batch = global_batch
        self.seq_len = seq_len
        self.ckpt_dir = ckpt_dir
        self.model_size = model_size
        self.data_fn = data_fn
        self.seed = seed
        self.init_device = init_device
        self.step = 0
        self.mesh: Optional[Mesh] = None
        self.device: Optional[torch.device] = None
        self.state: Optional[TrainState] = None
        self._step_fn = None
        self._world: Optional[_World] = None
        self.resizes = 0
        self.metrics_log: List[Dict] = []

    def _job(self) -> _Job:
        return _Job(self.cfg, self.tcfg, self.global_batch, self.seq_len, self.ckpt_dir,
                    self.data_fn, self.seed, self.init_device)

    # ------------------------------------------------------------- topology
    def start(self, devices: Sequence[DeviceLike]):
        """Initial launch (fresh init or restore-if-checkpoint-exists)."""
        self._launch(_mesh_from_devices(devices, self.model_size, self.global_batch))

    def resize(self, devices: Sequence[DeviceLike]):
        """Elastic resize: checkpoint -> new mesh -> restore -> continue."""
        assert self.mesh is not None, "call start() first"
        mesh = _mesh_from_devices(devices, self.model_size, self.global_batch)
        self.checkpoint()
        self.close()
        self.state = None   # free the old buffers before restoring
        self._launch(mesh, require=True)
        self.resizes += 1

    def _launch(self, mesh: Mesh, require: bool = False):
        self.mesh = mesh
        if mesh.size == 1:
            self.device = mesh.devices.flat[0]
            if not self._try_restore(require):
                self.state = init_state(self.cfg, seed=self.seed, device=self.device,
                                        init_device=self.init_device)
            self._step_fn = make_train_step(self.cfg, self.tcfg,
                                            moe_groups=max(1, mesh.shape["data"]))
            return
        if require and ckpt.latest_step(self.ckpt_dir) is None:
            raise FileNotFoundError(self.ckpt_dir)
        self.device = self._step_fn = None
        self._world = _World(self._job(), mesh)
        self.step = self._world.step

    def close(self):
        """Stop the ranks of a world of N (nothing at world size 1)."""
        if self._world is not None:
            world, self._world = self._world, None
            world.stop()

    # ---------------------------------------------------------- checkpoints
    def checkpoint(self):
        if self._world is not None:
            self._world.command("checkpoint")
        else:
            ckpt.save(self.ckpt_dir, convert.state_leaves(self.state), step=self.step)

    def _try_restore(self, require: bool = False) -> bool:
        step = ckpt.latest_step(self.ckpt_dir)
        if step is None:
            if require:
                raise FileNotFoundError(self.ckpt_dir)
            return False
        leaves = ckpt.restore(self.ckpt_dir, step=step)
        self.state = convert.state_from_leaves(leaves, self.cfg, self.device)
        self.step = step
        return True

    def opt_shapes(self) -> List[Dict[str, tuple]]:
        """Each rank's shapes of m (v and master alike), by JAX leaf path:
        its ZeRO-1 cut, the sharded dim first; one entry at world size 1,
        whose m is whole and per layer."""
        if self._world is not None:
            return self._world.command("opt_shapes", every=True)
        return [{k: tuple(t.shape) for k, t in self.state.opt.m.items()}]

    # -------------------------------------------------------------- compute
    def train_steps(self, n: int) -> Dict:
        """Run n steps on the current mesh; returns the last metrics."""
        assert self.mesh is not None, "call start() first"
        if self._world is not None:
            metrics = self._world.command("train", n)
            self.step += n
        else:
            metrics = {}
            for _ in range(n):
                batch = {k: t.to(self.device) for k, t in
                         _global_batch(self._job(), self.step).items()}
                self.state, metrics = self._step_fn(self.state, batch)
                self.step += 1
            metrics = {k: float(v) for k, v in metrics.items()}
        metrics["step"] = self.step
        metrics["devices"] = self.mesh.size
        self.metrics_log.append(metrics)
        return metrics


# ------------------------------------------------------------------- world

def _stop_processes(procs, store_dir):
    for p in procs:
        if p.is_alive():
            p.terminate()
    for p in procs:
        p.join(timeout=10)
        if p.is_alive():
            p.kill()
            p.join(timeout=10)
    shutil.rmtree(store_dir, ignore_errors=True)
    try:
        os.rmdir(os.path.dirname(store_dir))    # .ranks/, once no world uses it
    except OSError:
        pass


class _World:
    """N rank processes and the caller's end of their pipes."""

    def __init__(self, job: _Job, mesh: Mesh):
        import torch.multiprocessing as mp
        ctx = mp.get_context("spawn")
        self.store_dir = os.path.join(job.ckpt_dir, ".ranks", uuid.uuid4().hex)
        os.makedirs(self.store_dir)
        devices = [str(d) for d in mesh.devices.flat]
        self.conns, self.procs = [], []
        self._finalizer = weakref.finalize(self, _stop_processes, self.procs, self.store_dir)
        for rank in range(mesh.size):
            ours, theirs = ctx.Pipe()
            p = ctx.Process(target=_rank_main, name=f"elastic-rank-{rank}", daemon=True,
                            args=(rank, tuple(mesh.devices.shape), devices,
                                  os.path.join(self.store_dir, "store"), theirs, job))
            p.start()
            theirs.close()
            self.conns.append(ours)
            self.procs.append(p)
        self.step = self._replies()[0]

    def command(self, *cmd, every: bool = False):
        """Send ``cmd`` to every rank; rank 0's reply (every rank's with
        ``every``)."""
        for c in self.conns:
            try:
                c.send(cmd)
            except OSError:     # a rank that died: _replies reports it
                pass
        replies = self._replies()
        return replies if every else replies[0]

    def _fail(self, message: str):
        self._finalizer()
        raise RuntimeError(message)

    def _replies(self) -> list:
        """Each rank's next reply. A rank's error, exit or silence past
        ``TIMEOUT_S`` stops the world and raises."""
        deadline = time.monotonic() + TIMEOUT_S
        replies = [None] * len(self.conns)
        pending = set(range(len(self.conns)))
        while pending:
            left = deadline - time.monotonic()
            if left <= 0:
                self._fail(f"ranks {sorted(pending)} did not answer within {TIMEOUT_S} s")
            wait([self.conns[r] for r in pending] + [self.procs[r].sentinel for r in pending],
                 timeout=min(left, 1.0))
            for r in sorted(pending):
                if self.conns[r].poll():
                    try:
                        kind, payload = self.conns[r].recv()
                    except EOFError:
                        self._fail(f"rank {r} closed its pipe (exit code "
                                   f"{self.procs[r].exitcode})")
                    if kind == "error":
                        self._fail(f"rank {r} failed:\n{payload}")
                    replies[r] = payload
                    pending.discard(r)
                elif not self.procs[r].is_alive():
                    self._fail(f"rank {r} exited with code {self.procs[r].exitcode}")
        return replies

    def stop(self):
        """Ask every rank to leave the group and exit; then make sure they
        have (a world that failed is stopped already)."""
        if not self._finalizer.alive:
            return
        try:
            self.command("stop", every=True)
        finally:
            self._finalizer()


class _Rank:
    """One rank's share of the trainer: the whole model, its ZeRO-1 cut of
    the optimizer state, its rows of each batch."""

    def __init__(self, job: _Job, mesh: Mesh, rank: int, device: torch.device):
        self.job, self.device = job, device
        self.comm = dp.Comm(mesh.group("data"), mesh.shape["data"],
                            rank // mesh.shape["model"])
        self.is_first = rank == 0
        layout_of = lambda model: dp.leaf_layout(model, mesh, job.tcfg.zero1)  # noqa: E731
        self.step = ckpt.latest_step(job.ckpt_dir)
        if self.step is None:
            self.step = 0
            model = init_model(job.cfg, seed=job.seed, device=device,
                               init_device=job.init_device)
            self.layout = layout_of(model)
            self.state = dp.fresh_state(model, self.layout, self.comm)
        else:
            leaves = ckpt.restore(job.ckpt_dir, step=self.step)
            self.state = dp.state_from_leaves(leaves, job.cfg, device, layout_of, self.comm)
            self.layout = layout_of(self.state.params)
            del leaves
        self.rows = dp.rank_rows(job.global_batch, job.tcfg.microbatch, self.comm)
        self.step_fn = dp.make_sharded_step(job.cfg, job.tcfg, self.layout, self.comm)

    def train(self, n: int) -> Dict[str, float]:
        metrics = {}
        for _ in range(n):
            batch = {k: t[self.rows].to(self.device)
                     for k, t in _global_batch(self.job, self.step).items()}
            self.state, metrics = self.step_fn(self.state, batch)
            self.step += 1
        return {k: float(v) for k, v in metrics.items()}

    def checkpoint(self):
        leaves = dp.state_leaves(self.state, self.layout, self.comm, keep=self.is_first)
        if self.is_first:
            ckpt.save(self.job.ckpt_dir, leaves, step=self.step)

    def opt_shapes(self) -> Dict[str, tuple]:
        return {k: tuple(t.shape) for k, t in self.state.m.items()}


def _rank_main(rank: int, shape, devices: List[str], store_path: str, conn, job: _Job):
    """A rank process: join the group, build the rank's state, then answer
    the caller's commands until ``stop``. Any exception goes back to the
    caller as its traceback."""
    import torch.distributed as dist
    try:
        device = torch.device(devices[rank])
        world = len(devices)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        else:
            torch.set_num_threads(max(1, torch.get_num_threads() // world))
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                store=dist.FileStore(store_path, world), rank=rank,
                                world_size=world,
                                timeout=datetime.timedelta(seconds=TIMEOUT_S))
        mesh = make_mesh(shape, ("data", "model"), devices)
        me = _Rank(job, mesh, rank, device)
        conn.send(("ok", me.step))
        while True:
            cmd, *args = conn.recv()
            if cmd == "stop":
                dist.destroy_process_group()
                conn.send(("ok", None))
                return
            conn.send(("ok", getattr(me, cmd)(*args)))
    except BaseException:  # noqa: BLE001 -- the caller gets every failure
        try:
            conn.send(("error", traceback.format_exc()))
        finally:
            os._exit(1)
