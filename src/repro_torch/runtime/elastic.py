"""Elastic training runtime on one card: the port's payload of the paper's
ST CMS (counterpart of ``repro.runtime.elastic``).

An ``ElasticTrainer`` trains a model on the devices the provision policy
grants its job. When devices are reclaimed or granted it checkpoints at the
current step (synchronous, atomic), restores the state onto the new device
and rebuilds its step; the step counter and the losses go on as if nothing
happened. The checkpoint is the JAX package's layout, so either package can
restore the other's.

This slice runs on one device: a card, or the CPU when asked for. A grant
of more than one device, or a model split over several (``model_size`` >
1), raises ``NotImplementedError``: sharding, ZeRO-1 and tensor parallelism
wait for ROADMAP.md, queue 1 item 4.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import convert
from repro_torch.checkpoint import checkpointer as ckpt
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.training.train_step import TrainState, init_state, make_train_step


def _one_device(devices: Sequence[DeviceLike], model_size: int) -> torch.device:
    devices = list(devices)
    if len(devices) != 1 or model_size != 1:
        raise NotImplementedError(
            f"the port trains on one device; got {len(devices)} device(s), model_size "
            f"{model_size} (multi-card training: ROADMAP.md, queue 1 item 4)")
    return resolve_device(devices[0])


class ElasticTrainer:
    """``init_device``: where a fresh state's weights are drawn (the training
    device by default); the launcher draws a reduced model on the CPU, so
    that the card and ``--device cpu`` start from the same weights."""

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
        self.device: Optional[torch.device] = None
        self.state: Optional[TrainState] = None
        self._step_fn = None
        self.resizes = 0
        self.metrics_log: List[Dict] = []

    # ------------------------------------------------------------- topology
    def start(self, devices: Sequence[DeviceLike]):
        """Initial launch (fresh init or restore-if-checkpoint-exists)."""
        self.device = _one_device(devices, self.model_size)
        if not self._try_restore():
            self.state = init_state(self.cfg, seed=self.seed, device=self.device,
                                    init_device=self.init_device)
        self._compile()

    def resize(self, devices: Sequence[DeviceLike]):
        """Elastic resize: checkpoint -> new device -> restore -> new step."""
        assert self.state is not None
        device = _one_device(devices, self.model_size)
        self.checkpoint()
        self.device = device
        self.state = None   # free the old buffers before restoring
        self._try_restore(require=True)
        self._compile()
        self.resizes += 1

    # ---------------------------------------------------------- checkpoints
    def checkpoint(self):
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

    # -------------------------------------------------------------- compute
    def _compile(self):
        self._step_fn = make_train_step(self.cfg, self.tcfg)

    def _batch(self) -> Dict[str, torch.Tensor]:
        if self.data_fn is not None:
            batch = self.data_fn(self.step, self.global_batch, self.seq_len)
        else:
            rng = np.random.default_rng(self.seed * 1_000_003 + self.step)
            toks = rng.integers(0, self.cfg.vocab_size,
                                (self.global_batch, self.seq_len), dtype=np.int32)
            batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
        return {k: torch.as_tensor(v).to(self.device) for k, v in batch.items()}

    def train_steps(self, n: int) -> Dict:
        """Run n steps on the current device; returns the last metrics."""
        assert self._step_fn is not None, "call start() first"
        metrics = {}
        for _ in range(n):
            batch = self._batch()
            self.state, metrics = self._step_fn(self.state, batch)
            self.step += 1
        metrics = {k: float(v) for k, v in metrics.items()}
        metrics["step"] = self.step
        metrics["devices"] = 1
        self.metrics_log.append(metrics)
        return metrics
