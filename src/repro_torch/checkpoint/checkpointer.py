"""Checkpoints in the JAX package's layout (counterpart of
``repro.checkpoint.checkpointer``).

A checkpoint is a flat mapping of leaf keys (the JAX tree paths, e.g.
``.params/repeats/b0/mixer/wq/kernel``; ``repro_torch.convert.state_leaves``
builds them from a port ``TrainState``) to tensors:

  * each leaf goes to host memory and into ``<key>.npy`` (the key with
    characters outside ``[A-Za-z0-9_.-]`` replaced by ``_``); bfloat16,
    which numpy cannot hold, is stored as its raw bytes (uint8, one more
    axis of 2) with ``"bfloat16"`` as its dtype in ``manifest.json``, which
    also lists every key, file, shape and the step;
  * a checkpoint is written into ``step_XXXXXXXXXX.tmp`` and renamed to
    ``step_XXXXXXXXXX`` when complete, then ``LATEST`` is replaced
    atomically: a crash mid-save never corrupts the latest checkpoint;
  * ``AsyncCheckpointer`` copies the tensors to host memory synchronously
    and writes the files on a worker thread.

The JAX package restores these directories, and this module restores the
JAX package's.
"""
from __future__ import annotations

import json
import os
import queue
import re
import shutil
import threading
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

Leaves = Dict[str, torch.Tensor]


def _sanitize(key: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]", "_", key)


def _host(x) -> np.ndarray:
    """A leaf as a numpy array, bfloat16 as raw bytes [..., 2] uint8."""
    if isinstance(x, np.ndarray):
        return x
    x = x.detach().cpu().contiguous()
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(np.uint8).reshape(tuple(x.shape) + (2,))
    return x.numpy()


def save(ckpt_dir: str, leaves: Mapping[str, Any], *, step: int = 0) -> str:
    """Synchronous atomic save of ``leaves`` (key -> tensor or numpy array).
    Returns the final checkpoint path."""
    final = os.path.join(ckpt_dir, f"step_{step:010d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": []}
    for key, leaf in leaves.items():
        fname = _sanitize(key) + ".npy"
        arr = _host(leaf)
        bf16 = isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16
        dtype = "bfloat16" if bf16 else str(arr.dtype)
        np.save(os.path.join(tmp, fname), arr)
        shape = list(arr.shape[:-1]) if bf16 else list(arr.shape)
        manifest["leaves"].append({"key": key, "file": fname, "shape": shape,
                                   "dtype": dtype})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _update_latest(ckpt_dir, step)
    return final


def _update_latest(ckpt_dir: str, step: int):
    with open(os.path.join(ckpt_dir, "LATEST.tmp"), "w") as f:
        f.write(str(step))
    os.replace(os.path.join(ckpt_dir, "LATEST.tmp"),
               os.path.join(ckpt_dir, "LATEST"))


def latest_step(ckpt_dir: str) -> Optional[int]:
    p = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        step = int(f.read().strip())
    if os.path.isdir(os.path.join(ckpt_dir, f"step_{step:010d}")):
        return step
    return None


def _load(path: str, meta: dict) -> torch.Tensor:
    arr = np.load(path)
    if arr.ndim == len(meta["shape"]) + 1:          # raw bytes of a custom dtype
        if meta["dtype"] != "bfloat16":
            raise ValueError(f"{meta['key']}: dtype {meta['dtype']} is not supported")
        raw = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)[..., 0])
        return raw.view(torch.bfloat16)
    return torch.from_numpy(arr)


def restore(ckpt_dir: str, target: Optional[Mapping[str, torch.Tensor]] = None, *,
            step: Optional[int] = None) -> Leaves:
    """The leaves of checkpoint ``step`` (the latest by default) as CPU
    tensors. With ``target`` (key -> tensor), only its keys, each cast to
    the target's dtype; a missing key raises ``KeyError`` and a shape that
    differs ``ValueError``."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:010d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    by_key = {m["key"]: m for m in manifest["leaves"]}
    if target is None:
        return {k: _load(os.path.join(d, m["file"]), m) for k, m in by_key.items()}
    out: Leaves = {}
    for key, want in target.items():
        if key not in by_key:
            raise KeyError(f"checkpoint missing leaf {key}")
        t = _load(os.path.join(d, by_key[key]["file"]), by_key[key]).to(want.dtype)
        if tuple(t.shape) != tuple(want.shape):
            raise ValueError(f"shape mismatch for {key}: ckpt {tuple(t.shape)} "
                             f"vs {tuple(want.shape)}")
        out[key] = t
    return out


class AsyncCheckpointer:
    """Thread-backed async save with a bounded queue (backpressure = 1)."""

    def __init__(self, ckpt_dir: str):
        self.ckpt_dir = ckpt_dir
        self._q: "queue.Queue" = queue.Queue(maxsize=1)
        self._err: Optional[BaseException] = None
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            host, step = item
            try:
                save(self.ckpt_dir, host, step=step)
            except BaseException as e:  # noqa: BLE001
                self._err = e
            finally:
                self._q.task_done()

    def save(self, leaves: Mapping[str, Any], *, step: int):
        if self._err:
            raise self._err
        # to host memory now: the train step updates the tensors in place next
        host = {k: v.copy() if isinstance(v, np.ndarray) else v.detach().to("cpu", copy=True)
                for k, v in leaves.items()}
        self._q.put((host, step))

    def wait(self):
        self._q.join()
        if self._err:
            raise self._err

    def close(self):
        self.wait()
        self._q.put(None)
        self._worker.join(timeout=10)
