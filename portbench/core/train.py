"""The training driver: one ``ElasticTrainer`` at world size 1, as the HPC
department runs it on one card.

Set-up builds the trainer (``ElasticTrainer.start`` on the card, its
checkpoint directory a fresh one under ``TMPDIR`` that is never written),
copies the benchmark's weights into its parameters and float32 master, and
drives it through the cell's checked steps with ``train_steps(1)``, the
window's own call and feed, on batches that all differ. Those steps are the
warm-up and give the readings that are checked: each step's loss, the first
step's gradient as the optimizer got it (from its first moment after one
step, m = (1 - beta1) g clip, with the clip of the global norm the program
reports) and the master's change over the checked steps. The
same trainer then runs the window: ``train_steps(1)`` until ``seconds`` have
passed, every step on the cycled batches. After the window (and the traced
segment, with ``--trace 1``) the trainer is freed and the reference runs the
checked steps from the same weights and batches in float32.
"""
from __future__ import annotations

import math
import shutil
import tempfile
import time

import torch

from portbench.core import check, program, traffic, weights
from portbench.core.run import Call, Run
from portbench.core.trace import profiled, span
from portbench.reference.common import (Hyper, TrainReadings, matmul, no_tf32, sample_state,
                                        train_readings, update_gap)


def hyper(spec: dict) -> Hyper:
    return Hyper(**spec["optimizer"])


def trainer_for(run: Run, batches, ckpt_dir: str):
    """The program's trainer for the cell, started on ``run.device`` with the
    benchmark's weights in it."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.runtime.elastic import ElasticTrainer
    hp = hyper(run.spec)
    tcfg = TrainConfig(microbatch=0, remat=run.spec["remat"], zero1=True,
                       learning_rate=hp.learning_rate, weight_decay=hp.weight_decay,
                       beta1=hp.beta1, beta2=hp.beta2, eps=hp.eps, grad_clip=hp.grad_clip,
                       z_loss=hp.z_loss)
    K = len(batches)

    def data_fn(step, global_batch, seq_len):
        return batches[step % K]

    tr = run.traffic
    trainer = ElasticTrainer(program.model_config(run.model), tcfg,
                             global_batch=tr["batch"], seq_len=tr["seq_len"],
                             ckpt_dir=ckpt_dir, data_fn=data_fn, seed=run.seed % (1 << 31))
    trainer.start([run.device])
    state = trainer.state
    program.load(dict(state.params.named_parameters()),
                  weights.draw(run.reference.leaves(run.model), run.seed, run.device),
                  master=state.opt.master)
    return trainer


def checked_steps(run: Run, trainer) -> TrainReadings:
    """The checked steps through ``train_steps(1)``, and their readings."""
    hp = hyper(run.spec)
    steps = run.spec["checked_steps"]
    losses, grads, gnorms, before = [], {}, [], {}
    for i in range(steps):
        if i == steps - 1:
            opt = trainer.state.opt
            before = sample_state(opt.m, opt.v, opt.master, run.seed)
        metrics = trainer.train_steps(1)
        losses.append(metrics["loss"])
        gnorms.append(float(metrics["grad_norm"]))
        if i == 0:
            clip = min(1.0, hp.grad_clip / max(gnorms[0], 1e-12)) if hp.grad_clip > 0 else 1.0
            grads = {k: float(torch.linalg.vector_norm(m)) / (1.0 - hp.beta1) / clip
                     for k, m in trainer.state.opt.m.items()}
    opt = trainer.state.opt
    gap = update_gap(before, sample_state(opt.m, opt.v, opt.master, run.seed), steps, hp)
    change = {k: float(torch.linalg.vector_norm(opt.master[k] - w0.float()))
              for k, w0 in weights.draw(run.reference.leaves(run.model), run.seed, run.device)}
    return TrainReadings(losses, grads, change, gnorms, gap)


def reference_readings(run: Run, batches, mm=matmul) -> TrainReadings:
    """The reference's readings of the checked steps, in float32 (``mm``:
    the control's product instead)."""
    no_tf32()
    hp = hyper(run.spec)
    ref, model = run.reference, run.model
    steps = run.spec["checked_steps"]
    return train_readings(
        lambda: weights.draw(ref.leaves(model), run.seed, run.device), batches[:steps],
        lambda P, b: ref.loss(P, b, model, hp.z_loss, mm, remat=run.spec["remat"] != "none"),
        hp, steps, run.seed)


def execute(run: Run) -> None:
    tr = run.traffic
    B, S = tr["batch"], tr["seq_len"]
    batches = traffic.train_batches(tr, run.model, run.seed, run.device)
    ckpt_dir = tempfile.mkdtemp(prefix="portbench-ckpt-")
    trainer = None
    try:
        trainer = trainer_for(run, batches, ckpt_dir)
        prog = checked_steps(run, trainer)

        t0 = run.start_window()
        run.reset_peak()
        steps = 0
        while True:
            trainer.train_steps(1)
            steps += 1
            if time.perf_counter() - t0 >= run.seconds:
                break
        seconds = time.perf_counter() - t0
        run.window = {"steps": steps, "tokens": steps * B * S, "seconds": seconds,
                      "peak_bytes": run.peak(), "batch": B, "seq_len": S}
        run.attempted = steps
        run.reset_peak()

        if run.trace_on:
            k = run.spec["trace_steps"]
            holder: dict = {}
            with profiled(holder):
                for _ in range(k):
                    with span("train_step"):
                        trainer.train_steps(1)
            run.trace = holder["trace"]
            run.calls = [Call("train", B, S, run.spec["remat"] != "none")] * k
        run.reset_peak()
    finally:
        if trainer is not None:
            trainer.close()
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    del trainer
    run.free()
    t = time.perf_counter()
    run.checks = check.train(prog, reference_readings(run, batches), run.spec["limits"],
                             run.model["num_layers"], run.spec["grad_tail_layers"])
    run.window["reference_s"] = time.perf_counter() - t
    run.window["losses"] = prog.losses
    if not all(math.isfinite(x) for x in prog.losses):
        run.failed = run.attempted
