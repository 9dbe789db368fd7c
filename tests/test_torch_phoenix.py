"""The paper's ``PhoenixOrchestrator`` with a real elastic trainer on CPU
ranks, and the port's three runtime examples, against the JAX package.

* JAX's ``tests/test_runtime_elastic.py:93`` scenario: a reduced deepseek-7b
  ``ElasticTrainer`` (batch 8 x 16) and a ``ServingPool`` (100 tokens a
  replica) on 8 devices with ``min_st_devices=2``: ``start()`` gives the
  trainer all 8, a WS load of 90 tokens takes 2 for two replicas (the
  trainer shrinks to 6 and trains on the 4 its batch allows), a request is
  served, zero load gives one back (7, again on 4). The port runs on
  ``["cpu"] * 8`` (8 ``gloo`` ranks), JAX on 8 forced host devices, both
  trainers from one checkpoint of the JAX ``init_state(PRNGKey(0))`` and
  both pools on the JAX ``init_params(PRNGKey(0))`` (converted for the
  port). After every tick both hold the same devices in each group, the
  same replicas and events; the losses agree, and the served tokens are
  the same.
* ``repro_torch.examples.elastic_train``, ``elastic_serving`` and
  ``multi_department_runtime`` at their JAX defaults with ``--device cpu``
  (8, 4 and 8 CPU entries, the JAX examples' forced host devices) print the
  JAX examples' lines: every event, replica count, device count, step and
  resize; the losses, served tokens and wall times (weights drawn by
  another framework, another clock) are masked.

The JAX runs are four subprocesses started when this module's first test
starts, so that they run while the port does; each has a timeout.
Tolerances: the losses at ``test_torch_training.TOLS``' float32 loss
tolerance, 1e-5.
"""
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.checkpoint import checkpointer as jckpt  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.training import train_step as JS  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.runtime.elastic import ElasticTrainer  # noqa: E402
from repro_torch.runtime.orchestrator import PhoenixOrchestrator  # noqa: E402
from repro_torch.runtime.serving_pool import ServingPool  # noqa: E402
from test_torch_training import TOLS  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_TOL = TOLS["float32"][0]
TIMEOUT_S = 600
EXAMPLES = ("elastic_train", "elastic_serving", "multi_department_runtime")
# (op, args) of the scenario, after each of which both packages snapshot
TICKS = [("start",), ("train_steps", 1), ("ws_tick", 90.0), ("train_steps", 1),
         ("submit",), ("ws_tick", 0.0), ("train_steps", 1)]
PROMPT = [[1, 2, 3, 4]]

_JAX_SCRIPT = """
import json, os, shutil, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, {src!r})
import jax, numpy as np
from repro.configs import ARCHS, reduced_config
from repro.configs.base import TrainConfig
from repro.models import model as M
from repro.runtime.elastic import ElasticTrainer
from repro.runtime.orchestrator import PhoenixOrchestrator
from repro.runtime.serving_pool import ServingPool

cfg = reduced_config(ARCHS["deepseek-7b"])
d = {work!r}
shutil.copytree({init!r}, d)
trainer = ElasticTrainer(cfg, TrainConfig(), global_batch=8, seq_len=16, ckpt_dir=d,
                         model_size=1)
pool = ServingPool(cfg, M.init_params(jax.random.PRNGKey(0), cfg),
                   capacity_tokens_per_replica=100.0)
orch = PhoenixOrchestrator(trainer, pool, min_st_devices=2)
print("JAX_PHOENIX " + json.dumps(run(orch, trainer, pool, {ticks!r}, {prompt!r})))
"""

_RUN = '''
def run(orch, trainer, pool, ticks, prompt):
    """Each tick, then a snapshot: groups by device index, replicas, events."""
    index = {id(d): i for i, d in enumerate(orch.devs.devices)}
    on = lambda devs: [index[id(d)] for d in devs]
    snaps, losses, devices, served = [], [], [], None
    for op, *args in ticks:
        if op == "submit":
            served = pool.submit(np.array(prompt, dtype=np.int32), 4).tolist()
        else:
            m = getattr(orch, op)(*args)
            if op == "train_steps":
                losses.append(float(m["loss"]))
                devices.append(int(m["devices"]))
        orch.devs.check()
        orch.rps.check()
        snaps.append({"st": on(orch.devs.st), "ws": on(orch.devs.ws),
                      "replicas": len(pool.replicas), "events": json.dumps(orch.events)})
    return {"snaps": snaps, "losses": losses, "devices": devices, "served": served,
            "resizes": trainer.resizes, "step": trainer.step}
'''
exec(_RUN)      # the port runs the same function as the JAX subprocess


class JaxRuns:
    """The JAX phoenix scenario and the three JAX examples, one subprocess
    each; ``result(name)`` waits for one."""

    def __init__(self, init_dir, work_dir):
        env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
        env.update(JAX_PLATFORMS="cpu",
                   PYTHONPATH=os.pathsep.join([os.path.join(REPO, "src"),
                                               env.get("PYTHONPATH", "")]))
        code = _JAX_SCRIPT.format(
            src=os.path.join(REPO, "src"), init=str(init_dir), work=str(work_dir / "phoenix"),
            ticks=TICKS, prompt=PROMPT).replace('print("JAX_PHOENIX', _RUN + '\nprint("JAX_PHOENIX')
        self.procs = {"phoenix": subprocess.Popen(
            [sys.executable, "-c", code], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, env=env, cwd=str(work_dir))}
        for name in EXAMPLES:
            self.procs[name] = subprocess.Popen(
                [sys.executable, os.path.join(REPO, "examples", f"{name}.py")],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
                cwd=str(work_dir))
        self._out = {}

    def result(self, name):
        if name not in self._out:
            proc = self.procs[name]
            try:
                out, err = proc.communicate(timeout=TIMEOUT_S)
            except subprocess.TimeoutExpired:
                proc.kill()
                raise
            assert proc.returncode == 0, err[-4000:]
            self._out[name] = out
        return self._out[name]

    def stop(self):
        for proc in self.procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()


@pytest.fixture(scope="module")
def init_dir(tmp_path_factory):
    """A step-0 checkpoint of the JAX initial state of reduced deepseek-7b."""
    root = tmp_path_factory.mktemp("init") / "deepseek"
    cfg = JC.reduced_config(JC.ARCHS["deepseek-7b"])
    jckpt.save(str(root), JS.init_state(jax.random.PRNGKey(0), cfg), step=0)
    return root


@pytest.fixture(scope="module", autouse=True)
def jax_runs(init_dir, tmp_path_factory):
    runs = JaxRuns(init_dir, tmp_path_factory.mktemp("jax"))
    yield runs
    runs.stop()


def test_phoenix_orchestrator_with_a_real_trainer_matches_jax(tmp_path, init_dir, jax_runs):
    jcfg = JC.reduced_config(JC.ARCHS["deepseek-7b"])
    cfg = TC.reduced_config(TC.get_config("deepseek-7b"))
    d = tmp_path / "ck"
    shutil.copytree(init_dir, d)
    trainer = ElasticTrainer(cfg, TrainConfig(), global_batch=8, seq_len=16, ckpt_dir=str(d),
                             model_size=1)
    params = jax.device_get(JM.init_params(jax.random.PRNGKey(0), jcfg))
    pool = ServingPool(cfg, convert.params_from_jax(params, cfg, "cpu"),
                       capacity_tokens_per_replica=100.0)
    orch = PhoenixOrchestrator(trainer, pool, devices=["cpu"] * 8, min_st_devices=2)
    try:
        got = run(orch, trainer, pool, TICKS, PROMPT)
    finally:
        trainer.close()
    line = [ln for ln in jax_runs.result("phoenix").splitlines()
            if ln.startswith("JAX_PHOENIX ")][-1]
    want = json.loads(line[len("JAX_PHOENIX "):])
    assert got["snaps"] == want["snaps"]
    assert [len(s["st"]) for s in got["snaps"]] == [8, 8, 6, 6, 6, 7, 7]
    assert [s["replicas"] for s in got["snaps"]] == [0, 0, 2, 2, 2, 1, 1]
    assert got["devices"] == want["devices"] == [8, 4, 4]
    assert got["resizes"] == want["resizes"] == 2 and got["step"] == want["step"] == 3
    assert max(abs(a - b) for a, b in zip(got["losses"], want["losses"])) <= LOSS_TOL, (
        got["losses"], want["losses"])
    assert got["served"] == want["served"] and np.array(got["served"]).shape == (1, 4)


MASKS = {  # what another framework's weights or another clock change
    "elastic_train": [(r"loss=\S+", "loss=*"), (r"tokens \[.*\]", "tokens [*]")],
    "elastic_serving": [(r", [\d.]+s wall", ", *s wall"), (r"throughput: .*", "throughput: *")],
    "multi_department_runtime": [],
}


def _masked(text, name):
    for pattern, repl in MASKS[name]:
        text = re.sub(pattern, repl, text)
    return [ln for ln in text.splitlines() if ln.strip()]


@pytest.mark.parametrize("name", EXAMPLES)
def test_runtime_example_matches_jax(name, jax_runs, capsys):
    import importlib
    example = importlib.import_module(f"repro_torch.examples.{name}")
    assert example.main(["--device", "cpu"]) == 0
    got = _masked(capsys.readouterr().out, name)
    want = _masked(jax_runs.result(name), name)
    assert got == want
    assert len(got) >= 5
