"""Port parity for the runtime orchestrator: ``repro_torch.runtime.orchestrator``
against ``repro.runtime.orchestrator`` on the CPU.

The JAX package's four orchestrator scenarios (``tests/test_tenancy.py``'s
two, ``tests/test_market.py``'s and ``tests/test_telemetry.py``'s), the
one-card scenario (a WS department that gives its only card back when its
load falls to zero, a trainer started by the reflow, a node failure and its
repair) under the ``paper`` and ``demand_capped`` policies, and the paper's
two-department ``PhoenixOrchestrator`` run tick by tick on both packages
with duck-typed stub trainers and pools, which need no device. JAX devices
are named ``"dev{i}"``, the port's ``"cuda:{i}"`` (a ``torch.device`` that
builds without a card), so groups are compared by index. After every tick
both packages must hold the same devices in every group and in the free
pool, the same ``events``, allocations, market state and policy state; at
the end the tracers' JSONL lines must be the same bytes.

Then the one-card scenario with real port workloads on ``devices=["cpu"]``:
a reduced recurrentgemma-2b ``ServingPool`` and ``ElasticTrainer``.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import telemetry as JT  # noqa: E402
from repro.core.types import SLOConfig as JSLOConfig  # noqa: E402
from repro.runtime import orchestrator as JO  # noqa: E402
from repro.serving.batching import ServiceTimeModel as JServiceTimeModel  # noqa: E402
from repro.workloads.autoscaler import SLOAutoscaler as JSLOAutoscaler  # noqa: E402
from repro_torch.core import telemetry as TT  # noqa: E402
from repro_torch.core.types import SLOConfig as TSLOConfig  # noqa: E402
from repro_torch.runtime import orchestrator as TO  # noqa: E402
from repro_torch.serving.batching import ServiceTimeModel as TServiceTimeModel  # noqa: E402
from repro_torch.workloads.autoscaler import SLOAutoscaler as TSLOAutoscaler  # noqa: E402

PACKAGES = {  # name -> (orchestrator module, Tracer, SLO autoscaler parts, device name)
    "jax": (JO, JT.Tracer, (JSLOAutoscaler, JServiceTimeModel, JSLOConfig), "dev{}"),
    "port": (TO, TT.Tracer, (TSLOAutoscaler, TServiceTimeModel, TSLOConfig), "cuda:{}"),
}


class StubTrainer:
    """Duck-typed ElasticTrainer: records device moves, trains nothing."""

    def __init__(self, model_size=1, global_batch=8):
        self.model_size = model_size
        self.global_batch = global_batch
        self.step = 0
        self.devices = []
        self.resizes = 0

    def start(self, devices):
        self.devices = list(devices)

    def resize(self, devices):
        self.devices = list(devices)
        self.resizes += 1

    def train_steps(self, n):
        self.step += n
        return {"step": self.step}


class StubPool:
    """Duck-typed ServingPool: one replica per device; the utilization rule
    is the offered load itself."""

    def __init__(self):
        self.replicas = []

    def scale_to(self, devices):
        self.replicas = list(devices)

    def desired_replicas(self, load):
        return int(load)


class RulePool(StubPool):
    """A stub pool with ``ServingPool.desired_replicas``: the paper's §III-C
    80 % utilization rule against ``capacity`` tokens a replica."""

    def __init__(self, capacity):
        super().__init__()
        self.capacity = capacity

    def desired_replicas(self, load):
        n = max(1, len(self.replicas))
        util = load / (n * self.capacity)
        if util > 0.80:
            return n + 1
        if n > 1 and util < 0.80 * (n - 1) / n:
            return n - 1
        return n


def _slo(package, **kw):
    autoscaler, service, slo = PACKAGES[package][2]
    return autoscaler(service(), slo(latency_target_s=2.0), **kw)


# Scenarios: (devices, policy, departments, ticks). A department is
# ("latency", name, add_latency kwargs) or ("batch", name, StubTrainer
# kwargs, add_batch kwargs); "slo" in add_latency kwargs is the
# SLOAutoscaler's kwargs. A tick is (method, *args); "start" is one too.
SCENARIOS = {
    # tests/test_tenancy.py: test_multitenant_orchestrator_routes_counts_to_devices
    "routes_counts": (16, "demand_capped", [
        ("latency", "ws-a", dict(priority=0)),
        ("latency", "ws-b", dict(priority=1)),
        ("batch", "hpc-a", dict(model_size=2, global_batch=4), dict(priority=2, weight=2.0)),
        ("batch", "hpc-b", dict(model_size=2, global_batch=2), dict(priority=3)),
    ], [("start",), ("latency_tick", "ws-a", 6.0), ("latency_tick", "ws-b", 20.0),
        ("latency_tick", "ws-a", 0.0), ("latency_tick", "ws-b", 0.0)]),
    # tests/test_tenancy.py: test_multitenant_orchestrator_feeds_latency_signals_to_engine
    "latency_signals": (12, "slo_headroom", [
        ("latency", "ws-hot", dict(priority=0, floor=1)),
        ("latency", "ws-cozy", dict(priority=1, floor=1)),
        ("batch", "hpc", dict(model_size=2, global_batch=2), dict(priority=2)),
    ], [("start",), ("latency_tick", "ws-cozy", 4.0), ("observe_latency", "ws-cozy", 0.5),
        ("latency_tick", "ws-hot", 11.0)]),
    # tests/test_market.py: test_orchestrator_exposes_market_state
    "market_state": (8, "budget_auction", [
        ("latency", "serve", dict(priority=0, floor=1, budget=4.0, bid_policy="slo_elastic")),
        ("batch", "train", dict(model_size=1, global_batch=8),
         dict(priority=1, bid_weight=2.0, min_devices=1)),
    ], [("start",), ("latency_tick", "serve", 8.0), ("latency_tick", "serve", 0.0),
        ("latency_tick", "serve", 8.0)]),
    # tests/test_telemetry.py: test_orchestrator_emits_autoscale_decisions
    "autoscale_trace": (12, "demand_capped", [
        ("latency", "ws", dict(priority=0)),
        ("batch", "hpc", dict(model_size=2, global_batch=4), dict(priority=1)),
    ], [("start",), ("latency_tick", "ws", 6.0), ("latency_tick", "ws", 0.0)]),
}

# One card: the WS department holds it through a spike, gives it back at
# rate 0 (SLOAutoscaler n_min 0), the reflow starts the trainer; a second
# spike gets nothing (the only card is the trainer's floor); the card fails
# and is repaired, which re-grants it and resizes the trainer once.
ONE_CARD_DEPTS = [
    ("latency", "ws", dict(priority=0, slo=dict(n_min=0, n_max=1))),
    ("batch", "hpc", dict(model_size=1, global_batch=8), dict(priority=1, min_devices=1)),
]
SPIKE = ("latency_tick_slo", "ws", 5.0, 0.35, 1.0)
QUIET = ("latency_tick_slo", "ws", 0.0, 0.35, 1.0)
ONE_CARD_TICKS = [SPIKE, ("start",), QUIET, ("train_steps", "hpc", 2), SPIKE,
                  ("fail_node",), ("repair_node",), ("train_steps", "hpc", 2), QUIET]
ONE_CARD_EVENTS = [
    {"kind": "scale", "dept": "ws", "replicas": 1},
    {"kind": "grant", "dept": "hpc", "devices": 1},
    {"kind": "scale", "dept": "ws", "replicas": 0},
    {"kind": "scale", "dept": "ws", "replicas": 0},
    {"kind": "node_fail", "node": 0, "dept": "hpc"},
    {"kind": "grant", "dept": "hpc", "devices": 1},
    {"kind": "node_repair", "node": 0},
    {"kind": "scale", "dept": "ws", "replicas": 0},
]
for policy in ("paper", "demand_capped"):
    SCENARIOS[f"one_card_{policy}"] = (1, policy, ONE_CARD_DEPTS, ONE_CARD_TICKS)


def build(package, n_devices, policy, depts, *, devices=None, workloads=None):
    """The package's MultiTenantOrchestrator with a tracer and the
    departments registered: stub workloads unless ``workloads`` maps a
    department to its own."""
    module, tracer_cls, _, name = PACKAGES[package]
    if devices is None:
        devices = [name.format(i) for i in range(n_devices)]
    orch = module.MultiTenantOrchestrator(devices=devices, policy=policy,
                                          tracer=tracer_cls())
    workloads = dict(workloads or {})
    for kind, dept, *kw in depts:
        if kind == "latency":
            add = dict(kw[0])
            slo = add.pop("slo", None)
            if slo is not None:
                add["slo_autoscaler"] = _slo(package, **slo)
            orch.add_latency(dept, workloads.setdefault(dept, StubPool()), **add)
        else:
            orch.add_batch(dept, workloads.setdefault(dept, StubTrainer(**kw[0])), **kw[1])
    return orch, workloads


def tick(orch, op):
    return getattr(orch, op[0])(*op[1:])


def snapshot(orch, workloads):
    """Everything both packages must agree on after a tick; devices by index."""
    index = {d: i for i, d in enumerate(orch.devs.devices)}
    on = lambda devs: [index[d] for d in devs]  # noqa: E731
    snap = {"groups": {g: on(ds) for g, ds in orch.devs.groups.items()},
            "free": on(orch.devs.free), "events": json.dumps(orch.events),
            "alloc": {n: t.alloc for n, t in orch.svc.tenants.items()},
            "market": json.dumps(orch.market_state(), sort_keys=True),
            "policy": json.dumps(orch.svc.policy.state_snapshot(), sort_keys=True,
                                 default=repr),
            "nodes": {g: orch.nodes_of(g) for g in [*orch.svc.tenants, "free"]}}
    for dept, w in workloads.items():
        if isinstance(w, StubTrainer):
            snap[dept] = (on(w.devices), w.resizes, w.step)
        elif isinstance(w, StubPool):
            snap[dept] = on(w.replicas)
    return snap


def run_scenario(package, name):
    n, policy, depts, ticks = SCENARIOS[name]
    orch, workloads = build(package, n, policy, depts)
    snaps = []
    for op in ticks:
        tick(orch, op)
        orch.devs.check()
        orch.svc.check()
        snaps.append(snapshot(orch, workloads))
    return orch, snaps


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_orchestrator_matches_jax_tick_by_tick(name):
    jorch, jsnaps = run_scenario("jax", name)
    torch_orch, tsnaps = run_scenario("port", name)
    assert len(tsnaps) == len(jsnaps) == len(SCENARIOS[name][3])
    for i, (want, got) in enumerate(zip(jsnaps, tsnaps)):
        assert got == want, (name, i, SCENARIOS[name][3][i])
    want = "\n".join(jorch.tracer.lines()).encode()
    got = "\n".join(torch_orch.tracer.lines()).encode()
    assert got == want
    assert len(jorch.tracer.events) > 0
    assert TT.validate_events([torch_orch.tracer.header()] + torch_orch.tracer.events) == []


@pytest.mark.parametrize("policy", ["paper", "demand_capped"])
def test_one_card_scenario_events(policy):
    """The one-card scenario's 8 events and 15 trace events, pinned; the
    trainer starts at the reflow and is resized once, by the repair."""
    orch, snaps = run_scenario("port", f"one_card_{policy}")
    assert orch.events == ONE_CARD_EVENTS
    assert len(orch.tracer.events) == 15
    hpc = orch.batch["hpc"]
    assert hpc.started and hpc.trainer.resizes == 1 and hpc.trainer.step == 4
    # the department first holds the card at the zero-rate tick after
    # start(), loses it to the failure and gets it back at the repair
    assert [s["groups"]["hpc"] for s in snaps] == [[], [], [0], [0], [0], [], [0], [0], [0]]
    assert [s["groups"]["ws"] for s in snaps] == [[0], [0]] + [[]] * 7


def test_phoenix_orchestrator_matches_jax():
    """``PhoenixOrchestrator`` on ``tests/test_runtime_elastic.py``'s ticks
    with stubs: 8 devices, ``min_st_devices=2``, a pool with the §III-C rule
    at 100 tokens a replica. Both packages give the same trainer and pool
    devices and events after every tick."""
    def run(package):
        module, _, _, name = PACKAGES[package]
        trainer, pool = StubTrainer(), RulePool(100.0)
        orch = module.PhoenixOrchestrator(
            trainer, pool, devices=[name.format(i) for i in range(8)], min_st_devices=2)
        index = {d: i for i, d in enumerate(orch.devs.devices)}
        snaps = []
        for op in (("start",), ("train_steps", 1), ("ws_tick", 90.0), ("train_steps", 1),
                   ("ws_tick", 0.0), ("train_steps", 1)):
            getattr(orch, op[0])(*op[1:])
            orch.devs.check()
            orch.rps.check()
            snaps.append({"st": [index[d] for d in orch.devs.st],
                          "ws": [index[d] for d in orch.devs.ws],
                          "trainer": ([index[d] for d in trainer.devices], trainer.resizes),
                          "replicas": [index[d] for d in pool.replicas],
                          "events": json.dumps(orch.events)})
        return snaps
    want, got = run("jax"), run("port")
    assert got == want
    assert [len(s["st"]) for s in got] == [8, 8, 6, 6, 7, 7]
    assert [len(s["ws"]) for s in got] == [0, 0, 2, 2, 1, 1]


def test_orchestrator_without_devices_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TO.MultiTenantOrchestrator()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TO.PhoenixOrchestrator(StubTrainer(), StubPool())


def test_one_card_scenario_with_port_workloads_on_the_cpu(tmp_path):
    """The one-card scenario on ``devices=["cpu"]`` with a reduced
    recurrentgemma-2b ServingPool (weights drawn on the CPU from seed 0) and
    ElasticTrainer (the train launcher's reduced defaults at batch 2 x 16):
    the same events as the stub run; while the WS department holds the CPU,
    ``pool.submit`` gives a lone Replica's tokens; the trainer starts at the
    reflow, is resized once by the repair, and its losses over four steps
    equal an uninterrupted trainer's bit for bit."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import model as M
    from repro_torch.runtime.elastic import ElasticTrainer
    from repro_torch.runtime.serving_pool import Replica, ServingPool

    cfg = reduced_config(get_config("recurrentgemma-2b"))
    model = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    pool = ServingPool(cfg, model)

    def trainer(ckpt):
        return ElasticTrainer(cfg, TrainConfig(), global_batch=2, seq_len=16,
                              ckpt_dir=str(tmp_path / ckpt),
                              data_fn=SyntheticLM(cfg, seed=0).data_fn, init_device="cpu")

    hpc = trainer("elastic")
    orch, _ = build("port", 1, "paper", ONE_CARD_DEPTS, devices=["cpu"],
                    workloads={"ws": pool, "hpc": hpc})
    prompt = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 10), dtype=np.int32)
    served = None
    for op in ONE_CARD_TICKS:
        tick(orch, op)
        if op[0] == "start":          # the card is the WS department's
            assert [r.device.type for r in pool.replicas] == ["cpu"] and hpc.state is None
            served = pool.submit(prompt, 6)
            orch.observe_latency("ws", max(t["prefill_s"] + t["decode_s"]
                                           for t in pool.timings))
        orch.devs.check()
        orch.svc.check()
    assert orch.events == ONE_CARD_EVENTS
    want = Replica(cfg, model, "cpu").generate(prompt, 6)
    assert served.shape == (2, 6) and np.array_equal(served, want)
    assert hpc.resizes == 1 and hpc.step == 4 and pool.replicas == []
    straight = trainer("straight")
    straight.start(["cpu"])
    straight.train_steps(2)
    straight.train_steps(2)
    assert hpc.metrics_log == straight.metrics_log
    assert [m["step"] for m in hpc.metrics_log] == [2, 4]
