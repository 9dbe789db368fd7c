"""Trace-driven decision replay and divergence bisection.

Every control-plane decision is a typed, causally-linked trace event
(core/telemetry.py). This module *consumes* those traces:

  * :func:`replay_events` reconstructs a run's decision sequence — free
    pool drains, reclaim plans and their per-victim drains, idle grants,
    releases, drain-window deliveries, node failures/repairs, market
    debits — and re-applies it step-lockstep against fresh count books
    (per-tenant alloc, free pool, drain pool, total, market spend). The
    replayed books are verified against every recorded ``metrics``
    checkpoint (the simulator samples its live state into the trace on
    the same clock), against every ``slo_violation``'s recorded alloc,
    and against each claim's own arithmetic (``from_free`` + step grants
    == ``granted``). A clean replay *proves the trace is a complete
    causal record*: the end-of-run books are derivable from the decision
    events alone, with nothing moved off the record.

  * :func:`bisect_traces` walks two traces of the SAME scenario (same
    arrivals/jobs/seed) under different policy engines and localizes the
    first divergent *decision*: the sim-time, event type, tenant, and
    both sides' payloads (for reclaims: the full planned-victim lists),
    turning "engine A completes 69 jobs vs B's 33" into an explainable
    first cause. Span ids, engine labels and free-text reasons are
    normalized away so the comparison is behavioral, not cosmetic.

Both are surfaced by the analyzer CLI: ``python -m repro_torch.trace
replay`` and ``python -m repro_torch.trace bisect``
(src/repro_torch/trace.py).

The port's own copy of ``repro.core.replay`` with the same logic.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.nodes import DRAIN_POOL

# replayed floating-point books (market spend) accumulate in the exact
# order the live run debited them, so they should round-trip bitwise; the
# tolerance only absorbs JSON float formatting of pathological values
SPEND_RTOL = 1e-9

# event types that ARE control-plane decisions (replayed / bisected), in
# contrast to sampled state (`metrics`), inventory mirrors (`node_state`)
# and the header. `slo_violation`/`slo_recovery` ride along: they are
# consequences the simulator commits to the record at decision points and
# carry cross-checkable alloc/demand.
DECISION_TYPES = frozenset({
    "claim", "reclaim_plan", "reclaim_step", "surplus_reflow",
    "idle_grant", "release", "autoscale", "auction_clear", "debit",
    "node_fail", "node_repair", "fault_suppressed", "drain_complete",
    "slo_violation", "slo_recovery",
})


@dataclasses.dataclass
class ReplayResult:
    """Outcome of one :func:`replay_events` pass."""
    events: int = 0               # trace events consumed (header included)
    decisions: int = 0            # decision events applied to the books
    checkpoints: int = 0          # metrics samples verified against books
    problems: List[str] = dataclasses.field(default_factory=list)
    # final count books
    total: int = 0
    free: int = 0
    draining: int = 0
    alloc: Dict[str, int] = dataclasses.field(default_factory=dict)
    spend: Dict[str, float] = dataclasses.field(default_factory=dict)
    demand: Dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return not self.problems

    def books(self) -> Dict:
        """JSON-safe snapshot of the replayed count books."""
        return {
            "total": self.total, "free": self.free,
            "draining": self.draining,
            "alloc": dict(sorted(self.alloc.items())),
            "spend": {k: float(v)
                      for k, v in sorted(self.spend.items())},
            "demand": dict(sorted(self.demand.items())),
        }


def replay_events(events: Sequence[Dict]) -> ReplayResult:
    """Re-apply a trace's decision sequence against fresh count books.

    The books start from the header's ``total_nodes`` (everything free —
    exactly the provision service's initial state) and every decision
    event moves counts the way ``TenantProvisionService`` did live:

    ====================  =============================================
    event                 book transition
    ====================  =============================================
    ``idle_grant``        free -> tenant
    ``claim``             free -> claimant (the ``from_free`` part)
    ``reclaim_step``      victim -> claimant (or the drain pool when the
                          step pays a drain window); the over-released
                          remainder is held until its ``surplus_reflow``
    ``surplus_reflow``    held surplus -> free
    ``release``           tenant -> free
    ``drain_complete``    drain pool -> claimant (survivors only)
    ``node_fail``         owner pool and total shrink by one
    ``node_repair``       total and free grow by one
    ``debit``             market spend book grows by ``cost``
    ``autoscale``         demand book updated (no count move)
    ====================  =============================================

    Verification is step-lockstep: every ``metrics`` event must match the
    replayed free pool and per-tenant allocs exactly (and per-tenant
    spend within float round-trip), every ``slo_violation`` must match
    the replayed victim alloc, conservation (``sum(alloc) + free +
    draining == total``) must hold at every checkpoint, and every claim's
    ``from_free`` + step grants must equal its recorded ``granted``.
    Problems are collected, never raised — a corrupt or incomplete trace
    yields a non-empty ``problems`` list (the CLI exits non-zero on it).
    """
    res = ReplayResult()
    alloc = res.alloc
    spend = res.spend
    # reclaim bookkeeping for the per-claim arithmetic cross-check:
    # plan span -> claimant, claim span -> plan, plan span -> sum(granted)
    plan_claim_parent: Dict[int, int] = {}       # plan span -> claim span
    step_granted_by_plan: Dict[int, int] = {}
    surplus_held = 0

    def note(i: int, ev: Dict, msg: str) -> None:
        res.problems.append(
            f"event {i} ({ev.get('type')}, t={ev.get('ts', 0.0)}): {msg}")

    for i, ev in enumerate(events):
        res.events += 1
        t = ev.get("type")
        if t == "trace_header":
            res.total = int(ev.get("total_nodes", 0))
            res.free = res.total
            if res.total <= 0:
                note(i, ev, "header lacks a positive total_nodes; "
                            "count books cannot be seeded")
            continue
        if t == "metrics":
            res.checkpoints += 1
            if surplus_held != 0:
                note(i, ev, f"{surplus_held} over-released node(s) never "
                            "reflowed before the metrics sample")
            if int(ev.get("free", -1)) != res.free:
                note(i, ev, f"replayed free={res.free} but the live run "
                            f"recorded free={ev.get('free')}")
            for name, m in ev.get("tenants", {}).items():
                if int(m.get("alloc", -1)) != alloc.get(name, 0):
                    note(i, ev,
                         f"replayed alloc[{name}]={alloc.get(name, 0)} "
                         f"but the live run recorded {m.get('alloc')}")
                want = float(m.get("spend", 0.0))
                got = spend.get(name, 0.0)
                if abs(got - want) > SPEND_RTOL * max(abs(want), 1.0):
                    note(i, ev, f"replayed spend[{name}]={got} but the "
                                f"live run recorded {want}")
            used = sum(alloc.values())
            if used + res.free + res.draining != res.total:
                note(i, ev, "conservation broken: "
                            f"alloc={used} + free={res.free} + "
                            f"draining={res.draining} != total={res.total}")
            if any(a < 0 for a in alloc.values()) or res.free < 0 \
                    or res.draining < 0:
                note(i, ev, f"negative book: free={res.free} "
                            f"draining={res.draining} alloc={alloc}")
            continue
        if t not in DECISION_TYPES:
            continue                    # node_state / unknown: no counts
        res.decisions += 1
        if t == "idle_grant":
            n = int(ev["nodes"])
            res.free -= n
            alloc[ev["tenant"]] = alloc.get(ev["tenant"], 0) + n
        elif t == "claim":
            name = ev["tenant"]
            from_free = int(ev["from_free"])
            res.free -= from_free
            alloc[name] = alloc.get(name, 0) + from_free
            # arithmetic cross-check: free-pool part + reclaim-step
            # grants (immediate AND drain-committed) == granted
            plan_span = next(
                (ps for ps, cs in plan_claim_parent.items()
                 if cs == ev.get("span")), None)
            steps = step_granted_by_plan.pop(plan_span, 0) \
                if plan_span is not None else 0
            if from_free + steps != int(ev["granted"]):
                note(i, ev,
                     f"claim arithmetic: from_free={from_free} + step "
                     f"grants={steps} != granted={ev['granted']}")
        elif t == "reclaim_plan":
            plan_claim_parent[ev["span"]] = ev.get("parent")
        elif t == "reclaim_step":
            victim, claimant = ev["tenant"], ev["claimant"]
            released, granted = int(ev["released"]), int(ev["granted"])
            alloc[victim] = alloc.get(victim, 0) - released
            if "span" in ev:            # drain-delayed delivery
                res.draining += granted
            else:
                alloc[claimant] = alloc.get(claimant, 0) + granted
            surplus_held += released - granted
            plan = ev.get("parent")
            step_granted_by_plan[plan] = \
                step_granted_by_plan.get(plan, 0) + granted
        elif t == "surplus_reflow":
            n = int(ev["nodes"])
            res.free += n
            surplus_held -= n
            if surplus_held < 0:
                note(i, ev, f"surplus_reflow of {n} exceeds the "
                            "over-released nodes on the books")
        elif t == "release":
            n = int(ev["nodes"])
            alloc[ev["tenant"]] = alloc.get(ev["tenant"], 0) - n
            res.free += n
        elif t == "drain_complete":
            n = int(ev["nodes"])
            res.draining -= n
            alloc[ev["tenant"]] = alloc.get(ev["tenant"], 0) + n
        elif t == "node_fail":
            owner = ev["owner"]
            if owner == "free":
                res.free -= 1
            elif owner == DRAIN_POOL:
                res.draining -= 1
            else:
                alloc[owner] = alloc.get(owner, 0) - 1
            res.total -= 1
        elif t == "node_repair":
            res.total += 1
            res.free += 1
        elif t == "debit":
            spend[ev["tenant"]] = \
                spend.get(ev["tenant"], 0.0) + float(ev["cost"])
        elif t == "autoscale":
            res.demand[ev["tenant"]] = int(ev["demand"])
        elif t == "slo_violation":
            name = ev["tenant"]
            if int(ev.get("alloc", -1)) != alloc.get(name, 0):
                note(i, ev,
                     f"replayed alloc[{name}]={alloc.get(name, 0)} but "
                     f"the violation recorded alloc={ev.get('alloc')}")
        # slo_recovery / auction_clear / fault_suppressed: decisions on
        # the record, but they move no counts

    if surplus_held != 0:
        res.problems.append(
            f"end of trace: {surplus_held} over-released node(s) never "
            "reflowed to the free pool")
    used = sum(alloc.values())
    if used + res.free + res.draining != res.total:
        res.problems.append(
            f"end of trace: conservation broken — alloc={used} + "
            f"free={res.free} + draining={res.draining} "
            f"!= total={res.total}")
    return res


# ------------------------------------------------------------- bisection


def decision_stream(events: Sequence[Dict]) -> List[Tuple[int, Dict]]:
    """The (original_index, event) sequence of decision events — the unit
    :func:`bisect_traces` compares. ``metrics`` samples, ``node_state``
    inventory mirrors and the header are excluded: they restate decisions
    already on the stream (a divergence there is never the FIRST one)."""
    return [(i, ev) for i, ev in enumerate(events)
            if ev.get("type") in DECISION_TYPES]


# comparison-irrelevant keys: span ids are allocation-order artifacts,
# engine labels differ by construction when bisecting two engines, and
# auction intervals restate clearing order
_NORMALIZE_DROP = ("span", "parent", "engine", "interval")


def normalize_decision(ev: Dict) -> Dict:
    """Strip cosmetic fields so two engines' decisions compare on
    *behavior*: sim-time, type, tenant and the quantitative payload.
    Reclaim-plan steps keep (victim, take) but drop the engine-specific
    free-text ``reason``."""
    out = {k: v for k, v in ev.items() if k not in _NORMALIZE_DROP}
    if ev.get("type") == "reclaim_plan":
        out["steps"] = [{"victim": s["victim"], "take": s["take"]}
                        for s in ev.get("steps", [])]
    return out


def bisect_traces(a: Sequence[Dict], b: Sequence[Dict]) -> Optional[Dict]:
    """Localize the first divergent decision between two traces of the
    same scenario (returns None when the decision streams are
    behaviorally identical).

    The report pins the divergence to its sim-time, decision index,
    event types and tenants on both sides, the raw events themselves,
    and — when either side is mid-reclaim — the *planned* victim lists
    (``plan_a``/``plan_b``) so "planned vs taken" is visible in one
    place. ``context`` carries the trailing common decisions leading up
    to the split."""
    sa, sb = decision_stream(a), decision_stream(b)
    limit = min(len(sa), len(sb))
    div = None
    for k in range(limit):
        if normalize_decision(sa[k][1]) != normalize_decision(sb[k][1]):
            div = k
            break
    if div is None:
        if len(sa) == len(sb):
            return None
        div = limit                  # one stream is a strict prefix

    def side(stream, k):
        if k >= len(stream):
            return {"exhausted": True, "event": None, "index": None,
                    "ts": None, "type": None, "tenant": None}
        idx, ev = stream[k]
        return {"exhausted": False, "event": ev, "index": idx,
                "ts": ev.get("ts"), "type": ev.get("type"),
                "tenant": ev.get("tenant")}

    def last_plan(stream, k):
        """Most recent reclaim plan at or before the divergence: the
        'planned' half of planned-vs-taken."""
        for j in range(min(k, len(stream) - 1), -1, -1):
            ev = stream[j][1]
            if ev.get("type") == "reclaim_plan":
                return {"ts": ev.get("ts"), "tenant": ev.get("tenant"),
                        "engine": ev.get("engine"),
                        "steps": [{"victim": s["victim"],
                                   "take": s["take"]}
                                  for s in ev.get("steps", [])]}
        return None

    ctx = [sa[j][1] for j in range(max(0, div - 3), div)]
    report = {
        "decision_index": div,
        "common_decisions": div,
        "a": side(sa, div),
        "b": side(sb, div),
        "context": ctx,
    }
    types = {report["a"]["type"], report["b"]["type"]}
    if types & {"reclaim_plan", "reclaim_step", "claim"}:
        report["plan_a"] = last_plan(sa, div)
        report["plan_b"] = last_plan(sb, div)
    return report
