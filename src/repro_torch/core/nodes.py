"""Node-lifecycle layer: identified nodes, per-node state machines, and
failure domains.

The provision service (core/provision.py) is a pure state machine over
node *counts* — perfect for the paper's fungible-node model, but blind to
which physical node moved where, and unable to express correlated
failures ("this rack lost power") or drain windows ("this node serves
neither tenant for 30 s while it is repurposed"). This module adds the
missing identity without changing the count layer's semantics:

  * :class:`NodeInventory` — an explicit inventory of ``total`` identified
    nodes, each a :class:`Node` with a per-node state machine::

        healthy ──► draining ──► healthy        (reclaim drain window)
        healthy / flapping / draining ──► failed ──► repairing
        repairing ──► healthy   (or ──► flapping for designated flappers)

    Illegal transitions raise — the table below is the contract.
  * **failure domains**: node ``i`` lives in rack ``i // rack_size``;
    correlated injectors (core/faults.py) blast whole domains.
  * **ownership pools** mirroring the service's counts: ``"free"``, one
    pool per tenant, plus the :data:`DRAIN_POOL` holding mid-drain nodes.
    The service syncs every count move into the inventory (when one is
    attached), always choosing the **lowest-id** nodes of a pool — node
    identity is fully deterministic and consumes no RNG, so attaching an
    inventory can never perturb a seeded run.
  * **telemetry**: every state transition emits a ``node_state`` event
    (``{node, from, to, parent}``), parented to the causal context that
    forced it (the failure's span, the reclaim step's span, ...), so the
    full lifecycle of any node is one linked chain in the trace.

The count layer stays authoritative for *how many*; the inventory answers
*which*, *where* (domain) and *in what state*.

The port's own copy of ``repro.core.nodes`` with the same logic.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set

from repro_torch.core.telemetry import NULL_TRACER, Tracer

#: reserved pool name for nodes inside a reclaim drain window (serving
#: neither the victim nor the claimant); never a registrable tenant name
DRAIN_POOL = "__drain__"


class NodeState(enum.Enum):
    HEALTHY = "healthy"
    DRAINING = "draining"
    FAILED = "failed"
    REPAIRING = "repairing"
    FLAPPING = "flapping"      # up, but designated unreliable (fails often)


# the lifecycle contract: (from, to) pairs the inventory will perform.
# Anything else raises — a state-machine bug must never be silently
# absorbed into the count layer.
LEGAL_TRANSITIONS = frozenset({
    (NodeState.HEALTHY, NodeState.FLAPPING),     # flapper designation
    (NodeState.HEALTHY, NodeState.DRAINING),     # reclaim drain start
    (NodeState.FLAPPING, NodeState.DRAINING),
    (NodeState.DRAINING, NodeState.HEALTHY),     # drain complete
    (NodeState.DRAINING, NodeState.FLAPPING),
    (NodeState.HEALTHY, NodeState.FAILED),       # failure
    (NodeState.FLAPPING, NodeState.FAILED),
    (NodeState.DRAINING, NodeState.FAILED),      # fault mid-drain
    (NodeState.FAILED, NodeState.REPAIRING),     # repair crew dispatched
    (NodeState.REPAIRING, NodeState.HEALTHY),    # repair complete
    (NodeState.REPAIRING, NodeState.FLAPPING),   # flappers stay flappers
})

#: states in which a node occupies real hardware and can therefore fail
#: (draining nodes still sit in a rack; failed/repairing ones are already
#: down). Injectors select victims from this set only.
UP_STATES = (NodeState.HEALTHY, NodeState.FLAPPING, NodeState.DRAINING)


@dataclass
class Node:
    """One identified node: id, failure domain, lifecycle state, owner."""
    id: int
    domain: int
    state: NodeState = NodeState.HEALTHY
    owner: str = "free"
    flapper: bool = False
    # span of the node_fail event that took this node down; the matching
    # node_repair parents it (0 = untraced)
    fail_span: int = 0


class NodeInventory:
    """Identified-node mirror of a provision service's count pools.

    Deterministic by construction: pool picks are lowest-id, iteration is
    sorted, and no method draws randomness — the fault injectors own all
    RNG. Attach to a service with ``svc.attach_inventory(inv)`` *before*
    any provisioning so pools and counts start in lockstep.
    """

    def __init__(self, total: int, *, rack_size: int = 16,
                 tracer: Optional[Tracer] = None):
        assert total >= 0 and rack_size >= 1, (total, rack_size)
        self.total = total
        self.rack_size = rack_size
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.nodes: List[Node] = [Node(id=i, domain=i // rack_size)
                                  for i in range(total)]
        # owner -> node-id set; "free" plus one pool per tenant plus
        # DRAIN_POOL; failed/repairing nodes live in the down pool
        self.pools: Dict[str, Set[int]] = {"free": set(range(total))}
        self._down: Set[int] = set()

    # ------------------------------------------------------------- queries
    def owner_of(self, node_id: int) -> str:
        return self.nodes[node_id].owner

    def state_of(self, node_id: int) -> NodeState:
        return self.nodes[node_id].state

    def pool(self, owner: str) -> List[int]:
        """Sorted node ids currently owned by ``owner``."""
        return sorted(self.pools.get(owner, ()))

    def up_ids(self) -> List[int]:
        """Sorted ids of all nodes occupying hardware (healthy, flapping
        or draining) — the set fault injectors pick victims from. Depends
        only on past fault/repair events, never on which tenant owns a
        node, so seeded fault sequences stay policy-independent."""
        return sorted(n.id for n in self.nodes if n.state in UP_STATES)

    def domain_up_ids(self, domain: int) -> List[int]:
        return [i for i in self.up_ids()
                if self.nodes[i].domain == domain]

    def domains(self) -> List[int]:
        return sorted({n.domain for n in self.nodes})

    def counts(self) -> Dict[str, int]:
        return {owner: len(ids) for owner, ids in sorted(self.pools.items())
                if ids}

    def state_counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for n in self.nodes:
            out[n.state.value] = out.get(n.state.value, 0) + 1
        return out

    # --------------------------------------------------------- transitions
    def _set_state(self, node: Node, to: NodeState,
                   parent: Optional[int] = None) -> None:
        if node.state is to:
            return
        if (node.state, to) not in LEGAL_TRANSITIONS:
            raise ValueError(
                f"illegal node transition {node.state.value} -> {to.value} "
                f"(node {node.id})")
        tr = self.tracer
        if tr.enabled:
            tr.append({"type": "node_state", "node": node.id,
                       "from": node.state.value, "to": to.value,
                       "parent": parent})
        node.state = to

    def _move(self, node: Node, dst: str) -> None:
        self.pools[node.owner].discard(node.id)
        self.pools.setdefault(dst, set()).add(node.id)
        node.owner = dst

    def transfer(self, src: str, dst: str, k: int, *,
                 state: Optional[NodeState] = None,
                 parent: Optional[int] = None) -> List[int]:
        """Move the ``k`` lowest-id nodes from pool ``src`` to ``dst``,
        optionally transitioning their state (drain start/complete).
        Returns the moved ids."""
        if k <= 0:
            return []
        pool = self.pools.get(src, set())
        assert len(pool) >= k, \
            f"pool {src!r} has {len(pool)} nodes, need {k}"
        ids = sorted(pool)[:k]
        for nid in ids:
            node = self.nodes[nid]
            self._move(node, dst)
            if state is not None:
                self._set_state(node, state, parent=parent)
        return ids

    def move_nodes(self, ids: List[int], dst: str, *,
                   state: Optional[NodeState] = None,
                   parent: Optional[int] = None) -> None:
        """Move specific nodes (drain completions reference the exact ids
        that entered the drain window)."""
        for nid in ids:
            node = self.nodes[nid]
            self._move(node, dst)
            if state is not None:
                to = state
                if to is NodeState.HEALTHY and node.flapper:
                    to = NodeState.FLAPPING   # flappers never become healthy
                self._set_state(node, to, parent=parent)

    def pick(self, owner: str) -> int:
        """Lowest-id node of a pool (deterministic count->identity map for
        failures attributed by pool share)."""
        pool = self.pools.get(owner, set())
        assert pool, f"pool {owner!r} is empty"
        return min(pool)

    def designate_flappers(self, ids: List[int]) -> None:
        for nid in sorted(ids):
            node = self.nodes[nid]
            node.flapper = True
            self._set_state(node, NodeState.FLAPPING)

    def fail(self, node_id: int, *, span: int = 0,
             cause: Optional[str] = None) -> Node:
        """``<up state>`` -> FAILED -> REPAIRING: the node leaves its
        owner's pool; both transitions parent to the failure's span."""
        node = self.nodes[node_id]
        self._set_state(node, NodeState.FAILED, parent=span or None)
        self._set_state(node, NodeState.REPAIRING, parent=span or None)
        node.fail_span = span
        self.pools[node.owner].discard(node_id)
        self._down.add(node_id)
        node.owner = "__down__"
        return node

    def repair(self, node_id: Optional[int] = None) -> Node:
        """REPAIRING -> HEALTHY (FLAPPING for flappers); the node returns
        to the free pool. ``None`` repairs the lowest-id down node (the
        count-only legacy path does not thread node ids through repair
        events)."""
        if node_id is None:
            assert self._down, "repair with no node down"
            node_id = min(self._down)
        node = self.nodes[node_id]
        to = NodeState.FLAPPING if node.flapper else NodeState.HEALTHY
        self._set_state(node, to, parent=node.fail_span or None)
        self._down.discard(node_id)
        self.pools["free"].add(node_id)
        node.owner = "free"
        return node

    # --------------------------------------------------------------- audit
    def audit(self, svc) -> None:
        """Assert the inventory's pools mirror a provision service's counts
        exactly (free / per-tenant / draining / down). O(total); meant for
        tests and quiescent points, not the claim hot path."""
        assert len(self.pools.get("free", ())) == svc.free, \
            (sorted(self.pools.get("free", ())), svc.free)
        for t in svc.tenants.values():
            assert len(self.pools.get(t.name, ())) == t.alloc, \
                (t.name, sorted(self.pools.get(t.name, ())), t.alloc)
        assert len(self.pools.get(DRAIN_POOL, ())) == \
            getattr(svc, "draining", 0), \
            (sorted(self.pools.get(DRAIN_POOL, ())), svc.draining)
        assert len(self._down) == self.total - svc.total, \
            (sorted(self._down), self.total, svc.total)
