"""ST CMS — cloud management service for scientific computing (paper §II).

ST Server resource-management policy (verbatim):
  * passively receives resources provisioned by the Resource Provision Service;
  * on forced return, releases immediately with the demanded size;
  * if idle nodes are insufficient, kills jobs in turn starting from the job
    with MINIMUM SIZE and SHORTEST RUNNING TIME, until enough nodes are free.

``preempt_mode="checkpoint"`` (beyond-paper) checkpoints instead of killing:
the job is requeued with its completed work preserved (plus a checkpoint
overhead), which materially improves the ST benefit curve (EXPERIMENTS.md).

The grant / force-release / node-lost protocol itself lives in
``core/cms.py`` (shared with every other tenant kind); this class supplies
the batch-specific parts: the job queue, the paper's kill order, and the
scheduler hookup.

The port's own copy of ``repro.core.st_cms`` with the same logic.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

from repro_torch.core.cms import CMSBase
from repro_torch.core.scheduler import SCHEDULERS
from repro_torch.core.types import Job, JobState, SimConfig, TenantSignals


class STServer(CMSBase):
    kind = "batch"

    def __init__(self, cfg: SimConfig,
                 schedule_finish: Callable[[Job, float], None],
                 cancel_finish: Callable[[Job], None]):
        super().__init__()
        self.cfg = cfg
        self.queue: List[Job] = []
        self.running: Dict[int, Job] = {}
        self._schedule_finish = schedule_finish
        self._cancel_finish = cancel_finish
        self.scheduler = SCHEDULERS[cfg.scheduler]
        self.killed: List[Job] = []
        self.preemptions = 0
        self._finish_at: Dict[int, float] = {}

    # ------------------------------------------------------------ capacity
    @property
    def used(self) -> int:
        return sum(j.size for j in self.running.values())

    @property
    def idle(self) -> int:
        return self.alloc - self.used

    def demand_nodes(self) -> int:
        """Declared demand: nodes busy now plus everything queued could use
        (drives demand-aware cooperative policies; the paper's policy
        ignores it)."""
        return self.used + sum(j.size for j in self.queue)

    def preemption_cost_s(self, now: float) -> float:
        """Estimated seconds of work lost per node if one node is reclaimed
        right now: 0 while idle nodes can absorb it; otherwise the paper's
        kill order picks the cheapest running job, whose per-node cost is
        its elapsed work (kill mode) or the checkpoint overhead (checkpoint
        mode). Feeds the ``slo_headroom`` planner's cheapest-first band."""
        if self.idle > 0 or not self.running:
            return 0.0
        v = min(self.running.values(), key=self._kill_key(now))
        if self.cfg.preempt_mode == "checkpoint":
            return self.cfg.checkpoint_cost / max(v.size, 1)
        return max(0.0, now - v.start_time)

    def signals(self, now: float, name: str = "",
                weight: float = 1.0) -> TenantSignals:
        return TenantSignals(
            name=name, kind=self.kind, alloc=self.alloc,
            demand=self.demand_nodes(), weight=weight,
            queue_depth=len(self.queue),
            preemption_cost_s=self.preemption_cost_s(now))

    # ------------------------------------------------------------ events
    def submit(self, job: Job, now: float):
        self.queue.append(job)
        self.try_schedule(now)

    def job_finished(self, job: Job, now: float):
        if job.job_id in self.running:
            del self.running[job.job_id]
            self._finish_at.pop(job.job_id, None)
            job.state = JobState.COMPLETED
            job.end_time = now
            if job in self.queue:
                self.queue.remove(job)
            self.try_schedule(now)

    # ------------------------------------------------------------ scheduling
    def _running_release(self, now: float):
        return sorted((self._finish_at[j.job_id], j.size)
                      for j in self.running.values())

    def try_schedule(self, now: float):
        free = self.idle
        if free <= 0 or not self.queue:
            return
        kw = {}
        if self.cfg.scheduler == "easy_backfill":
            kw["running_release"] = self._running_release(now)
        started = self.scheduler(self.queue, free, now, **kw)
        for job in started:
            self.queue.remove(job)
            job.state = JobState.RUNNING
            job.start_time = now
            self.running[job.job_id] = job
            finish = now + job.remaining()
            self._finish_at[job.job_id] = finish
            self._schedule_finish(job, finish)

    # ------------------------------------------------------------ reclaim
    @staticmethod
    def _kill_key(now: float):
        """The paper's kill order: (size asc, running-time asc). Shared by
        the eviction path and the preemption-cost signal so the cost
        estimate can never drift from the actual eviction order."""
        return lambda j: (j.size, now - j.start_time)

    def _make_available(self, n: int, now: float):
        """Free n nodes: idle first, then kill/preempt jobs in the paper's
        kill order. Eviction may free more than needed; the surplus stays
        idle in ST."""
        still_needed = n - self.idle
        if still_needed > 0:
            victims = sorted(self.running.values(), key=self._kill_key(now))
            got = 0
            for v in victims:
                if got >= still_needed:
                    break
                got += v.size
                self._evict(v, now)

    def _after_change(self, now: float):
        self.try_schedule(now)

    def release_idle(self, n: int) -> int:
        """Voluntarily give back up to n idle nodes (demand-aware policies);
        returns the count actually freed. Never touches running jobs."""
        n = max(0, min(n, self.idle))
        self.alloc -= n
        return n

    def _evict(self, job: Job, now: float):
        self._cancel_finish(job)
        del self.running[job.job_id]
        self._finish_at.pop(job.job_id, None)
        job.kills += 1
        if self.cfg.preempt_mode == "checkpoint":
            elapsed = now - job.start_time
            job.checkpointed_work = min(
                job.runtime,
                job.checkpointed_work + max(0.0, elapsed
                                            - self.cfg.checkpoint_cost))
            job.state = JobState.QUEUED
            job.start_time = None
            self.preemptions += 1
            self.queue.insert(0, job)       # resume first (it lost its slot)
        else:
            job.state = JobState.KILLED
            job.end_time = now
            self.killed.append(job)
