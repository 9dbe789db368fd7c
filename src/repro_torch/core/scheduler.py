"""Job schedulers for the ST CMS.

``first_fit`` is the paper's policy (§III-D). ``fcfs`` and ``easy_backfill``
are beyond-paper options for the scheduler ablation (EXPERIMENTS.md).

The port's own copy of ``repro.core.scheduler`` with the same logic.
"""
from __future__ import annotations

from typing import Callable, List, Optional

from repro_torch.core.types import Job, JobState


def first_fit(queue: List[Job], free_nodes: int, now: float) -> List[Job]:
    """Scan the queue in submit order; start every job that fits."""
    started = []
    for job in queue:
        if job.state is not JobState.QUEUED:
            continue
        if job.size <= free_nodes:
            free_nodes -= job.size
            started.append(job)
        if free_nodes <= 0:
            break
    return started


def fcfs(queue: List[Job], free_nodes: int, now: float) -> List[Job]:
    """Strict FCFS: head of queue blocks everything behind it."""
    started = []
    for job in queue:
        if job.state is not JobState.QUEUED:
            continue
        if job.size <= free_nodes:
            free_nodes -= job.size
            started.append(job)
        else:
            break
    return started


def easy_backfill(queue: List[Job], free_nodes: int, now: float,
                  running_release: Optional[List] = None) -> List[Job]:
    """EASY backfill: FCFS head gets a reservation; later jobs may jump the
    queue iff they do not delay the head's reservation.

    ``running_release``: sorted [(finish_time, size), ...] of running jobs.
    """
    started = []
    pending = [j for j in queue if j.state is JobState.QUEUED]
    if not pending:
        return started
    head = pending[0]
    if head.size <= free_nodes:
        # head fits: behave like first-fit from the head onwards
        return first_fit(queue, free_nodes, now)
    # compute the shadow time: when enough nodes free up for the head
    avail = free_nodes
    shadow_time = float("inf")
    extra_at_shadow = 0
    for ft, sz in (running_release or []):
        avail += sz
        if avail >= head.size:
            shadow_time = ft
            extra_at_shadow = avail - head.size
            break
    for job in pending[1:]:
        if job.size > free_nodes:
            continue
        # backfill if it finishes before the shadow time, or fits in the
        # spare capacity at the shadow time
        if now + job.remaining() <= shadow_time or job.size <= extra_at_shadow:
            if job.size <= extra_at_shadow:
                extra_at_shadow -= job.size
            free_nodes -= job.size
            started.append(job)
            if free_nodes <= 0:
                break
    return started


SCHEDULERS: dict = {
    "first_fit": first_fit,
    "fcfs": fcfs,
    "easy_backfill": easy_backfill,
}
