"""Sharded, resumable campaign walkthrough (API form of the CLI flow).

Runs the tiny grid as two shards spooling into JSONL files, kills-and-
resumes one shard to show crash durability, merges the spools, and checks
the merged reductions against a single-shot run — then prints the
throughput section the campaign artifact now carries.

    PYTHONPATH=src python -m repro_torch.examples.sharded_campaign [--grid tiny]
    PYTHONPATH=src python -m repro_torch.examples.sharded_campaign --device cpu

The port's own copy of ``examples/sharded_campaign.py``. Every
``run_campaign`` call flushes its WS queues on ``--device``: the card by
default (the ``queue_core`` kernel; it raises without one), or the kernel's
plain PyTorch version with ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile

from repro_torch.workloads.campaign import (make_grid, merge_spools,
                                            run_campaign, shard_cells,
                                            spool_load)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--grid", default="tiny",
                    choices=["tiny", "small", "mix_tiny"])
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where every campaign flushes its WS queues")
    args = ap.parse_args(argv)

    cells = make_grid(args.grid)
    print(f"grid={args.grid}: {len(cells)} cells, "
          f"{len(shard_cells(cells, '0/2'))}+{len(shard_cells(cells, '1/2'))}"
          f" across 2 shards")

    with tempfile.TemporaryDirectory() as td:
        spools = [os.path.join(td, f"shard{i}.jsonl") for i in range(2)]

        # shard 0 runs to completion
        run_campaign(cells, workers=args.workers, grid_name=args.grid,
                     spool_path=spools[0], shard="0/2", device=args.device)

        # shard 1 is "interrupted" after half its cells...
        half = shard_cells(cells, "1/2")
        run_campaign(half[: len(half) // 2], workers=args.workers,
                     grid_name=args.grid, spool_path=spools[1],
                     device=args.device)
        print(f"shard 1 interrupted with "
              f"{len(spool_load(spools[1]))}/{len(half)} cells spooled")

        # ...and resumed: only the missing cells re-execute
        art1 = run_campaign(cells, workers=args.workers,
                            grid_name=args.grid, spool_path=spools[1],
                            resume=True, shard="1/2", device=args.device)
        tp = art1["throughput"]
        print(f"resume executed={tp['executed']} skipped={tp['skipped']}")

        merged, missing = merge_spools(spools, grid_cells=cells,
                                       grid_name=args.grid)
        assert not missing, missing

        single = run_campaign(cells, workers=args.workers,
                              grid_name=args.grid, device=args.device)
        assert merged["reductions"] == single["reductions"], \
            "merge must reproduce the single-shot reductions exactly"
        print("merged reductions == single-shot reductions")
        print("throughput:",
              json.dumps(single["throughput"], indent=1, default=float))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
