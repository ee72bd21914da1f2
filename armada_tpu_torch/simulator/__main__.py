"""Simulator CLI: `python -m armada_tpu_torch.simulator --clusters c.yaml --workloads w.yaml`.

Equivalent of the reference's `cmd/simulator` (cmd/simulator/cmd/root.go:18-35):
runs every (cluster, workload) pair, prints a summary per pair, optionally
writes per-cycle JSONL/parquet.  The rounds run on the card (--device cuda,
the default) or, with --device cpu, through the plain versions.
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="armada-tpu-torch-simulator")
    ap.add_argument("--clusters", nargs="+", required=True, help="cluster spec YAMLs")
    ap.add_argument("--workloads", nargs="+", required=True, help="workload spec YAMLs")
    ap.add_argument("--config", help="scheduling config YAML (reference schema)")
    ap.add_argument("--schedule-interval", type=float, default=10.0)
    ap.add_argument("--output", help="per-cycle JSONL output path")
    ap.add_argument("--parquet", help="per-cycle parquet output path")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the rounds run (default: the card)")
    args = ap.parse_args(argv)

    from armada_tpu_torch.core.config import (
        default_scheduling_config,
        scheduling_config_from_yaml,
    )
    from armada_tpu_torch.simulator import (
        JsonlSink,
        Simulator,
        cluster_spec_from_yaml,
        workload_spec_from_yaml,
        write_parquet,
    )

    config = (
        scheduling_config_from_yaml(args.config)
        if args.config
        else default_scheduling_config()
    )

    def pair_path(base: str, tag: str) -> str:
        if len(args.clusters) == 1 and len(args.workloads) == 1:
            return base
        root, ext = os.path.splitext(base)
        return f"{root}-{tag}{ext}"

    clusters = {c: cluster_spec_from_yaml(c) for c in args.clusters}
    workloads = {w: workload_spec_from_yaml(w) for w in args.workloads}
    for cpath in args.clusters:
        for wpath in args.workloads:
            cluster = clusters[cpath]
            workload = workloads[wpath]
            tag = (
                f"{os.path.splitext(os.path.basename(cpath))[0]}"
                f"-{os.path.splitext(os.path.basename(wpath))[0]}"
            )
            sink = JsonlSink(pair_path(args.output, tag)) if args.output else None
            t0 = time.perf_counter()
            sim = Simulator(
                cluster,
                workload,
                config,
                schedule_interval_s=args.schedule_interval,
                sink=sink,
                device=args.device,
            )
            result = sim.run()
            wall = time.perf_counter() - t0
            if sink:
                sink.close(result)
            if args.parquet:
                write_parquet(result, pair_path(args.parquet, tag))
            print(
                f"{cluster.name!r} x {workload.name!r}: "
                f"makespan={result.makespan:.0f}s scheduled={result.total_scheduled} "
                f"succeeded={result.total_succeeded} preempted={result.total_preempted} "
                f"failed={result.total_failed} never_scheduled={len(result.never_scheduled)} "
                f"cycles={len(result.cycles)} wall={wall:.2f}s"
            )
    return 0


if __name__ == "__main__":
    sys.exit(main())
