"""Simulation output sinks (the reference's parquet sink,
internal/scheduler/simulator/sink/sink.go:12-31).

JSONL is the native format (one row per scheduling cycle + a summary footer);
parquet is written too when pyarrow/pandas are importable (not baked into every
image, so gated).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional

from armada_tpu_torch.simulator.simulator import CycleStats, SimulationResult


class JsonlSink:
    """Streams one JSON row per scheduling cycle; `close` writes the summary."""

    def __init__(self, path: str):
        self._f = open(path, "w")

    def __call__(self, stats: CycleStats) -> None:
        self._f.write(json.dumps(dataclasses.asdict(stats)) + "\n")

    def close(self, result: Optional[SimulationResult] = None) -> None:
        if result is not None:
            summary = dataclasses.asdict(result)
            summary.pop("cycles", None)
            summary.pop("events", None)
            summary.pop("success_time_by_job", None)
            self._f.write(json.dumps({"summary": summary}) + "\n")
        self._f.close()


def write_parquet(result: SimulationResult, path: str) -> bool:
    """Cycle stats -> parquet, if pandas+pyarrow exist.  Returns written?"""
    try:
        import pandas as pd
    except ImportError:
        return False
    rows = [dataclasses.asdict(c) for c in result.cycles]
    for r in rows:
        r["share_by_queue"] = json.dumps(r["share_by_queue"])
    try:
        pd.DataFrame(rows).to_parquet(path)
    except (ImportError, ValueError, OSError):
        return False
    return True
