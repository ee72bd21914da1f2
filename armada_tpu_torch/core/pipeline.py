"""The steady-cycle pipeline switches (the port's copy of the JAX package's
core/pipeline.py).

The shadow-pipelined cycle hides decision-independent host work behind the
device round: while the kernels and the result fetch are in flight, the
scheduling cycle runs the next cycle's decision-independent feed --
submit-side table inserts and the slab upload of new-submit rows
(IncrementalBuilder.prefetch_content).  Decisions are identical either way:
the pipeline only reorders work that neither reads the round's output nor
feeds its problem.

``ARMADA_PIPELINE=0`` is the escape hatch (A/B measurement, bisection):
every pipelined call site degrades to the sequential order.  The variables
are read per call, so a test can flip them with monkeypatch.
"""

from __future__ import annotations

import os


def pipeline_enabled() -> bool:
    """True unless ARMADA_PIPELINE=0: shadow-pipeline the steady cycle."""
    return os.environ.get("ARMADA_PIPELINE", "1") != "0"


def pool_parallel_enabled() -> bool:
    """Pool-parallel serving armed?  ``ARMADA_POOL_PARALLEL=1`` restructures
    the multi-pool cycle into dispatch and fetch phases (pool B's apply and
    round dispatch fire before pool A's fetch) and stacks shape-matched
    pools into one round launch.  Default off: the serial per-pool loop.
    Decisions are identical either way, but only because
    scheduler/algo.py certifies each cycle's pools independent first and
    falls back to the serial order when it cannot (shared queued
    candidates, binding rate limiters, market pools)."""
    return os.environ.get("ARMADA_POOL_PARALLEL", "0") not in ("0", "")


def prefetch_worthwhile(device) -> bool:
    """Whether the slab content prefetch pays for itself on `device`.

    The prefetch trades an extra scatter pass for moving its upload off the
    round's critical path.  On a card the scatter is device-side
    microseconds and the upload overlaps host work; on the CPU the "device"
    is the host, and the extra pass is pure host cost.  Default: CUDA
    devices only.  ARMADA_PIPELINE_PREFETCH=1/0 overrides (tests pin the
    scatter path on the CPU with 1)."""
    env = os.environ.get("ARMADA_PIPELINE_PREFETCH")
    if env is not None:
        return env != "0"
    import torch

    return torch.device(device).type != "cpu"
