"""Mesh serving plane: process-global mesh state and the shard ladder.

The port's copy of the JAX package's parallel/serving.py.  `MeshServing`
answers "over how many shards do rounds run right now"::

    full mesh (ARMADA_MESH / configure(n))
      -> smaller mesh      (degrade: halve, one slab re-upload)
      -> single device     (ladder exhausted: the plain single-card path)

A degrade or a restore fires the module-level reset hooks
(core/watchdog.fire_reset_hooks): every feed replaces its device caches,
so the next cycle's apply is one full upload onto the current mesh.
Divisibility is a build-time property: the incremental builders round
their node bucket up to `mesh_axis_multiple()`, and `shard_problem` pads.

Two differences from the JAX package:

* The clamp.  `_mesh_for` halves the shard count on a card down to the
  largest cluster of K-K's loop the card can launch
  (cudaOccupancyMaxActiveClusters > 0); the JAX package clamps to the chips
  it sees.  On the CPU there is no clamp.
* No restore probe thread: it waits for ROADMAP item 8's re-probe (the JAX
  behaviour at ARMADA_REPROBE_INTERVAL_S=0); `restore()` is called by its
  caller.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Optional

import torch

_log = logging.getLogger(__name__)


def _cluster_limit(n: int, device: torch.device, capacity=None) -> int:
    """The largest shard count <= n, halving, whose K-K cluster the card
    can launch (1 when none can), as kernels/round.py's owner of the
    cluster size decides it; n itself off the card."""
    if device.type != "cuda":
        return n
    from armada_tpu_torch.kernels.round import choose_cluster_size

    sizes = []
    while n >= 2:
        sizes.append(n)
        n = n // 2 if n % 2 == 0 else 1
    return choose_cluster_size(None, 1, device=device, capacity=capacity, sizes=sizes)


class MeshServing:
    """Process-wide mesh serving state (see module docstring)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._requested = 0  # configure(n) / ARMADA_MESH (0 = off)
        self._active = 0  # current ladder rung (shards rounds target)
        self._meshes: dict = {}  # (shards, device) -> constructed Mesh
        self._device = torch.device("cuda")  # the last device a mesh was asked for
        self.degrades = 0
        self.restores = 0
        self.last_degrade_reason: Optional[str] = None
        self.last_degrade_ts: Optional[float] = None

    # --- config ---------------------------------------------------------------

    def configure(self, n_devices: int) -> None:
        """Arm (n >= 2) or disarm (0/1) mesh serving.  Called before the
        feed builds its device caches; idempotent."""
        n = max(0, int(n_devices))
        with self._lock:
            self._requested = n
            self._active = n
            self._meshes = {}

    def enabled(self) -> bool:
        """Mesh serving is armed (whatever the current rung)."""
        return self._requested >= 2

    def device_count(self) -> int:
        """Shards the current rung targets (0 when off or exhausted)."""
        with self._lock:
            return self._active if self._requested >= 2 and self._active >= 2 else 0

    def axis_multiple(self) -> int:
        """The node-axis alignment every problem and slab must honour: the
        configured mesh size (every smaller rung is reached by halving, so
        it divides every rung)."""
        return self._requested if self._requested >= 2 else 1

    # --- meshes ---------------------------------------------------------------

    def serving_mesh(self, device="cuda"):
        """The Mesh rounds on `device` run over right now, or None (mesh off,
        ladder exhausted, or no cluster of two the card can launch)."""
        device = torch.device(device)
        with self._lock:
            n = self._active if self._requested >= 2 else 0
            self._device = device
        return self._mesh_for(n, device)

    def _mesh_for(self, n: int, device=None):
        """Construct (or return the cached) Mesh for a given rung; callers
        that just set a rung pass it, so a concurrent restore() cannot hand
        them another."""
        device = self._device if device is None else torch.device(device)
        if n < 2:
            return None
        mesh = self._meshes.get((n, device))
        if mesh is not None:
            return mesh
        from armada_tpu_torch.parallel.mesh import make_mesh

        clamped = _cluster_limit(n, device)
        if clamped != n:
            _log.warning("mesh serving requested %d shards, the card launches clusters of %d: "
                         "serving on %d", n, clamped, clamped)
            with self._lock:
                if self._active > clamped:
                    self._active = clamped
            if clamped < 2:
                return None
            n = clamped
            mesh = self._meshes.get((n, device))
            if mesh is not None:
                return mesh
        mesh = make_mesh(device, node_shards=n, job_shards=1)
        with self._lock:
            self._meshes[(n, device)] = mesh
        return mesh

    # --- transitions ----------------------------------------------------------

    def degrade(self, reason: str):
        """One rung down the ladder: halve the mesh and fire the reset hooks.
        Returns the new (smaller) Mesh, or None when the ladder is
        exhausted (the single-card path next)."""
        with self._lock:
            if self._requested < 2 or self._active < 2:
                return None
            self._active = self._active // 2 if self._active % 2 == 0 else 1
            self.degrades += 1
            self.last_degrade_reason = str(reason)[:300]
            self.last_degrade_ts = time.time()
            new_n = self._active
        _log.error("mesh round failed (%s): degrading to %d shards (one full slab re-upload)",
                   reason, new_n)
        from armada_tpu_torch.core.watchdog import fire_reset_hooks

        fire_reset_hooks()
        return self._mesh_for(new_n)

    def restore(self) -> bool:
        """Back to the full configured mesh; device caches re-shard on
        their next apply via the reset hooks.  Returns False (staying on the
        smaller rung) while the promotion gate vetoes."""
        from armada_tpu_torch.core.watchdog import promotion_blocked

        blocked = promotion_blocked()
        if blocked:
            _log.warning("mesh restore is blocked: %s", blocked)
            return False
        with self._lock:
            if self._requested < 2 or self._active >= self._requested:
                return True
            self._active = self._requested
            self.restores += 1
        _log.warning("restoring the full %d-shard mesh (next cycle pays one full slab "
                     "re-upload)", self._requested)
        from armada_tpu_torch.core.watchdog import fire_reset_hooks

        fire_reset_hooks()
        return True

    # --- export ---------------------------------------------------------------

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "requested": self._requested,
                # 0 = mesh off or ladder exhausted (single-device rounds)
                "devices": self._active if self._requested >= 2 and self._active >= 2 else 0,
                "degrades": self.degrades,
                "restores": self.restores,
                "last_degrade_reason": self.last_degrade_reason,
                "last_degrade_ts": self.last_degrade_ts,
            }


_MESH_SERVING = MeshServing()


def mesh_serving() -> MeshServing:
    return _MESH_SERVING


def reset_mesh_serving() -> MeshServing:
    """Fresh state (tests)."""
    global _MESH_SERVING
    _MESH_SERVING = MeshServing()
    return _MESH_SERVING


def mesh_axis_multiple() -> int:
    """Alignment the problem builders apply to the node axis (1 = off)."""
    return _MESH_SERVING.axis_multiple()


def dryrun_round(n_devices: int, device="cuda") -> int:
    """One sharded round on tiny shapes over an n-shard (nodes x jobs) mesh
    on `device`.  Returns the scheduled-member count (> 0 asserted)."""
    from armada_tpu_torch.models.synthetic import synthetic_problem
    from armada_tpu_torch.parallel.mesh import make_mesh, sharded_schedule_round

    job_shards = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    node_shards = n_devices // job_shards
    mesh = make_mesh(device, node_shards=node_shards, job_shards=job_shards)
    pad = 2 * node_shards * job_shards
    problem, meta = synthetic_problem(
        num_nodes=max(16, pad),
        num_gangs=max(64, 4 * pad),
        num_queues=4,
        num_runs=max(8, pad),
        max_gang_cardinality=2,
        global_burst=16,
        perq_burst=8,
        node_pad_to=pad,
        gang_pad_to=pad,
    )
    result = sharded_schedule_round(
        problem, mesh, num_levels=meta["num_levels"], max_slots=meta["max_slots"],
        slot_width=meta["slot_width"],
    )
    scheduled = int(result.scheduled_count)
    assert scheduled > 0, "dry run scheduled nothing"
    return scheduled
