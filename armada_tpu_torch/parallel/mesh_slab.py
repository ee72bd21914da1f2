"""Node-axis-sharded slab cache: the steady cycle's O(delta) path on a mesh.

The port's copy of the JAX package's parallel/mesh_slab.py.  There, a
`DeviceDeltaCache` subclass keeps every slab array under its mesh
NamedSharding and scatters each cycle's delta with a program whose
`out_shardings` are pinned to that layout (`_sharded_apply_for`, K-L), so
GSPMD never gathers the 1M-row slab onto one chip.  Here the mesh lies on
one card, where the shard-contiguous layout of every field is its plain
layout: the full upload is the single-card upload, and the scatter is
K-H's kernel (kernels/slab.py apply_delta with the mesh, counted as
"slab_sharded").  On the serving mesh the job axis is not split, so every
row the scatter writes is replicated and the node-axis fields arrive whole
in the bundle's `fulls`.  What the subclass keeps of the JAX design:

* the mesh is resolved lazily, at the first apply, and the resolution is
  sticky in either direction for the whole apply (`_sync_mesh`), so a
  ladder transition landing mid-upload cannot mix placements; a ladder
  move keeps the resident problem where the new mesh divides it, since
  the layout is the same on one card (the JAX cache re-uploads);
* one apply per mesh, shared by every pool's cache (`_sharded_apply_for`);
* the per-shard bytes of node-axis fields in TRANSFER_STATS (a layout
  figure: on one card no shard receives its bytes apart);
* `_full_upload` asserts divisibility: the builders align their node
  bucket to `mesh_axis_multiple()`, so a misaligned problem is a build bug.

There is no device supervisor yet (ROADMAP item 8): "degraded" reads false,
so the cache follows the serving ladder alone.
"""

from __future__ import annotations

import functools

import numpy as np

from armada_tpu_torch.models.slab import DeviceDeltaCache
from armada_tpu_torch.models.xfer import TRANSFER_STATS

# One apply PER MESH, shared by every cache on it: the feed builds one
# cache per pool and replaces all of them on every reset hook.
_SHARDED_APPLY: dict = {}


def _sharded_apply_for(mesh):
    """The slab apply pinned to `mesh`'s layout: K-H's wrapper with the mesh."""
    fn = _SHARDED_APPLY.get(mesh)
    if fn is None:
        from armada_tpu_torch.kernels.slab import apply_delta

        fn = _SHARDED_APPLY[mesh] = functools.partial(apply_delta, mesh=mesh)
    return fn


class MeshDeviceDeltaCache(DeviceDeltaCache):
    """DeviceDeltaCache whose resident problem is node-axis-sharded."""

    def __init__(self, serving=None, device="cuda"):
        super().__init__(device=device)
        if serving is None:
            from armada_tpu_torch.parallel.serving import mesh_serving

            serving = mesh_serving()
        self._serving = serving
        self._mesh = None
        self._field_shards = None  # field name -> shard count (for stats)
        self._sharded_apply = None
        # True while a _sync_mesh entry resolved "no mesh": pins the
        # decision for the whole apply()/scatter_content() call.
        self._none_sticky = False

    def _ensure_mesh(self):
        """The mesh this cache places on, or None (plain base behaviour:
        serving disarmed or exhausted).  Sticky once resolved, in either
        direction, until the next `_sync_mesh`."""
        if self._mesh is not None:
            return self._mesh
        if self._none_sticky:
            return None
        mesh = self._serving.serving_mesh(self.device)
        if mesh is None:
            return None
        from armada_tpu_torch.parallel.mesh import problem_shardings, spec_shards

        sh = problem_shardings(mesh)
        self._mesh = mesh
        self._field_shards = {name: spec_shards(mesh, spec) for name, spec in zip(sh._fields, sh)}
        self._sharded_apply = _sharded_apply_for(mesh)
        return self._mesh

    def _sync_mesh(self) -> None:
        """Entry guard of apply()/scatter_content(): if the serving ladder
        moved since this cache resolved its mesh, re-resolve; the resolution
        is pinned for the rest of the call.  On one card every mesh's layout
        is the plain layout, so the resident problem stays where the new
        mesh divides it (always for no mesh); else it is dropped and the
        next apply is a full upload onto the new mesh."""
        if self._mesh is not None:
            new = self._serving.serving_mesh(self.device)
            if new != self._mesh:
                if not self._resident_fits(new):
                    self.reset()
                self._mesh = None
                self._field_shards = None
                self._sharded_apply = None
        self._none_sticky = False
        self._none_sticky = self._ensure_mesh() is None

    def _resident_fits(self, mesh) -> bool:
        if self._prev is None or mesh is None:
            return True
        from armada_tpu_torch.parallel.mesh import _check_divisible

        try:
            _check_divisible(self._prev, mesh)
        except ValueError:
            return False
        return True

    def apply(self, bundle):
        self._sync_mesh()
        return super().apply(bundle)

    def scatter_content(self, **kwargs) -> bool:
        self._sync_mesh()
        return super().scatter_content(**kwargs)

    @property
    def mesh(self):
        """The mesh the resident problem is sharded over (None: single-card)."""
        return self._mesh

    @property
    def mesh_devices(self) -> int:
        """Shards the resident slab is split over (0 = single-device)."""
        return 0 if self._mesh is None else int(self._mesh.devices.size)

    # --- base hooks ------------------------------------------------------------

    def _apply_fn(self):
        if self._apply is not None or self._ensure_mesh() is None:
            return super()._apply_fn()
        return self._sharded_apply

    def _count_up(self, arr, name=None) -> None:
        shards = 1
        if self._mesh is not None and name is not None and self._field_shards:
            shards = self._field_shards.get(name, 1)
        TRANSFER_STATS.count_up(np.asarray(arr).nbytes, shards=shards)

    def _full_upload(self, problem):
        mesh = self._ensure_mesh()
        if mesh is not None:
            from armada_tpu_torch.parallel.mesh import _check_divisible

            _check_divisible(problem, mesh)
        return super()._full_upload(problem)
