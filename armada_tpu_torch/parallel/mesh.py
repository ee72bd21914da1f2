"""The node-axis mesh of the scheduling round, on one card.

The port's copy of the JAX package's parallel/mesh.py.  There, a
`jax.sharding.Mesh` splits the node axis (a 50k-node pool) and, optionally,
the gang and run axes across chips, and GSPMD inserts a cross-shard
(value, index) reduction for every [N] argmin and sum of the round.  Here a
`Mesh` of node_shards x job_shards shards lies on one torch device:

- the node axis: kernel K-K (csrc/round_cluster.cu) runs the round's
  placement loop as one thread-block cluster of node_shards CTAs, each
  reducing its node passes over N / node_shards nodes, the partials
  combined through distributed shared memory -- the hardware counterpart on
  one H100 of shards that exchange a reduction every step;
- the job axis: job_shards only pads the gang and run axes; every CTA reads
  them in place in global memory;
- the queue and pool tensors are replicated, as in the JAX package.

On one card a shard-contiguous node layout is the plain layout, so
`shard_problem` pads and uploads, and the round learns of the mesh from the
`mesh=` argument its caller passes (models/__init__.py), never from tensor
shapes.  The results equal the single-device round's: sharding only
distributes the reductions.  A mesh over more than one card waits for a
machine that has several (ROADMAP Queue 2).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from armada_tpu_torch.models.problem import SchedulingProblem

AXIS_NODES = "nodes"
AXIS_JOBS = "jobs"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """node_shards x job_shards shards on one torch device.  Hashable: the
    mesh cache keys its apply by it.  `shape[AXIS_NODES]` and
    `devices.size` (the shard count) read as on a JAX mesh."""

    device: torch.device
    node_shards: int
    job_shards: int = 1

    @property
    def shape(self) -> dict:
        return {AXIS_NODES: self.node_shards, AXIS_JOBS: self.job_shards}

    @property
    def devices(self) -> np.ndarray:
        """The device of every shard, [node_shards, job_shards]."""
        out = np.empty((self.node_shards, self.job_shards), dtype=object)
        out.fill(self.device)
        return out


def make_mesh(device="cuda", *, node_shards: Optional[int] = None, job_shards: int = 1) -> Mesh:
    """A (nodes x jobs) mesh on one device.  `device` is a torch device (or
    its name), or a sequence of them that name one device once per shard;
    `node_shards` defaults to that sequence's length over job_shards (1 for
    a single device).  A mesh over more than one distinct card raises: it
    waits for a machine with several (ROADMAP Queue 2)."""
    if isinstance(device, (list, tuple, np.ndarray)):
        devs = [torch.device(d) for d in np.asarray(device, dtype=object).ravel()]
        if len(set(devs)) != 1:
            raise NotImplementedError(
                f"a mesh over {len(set(devs))} devices: the port runs the node-axis mesh on one "
                "card (ROADMAP Queue 2: the mesh across cards waits for a machine with several)")
        n = len(devs)
        dev = devs[0]
    else:
        dev = torch.device(device)
        n = None
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the card unless the caller passes "
                           "device='cpu'")
    if node_shards is None:
        node_shards = (n // job_shards) if n is not None else 1
    if n is not None and node_shards * job_shards != n:
        raise ValueError(f"mesh {node_shards}x{job_shards} != {n} devices")
    if node_shards < 1 or job_shards < 1:
        raise ValueError(f"mesh {node_shards}x{job_shards}: every axis needs a shard")
    return Mesh(dev, int(node_shards), int(job_shards))


def problem_shardings(mesh: Mesh) -> SchedulingProblem:
    """A SchedulingProblem of partition specs matching its field layout:
    each field's mesh axis per dimension (None: not split; (): replicated),
    field for field as the JAX package's."""
    nodes = (AXIS_NODES,)
    nodes_r = (AXIS_NODES, None)
    jobsax = (AXIS_JOBS,)
    jobs_r = (AXIS_JOBS, None)
    repl = ()
    return SchedulingProblem(
        node_total=nodes_r,
        node_type=nodes,
        node_ok=nodes,
        run_req=jobs_r,
        run_node=jobsax,
        run_level=jobsax,
        run_queue=jobsax,
        run_pc=jobsax,
        run_preemptible=jobsax,
        run_gang=jobsax,
        run_valid=jobsax,
        g_req=jobs_r,
        g_card=jobsax,
        g_level=jobsax,
        g_queue=jobsax,
        g_key=jobsax,
        g_pc=jobsax,
        g_order=jobsax,
        g_run=jobsax,
        g_valid=jobsax,
        g_absent=jobsax,
        g_price=jobsax,
        g_spot_price=jobsax,
        # read-only index data gathered with [Q, W] indices every iteration
        gq_gang=repl,
        q_start=repl,
        q_len=repl,
        q_weight=repl,
        q_cds=repl,
        q_penalty=repl,
        compat=repl,
        total_pool=repl,
        drf_mult=repl,
        inv_scale=repl,
        round_cap=repl,
        pc_queue_cap=repl,
        protected_fraction=repl,
        global_burst=repl,
        perq_burst=repl,
        node_axes=repl,
        float_total=repl,
        market=repl,
        spot_cutoff=repl,
        # ban rows follow the node axis; the row-index vector follows gangs
        ban_mask=(None, AXIS_NODES),
        g_ban_row=jobsax,
        type_bias=repl,
        key_type_row=repl,
        compat_pre_type=repl,
    )


def spec_shards(mesh: Mesh, spec: tuple) -> int:
    """How many shards a field of partition spec `spec` is split into."""
    n = 1
    for ax in spec:
        if ax is not None:
            n *= mesh.shape[ax]
    return n


def _check_divisible(problem: SchedulingProblem, mesh: Mesh) -> None:
    """Internal invariant check (post-pad): a trip here is a build bug --
    `shard_problem` pads and the serving builders align their node bucket
    to the mesh multiple (models/incremental._node_bucket)."""
    n_shards = mesh.shape[AXIS_NODES]
    j_shards = mesh.shape[AXIS_JOBS]
    N = problem.node_total.shape[0]
    G = problem.g_req.shape[0]
    RJ = problem.run_req.shape[0]
    for size, shards, name in ((N, n_shards, "nodes"), (G, j_shards, "gangs"),
                               (RJ, j_shards, "runs")):
        if size % shards:
            raise ValueError(
                f"{name} axis {size} not divisible by its {shards} mesh shards "
                f"after padding -- pad_problem missed an axis (build bug)"
            )


# Axis membership for pad_problem.  Everything not listed (queue tensors,
# scalars, compat, gq offsets) is replicated and never padded.
_NODE_AX0 = ("node_total", "node_type", "node_ok")
_RUN_AX0 = (
    "run_req", "run_node", "run_level", "run_queue", "run_pc",
    "run_preemptible", "run_gang", "run_valid",
)
_GANG_AX0 = (
    "g_req", "g_card", "g_level", "g_queue", "g_key", "g_pc", "g_order",
    "g_run", "g_valid", "g_absent", "g_price", "g_spot_price", "g_ban_row",
    "gq_gang",
)
# Pad lanes must be INERT: absent gangs (state 3, decode-invisible), invalid
# runs, unschedulable zero-capacity nodes -- the values the builders use for
# their own bucket padding, so a padded round equals the unpadded one.
_PAD_VALUE = {"g_absent": True, "g_key": -1, "g_run": -1, "run_gang": -1}


def _round_up(n: int, mult: int) -> int:
    return ((n + mult - 1) // mult) * mult if mult > 1 else n


def _grow(arr, target: int, value, axis: int = 0):
    """`arr` (numpy or torch) grown along `axis` to `target` with `value`."""
    shape = list(arr.shape)
    shape[axis] = target - shape[axis]
    if isinstance(arr, torch.Tensor):
        return torch.cat([arr, torch.full(shape, value, dtype=arr.dtype, device=arr.device)],
                         dim=axis)
    return np.concatenate([arr, np.full(shape, value, arr.dtype)], axis=axis)


def pad_problem(problem: SchedulingProblem, node_multiple: int = 1,
                job_multiple: int = 1) -> SchedulingProblem:
    """Pad the node/gang/run axes up to shard multiples with inert lanes.

    Returns `problem` unchanged when the axes already divide.  Works on host
    arrays and on tensors alike.  Padded nodes are node_ok=False with zero
    capacity, padded gang slots g_absent (state 3, which decode ignores),
    padded run slots run_valid=False; decode bounds (ctx.num_real_*)
    predate the pad."""
    N = problem.node_total.shape[0]
    G = problem.g_req.shape[0]
    RJ = problem.run_req.shape[0]
    N2 = _round_up(N, node_multiple)
    G2 = _round_up(G, job_multiple)
    RJ2 = _round_up(RJ, job_multiple)
    if (N2, G2, RJ2) == (N, G, RJ):
        return problem
    out = {}
    for name, arr in zip(problem._fields, problem):
        if not isinstance(arr, torch.Tensor):
            arr = np.asarray(arr)
        if name in _NODE_AX0:
            target = N2
        elif name in _RUN_AX0:
            target = RJ2
        elif name in _GANG_AX0:
            target = G2
        elif name == "ban_mask" and N2 != N:
            # a padded node is never banned (node_ok already excludes it)
            out[name] = _grow(arr, N2, 0, axis=1)
            continue
        else:
            out[name] = arr
            continue
        if target != arr.shape[0]:
            arr = _grow(arr, target, _PAD_VALUE.get(name, 0))
        out[name] = arr
    return SchedulingProblem(**out)


def shard_problem(problem: SchedulingProblem, mesh: Mesh, pad: bool = True) -> SchedulingProblem:
    """Place a (host or device) problem onto the mesh, padding
    non-divisible axes with inert lanes first (pad=True).  On one card the
    shard-contiguous layout of every field is its plain layout: the upload
    is the single-card upload."""
    from armada_tpu_torch.models.state import problem_from_numpy

    if pad:
        problem = pad_problem(problem, mesh.shape[AXIS_NODES], mesh.shape[AXIS_JOBS])
    _check_divisible(problem, mesh)
    return problem_from_numpy(problem, mesh.device)


def sharded_schedule_round(
    problem: SchedulingProblem,
    mesh: Mesh,
    *,
    num_levels: int,
    max_slots: int,
    slot_width: int,
    max_iterations: int = 0,
    commit_k: int = -1,
):
    """Run one scheduling round over the mesh: kernel K-K on a card, the
    plain round on the CPU (its plain version: sharding changes nothing the
    round decides).  Equivalent single-device call:
    models.fair_scheduler.schedule_round on the padded problem."""
    from armada_tpu_torch.models.fair_scheduler import resolve_commit_k, schedule_round

    if commit_k < 0:
        commit_k = resolve_commit_k()
    dp = shard_problem(problem, mesh)
    return schedule_round(dp, num_levels=num_levels, max_slots=max_slots,
                          slot_width=slot_width, max_iterations=max_iterations,
                          commit_k=commit_k, device=mesh.device, mesh=mesh)
