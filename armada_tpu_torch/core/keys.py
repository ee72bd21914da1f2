"""Categorical compression: node types and scheduling keys.

The reference collapses nodes into `NodeType`s -- the hash of (taints, indexed
labels) -- so that taint/label fit is checked once per (job, nodeType) instead of per
(job, node) (internaltypes/node_type.go; nodedb/nodematching.go:127-145), and
collapses jobs into `SchedulingKey`s -- the hash of everything that affects where a
job can run (internaltypes/podutils.go SchedulingKeyGenerator) -- used both to skip
identical unfeasible jobs (gang_scheduler.go:64-98) and to cache submit checks
(submitcheck.go:243).

Here the same idea becomes the device-side representation: the (key x type) static
fit matrix is precomputed on host with exact string matching, and on device fit is a
single gather `compat[job_key, node_type]` -- no string ever reaches the device.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Sequence

import numpy as np

from armada_tpu_torch.core.types import (
    JobSpec,
    NodeSpec,
    Taint,
    Toleration,
    selector_matches,
    taints_tolerated,
)


@dataclasses.dataclass(frozen=True)
class NodeType:
    """Identity of a class of nodes indistinguishable to static fit checks."""

    taints: tuple[Taint, ...]
    indexed_labels: tuple[tuple[str, str], ...]  # sorted (label, value) pairs
    # Hardware type (NodeSpec.node_type, executor-reported): two nodes with
    # identical taints/labels but different hardware are NOT interchangeable
    # once any job declares per-type scores, so the hardware axis is part of
    # node-type identity.  "" (the default) keeps single-type worlds on the
    # exact pre-hetero identities.
    hw_type: str = ""


@dataclasses.dataclass(frozen=True)
class SchedulingKey:
    """Identity of a class of jobs indistinguishable to the scheduler."""

    resources: tuple[int, ...]  # atoms, fixed axis order
    node_selector: tuple[tuple[str, str], ...]
    tolerations: tuple[Toleration, ...]
    priority_class: str
    priority: int
    # Retry anti-affinity terms (scheduler.go:522-568): the reference folds
    # affinity into the key via the pod requirements, so a retried job never
    # shares an unfeasible-key class with a clean one.
    banned_nodes: tuple[str, ...] = ()
    # (uniformity label, chosen domain value) for gangs constrained to one
    # node domain (gang_scheduler.go NodeUniformity): a domain-restricted
    # gang must never retire the unrestricted jobs' key class.
    uniformity: tuple[str, str] = ("", "")
    # Per-node-type effective-throughput map (JobSpec.node_type_scores,
    # sorted).  Part of key identity because the key must determine EVERY
    # placement-relevant property: the per-key fit cache and commit_k's head
    # certification key on it, and a type-sensitive job sharing a key class
    # with an insensitive twin would poison both (docs/lint.md ledger:
    # "key must absorb the type axis").  () = type-insensitive.
    type_scores: tuple[tuple[str, float], ...] = ()


class NodeTypeIndex:
    """Assigns each node a dense node-type id; built per round on host."""

    def __init__(self, indexed_labels: Sequence[str]):
        self.indexed_labels = tuple(sorted(set(indexed_labels)))
        self.types: list[NodeType] = []
        self._ids: dict[NodeType, int] = {}

    def type_of(self, node: NodeSpec) -> int:
        labels = tuple(
            (k, node.labels[k]) for k in self.indexed_labels if k in node.labels
        )
        nt = NodeType(tuple(node.taints), labels, node.node_type)
        tid = self._ids.get(nt)
        if tid is None:
            tid = len(self.types)
            self.types.append(nt)
            self._ids[nt] = tid
        return tid

    def __len__(self) -> int:
        return len(self.types)


def class_signature(job: JobSpec, node_id_label: str) -> tuple:
    """The hashable identity of a job's scheduling class -- EXACTLY the
    fields SchedulingKeyIndex.key_of folds into the key (minus per-gang bans
    and uniformity, which are gang-level).  Shared by the problem builder's
    provisional gang grouping and the SubmitChecker so their class splits can
    never diverge from the interned keys (the node-id pinning label is
    excluded in both, matching key_of)."""
    selector = (
        tuple(
            sorted(
                (k, v) for k, v in job.node_selector.items() if k != node_id_label
            )
        )
        if job.node_selector
        else ()
    )
    return (
        job.resources.atoms_tuple() if job.resources else (),
        selector,
        tuple(job.tolerations),
        job.priority_class,
        job.priority,
        tuple(job.node_type_scores),
    )


class SchedulingKeyIndex:
    """Assigns each job a dense scheduling-key id; built per round on host."""

    def __init__(self):
        self.keys: list[SchedulingKey] = []
        self._ids: dict[SchedulingKey, int] = {}

    def key_of(
        self,
        job: JobSpec,
        node_id_label: str = "kubernetes.io/hostname",
        banned_nodes: Sequence[str] = (),
        uniformity: tuple = ("", ""),
    ) -> int:
        # The node-id pinning label is excluded: pinning is handled positionally via
        # the pinned-node tensor, the way the reference injects node-id selectors
        # for evicted jobs (internal/scheduler/api.go addNodeIdSelector:278).
        # Hot path (one call per queued job per round): probe with a plain
        # tuple and only materialize the SchedulingKey dataclass on a miss.
        selector = (
            tuple(
                sorted(
                    (k, v)
                    for k, v in job.node_selector.items()
                    if k != node_id_label
                )
            )
            if job.node_selector
            else ()
        )
        resources = job.resources.atoms_tuple() if job.resources else ()
        tolerations = tuple(job.tolerations)
        bans = tuple(sorted(banned_nodes)) if banned_nodes else ()
        uni = tuple(uniformity)
        tscores = tuple(job.node_type_scores)
        probe = (
            resources, selector, tolerations, job.priority_class, job.priority,
            bans, uni, tscores,
        )
        kid = self._ids.get(probe)
        if kid is None:
            kid = len(self.keys)
            self.keys.append(
                SchedulingKey(
                    resources=resources,
                    node_selector=selector,
                    tolerations=tolerations,
                    priority_class=job.priority_class,
                    priority=job.priority,
                    banned_nodes=bans,
                    uniformity=uni,
                    type_scores=tscores,
                )
            )
            self._ids[probe] = kid
        return kid

    def __len__(self) -> int:
        return len(self.keys)


def type_feasible(key: SchedulingKey, nt: NodeType) -> bool:
    """Does the key's type-score map admit hardware type `nt.hw_type`?

    A NONEMPTY map is a whitelist with weights (Gavel-style: a job has a
    throughput on each type it can run on): hardware types absent from the
    map, or mapped to a throughput <= 0, are infeasible.  An empty map (the
    default) admits every type.
    """
    if not key.type_scores:
        return True
    for name, thr in key.type_scores:
        if name == nt.hw_type:
            return thr > 0
    return False


def static_fit_matrix(
    keys: Sequence[SchedulingKey],
    types: Sequence[NodeType],
    *,
    pre_type: bool = False,
) -> np.ndarray:
    """bool[K, T]: does job-class k statically fit node-class t?

    Static fit = tolerations cover the type's blocking taints AND the selector is
    satisfied by the type's indexed labels (nodematching.go NodeTypeJobRequirementsMet
    :127 + StaticJobRequirementsMet:161) AND the key's node-type-score map admits
    the type's hardware (`type_feasible`).  Callers must index every label referenced
    by a selector (the problem builder does, via labels_referenced_by_selectors);
    a selector naming an unindexed label never matches.

    pre_type=True skips the hardware-type gate -- the explain pass's
    type-mismatch partition needs "would this fit if the type map admitted
    everything" to tell type-gated infeasibility from shape infeasibility.
    """
    out = np.zeros((len(keys), len(types)), dtype=bool)
    type_labels = [dict(nt.indexed_labels) for nt in types]
    for ki, key in enumerate(keys):
        sel = dict(key.node_selector)
        for ti, nt in enumerate(types):
            if not taints_tolerated(nt.taints, key.tolerations):
                continue
            if not selector_matches(sel, type_labels[ti]):
                continue
            if pre_type or type_feasible(key, nt):
                out[ki, ti] = True
    return out


# Packing scores live in [0, R] (per-resource terms are alloc/scale <= 1);
# a bias of 1024 per unit of (1/throughput - 1) tiers nodes by declared
# throughput (types differing >= ~1% in 1/throughput never lose to packing)
# while equal-throughput types still pack best-fit.  Power of two: the
# f32 add `score + bias` the kernel and the sequential oracle both perform
# stays exactly mirrorable.
TYPE_BIAS_SCALE = 1024.0


def type_score_tables(
    keys: Sequence[SchedulingKey],
    types: Sequence[NodeType],
    K: int,
    T: int,
    *,
    row_bucket: int = 8,
) -> tuple[np.ndarray, np.ndarray]:
    """The kernel's per-type score-adjust tables, padded to (K, T).

    Returns (key_type_row i32[K], type_bias f32[TR, T]):

    - `key_type_row[k]` = the bias row of key k; row 0 is the all-zero
      insensitive row, so every key with an empty type-score map (and every
      padded key slot) shares it and TR == 1 means "no sensitive key in
      this problem" -- the structural switch the kernel uses to compile the
      exact pre-hetero body.
    - `type_bias[r, t]` = (1/throughput - 1) * TYPE_BIAS_SCALE for hardware
      types the row's map names feasibly; 0 elsewhere (infeasible types are
      excluded by the compat gate, never by bias).  Computed in f32.

    Distinct nonempty maps intern distinct rows; TR pads to `row_bucket`
    past 1 so a newly interned map mid-steady-state rarely changes the
    compiled shape (the compat-table discipline).
    """
    rows: dict[tuple, int] = {}
    key_type_row = np.zeros((K,), np.int32)
    for ki, key in enumerate(keys):
        if not key.type_scores:
            continue
        row = rows.get(key.type_scores)
        if row is None:
            row = len(rows) + 1
            rows[key.type_scores] = row
        key_type_row[ki] = row
    if not rows:
        return key_type_row, np.zeros((1, T), np.float32)
    TR = ((len(rows) + 1 + row_bucket - 1) // row_bucket) * row_bucket
    type_bias = np.zeros((TR, T), np.float32)
    hw_of = [nt.hw_type for nt in types]
    for tscores, row in rows.items():
        by_name = dict(tscores)
        for ti, hw in enumerate(hw_of):
            thr = by_name.get(hw)
            if thr is not None and thr > 0:
                type_bias[row, ti] = np.float32(
                    (np.float32(1.0) / np.float32(thr) - np.float32(1.0))
                    * np.float32(TYPE_BIAS_SCALE)
                )
    return key_type_row, type_bias


def labels_referenced_by_selectors(
    jobs: Sequence[JobSpec], node_id_label: str
) -> set[str]:
    """Labels that must be folded into node types for exact static fit."""
    out: set[str] = set()
    for job in jobs:
        for k in job.node_selector:
            if k != node_id_label:
                out.add(k)
    return out
