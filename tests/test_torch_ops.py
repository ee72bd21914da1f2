"""The port's plain fit, packing and fairness ops against the JAX package's.

Inputs come from numpy seeds and go to both sides as identical arrays.
Integer and bool outputs must be equal; f32 scores and costs must be equal
too (no tolerance): the port reproduces XLA:CPU's association -- the packing
score's fused multiply-add chain and the water-fill's windowed sums -- so the
orderings they feed cannot flip.
"""

import numpy as np
import pytest
import torch

import jax

from armada_tpu.ops import fairness as jfair
from armada_tpu.ops import fit as jfit
from armada_tpu.ops import packing as jpack
from armada_tpu_torch.ops import fairness as tfair
from armada_tpu_torch.ops import fit as tfit
from armada_tpu_torch.ops import packing as tpack


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _eq(jax_out, torch_out):
    a = np.asarray(jax_out)
    b = torch_out.numpy() if isinstance(torch_out, torch.Tensor) else np.asarray(torch_out)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert a.dtype == b.dtype or a.dtype.kind == b.dtype.kind, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


def _alloc(rng, N, R, ties=True):
    """Integral allocatable rows (resolution units), some negative, with
    forced duplicate rows so argmin ties occur."""
    a = rng.integers(-4, 64, (N, R)).astype(np.float32)
    if ties:
        dup = rng.integers(0, N, N // 4)
        a[dup] = a[0]
    return a


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_allocatable_from_used(seed):
    rng = np.random.default_rng(seed)
    total = rng.integers(0, 100, (40, 4)).astype(np.float32)
    used = rng.integers(0, 10, (5, 40, 4)).astype(np.float32)
    _eq(jfit.allocatable_from_used(total, used), tfit.allocatable_from_used(_t(total), _t(used)))


@pytest.mark.parametrize("seed", [0, 1])
def test_static_dynamic_and_job_fit(seed):
    rng = np.random.default_rng(seed)
    N, R = 64, 3
    compat = rng.random((5, 4)) < 0.6
    node_type = rng.integers(0, 4, N).astype(np.int32)
    alloc = _alloc(rng, N, R)
    req = np.array([3, 0, 7], np.float32)
    node_ok = rng.random(N) < 0.9
    for key in range(5):
        _eq(jfit.static_fit(compat, key, node_type), tfit.static_fit(_t(compat), key, _t(node_type)))
    _eq(jfit.dynamic_fit(alloc, req), tfit.dynamic_fit(_t(alloc), _t(req)))
    for pinned in (-1, 0, 17):
        _eq(
            jfit.job_fit(compat, 2, node_type, alloc, req, node_ok, np.int32(pinned)),
            tfit.job_fit(_t(compat), 2, _t(node_type), _t(alloc), _t(req), _t(node_ok), pinned),
        )


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_packing_score_and_best_node(seed):
    rng = np.random.default_rng(seed)
    N, R = 257, 4
    alloc = _alloc(rng, N, R) * np.float32(1000.0)
    scale = np.maximum(alloc.max(axis=0), 1.0).astype(np.float32)
    inv_scale = (1.0 / scale).astype(np.float32)
    inv_scale[2] = 0.0  # a zero-total resource
    # Jitted, as the round evaluates it: inside one XLA program the multiply
    # fuses into the reduction as a chain of fused multiply-adds, which is
    # the association that orders nodes (op-by-op dispatch would round each
    # product separately instead).
    js = jax.jit(jpack.node_packing_score)(alloc, inv_scale)
    ts = tpack.node_packing_score(_t(alloc), _t(inv_scale))
    _eq(js, ts)
    for mask in (rng.random(N) < 0.5, np.zeros(N, bool), np.ones(N, bool)):
        jf, jn = jpack.select_best_node(mask, js)
        tf_, tn = tpack.select_best_node(_t(mask), ts)
        assert bool(jf) == bool(tf_) and int(jn) == int(tn)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_member_capacity(seed):
    rng = np.random.default_rng(seed)
    alloc = _alloc(rng, 100, 4)
    for req in ([3, 2, 0, 1], [0, 0, 0, 0], [7, 64, 1, 5]):
        req = np.asarray(req, np.float32)
        _eq(jpack.member_capacity(alloc, req), tpack.member_capacity(_t(alloc), _t(req)))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("card", [1, 3, 8, 40])
def test_gang_selection(seed, card):
    rng = np.random.default_rng(seed)
    N = 96
    alloc = _alloc(rng, N, 2)
    cap = np.asarray(jpack.member_capacity(alloc, np.array([2, 3], np.float32)))
    cap = np.minimum(cap, card)
    mask = (cap >= 1) & (rng.random(N) < 0.8)
    score = (rng.integers(0, 5, N)).astype(np.float32)  # many exact ties
    jf, jc = jpack.select_gang_nodes(mask, cap, card, score)
    tf_, tc = tpack.select_gang_nodes(_t(mask), _t(cap), card, _t(score))
    assert bool(jf) == bool(tf_)
    _eq(jc, tc)
    width = min(card, N)
    jf, jn, jcc = jpack.select_gang_nodes_compact(mask, cap, card, score, width)
    tf_, tn, tcc = tpack.select_gang_nodes_compact(_t(mask), _t(cap), card, _t(score), width)
    assert bool(jf) == bool(tf_)
    _eq(jn, tn)
    _eq(jcc, tcc)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_drf_costs(seed):
    rng = np.random.default_rng(seed)
    Q, R = 33, 4
    alloc = (rng.integers(0, 5000, (Q, R)) * rng.random((Q, R))).astype(np.float32)
    total = np.array([123456.0, 0.0, 77.0, 3.0], np.float32)  # a zero total
    mult = np.array([1.0, 1.0, 0.5, 2.0], np.float32)
    weight = rng.choice([0.0, 0.5, 1.0, 3.0], Q).astype(np.float32)  # zero weights
    _eq(jfair.unweighted_drf_cost(alloc, total, mult),
        tfair.unweighted_drf_cost(_t(alloc), _t(total), _t(mult)))
    _eq(jfair.weighted_drf_cost(alloc, total, mult, weight),
        tfair.weighted_drf_cost(_t(alloc), _t(total), _t(mult), _t(weight)))


@pytest.mark.parametrize("Q", [1, 5, 16, 32, 64, 96, 25, 31, 33, 65, 257])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_fair_shares(Q, seed):
    rng = np.random.default_rng(seed * 100 + Q)
    w = rng.choice([0.0, 0.5, 1.0, 2.0, 3.7], Q).astype(np.float32)
    if seed == 0:
        w[:] = 0.0  # all-zero weights
    cds = (rng.random(Q) * rng.choice([0.0, 0.01, 0.1, 1.0], Q)).astype(np.float32)
    j = jfair.fair_shares(w, cds)
    t = tfair.fair_shares(_t(w), _t(cds))
    for a, b in zip(j, t):
        _eq(a, b)


def test_theoretical_share():
    w = np.array([1.0, 2.0, 0.0, 1.0], np.float32)
    cds = np.array([0.2, 0.9, 0.0, 0.05], np.float32)
    for prio in (1.0, 2.0, 0.5):
        assert jfair.theoretical_share(w, cds, prio) == tfair.theoretical_share(w, cds, prio)


@pytest.mark.parametrize("Q", [8, 32, 256, 8192])
def test_theoretical_share_padded(Q):
    """theoretical_share as a round's stats call it: the padded queue vector
    (real queues first, zero-weight padding after) plus the new queue, so the
    water-filling runs at Q + 1, never a multiple of 32."""
    rng = np.random.default_rng(Q)
    real = min(Q, 200)
    w = np.zeros(Q, np.float32)
    cds = np.zeros(Q, np.float32)
    w[:real] = rng.random(real) * 10.0 ** rng.integers(-3, 3, real)
    cds[:real] = rng.random(real) * rng.choice([0.001, 0.01, 0.1], real)
    for prio in (1.0, 2.0, 3.0):
        assert jfair.theoretical_share(w, cds, prio) == tfair.theoretical_share(
            _t(w), _t(cds), prio)


def _padded(Q, real, seed):
    rng = np.random.default_rng(seed)
    w = np.zeros(Q, np.float32)
    cds = np.zeros(Q, np.float32)
    w[:real] = rng.choice([0.5, 1.0, 2.0, 3.7], real)
    cds[:real] = rng.random(real) * rng.choice([0.001, 0.01, 0.1], real)
    return w, cds


@pytest.mark.parametrize("Q", [1025, 8192, 8193])
def test_fair_shares_full_vectors(Q):
    """K-A's plain version against the JAX package's fair_shares in every
    element of all three vectors, at the register form's first width and
    the main path's Q and Q + 1, on a padded row (64 real queues, as a
    round's stats pass it) and on a dense one."""
    for w, cds in (_padded(Q, 64, Q), _padded(Q, Q, Q + 1)):
        for a, b in zip(jfair.fair_shares(w, cds), tfair.fair_shares(_t(w), _t(cds))):
            _eq(a, b)


@pytest.mark.parametrize("P,Q", [(7, 64), (3, 8193)])
def test_fair_shares_lanes_equal_jax_vmap(P, Q):
    """The [P, Q] lane form (the pools path's K-A) against jax.vmap of the
    JAX package's fair_shares, every lane with other rows."""
    from armada_tpu_torch.kernels.fair_shares import fair_shares as lanes_form

    rows = [_padded(Q, 40 + 3 * i, 10 * P + i) for i in range(P)]
    w = np.stack([r[0] for r in rows])
    cds = np.stack([r[1] for r in rows])
    j = jax.vmap(jfair.fair_shares)(w, cds)
    for a, b in zip(j, lanes_form(_t(w), _t(cds))):
        _eq(a, b)


_ADVERSARIAL = None


def _adversarial_fair_share_cases():
    global _ADVERSARIAL
    if _ADVERSARIAL is None:
        from armada_tpu_torch.models.synthetic import adversarial_fair_share_cases

        _ADVERSARIAL = {c[0]: c[1:] for c in adversarial_fair_share_cases()
                        if c[1].ndim == 1 and c[1].shape[0] <= 8_193}
    return _ADVERSARIAL


@pytest.mark.parametrize("name", [
    "zero weights Q=25", "all achieved first Q=1025", "max iterations Q=33",
    "max iterations 3 Q=8193", "infinite unallocated Q=29", "infinite unallocated Q=8192",
    "NaN weight Q=8193", "random Q=24",
])
def test_fair_shares_adversarial_equal_jax(name):
    """K-A's adversarial cases (models/synthetic.py, the ones chip_smoke.py
    holds the kernel to on the card) through the plain version and the JAX
    package, every element, and each case's loop as its name says."""
    w, cds, max_iterations, expect = _adversarial_fair_share_cases()[name]
    j = jfair.fair_shares(w, cds, max_iterations=max_iterations)
    stats = {}
    t = tfair.fair_shares_plain(_t(w), _t(cds), max_iterations, stats=stats)
    for a, b in zip(j, t):
        _eq(a, b)
    if "iterations" in expect:
        assert stats["iterations"] == expect["iterations"]
    if expect.get("first_all"):
        assert stats["achieved"][0] == int((w > 0).sum())


def test_fair_shares_forms():
    """The kernel's form by width (kernels/fair_shares.py form_of, which the
    library checks against csrc/fair_shares.cu on the card)."""
    from armada_tpu_torch.kernels.fair_shares import MAX_QUEUES, form_of

    assert [form_of(q) for q in (1, 24, 32, 33, 1024)] == ["warp"] * 5
    assert [form_of(q) for q in (1025, 8192, 8193, 8448)] == ["shared"] * 4
    assert [form_of(q) for q in (8449, MAX_QUEUES)] == ["global"] * 2
