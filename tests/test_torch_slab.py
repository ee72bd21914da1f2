"""The port's slab delta apply (kernel K-H's plain version) against the JAX
package's.

- `armada_tpu_torch.models.slab.apply_delta_plain` against the JAX
  `apply_delta` program on the same previous problem and the same padded
  rows: splice and whole-vector forms, sentinel padding, negative indices.
- The JAX builder's bundle stream applied by both packages' caches (and the
  port builder's stream by both): after every apply and every content
  prefetch the resident problems are equal, field by field, and equal to
  `bundle.materialize()`.
- The DualDriver scenario of tests/test_slab_delta.py driven through the
  port: legacy assemble + full upload against slab + scatter, with equal
  outcomes every cycle (and equal to the JAX package's).
- The running-gang cascade on a slab context, through the port's
  run_round_on_device (rollback over `gang_members_over`).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from armada_tpu.core.config import PoolConfig
from armada_tpu.core.types import JobSpec, NodeSpec, Queue, RunningJob
from armada_tpu.models import SchedulingProblem as JaxProblem
from armada_tpu.models import decode_result as jax_decode
from armada_tpu.models import run_round_on_device as jax_run_round
from armada_tpu.models import schedule_round as jax_round
from armada_tpu.models.incremental import IncrementalBuilder as JaxBuilder
from armada_tpu.models.slab import DeviceDeltaCache as JaxCache
from armada_tpu.models.slab import _make_apply
from armada_tpu_torch.models import run_round_on_device
from armada_tpu_torch.models.incremental import DeviceProblemCache, IncrementalBuilder
from armada_tpu_torch.models.slab import (
    _EV_FIELDS, _RR_FIELDS, _SG_FIELDS, DeviceDeltaCache, apply_delta_plain,
)
from armada_tpu_torch.models.state import problem_from_numpy
from test_slab_delta import make_config, make_job, make_world


def _assert_problems_equal(got, want, what=""):
    for name in got._fields:
        a = getattr(got, name)
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        b = np.asarray(getattr(want, name))
        assert a.dtype == b.dtype, f"{what}{name}: dtype {a.dtype} != {b.dtype}"
        np.testing.assert_array_equal(a, b, err_msg=f"{what}{name}")


def _random_problem(rng, G=96, RJ=24, N=10, R=2):
    """A host problem with random content in every field the apply touches."""
    from armada_tpu_torch.models.synthetic import synthetic_problem

    p, _ = synthetic_problem(num_nodes=N, num_gangs=G - RJ, num_queues=3, num_runs=RJ,
                             max_gang_cardinality=3, seed=int(rng.integers(1 << 30)))
    f = p._asdict()
    G = f["g_req"].shape[0]
    f["gq_gang"] = rng.permutation(G).astype(np.int32)
    f["g_price"] = rng.random(G).astype(np.float32)
    f["g_spot_price"] = rng.random(G).astype(np.float32)
    f["g_absent"] = rng.random(G) < 0.2
    return type(p)(**f)


def _rows(rng, prev, names, k):
    out = {}
    for n in names:
        a = np.asarray(getattr(prev, n))
        if a.dtype == np.bool_:
            out[n] = rng.random((k,) + a.shape[1:]) < 0.5
        elif a.dtype == np.float32:
            out[n] = rng.integers(0, 50, (k,) + a.shape[1:]).astype(np.float32)
        else:
            out[n] = rng.integers(-1, 9, (k,) + a.shape[1:]).astype(a.dtype)
    return out


@pytest.mark.parametrize("splice", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_apply_plain_equals_jax(splice, seed):
    rng = np.random.default_rng(seed)
    prev = _random_problem(rng)
    G, RJ = prev.g_req.shape[0], prev.run_req.shape[0]
    ev_base = G - RJ - 8
    kg, kr = 16, 8
    sg_idx = np.full((kg,), G, np.int32)
    sg_idx[:10] = rng.choice(G, 10, replace=False)
    sg_idx[10] = -1  # a negative index counts from the end, as in JAX
    rr_idx = np.full((kr,), RJ, np.int32)
    rr_idx[:5] = rng.choice(RJ, 5, replace=False)
    sg_cols = _rows(rng, prev, _SG_FIELDS, kg)
    rr_cols = _rows(rng, prev, _RR_FIELDS, kr)
    ev_cols = _rows(rng, prev, _EV_FIELDS, kr)
    fulls = {"q_len": (np.asarray(prev.q_len) + 1).astype(np.int32),
             "global_burst": np.int32(7)}
    if splice:
        kq = 16
        rem = np.sort(rng.choice(G, 6, replace=False)).astype(np.int32)
        ins = np.sort(rng.choice(G, 6, replace=False)).astype(np.int32)
        rem_pos = np.full((kq,), G, np.int32)
        rem_pos[:6] = rem
        ins_pos = np.full((kq,), G, np.int32)
        ins_pos[:6] = ins
        ins_val = np.zeros((kq,), np.int32)
        ins_val[:6] = rng.integers(0, G, 6)
        gq_args = (rem_pos, ins_pos, ins_val)
    else:
        gq_args = ()
        fulls["gq_gang"] = rng.permutation(G).astype(np.int32)
    _apply_both(prev, sg_idx, sg_cols, rr_idx, rr_cols, ev_cols, fulls, gq_args,
                ev_base=ev_base, splice=splice)


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _apply_both(prev, sg_idx, sg_cols, rr_idx, rr_cols, ev_cols, fulls, gq_args, *, ev_base,
                splice):
    """The JAX `apply_delta` program and the plain version on the same
    inputs (numpy): every field equal, and the previous problem unwritten."""
    jprev = JaxProblem(*(jnp.asarray(a) for a in prev))
    want = _make_apply()(jprev, sg_idx, sg_cols, rr_idx, rr_cols, ev_cols, fulls, gq_args,
                         ev_base=ev_base, splice=splice)
    tprev = problem_from_numpy(prev, "cpu")
    before = {n: getattr(tprev, n).clone() for n in tprev._fields}
    got = apply_delta_plain(
        tprev, _t(sg_idx), {n: _t(v) for n, v in sg_cols.items()}, _t(rr_idx),
        {n: _t(v) for n, v in rr_cols.items()}, {n: _t(v) for n, v in ev_cols.items()},
        {n: _t(v) for n, v in fulls.items()}, tuple(_t(a) for a in gq_args),
        ev_base=ev_base, splice=splice,
    )
    _assert_problems_equal(got, want)
    # functional: the previous problem's tensors are untouched
    for n in tprev._fields:
        assert torch.equal(getattr(tprev, n), before[n]), n
    return got


def _adversarial(rng, prev, case):
    """K-H's adversarial inputs: (sg_idx, rr_idx, gq_args, ev_base), index
    vectors bucket-padded with the sentinels, a splice of 16 entries."""
    G, RJ = prev.g_req.shape[0], prev.run_req.shape[0]
    ev_base = G - RJ - 8
    sg_idx = np.full((32,), G, np.int32)
    rr_idx = np.full((16,), RJ, np.int32)
    rem_pos = np.full((16,), G, np.int32)
    ins_pos = np.full((16,), G, np.int32)
    ins_val = np.zeros((16,), np.int32)
    if case != "all_sentinel":
        run = rng.choice(RJ, 6, replace=False)
        rr_idx[:6] = run
        free = np.setdiff1d(np.arange(G), run + ev_base)
        sg_idx[:12] = rng.choice(free, 12, replace=False)
        rem_pos[:5] = rng.choice(G, 5, replace=False)
        ins_pos[:5] = rng.choice(G, 5, replace=False)
        ins_val[:5] = rng.integers(0, G, 5)
    if case == "cross_group":
        sg_idx[12:15] = run[:3] + ev_base  # the evictee rows, a later group, win
    elif case == "unsorted":
        sg_idx[[12, 13]] = [-1, -G]  # negative: counted from the end
        rng.shuffle(sg_idx)
        rng.shuffle(rr_idx)
        order = rng.permutation(16)
        rem_pos, ins_pos, ins_val = rem_pos[::-1].copy(), ins_pos[order], ins_val[order]
    elif case == "within_group":
        sg_idx[12:15] = sg_idx[:3]  # the later entry of a group wins (XLA:CPU's loop)
        rr_idx[6] = rr_idx[0]
        ins_pos[5], ins_val[5] = ins_pos[0], 12345
    elif case == "no_inserts":
        ins_pos[:] = G
        ins_val[:] = 0
    elif case == "no_removals":
        rem_pos[:] = G
    return sg_idx, rr_idx, (rem_pos, ins_pos, ins_val), ev_base


@pytest.mark.parametrize("case", ["cross_group", "unsorted", "within_group", "all_sentinel",
                                  "no_inserts", "no_removals"])
def test_apply_plain_equals_jax_adversarial(case):
    """K-H's adversarial cases, the plain version against the JAX program:
    a slot written by two groups, index vectors and splice positions out of
    ascending order (negative ones among them), a slot written twice within
    a group, groups whose rows are all sentinel, splices with no inserts
    and with no removals."""
    rng = np.random.default_rng(7)
    prev = _random_problem(rng)
    sg_idx, rr_idx, gq_args, ev_base = _adversarial(rng, prev, case)
    sg_cols = _rows(rng, prev, _SG_FIELDS, len(sg_idx))
    rr_cols = _rows(rng, prev, _RR_FIELDS, len(rr_idx))
    ev_cols = _rows(rng, prev, _EV_FIELDS, len(rr_idx))
    got = _apply_both(prev, sg_idx, sg_cols, rr_idx, rr_cols, ev_cols, {}, gq_args,
                      ev_base=ev_base, splice=True)
    if case == "cross_group":
        slot = int(sg_idx[12])
        row = int(np.flatnonzero(rr_idx == slot - ev_base)[0])
        assert float(got.g_price[slot]) == float(ev_cols["g_price"][row])
    if case == "all_sentinel":
        _assert_problems_equal(got._replace(gq_gang=prev.gq_gang),
                               problem_from_numpy(prev, "cpu"))


def _plan_inputs(seed=3, splice=True):
    """A CPU problem and one apply's padded inputs as tensors."""
    rng = np.random.default_rng(seed)
    prev = _random_problem(rng)
    sg_idx, rr_idx, gq_args, ev_base = _adversarial(rng, prev, "cross_group")
    cols = [{n: _t(v) for n, v in _rows(rng, prev, names, k).items()}
            for names, k in ((_SG_FIELDS, len(sg_idx)), (_RR_FIELDS, len(rr_idx)),
                             (_EV_FIELDS, len(rr_idx)))]
    tprev = problem_from_numpy(prev, "cpu")
    gq = tuple(_t(a) for a in gq_args) if splice else ()
    return (tprev, _t(sg_idx), cols[0], _t(rr_idx), cols[1], cols[2], {}, gq), \
        dict(ev_base=ev_base, splice=splice)


@pytest.mark.parametrize("splice", [True, False])
def test_apply_plan_layout(splice):
    """K-H's wrapper on CPU tensors, without the launch: the fresh fields
    are views of one arena at ALIGN-aligned, disjoint offsets; the other
    fields are the previous problem's own tensors; the argument block holds
    every tensor's address, the row bytes, the shapes and a new epoch of the
    (device, stream, shape) workspace a call; the plan is cached by
    signature and a row column of another shape is refused by name."""
    from armada_tpu_torch.kernels import slab as KS

    args, kw = _plan_inputs(splice=splice)
    prev, sg_idx, sg_cols, rr_idx, rr_cols, ev_cols, _, gq = args
    out, call, ws = KS.apply_plan(*args, **kw)
    plans = len(KS._PLANS)
    out2, call2, ws2 = KS.apply_plan(*args, **kw)
    assert len(KS._PLANS) == plans and ws2 is ws
    assert int(call2[KS.WORD["epoch"]]) == int(call[KS.WORD["epoch"]]) + 1
    gang, run, row_slots = KS._fields()
    fresh = list(gang + run) + (["gq_gang"] if splice else [])
    G, RJ = prev.g_req.shape[0], prev.run_req.shape[0]
    stores = {getattr(out, n).untyped_storage().data_ptr() for n in fresh}
    assert len(stores) == 1
    base = stores.pop()
    spans = []
    for n in fresh:
        a, b = getattr(out, n), getattr(prev, n)
        assert a.shape == b.shape and a.dtype == b.dtype and a.is_contiguous()
        assert a.untyped_storage().data_ptr() != b.untyped_storage().data_ptr()
        off = a.data_ptr() - base
        assert off % KS.ALIGN == 0
        spans.append((off, off + a.numel() * a.element_size()))
    spans.sort()
    assert all(e <= s for (_, e), (s, _) in zip(spans, spans[1:]))
    for n in prev._fields:
        if n not in fresh:
            assert getattr(out, n) is getattr(prev, n), n
    W = KS._FIELD_WORDS
    for i, n in enumerate(gang + run):
        t = getattr(prev, n)
        assert call[i * W] == t.data_ptr() and call[i * W + 1] == getattr(out, n).data_ptr()
        assert call[i * W + 4] == t[0].numel() * t.element_size()
    cols = {"sg": sg_cols, "ev": ev_cols, "rr": rr_cols}
    for g, n, w in row_slots:
        assert call[w] == cols[g][n].data_ptr(), (g, n)
    words = dict(G=G, RJ=RJ, k_sg=len(sg_idx), k_rr=len(rr_idx), ngf=len(gang), nrf=len(run),
                 ev_base=kw["ev_base"], splice=int(splice), kq=len(gq[0]) if splice else 0)
    for k, v in words.items():
        assert call[KS.WORD[k]] == v, k
    assert call[KS.WORD["sg_idx"]] == sg_idx.data_ptr()
    assert call[KS.WORD["ws"]] == ws.buf.data_ptr()
    assert ws.buf.numel() == KS.ws_bytes(G, RJ) and KS.ws_bytes(G, RJ) % 256 == 0
    if splice:
        assert call[KS.WORD["gq_prev"]] == prev.gq_gang.data_ptr()
        assert call[KS.WORD["gq_out"]] == out.gq_gang.data_ptr()
    bad = dict(sg_cols, g_card=sg_cols["g_card"][:-1])
    with pytest.raises(ValueError, match="g_card"):
        KS.apply_plan(prev, sg_idx, bad, rr_idx, rr_cols, ev_cols, {}, gq, **kw)


class _BothCaches:
    """A devcache stand-in for the builder's prefetch: forwards each content
    scatter to the JAX and the port cache and reports whether both took it."""

    def __init__(self, jc, tc):
        self.jc, self.tc = jc, tc

    def scatter_content(self, **kw):
        a = self.jc.scatter_content(**kw)
        b = self.tc.scatter_content(**kw)
        assert a == b
        return a


def _feed(builder_cls, cfg, queues, nodes, F, market_prices=None):
    b = builder_cls(cfg, "default", queues,
                    bid_price_of=(lambda j: market_prices.get((j.queue, j.price_band), 0.0))
                    if market_prices is not None else None)
    b.set_nodes(nodes)
    return b


def _drive_both_caches(builder, cfg, F, cycles=5, force_whole_gq=False, prefetch=True):
    """Run cycles of one builder, applying each bundle with the JAX and the
    port cache; decisions come from the JAX round on the JAX state."""
    jc = JaxCache()
    tc = DeviceDeltaCache(device="cpu")
    spec_of = {}
    nid = [0]
    splices = 0

    def submit(n, queue, cpu=2, pc="high"):
        batch = [make_job(F, 1000 + nid[0] + i, queue, pc=pc, cpu=cpu) for i in range(n)]
        nid[0] += n
        for s in batch:
            spec_of[s.id] = s
        builder.submit_many(batch)

    submit(12, "q0")
    submit(9, "q1", cpu=3)
    submit(7, "q2", pc="low")
    for cyc in range(cycles):
        bundle, ctx = builder.assemble_delta()
        if force_whole_gq and bundle.gq_splice is not None:
            truth_gq = bundle.materialize().gq_gang
            bundle = dataclasses.replace(bundle, gq_splice=None,
                                         fulls={**bundle.fulls, "gq_gang": truth_gq})
        splices += bundle.gq_splice is not None
        jdev = jc.apply(bundle)
        tdev = tc.apply(bundle)
        truth = bundle.materialize()
        _assert_problems_equal(tdev, jdev, f"cycle {cyc} apply vs JAX: ")
        _assert_problems_equal(tdev, truth, f"cycle {cyc} apply vs materialize: ")
        res = jax_round(jdev, num_levels=len(ctx.ladder) + 2, max_slots=ctx.max_slots,
                        slot_width=ctx.slot_width)
        out = jax_decode(res, ctx)
        if prefetch:
            submit(4, "q%d" % (cyc % 3), cpu=1)
            builder.prefetch_content(_BothCaches(jc, tc))
            _assert_problems_equal(tc._prev, jc._prev, f"cycle {cyc} prefetch vs JAX: ")
        builder.remove_many(list(out.scheduled))
        builder.lease_many([RunningJob(job=spec_of[j], node_id=n)
                            for j, n in out.scheduled.items() if j in spec_of])
        for jid in out.preempted:
            builder.unlease(jid)
        if not prefetch:
            submit(4, "q%d" % (cyc % 3), cpu=1)
    return tc, splices


@pytest.mark.parametrize("side", ["jax_builder", "port_builder"])
@pytest.mark.parametrize("form", ["splice", "whole_gq", "no_prefetch"])
def test_bundle_stream_applies_equal(side, form):
    cfg = make_config()
    F, nodes, queues = make_world(cfg, None)
    cls = JaxBuilder if side == "jax_builder" else IncrementalBuilder
    b = _feed(cls, cfg, queues, nodes, F)
    tc, splices = _drive_both_caches(b, cfg, F, force_whole_gq=form == "whole_gq",
                                     prefetch=form != "no_prefetch")
    if form == "whole_gq":
        assert splices == 0
    else:
        assert splices > 0, "the gq splice never engaged"
    if form != "no_prefetch":
        assert tc.content_prefetches > 0


def test_bundle_stream_market_pool():
    cfg = dataclasses.replace(
        make_config(),
        pools=(PoolConfig("default", market_driven=True, spot_price_cutoff=0.5),),
    )
    F, nodes, queues = make_world(cfg, None)
    prices = {(q.name, band): 1.0 + i for i, q in enumerate(queues) for band in ("", "low")}
    b = _feed(IncrementalBuilder, cfg, queues, nodes, F, market_prices=prices)
    _drive_both_caches(b, cfg, F, cycles=4)


def test_seq_gap_forces_full_upload():
    cfg = make_config()
    F, nodes, queues = make_world(cfg, None)
    b = IncrementalBuilder(cfg, "default", queues)
    b.set_nodes(nodes)
    b.submit_many([make_job(F, i, "q0") for i in range(5)])
    cache = DeviceDeltaCache(device="cpu")
    bundle, _ = b.assemble_delta()
    cache.apply(bundle)
    b.assemble_delta()  # never applied
    b.submit_many([make_job(F, 100, "q1")])
    bundle3, _ = b.assemble_delta()
    dev = cache.apply(bundle3)
    assert cache.last_apply == "full"
    _assert_problems_equal(dev, bundle3.materialize())


def test_steady_noop_keeps_the_resident_problem():
    cfg = make_config()
    F, nodes, queues = make_world(cfg, None)
    b = IncrementalBuilder(cfg, "default", queues)
    b.set_nodes(nodes)
    b.submit_many([make_job(F, i, "q0", cpu=64) for i in range(3)])  # fits nowhere
    cache = DeviceDeltaCache(device="cpu")
    first = cache.apply(b.assemble_delta()[0])
    second = cache.apply(b.assemble_delta()[0])
    bundle, _ = b.assemble_delta()
    third = cache.apply(bundle)
    assert cache.last_apply == "noop"
    assert third is second
    _assert_problems_equal(third, bundle.materialize())
    assert first is not None


class PortDual:
    """tests/test_slab_delta.py's DualDriver through the port: a legacy
    builder (assemble -> full upload) and a slab builder (assemble_delta ->
    scatter), both on the CPU, plus the JAX legacy round as the reference."""

    def __init__(self, cfg, queues, nodes):
        self.legacy = IncrementalBuilder(cfg, "default", queues)
        self.slab = IncrementalBuilder(cfg, "default", queues)
        self.jax = JaxBuilder(cfg, "default", queues)
        for b in (self.legacy, self.slab, self.jax):
            b.set_nodes(nodes)
        self.cache = DeviceDeltaCache(device="cpu")
        self.put = DeviceProblemCache(device="cpu")
        self.full_uploads = 0

    def each(self, fn):
        fn(self.legacy)
        fn(self.slab)
        fn(self.jax)

    def cycle(self):
        cfg = self.legacy.config
        problem, lctx = self.legacy.assemble()
        _, lout = run_round_on_device(problem, lctx, cfg, device="cpu",
                                      device_problem=self.put.put(problem))
        bundle, sctx = self.slab.assemble_delta()
        sdev = self.cache.apply(bundle)
        self.full_uploads += self.cache.last_apply == "full"
        _assert_problems_equal(sdev, bundle.materialize(), "scatter drift: ")
        _, sout = run_round_on_device(bundle.stats_view(), sctx, cfg, device="cpu",
                                      device_problem=sdev)
        jproblem, jctx = self.jax.assemble()
        _, jout = jax_run_round(jproblem, jctx, cfg)
        for out in (lout, sout):
            assert out.scheduled == jout.scheduled
            assert sorted(out.preempted) == sorted(jout.preempted)
            assert sorted(out.rescheduled) == sorted(jout.rescheduled)
            assert sorted(out.failed) == sorted(jout.failed)
            assert out.termination == jout.termination
        return lout


def _apply_outcome(dual, out, spec_of):
    leases = []
    for jid, nid in out.scheduled.items():
        spec = spec_of.get(jid)
        dual.each(lambda b: b.remove(jid))
        if spec is not None:
            leases.append(RunningJob(job=spec, node_id=nid))
    dual.each(lambda b: b.lease_many(leases))
    for jid in out.preempted:
        dual.each(lambda b: b.unlease(jid))


def test_port_slab_delta_matches_legacy_over_cycles():
    cfg = make_config()
    F, nodes, queues = make_world(cfg, None)
    d = PortDual(cfg, queues, nodes)
    spec_of = {}
    next_id = [0]

    def submit(n, queue, pc="high", cpu=2, gang=None):
        out = []
        for _ in range(n):
            s = make_job(F, next_id[0], queue, pc=pc, cpu=cpu, gang=gang)
            spec_of[s.id] = s
            out.append(s)
            next_id[0] += 1
        d.each(lambda b: b.submit_many(out))

    hogs = []
    for i in range(4):
        s = make_job(F, 10_000 + i, "q0", pc="low", cpu=8, sub=0)
        spec_of[s.id] = s
        hogs.append(s)
    d.each(lambda b: b.lease_many(
        [RunningJob(job=s, node_id=f"n{i // 2}") for i, s in enumerate(hogs)]))
    submit(10, "q0")
    submit(8, "q1", cpu=3)
    submit(6, "q2", pc="low")
    _apply_outcome(d, d.cycle(), spec_of)

    submit(2, "q1", gang="gang-a")
    banned = make_job(F, 20_000, "q2", cpu=2)
    spec_of[banned.id] = banned
    d.each(lambda b: b.submit(banned, banned_nodes=["n0", "n1"]))
    _apply_outcome(d, d.cycle(), spec_of)

    victims = [jid for jid in list(spec_of) if jid.startswith("j")][:3]
    for jid in victims:
        d.each(lambda b: b.remove(jid))
        spec_of.pop(jid, None)
    repri = next(iter([s for s in spec_of.values() if s.queue == "q1"]), None)
    if repri is not None:
        bumped = JobSpec(id=repri.id, queue=repri.queue, priority_class=repri.priority_class,
                         submit_time=repri.submit_time, resources=repri.resources,
                         priority=50)
        spec_of[bumped.id] = bumped
        d.each(lambda b: b.reprioritise(bumped))
    submit(5, "q2")
    _apply_outcome(d, d.cycle(), spec_of)

    d.each(lambda b: b.set_queues([Queue("q0", weight=1.0), Queue("q1", weight=2.0)]))
    d.each(lambda b: b.set_nodes([n for n in nodes if n.id != "n3"]))
    _apply_outcome(d, d.cycle(), spec_of)

    d.each(lambda b: b.set_queues(queues))
    d.each(lambda b: b.set_nodes(nodes))
    submit(6, "q2", pc="low", cpu=1)
    for _ in range(3):
        _apply_outcome(d, d.cycle(), spec_of)
    assert d.full_uploads < 7, f"delta path never engaged ({d.full_uploads} full uploads)"
    assert d.cache.splice_applies > 0, "gq splice never engaged"


def test_running_gang_cascade_on_slab_path():
    """The partial-preemption cascade works off the slab context (slot
    indices, a lazily built running_gangs mapping, gang_members=None)."""
    cfg = make_config()
    F, nodes, queues = make_world(cfg, None, num_nodes=2, num_queues=2)
    port = IncrementalBuilder(cfg, "default", queues)
    jaxb = JaxBuilder(cfg, "default", queues)
    members = [make_job(F, i, "q0", pc="low", cpu=16, gang="g1", sub=-1.0) for i in range(2)]
    leases = [RunningJob(job=m, node_id=f"n{i}") for i, m in enumerate(members)]
    intruder = make_job(F, 9, "q1", pc="high", cpu=16)
    for b in (port, jaxb):
        b.set_nodes(nodes)
        b.lease_many(leases)
        for m in members:
            b.note_running_gang("q0", "g1", m.id)
        b.submit(intruder)
    bundle, sctx = port.assemble_delta()
    assert sctx.gang_members is None and sctx.running_gangs
    cache = DeviceDeltaCache(device="cpu")
    # device_problem as a thunk: the apply runs inside the round
    _, sout = run_round_on_device(bundle.stats_view(), sctx, cfg, device="cpu",
                                  device_problem=lambda: cache.apply(bundle),
                                  host_problem=bundle.materialize)
    jbundle, jctx = jaxb.assemble_delta()
    _, jout = jax_run_round(jbundle.stats_view(), jctx, cfg,
                            device_problem=JaxCache().apply(jbundle))
    assert sorted(sout.preempted) == ["j0", "j1"], sout.preempted
    assert "j9" in sout.scheduled
    assert sout.scheduled == jout.scheduled
    assert sorted(sout.preempted) == sorted(jout.preempted)


def test_cpu_wrappers_take_the_plain_version_and_count_nothing():
    from armada_tpu_torch import kernels
    from armada_tpu_torch.kernels.explain import explain_round
    from armada_tpu_torch.kernels.verify import verify_round
    from armada_tpu_torch.models import explain as X
    from armada_tpu_torch.models import verify as V
    from armada_tpu_torch.models.fair_scheduler import compact_result_plain, schedule_round
    from armada_tpu_torch.models.synthetic import synthetic_problem

    kernels.reset_launches()
    problem, meta = synthetic_problem(num_nodes=20, num_gangs=60, num_queues=3, num_runs=5)
    dp = problem_from_numpy(problem, "cpu")
    res = schedule_round(dp, **meta, device="cpu")
    kernels.reset_launches()
    compact = compact_result_plain(res, 60, 5, fcap=8, ecap=4)
    vin = V.verify_inputs(dp, res, compact, 60)
    assert torch.equal(verify_round(*vin), V.verify_kernel_plain(*vin))
    xin = X.explain_inputs(dp, res, 60)
    assert torch.equal(explain_round(*xin, kcap=2, fcap=4),
                       X.explain_kernel_plain(*xin, kcap=2, fcap=4))
    cfg = make_config()
    F, nodes, queues = make_world(cfg, None)
    b = IncrementalBuilder(cfg, "default", queues)
    b.set_nodes(nodes)
    b.submit_many([make_job(F, i, "q0") for i in range(5)])
    cache = DeviceDeltaCache(device="cpu")
    cache.apply(b.assemble_delta()[0])
    b.submit_many([make_job(F, 9, "q1")])
    cache.apply(b.assemble_delta()[0])
    assert cache.last_apply == "scatter"
    assert all(n == 0 for n in kernels.LAUNCHES.values()), kernels.LAUNCHES


def test_caches_need_a_card_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError):
        DeviceDeltaCache()
    with pytest.raises(RuntimeError):
        DeviceProblemCache()
