"""The port's event schema (armada_tpu_torch.events.schema) against protobuf.

The JAX package's events are protobuf messages generated from events.proto;
the port builds its own classes from its copy of the file. For every
message type, hypothesis-generated messages are built in both packages from
the same field values: the port's deterministic bytes must equal protobuf's
byte for byte, and each package must parse the other's bytes to an equal
message. Edge cases (negative int64, set-but-empty sub-messages, every
oneof member, empty and multi-key maps, packed ports, unknown fields) and
the proto3 behaviours the service relies on are held one by one, and the
conversions of events/convert.py are held against the JAX package's.
"""

from __future__ import annotations

import filecmp
from pathlib import Path

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from armada_tpu.events import events_pb2 as jpb
from armada_tpu_torch.events import schema as tpb

REPO = Path(__file__).resolve().parent.parent
NAMES = sorted(tpb.MESSAGES)

_INTS = {
    "int32": (-(1 << 31), (1 << 31) - 1), "int64": (-(1 << 63), (1 << 63) - 1),
    "uint32": (0, (1 << 32) - 1), "uint64": (0, (1 << 64) - 1),
    "sint32": (-(1 << 31), (1 << 31) - 1), "sint64": (-(1 << 63), (1 << 63) - 1),
}


def _scalar(t: str):
    if t in _INTS:
        lo, hi = _INTS[t]
        return st.one_of(st.sampled_from([0, 1, -1 if lo < 0 else 2, lo, hi]),
                         st.integers(lo, hi))
    if t == "bool":
        return st.booleans()
    if t == "double":
        return st.one_of(st.sampled_from([0.0, -0.0, 1.5, float("inf")]),
                         st.floats(allow_nan=False))
    if t == "string":
        return st.text(max_size=6)
    if t == "bytes":
        return st.binary(max_size=6)
    raise AssertionError(t)


def _fields(name: str) -> dict:
    """A strategy for the keyword arguments of one message (a dict of field
    values, at most one member of each oneof, sub-messages as dicts)."""
    desc = tpb.MESSAGES[name].DESCRIPTOR
    plain = {}
    for f in desc.fields:
        if f.oneof is not None:
            continue
        if f.kind == "map":
            plain[f.name] = st.dictionaries(_scalar(f.key_type), _scalar(f.type), max_size=4)
        elif f.kind == "message":
            sub = st.deferred(lambda t=f.type: _fields(t))
            plain[f.name] = st.lists(sub, max_size=2) if f.repeated else sub
        elif f.repeated:
            plain[f.name] = st.lists(_scalar(f.type), max_size=4)
        else:
            plain[f.name] = _scalar(f.type)
    body = st.fixed_dictionaries({}, optional=plain)
    for oneof, members in desc.oneofs.items():
        choices = [st.just({})] + [
            st.deferred(lambda t=desc.fields_by_name[m].type: _fields(t)).map(
                lambda v, m=m: {m: v})
            for m in members
        ]
        body = st.tuples(body, st.one_of(choices)).map(lambda p: {**p[0], **p[1]})
    return body


def _both(name: str, kw: dict):
    return getattr(jpb, name)(**kw), getattr(tpb, name)(**kw)


def _held(j, t) -> None:
    jb = j.SerializeToString(deterministic=True)
    assert t.SerializeToString(deterministic=True) == jb
    assert type(t).FromString(jb) == t
    assert type(j).FromString(t.SerializeToString()) == j
    assert type(j).FromString(t.SerializeToString(deterministic=True)) == j


def test_schema_is_a_copy_of_the_jax_packages_proto():
    assert filecmp.cmp(REPO / "armada_tpu/events/events.proto",
                       REPO / "armada_tpu_torch/events/events.proto", shallow=False)
    assert set(NAMES) == {d.name for d in jpb.DESCRIPTOR.message_types_by_name.values()}
    for name in NAMES:
        jd = getattr(jpb, name).DESCRIPTOR
        td = tpb.MESSAGES[name].DESCRIPTOR
        assert {f.name: f.number for f in jd.fields} == {f.name: f.number for f in td.fields}
        assert {o.name: [f.name for f in o.fields] for o in jd.oneofs} == td.oneofs


@pytest.mark.parametrize("name", NAMES)
@settings(max_examples=30, deadline=None, suppress_health_check=list(HealthCheck))
@given(data=st.data())
def test_random_messages_are_wire_equal(name, data):
    kw = data.draw(_fields(name))
    _held(*_both(name, kw))


def test_negative_ints_take_ten_bytes():
    j, t = _both("JobSpec", dict(priority=-1, gang_cardinality=-(1 << 31)))
    _held(j, t)
    assert t.SerializeToString() == bytes.fromhex("10" + "ff" * 9 + "01" + "38" + "80808080f8ffffffff01")


@pytest.mark.parametrize("kw", [
    dict(spec={}), dict(spec={"resources": {}}), dict(job_id="a", spec={"resources": {"milli": {}}}),
], ids=["spec", "resources", "empty-milli"])
def test_set_empty_sub_messages_are_encoded(kw):
    j, t = _both("SubmitJob", kw)
    _held(j, t)
    assert t.HasField("spec") and t.SerializeToString() != tpb.SubmitJob(job_id=t.job_id).SerializeToString()
    assert t != tpb.SubmitJob(job_id=t.job_id)


@pytest.mark.parametrize("member", tpb.Event.DESCRIPTOR.oneofs["event"])
def test_every_oneof_member(member):
    j, t = _both("Event", {"created_ns": 7, member: {}})
    _held(j, t)
    assert t.WhichOneof("event") == member and t.HasField(member) and t.HasField("event")
    # A write into an unset member selects it and clears the previous one.
    t2 = tpb.Event(submit_job={"job_id": "x"})
    j2 = jpb.Event(submit_job={"job_id": "x"})
    sub_t, sub_j = getattr(t2, member), getattr(j2, member)
    f = tpb.MESSAGES[type(sub_t).__name__].DESCRIPTOR.fields[0]
    value = {"string": "v", "int64": 3, "int32": 3, "double": 0.5, "bool": True}.get(f.type)
    if f.kind == "scalar" and not f.repeated:
        setattr(sub_t, f.name, value)
        setattr(sub_j, f.name, value)
    elif f.kind == "message":
        getattr(sub_t, f.name).SetInParent()
        getattr(sub_j, f.name).SetInParent()
    else:
        getattr(sub_t, f.name).extend(["q"])
        getattr(sub_j, f.name).extend(["q"])
    assert t2.WhichOneof("event") == j2.WhichOneof("event") == member
    _held(j2, t2)


@pytest.mark.parametrize("name,kw", [
    ("Resources", dict(milli={})),
    ("Resources", dict(milli={"cpu": 0})),
    ("Resources", dict(milli={"cpu": 4000, "memory": -1, "nvidia.com/gpu": 1 << 40, "": 5})),
    ("JobSpec", dict(node_selector={"b": "1", "a": "", "ab": "x", "B": "y"},
                     annotations={"k": "v"}, labels={"z": "1", "é": "2"})),
    ("StandaloneIngressInfo", dict(addresses={0: "", 5: "x", 300: "h:1", (1 << 32) - 1: "m"})),
    ("QueueUpsert", dict(name="q", weight=2.5, labels={"team": "a", "tier": "b"})),
], ids=["empty", "zero-value", "multi", "string-maps", "uint32-keys", "queue"])
def test_maps(name, kw):
    _held(*_both(name, kw))


@pytest.mark.parametrize("ports", [[], [0], [1, 300, (1 << 32) - 1]], ids=["none", "zero", "three"])
def test_packed_ports(ports):
    j, t = _both("ServiceSpec", dict(type="NodePort", ports=ports))
    _held(j, t)
    j2, t2 = _both("IngressSpec", dict(ports=ports, tls_enabled=True))
    _held(j2, t2)
    if ports:
        data = t.SerializeToString()
        assert data[data.index(0x12) + 1] == len(b"".join(
            tpb._varint_bytes(p) for p in ports))
    # Unpacked encodings (an older writer) parse to the same list.
    unpacked = b"".join(b"\x10" + tpb._varint_bytes(p) for p in ports)
    assert list(tpb.ServiceSpec.FromString(unpacked).ports) == ports
    assert list(jpb.ServiceSpec.FromString(unpacked).ports) == ports


def test_unknown_fields_are_skipped():
    known = tpb.JobSucceeded(job_id="j").SerializeToString()
    extra = (known + b"\xa0\x06\x05" + b"\xaa\x06\x03abc" + b"\xa9\x06" + b"\0" * 8
             + b"\xad\x06" + b"\0" * 4)
    assert tpb.JobSucceeded.FromString(extra) == tpb.JobSucceeded(job_id="j")
    assert jpb.JobSucceeded.FromString(extra).job_id == "j"


@pytest.mark.parametrize("data", [b"\x0a\x05ab", b"\x08", b"\x0a\x02\xff\xfe", b"\x0f"],
                         ids=["short-string", "short-varint", "bad-utf8", "bad-wire-type"])
def test_bad_bytes_raise(data):
    with pytest.raises(tpb.DecodeError):
        tpb.JobSucceeded.FromString(data)


def test_proto3_behaviours_match_protobuf():
    for P in (jpb, tpb):
        ev = P.Event()
        sub = ev.submit_job
        assert not ev.HasField("submit_job") and ev.WhichOneof("event") is None
        sub.spec.resources.milli["cpu"] = 5
        assert ev.WhichOneof("event") == "submit_job" and ev.submit_job.spec.resources.milli["cpu"] == 5
        ev.cancel_job.job_id = "c"
        assert ev.WhichOneof("event") == "cancel_job" and not ev.HasField("submit_job")
        with pytest.raises(ValueError):
            ev.HasField("created_ns")
        with pytest.raises(AttributeError):
            ev.cancel_job = P.CancelJob()
        r = P.Resources()
        assert r.milli["missing"] == 0 and dict(r.milli) == {"missing": 0}
        spec = P.JobSpec(pools=["a"])
        spec.pools.append("b")
        spec.pools.extend(["c"])
        spec.tolerations.add(key="k")
        spec.tolerations.append(P.Toleration(key="k2"))
        assert list(spec.pools) == ["a", "b", "c"] and len(spec.tolerations) == 2
        with pytest.raises(AttributeError):
            spec.pools = ["x"]
        with pytest.raises(TypeError):
            P.JobSpec(priority=1.5)
        with pytest.raises(ValueError):
            P.JobSpec(gang_cardinality=1 << 31)
        copy = P.JobSpec()
        copy.CopyFrom(spec)
        assert copy == spec and copy is not spec
        copy.pools.append("d")
        assert copy != spec
        seq = P.EventSequence(queue="q", events=[P.Event(created_ns=1)])
        seq.events.append(P.Event(created_ns=2))
        assert [e.created_ns for e in seq.events] == [1, 2]
        parsed = P.EventSequence()
        assert parsed.ParseFromString(seq.SerializeToString()) == len(seq.SerializeToString())
        assert parsed == seq
        ev = P.Event(job_run_errors=P.JobRunErrors(job_id="j"))
        getattr(ev, "job_run_errors").errors.add(reason="r")
        assert ev.job_run_errors.errors[0].reason == "r"
        # A message passed to a constructor or appended is copied: later
        # writes to the original do not reach the new message.
        sub = P.SubmitJob(job_id="a", spec=P.JobSpec(priority=1))
        ev = P.Event(submit_job=sub)
        seq = P.EventSequence(events=[ev])
        seq.events.append(ev)
        sub.job_id = "b"
        sub.spec.priority = 2
        ev.created_ns = 9
        assert ev.submit_job.job_id == "a" and ev.submit_job.spec.priority == 1
        assert [e.created_ns for e in seq.events] == [0, 0]


def _job_specs(P, factory, rng):
    """The same random JobSpecs in one package's types (every field set on
    some of them)."""
    T = P.types
    out = []
    for i in range(40):
        kw = dict(id=f"job-{i}", queue=f"q{i % 3}", jobset=f"js{i % 2}",
                  priority_class=["", "armada-default", "armada-preemptible"][i % 3],
                  priority=int(rng.integers(-5, 1000)),
                  resources=factory.from_mapping({"cpu": str(int(rng.integers(0, 64))),
                                                  "memory": f"{int(rng.integers(0, 512))}Gi"}))
        if i % 2:
            kw.update(node_selector={"zone": f"z{i % 4}"}, labels={"team": "a"},
                      annotations={"note": "x"},
                      tolerations=(T.Toleration(key="gpu", operator="Exists", effect="NoSchedule"),))
        if i % 3 == 0:
            kw.update(gang_id=f"g{i}", gang_cardinality=3, gang_node_uniformity_label="rack",
                      pools=("default", "other"), price_band="B", namespace="ns")
        if i % 5 == 0:
            kw.update(services=(T.ServiceSpec(type="Headless", ports=(80, 443), name="s"),),
                      ingress=(T.IngressSpec(ports=(8080,), annotations={"a": "b"},
                                             tls_enabled=True, cert_name="c"),),
                      node_type_scores=(("a100", 2.0), ("h100", 3.5)))
        out.append(T.JobSpec(**kw))
    return out


def test_job_spec_conversions_match_the_jax_package():
    from types import SimpleNamespace

    import armada_tpu.core.config as jc
    import armada_tpu.core.types as jt
    import armada_tpu.events.convert as jconv
    import armada_tpu_torch.core.config as tc
    import armada_tpu_torch.core.types as tt
    import armada_tpu_torch.events.convert as tconv

    jf = jc.SchedulingConfig().resource_list_factory()
    tf = tc.SchedulingConfig().resource_list_factory()
    jspecs = _job_specs(SimpleNamespace(types=jt), jf, np.random.default_rng(5))
    tspecs = _job_specs(SimpleNamespace(types=tt), tf, np.random.default_rng(5))
    for js, ts in zip(jspecs, tspecs):
        jb = jconv.job_spec_to_proto(js).SerializeToString(deterministic=True)
        tb = tconv.job_spec_to_proto(ts).SerializeToString(deterministic=True)
        assert tb == jb
        back_j = jconv.job_spec_from_proto(js.id, js.queue, js.jobset,
                                           jpb.JobSpec.FromString(tb), jf, submit_time=3.0)
        back_t = tconv.job_spec_from_proto(ts.id, ts.queue, ts.jobset,
                                           tpb.JobSpec.FromString(jb), tf, submit_time=3.0)
        for field in ("id", "queue", "jobset", "priority_class", "priority", "submit_time",
                      "node_selector", "gang_id", "gang_cardinality", "pools", "price_band",
                      "namespace", "annotations", "labels", "node_type_scores"):
            assert getattr(back_t, field) == getattr(back_j, field), field
        assert list(back_t.resources.atoms) == list(back_j.resources.atoms)
        assert [dataclass_tuple(x) for x in back_t.tolerations] == [
            dataclass_tuple(x) for x in back_j.tolerations]
        assert [dataclass_tuple(x) for x in back_t.services + back_t.ingress] == [
            dataclass_tuple(x) for x in back_j.services + back_j.ingress]


def dataclass_tuple(x):
    import dataclasses

    return tuple(
        tuple(sorted(v.items())) if isinstance(v, dict) else v
        for v in (getattr(x, f.name) for f in dataclasses.fields(x))
    )
