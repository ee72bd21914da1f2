"""The event schema of events.proto as plain Python message classes.

The port runs where no protobuf runtime is installed, so it carries its own
message classes for events.proto: the file beside this module is parsed at
import (the proto3 subset the schema uses: messages with scalar, message,
repeated and map fields and oneofs) and one class a message is made from it.
The module reads like a generated ``events_pb2``: ``pb.Event``,
``pb.EventSequence`` and the rest are its attributes.

The classes behave as protobuf's proto3 messages do where the service uses
them, and their bytes are protobuf's:

- constructors take keyword arguments (a sub-message, a dict, a list, None);
- scalars have implicit presence: a default value is not encoded;
- reading an unset sub-message gives a default instance bound to its parent,
  and the first write into it makes it present (selecting the member of its
  oneof); setting one member of a oneof clears the others;
- repeated fields (``append``, ``extend``, ``add``) and maps (``milli``,
  labels, annotations; reading a missing key of a scalar map inserts the
  default, as protobuf's does);
- ``CopyFrom``, ``MergeFrom``, ``ClearField``, ``HasField``, ``WhichOneof``,
  equality, ``SerializeToString(deterministic=...)``, ``FromString``,
  ``ParseFromString``;
- the encoding: fields in number order, varints (a negative int32/int64 as
  ten bytes), zigzag for sint*, double as fixed64 (its bits decide
  presence, so -0.0 is encoded), packed repeated numerics, map entries as
  messages of key 1 and value 2 (both always written; when deterministic,
  in the order protobuf's runtime writes them, see `_map_order`). Parsing skips unknown fields and accepts packed and
  unpacked repeated numerics.
"""

from __future__ import annotations

import os
import re
import struct
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
PROTO_PATH = os.path.join(_HERE, "events.proto")


class DecodeError(Exception):
    """The bytes are not a valid encoding of the message."""


# --- the .proto parser (the subset events.proto uses) -----------------------

_SCALARS = (
    "double", "float", "int64", "uint64", "int32", "fixed64", "fixed32",
    "bool", "string", "bytes", "uint32", "sfixed32", "sfixed64", "sint32",
    "sint64",
)
_WIRE = {
    "double": 1, "fixed64": 1, "sfixed64": 1,
    "float": 5, "fixed32": 5, "sfixed32": 5,
    "string": 2, "bytes": 2,
}  # every other scalar is a varint (0)


def _strip_comments(text: str) -> str:
    text = re.sub(r"/\*.*?\*/", "", text, flags=re.S)
    return re.sub(r"//[^\n]*", "", text)


def _tokenize(text: str) -> list:
    return re.findall(r"[A-Za-z0-9_.]+|\"[^\"]*\"|[{}=;<>,]", text)


class _Tokens:
    def __init__(self, toks: list):
        self.toks = toks
        self.i = 0

    def peek(self) -> str:
        return self.toks[self.i] if self.i < len(self.toks) else ""

    def next(self) -> str:
        t = self.peek()
        self.i += 1
        return t

    def expect(self, t: str) -> None:
        got = self.next()
        if got != t:
            raise ValueError(f"expected {t!r}, got {got!r}")

    def skip_block(self) -> None:
        self.expect("{")
        depth = 1
        while depth:
            t = self.next()
            if not t:
                raise ValueError("unbalanced block")
            depth += t == "{"
            depth -= t == "}"


class FieldDescriptor:
    """One field: `kind` is "scalar", "message", "map"; `type` the scalar
    name or the message name; for maps `key_type` and `type` (the value)."""

    __slots__ = ("name", "number", "kind", "type", "key_type", "repeated",
                 "oneof", "message_type", "new_container")

    def __init__(self, name, number, kind, type_, repeated=False, key_type=None):
        self.name = name
        self.number = number
        self.kind = kind
        self.type = type_
        self.key_type = key_type
        self.repeated = repeated
        self.oneof = None
        self.message_type = None  # the class, for message fields and message maps
        self.new_container = None  # owner -> an empty container (repeated and map fields)

    def __repr__(self) -> str:
        return f"FieldDescriptor({self.name!r}, {self.number})"


class Descriptor:
    """A message type: its fields (in declaration order) and oneofs."""

    def __init__(self, name: str, full_name: str):
        self.name = name
        self.full_name = full_name
        self.fields: list = []
        self.fields_by_name: dict = {}
        self.fields_by_number: dict = {}
        self.oneofs: dict = {}  # oneof name -> [field names]
        self.by_number: list = []  # the fields in number order (encoding order)


def parse_proto(text: str) -> tuple:
    """(package, [Descriptor]) of a proto3 file in the supported subset."""
    tk = _Tokens(_tokenize(_strip_comments(text)))
    package = ""
    messages: list = []
    while tk.peek():
        t = tk.next()
        if t == "syntax":
            tk.expect("=")
            if tk.next() != '"proto3"':
                raise ValueError("only proto3 is supported")
            tk.expect(";")
        elif t == "package":
            package = tk.next()
            tk.expect(";")
        elif t == "import":
            raise ValueError("imports are not supported")
        elif t == "option":
            while tk.next() != ";":
                pass
        elif t == "service":
            tk.next()
            tk.skip_block()
        elif t == "message":
            messages.append(_parse_message(tk, package))
        else:
            raise ValueError(f"unsupported top-level token {t!r}")
    names = {d.name for d in messages}
    for d in messages:
        for f in d.fields:
            if f.kind != "scalar" or f.type in _SCALARS:
                if f.kind == "map" and f.type not in _SCALARS and f.type not in names:
                    raise ValueError(f"unknown type {f.type!r} in {d.name}.{f.name}")
                continue
            if f.type not in names:
                raise ValueError(f"unknown type {f.type!r} in {d.name}.{f.name}")
            f.kind = "message"
    return package, messages


def _parse_message(tk: _Tokens, package: str) -> Descriptor:
    name = tk.next()
    d = Descriptor(name, f"{package}.{name}" if package else name)
    tk.expect("{")
    while True:
        t = tk.next()
        if t == "}":
            return d
        if t == "oneof":
            oneof = tk.next()
            d.oneofs[oneof] = []
            tk.expect("{")
            while tk.peek() != "}":
                f = _parse_field(tk, d, tk.next())
                f.oneof = oneof
                d.oneofs[oneof].append(f.name)
            tk.expect("}")
        elif t in ("message", "enum", "reserved", "extensions", "optional"):
            raise ValueError(f"unsupported construct {t!r} in {d.name}")
        else:
            _parse_field(tk, d, t)


def _parse_field(tk: _Tokens, d: Descriptor, first: str) -> FieldDescriptor:
    repeated = first == "repeated"
    if repeated:
        first = tk.next()
    if first == "map":
        tk.expect("<")
        key_t = tk.next()
        tk.expect(",")
        val_t = tk.next()
        tk.expect(">")
        if key_t not in _SCALARS or key_t in ("double", "float", "bytes"):
            raise ValueError(f"unsupported map<{key_t}, {val_t}>")
        f = FieldDescriptor(tk.next(), 0, "map", val_t, key_type=key_t)
    else:
        f = FieldDescriptor(tk.next(), 0, "scalar", first, repeated=repeated)
    tk.expect("=")
    f.number = int(tk.next())
    tk.expect(";")
    if f.name in d.fields_by_name or f.number in d.fields_by_number:
        raise ValueError(f"duplicate field {f.name} = {f.number} in {d.name}")
    d.fields.append(f)
    d.fields_by_name[f.name] = f
    d.fields_by_number[f.number] = f
    return f


# --- scalar values: defaults, checks, wire codecs --------------------------

_INT_RANGES = {
    "int32": (-(1 << 31), (1 << 31) - 1), "sint32": (-(1 << 31), (1 << 31) - 1),
    "sfixed32": (-(1 << 31), (1 << 31) - 1),
    "int64": (-(1 << 63), (1 << 63) - 1), "sint64": (-(1 << 63), (1 << 63) - 1),
    "sfixed64": (-(1 << 63), (1 << 63) - 1),
    "uint32": (0, (1 << 32) - 1), "fixed32": (0, (1 << 32) - 1),
    "uint64": (0, (1 << 64) - 1), "fixed64": (0, (1 << 64) - 1),
}
_F32 = struct.Struct("<f")
_F64 = struct.Struct("<d")
_I32 = struct.Struct("<i")
_U32 = struct.Struct("<I")
_I64 = struct.Struct("<q")
_U64 = struct.Struct("<Q")


def _default(t: str):
    if t in ("double", "float"):
        return 0.0
    if t == "bool":
        return False
    if t == "string":
        return ""
    if t == "bytes":
        return b""
    return 0


def _checker(t: str):
    """A function that checks and normalizes a value for scalar type `t`
    (TypeError / ValueError as protobuf's runtime raises them)."""
    if t in _INT_RANGES:
        lo, hi = _INT_RANGES[t]

        def check_int(v):
            if not isinstance(v, int):
                try:
                    v = v.__index__()
                except AttributeError:
                    raise TypeError(
                        f"'{type(v).__name__}' object cannot be interpreted as an integer"
                    ) from None
            if v < lo or v > hi:
                raise ValueError(f"Value out of range: {v}")
            return int(v)

        return check_int
    if t == "double":
        def check_double(v):
            if isinstance(v, (str, bytes)) or not hasattr(v, "__float__"):
                raise TypeError(f"'{type(v).__name__}' object cannot be interpreted as a float")
            return float(v)

        return check_double
    if t == "float":
        def check_float(v):
            if isinstance(v, (str, bytes)) or not hasattr(v, "__float__"):
                raise TypeError(f"'{type(v).__name__}' object cannot be interpreted as a float")
            return _F32.unpack(_F32.pack(float(v)))[0]

        return check_float
    if t == "bool":
        def check_bool(v):
            if not isinstance(v, int) and not hasattr(v, "__index__"):
                raise TypeError(f"'{type(v).__name__}' object cannot be interpreted as a bool")
            return bool(v)

        return check_bool
    if t == "string":
        def check_str(v):
            if isinstance(v, str):
                return v
            if isinstance(v, bytes):
                try:
                    return v.decode("utf-8")
                except UnicodeDecodeError:
                    raise ValueError(f"{v!r} has type bytes, but isn't valid UTF-8") from None
            raise TypeError(f"{v!r} has type {type(v).__name__}, but expected one of: bytes, str")

        return check_str
    if t == "bytes":
        def check_bytes(v):
            if isinstance(v, (bytes, bytearray)):
                return bytes(v)
            raise TypeError(f"{v!r} has type {type(v).__name__}, but expected one of: bytes")

        return check_bytes
    raise ValueError(f"unknown scalar type {t!r}")


def _put_varint(out: bytearray, v: int) -> None:
    if 0 <= v < 0x80:
        out.append(v)
        return
    if v < 0:
        v += 1 << 64
    while v > 0x7F:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)


def _varint_bytes(v: int) -> bytes:
    out = bytearray()
    _put_varint(out, v)
    return bytes(out)


def _get_varint(data, pos: int) -> tuple:
    n = len(data)
    if pos < n and data[pos] < 0x80:
        return data[pos], pos + 1
    result = 0
    shift = 0
    while True:
        if pos >= n:
            raise DecodeError("truncated varint")
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift >= 70:
            raise DecodeError("varint too long")


def _encoder(t: str):
    """(put(out, value), present(value)) for scalar type `t`."""
    if t in ("int32", "int64", "uint32", "uint64"):
        return _put_varint, bool
    if t == "bool":
        return (lambda out, v: out.append(1 if v else 0)), bool
    if t in ("sint32", "sint64"):
        bits = 31 if t == "sint32" else 63

        def put_zigzag(out, v):
            _put_varint(out, (v << 1) ^ (v >> bits))

        return put_zigzag, bool
    if t == "double":
        return (lambda out, v: out.extend(_F64.pack(v))), (lambda v: _F64.pack(v) != b"\0" * 8)
    if t == "float":
        return (lambda out, v: out.extend(_F32.pack(v))), (lambda v: _F32.pack(v) != b"\0" * 4)
    fixed = {"fixed32": _U32, "sfixed32": _I32, "fixed64": _U64, "sfixed64": _I64}
    if t in fixed:
        s = fixed[t]
        return (lambda out, v: out.extend(s.pack(v))), bool
    if t == "string":
        def put_str(out, v):
            b = v.encode("utf-8")
            _put_varint(out, len(b))
            out.extend(b)

        return put_str, bool
    if t == "bytes":
        def put_bytes(out, v):
            _put_varint(out, len(v))
            out.extend(v)

        return put_bytes, bool
    raise ValueError(t)


def _decoder(t: str):
    """get(data, pos) -> (value, pos) for scalar type `t` (wire type _WIRE)."""
    if t in ("int64", "int32"):
        def get_signed(data, pos):
            v, pos = _get_varint(data, pos)
            v &= (1 << 64) - 1
            if t == "int32":
                v &= 0xFFFFFFFF
                return (v - (1 << 32) if v >> 31 else v), pos
            return (v - (1 << 64) if v >> 63 else v), pos

        return get_signed
    if t in ("uint32", "uint64"):
        mask = (1 << (32 if t == "uint32" else 64)) - 1

        def get_unsigned(data, pos):
            v, pos = _get_varint(data, pos)
            return v & mask, pos

        return get_unsigned
    if t == "bool":
        def get_bool(data, pos):
            v, pos = _get_varint(data, pos)
            return v != 0, pos

        return get_bool
    if t in ("sint32", "sint64"):
        mask = (1 << (32 if t == "sint32" else 64)) - 1

        def get_zigzag(data, pos):
            v, pos = _get_varint(data, pos)
            v &= mask
            return (v >> 1) ^ -(v & 1), pos

        return get_zigzag
    fixed = {"double": _F64, "float": _F32, "fixed32": _U32, "sfixed32": _I32,
             "fixed64": _U64, "sfixed64": _I64}
    if t in fixed:
        s = fixed[t]
        size = s.size

        def get_fixed(data, pos):
            end = pos + size
            if end > len(data):
                raise DecodeError("truncated fixed-width value")
            return s.unpack_from(data, pos)[0], end

        return get_fixed
    if t == "string":
        def get_str(data, pos):
            n, pos = _get_varint(data, pos)
            end = pos + n
            if end > len(data):
                raise DecodeError("truncated string")
            try:
                return data[pos:end].decode("utf-8"), end
            except UnicodeDecodeError:
                raise DecodeError("string field is not valid UTF-8") from None

        return get_str
    if t == "bytes":
        def get_bytes(data, pos):
            n, pos = _get_varint(data, pos)
            end = pos + n
            if end > len(data):
                raise DecodeError("truncated bytes")
            return data[pos:end], end

        return get_bytes
    raise ValueError(t)


def _skip(data, pos: int, wire: int, number: int) -> int:
    """Skip one unknown field's value."""
    if wire == 0:
        return _get_varint(data, pos)[1]
    if wire == 1:
        pos += 8
    elif wire == 5:
        pos += 4
    elif wire == 2:
        n, pos = _get_varint(data, pos)
        pos += n
    elif wire == 3:
        while True:
            tag, pos = _get_varint(data, pos)
            if tag & 7 == 4:
                if tag >> 3 != number:
                    raise DecodeError("mismatched end group")
                return pos
            pos = _skip(data, pos, tag & 7, tag >> 3)
    else:
        raise DecodeError(f"invalid wire type {wire}")
    if pos > len(data):
        raise DecodeError("truncated field")
    return pos


# --- containers -------------------------------------------------------------


class RepeatedScalarContainer:
    """A repeated scalar field: a checked list that marks its owner set."""

    __slots__ = ("_owner", "_check", "_items")

    def __init__(self, owner, check):
        self._owner = owner
        self._check = check
        self._items: list = []

    def append(self, v) -> None:
        self._items.append(self._check(v))
        self._owner._touch()

    def extend(self, values) -> None:
        items = [self._check(v) for v in values]
        self._items.extend(items)
        if items:
            self._owner._touch()

    def __len__(self) -> int:
        return len(self._items)

    def __iter__(self):
        return iter(self._items)

    def __getitem__(self, i):
        return self._items[i]

    def __setitem__(self, i, v) -> None:
        if isinstance(i, slice):
            self._items[i] = [self._check(x) for x in v]
        else:
            self._items[i] = self._check(v)
        self._owner._touch()

    def __eq__(self, other) -> bool:
        if isinstance(other, RepeatedScalarContainer):
            return self._items == other._items
        try:
            return self._items == list(other)
        except TypeError:
            return NotImplemented

    __hash__ = None

    def __repr__(self) -> str:
        return repr(self._items)


class RepeatedCompositeContainer:
    """A repeated message field; `append`/`extend` copy, `add` builds."""

    __slots__ = ("_owner", "_cls", "_items")

    def __init__(self, owner, cls):
        self._owner = owner
        self._cls = cls
        self._items: list = []

    def add(self, **kw):
        m = self._cls(**kw)
        self._items.append(m)
        self._owner._touch()
        return m

    def _coerce(self, v):
        if isinstance(v, dict):
            return self._cls(**v)
        if type(v) is not self._cls:
            raise TypeError(
                f"Expected a message of type {self._cls.__name__}, got {type(v).__name__}"
            )
        return v._clone()

    def append(self, v) -> None:
        self._items.append(self._coerce(v))
        self._owner._touch()

    def extend(self, values) -> None:
        items = [self._coerce(v) for v in values]
        self._items.extend(items)
        if items:
            self._owner._touch()

    def __len__(self) -> int:
        return len(self._items)

    def __iter__(self):
        return iter(self._items)

    def __getitem__(self, i):
        return self._items[i]

    def __eq__(self, other) -> bool:
        if isinstance(other, RepeatedCompositeContainer):
            return self._items == other._items
        try:
            return self._items == list(other)
        except TypeError:
            return NotImplemented

    __hash__ = None

    def __repr__(self) -> str:
        return repr(self._items)


class MapContainer:
    """A map field. A scalar map's missing key reads as its default and is
    inserted (protobuf's ScalarMap); a message map's missing key inserts a
    new message (MessageMap) and refuses assignment."""

    __slots__ = ("_owner", "_check_key", "_check_value", "_cls", "_default", "_d")

    def __init__(self, owner, check_key, check_value, cls, default):
        self._owner = owner
        self._check_key = check_key
        self._check_value = check_value
        self._cls = cls
        self._default = default
        self._d: dict = {}

    def __getitem__(self, key):
        key = self._check_key(key)
        try:
            return self._d[key]
        except KeyError:
            pass
        v = self._cls() if self._cls is not None else self._default
        self._d[key] = v
        self._owner._touch()
        return v

    def __setitem__(self, key, value) -> None:
        if self._cls is not None:
            raise ValueError("May not set values directly, call my_map[key].foo = 5")
        self._d[self._check_key(key)] = self._check_value(value)
        self._owner._touch()

    def _put(self, key, value) -> None:
        key = self._check_key(key)
        if self._cls is None:
            self._d[key] = self._check_value(value)
        elif isinstance(value, dict):
            self._d[key] = self._cls(**value)
        elif type(value) is self._cls:
            self._d[key] = value._clone()
        else:
            raise TypeError(f"Expected a message of type {self._cls.__name__}, "
                            f"got {type(value).__name__}")

    def update(self, other=(), **kw) -> None:
        items = other.items() if hasattr(other, "items") else other
        n = 0
        for k, v in items:
            self._put(k, v)
            n += 1
        for k, v in kw.items():
            self._put(k, v)
            n += 1
        if n:
            self._owner._touch()

    def get(self, key, default=None):
        return self._d.get(key, default)

    def __contains__(self, key) -> bool:
        return key in self._d

    def keys(self):
        return self._d.keys()

    def values(self):
        return self._d.values()

    def items(self):
        return self._d.items()

    def __len__(self) -> int:
        return len(self._d)

    def __iter__(self):
        return iter(self._d)

    def __eq__(self, other) -> bool:
        if isinstance(other, MapContainer):
            return self._d == other._d
        if isinstance(other, dict):
            return self._d == other
        return NotImplemented

    __hash__ = None

    def __repr__(self) -> str:
        return repr(self._d)


# --- the message base -------------------------------------------------------


class Message:
    """The base of every message class (see the module docstring)."""

    __slots__ = ("_f", "_which", "_parent", "_pfield")
    DESCRIPTOR: Descriptor

    # filled per class by _make_classes
    _fields: dict = {}
    _inits: dict = {}
    _encoders: tuple = ()
    _decoders: dict = {}

    def __init__(self, **kw):
        self._f = {}
        self._which = None
        self._parent = None
        self._pfield = None
        if kw:
            inits = self._inits
            for name, value in kw.items():
                if value is None:
                    continue
                init = inits.get(name)
                if init is None:
                    raise ValueError(
                        f'Protocol message {type(self).__name__} has no "{name}" field.'
                    )
                init(self, value)

    def _clone(self):
        """A deep copy: what protobuf's copy on assignment makes."""
        m = _blank(type(self))
        if self._which:
            m._which = dict(self._which)
        f = m._f
        for name, v in self._f.items():
            t = type(v)
            if t in _PLAIN:
                pass
            elif t is RepeatedScalarContainer:
                c = RepeatedScalarContainer(m, v._check)
                c._items = v._items.copy()
                v = c
            elif t is RepeatedCompositeContainer:
                c = RepeatedCompositeContainer(m, v._cls)
                c._items = [x._clone() for x in v._items]
                v = c
            elif t is MapContainer:
                c = MapContainer(m, v._check_key, v._check_value, v._cls, v._default)
                c._d = (v._d.copy() if v._cls is None
                        else {k: x._clone() for k, x in v._d.items()})
                v = c
            elif isinstance(v, Message):
                v = v._clone()
            f[name] = v
        return m

    # -- presence plumbing --

    def _touch(self) -> None:
        """A write into this message: make it present in its parent."""
        parent = self._parent
        if parent is not None:
            self._parent = None
            parent._attach(parent._fields[self._pfield], self)

    def _attach(self, f: FieldDescriptor, child) -> None:
        if f.oneof is not None:
            self._select(f)
        child._parent = None
        self._f[f.name] = child
        self._touch()

    def _select(self, f: FieldDescriptor) -> None:
        which = self._which
        if which is None:
            self._which = which = {}
        old = which.get(f.oneof)
        if old is not None and old != f.name:
            self._f.pop(old, None)
        which[f.oneof] = f.name

    def _container(self, f: FieldDescriptor):
        c = self._f.get(f.name)
        if c is None:
            c = self._f[f.name] = f.new_container(self)
        return c

    # -- the protobuf message API --

    def HasField(self, name: str) -> bool:
        desc = self.DESCRIPTOR
        if name in desc.oneofs:
            return bool(self._which) and name in self._which
        f = self._fields.get(name)
        if f is None:
            raise ValueError(f'Protocol message has no "{name}" field.')
        if f.repeated or f.kind == "map":
            raise ValueError(f'Protocol message has no singular "{name}" field.')
        if f.kind == "message" or f.oneof is not None:
            return name in self._f
        raise ValueError(f'Can\'t test non-optional, non-submessage field "{name}" for presence '
                         "in proto3.")

    def WhichOneof(self, oneof: str):
        if oneof not in self.DESCRIPTOR.oneofs:
            raise ValueError(f'Protocol message has no oneof "{oneof}" field.')
        if not self._which:
            return None
        return self._which.get(oneof)

    def ClearField(self, name: str) -> None:
        desc = self.DESCRIPTOR
        if name in desc.oneofs:
            member = self._which.pop(name, None) if self._which else None
            if member is not None:
                self._f.pop(member, None)
            return
        f = self._fields.get(name)
        if f is None:
            raise ValueError(f'Protocol message has no "{name}" field.')
        self._f.pop(name, None)
        if f.oneof is not None and self._which and self._which.get(f.oneof) == name:
            del self._which[f.oneof]

    def Clear(self) -> None:
        self._f = {}
        self._which = None

    def SetInParent(self) -> None:
        self._touch()

    def ListFields(self) -> list:
        out = []
        for f in self.DESCRIPTOR.by_number:
            v = self._f.get(f.name)
            if v is None:
                continue
            if f.kind == "map" or f.repeated:
                if not len(v):
                    continue
            elif f.kind == "scalar" and f.oneof is None and not _PRESENT[f.type](v):
                continue
            out.append((f, v))
        return out

    def MergeFrom(self, other) -> None:
        if type(other) is not type(self):
            raise TypeError(
                f"Parameter to MergeFrom() must be instance of same class: expected "
                f"{type(self).__name__} got {type(other).__name__}."
            )
        if other is self:
            other = type(self).FromString(self.SerializeToString())
        for f, v in other.ListFields():
            if f.kind == "map":
                self._container(f).update(v)
            elif f.repeated:
                self._container(f).extend(v)
            elif f.kind == "message":
                mine = self._f.get(f.name)
                if mine is None:
                    self._attach(f, v._clone())
                else:
                    mine.MergeFrom(v)
            else:
                setattr(self, f.name, v)
        if other._f:
            self._touch()

    def CopyFrom(self, other) -> None:
        if other is self:
            return
        if type(other) is not type(self):
            raise TypeError(
                f"Parameter to CopyFrom() must be instance of same class: expected "
                f"{type(self).__name__} got {type(other).__name__}."
            )
        copy = other._clone()
        self._f = copy._f
        self._which = copy._which
        for v in self._f.values():
            if type(v) in _CONTAINERS:
                v._owner = self
        self._touch()

    def SerializeToString(self, deterministic: bool = False) -> bytes:
        out = bytearray()
        self._encode(out, deterministic)
        return bytes(out)

    def _encode(self, out: bytearray, deterministic: bool) -> None:
        values = self._f
        if not values:
            return
        for name, enc in self._encoders:
            v = values.get(name)
            if v is not None:
                enc(out, v, deterministic)

    @classmethod
    def FromString(cls, data):
        m = _blank(cls)
        data = bytes(data)
        try:
            m._decode(data, 0, len(data))
        except IndexError:
            raise DecodeError("truncated message") from None
        return m

    def ParseFromString(self, data) -> int:
        self.Clear()
        return self.MergeFromString(data)

    def MergeFromString(self, data) -> int:
        data = bytes(data)
        try:
            self._decode(data, 0, len(data))
        except IndexError:
            raise DecodeError("truncated message") from None
        self._touch()
        return len(data)

    def _decode(self, data, pos: int, end: int) -> None:
        by_number = self._decoders
        while pos < end:
            tag = data[pos]
            if tag < 0x80:
                pos += 1
            else:
                tag, pos = _get_varint(data, pos)
            handler = by_number.get(tag)
            if handler is None:
                number, wire = tag >> 3, tag & 7
                if number == 0:
                    raise DecodeError("field number 0")
                pos = _skip(data, pos, wire, number)
            else:
                pos = handler(self, data, pos)
        if pos != end:
            raise DecodeError("truncated message")

    def __eq__(self, other):
        if not isinstance(other, Message):
            return NotImplemented
        if type(other) is not type(self):
            return False
        a = self.ListFields()
        b = other.ListFields()
        if len(a) != len(b):
            return False
        for (fa, va), (fb, vb) in zip(a, b):
            if fa is not fb or not _field_equal(fa, va, vb):
                return False
        return True

    __hash__ = None

    def __repr__(self) -> str:
        return self._text(0)

    __str__ = __repr__

    def _text(self, indent: int) -> str:
        pad = " " * indent
        lines = []
        for f, v in self.ListFields():
            if f.kind == "map":
                for k in sorted(v):
                    item = v.get(k)
                    inner = f"{pad}  key: {_text_scalar(k)}\n"
                    if f.message_type is not None:
                        inner += f"{pad}  value {{\n{item._text(indent + 4)}{pad}  }}\n"
                    else:
                        inner += f"{pad}  value: {_text_scalar(item)}\n"
                    lines.append(f"{pad}{f.name} {{\n{inner}{pad}}}\n")
            elif f.kind == "message":
                for m in (v if f.repeated else (v,)):
                    lines.append(f"{pad}{f.name} {{\n{m._text(indent + 2)}{pad}}}\n")
            else:
                for x in (v if f.repeated else (v,)):
                    lines.append(f"{pad}{f.name}: {_text_scalar(x)}\n")
        return "".join(lines)


def _blank(cls):
    """A new empty message, without the keyword-argument machinery."""
    m = object.__new__(cls)
    m._f = {}
    m._which = None
    m._parent = None
    m._pfield = None
    return m


def _text_scalar(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, str):
        return '"' + v.encode("unicode_escape").decode("ascii").replace('"', '\\"') + '"'
    if isinstance(v, bytes):
        return '"' + "".join(
            chr(b) if 32 <= b < 127 and b not in (34, 92) else f"\\{b:03o}" for b in v
        ) + '"'
    return repr(v)


def _field_equal(f: FieldDescriptor, a, b) -> bool:
    if f.kind == "map":
        return dict(a.items()) == dict(b.items())
    if f.repeated:
        return list(a) == list(b)
    return a == b


_CHECKERS = {t: _checker(t) for t in _SCALARS}
# the scalar values a message stores as they are (copied by reference)
_PLAIN = frozenset((str, int, float, bool, bytes))
_CONTAINERS = frozenset((RepeatedScalarContainer, RepeatedCompositeContainer, MapContainer))
_PRESENT = {t: _encoder(t)[1] for t in _SCALARS}


# --- class construction -----------------------------------------------------


def _scalar_property(f: FieldDescriptor):
    name = f.name
    check = _CHECKERS[f.type]
    default = _default(f.type)
    if f.oneof is None:
        def fget(self):
            return self._f.get(name, default)

        def fset(self, v):
            self._f[name] = check(v)
            self._touch()
    else:
        def fget(self):
            return self._f.get(name, default)

        def fset(self, v):
            v = check(v)
            self._select(f)
            self._f[name] = v
            self._touch()

    return property(fget, fset)


def _message_property(f: FieldDescriptor):
    name = f.name

    def fget(self):
        v = self._f.get(name)
        if v is None:
            v = f.message_type()
            v._parent = self
            v._pfield = name
        return v

    def fset(self, v):
        raise AttributeError(
            f'Assignment not allowed to field "{name}" in protocol message object.'
        )

    return property(fget, fset)


def _container_property(f: FieldDescriptor):
    name = f.name

    def fget(self):
        c = self._f.get(name)
        return c if c is not None else self._container(f)

    def fset(self, v):
        raise AttributeError(
            f'Assignment not allowed to repeated field "{name}" in protocol message object.'
        )

    return property(fget, fset)


def _map_order(key_type: str):
    """The sort key of a deterministic map's entries, in the order
    protobuf's runtime (upb) writes them: numeric and bool keys from the
    largest down; string keys byte-wise, where a key that is a prefix of
    another comes after it (as if ended by a byte above 255)."""
    if key_type == "string":
        return lambda k: (*k.encode("utf-8"), 256)
    return lambda k: -k


def _field_init(f: FieldDescriptor):
    """init(msg, value) for one keyword argument of the constructor."""
    name = f.name
    if f.kind == "map" or f.repeated:
        def init_container(msg, value):
            if not value and type(value) in (list, tuple, dict):
                return  # nothing to add (the container is made when read)
            if f.repeated and isinstance(value, (str, bytes)):
                raise TypeError(f"{name}: expected an iterable, got {type(value).__name__}")
            c = msg._container(f)
            if f.kind == "map":
                c.update(value)
            else:
                c.extend(value)

        return init_container
    if f.kind == "message":
        cls = f.message_type

        def init_message(msg, value):
            if type(value) is cls:
                # A temporary no one else holds (the usual nested
                # constructor call) is adopted; anything else is copied.
                if value._parent is None and _refs(value) <= _ADOPT_REFS:
                    child = value
                else:
                    child = value._clone()
            elif isinstance(value, dict):
                child = cls(**value)
            else:
                raise TypeError(
                    f"Parameter to initialize message field must be dict or instance "
                    f"of same class: expected {cls.__name__} got {type(value).__name__}."
                )
            if f.oneof is not None:
                msg._select(f)
            msg._f[name] = child

        return init_message
    check = _CHECKERS[f.type]
    if f.oneof is not None:
        def init_oneof(msg, value):
            value = check(value)
            msg._select(f)
            msg._f[name] = value

        return init_oneof

    def init_scalar(msg, value):
        msg._f[name] = check(value)

    return init_scalar


def _container_factory(f: FieldDescriptor):
    """owner -> a new empty container for a repeated or map field."""
    cls = f.message_type
    if f.kind == "map":
        check_key = _CHECKERS[f.key_type]
        if cls is not None:
            return lambda owner: MapContainer(owner, check_key, None, cls, None)
        check_value, default = _CHECKERS[f.type], _default(f.type)
        return lambda owner: MapContainer(owner, check_key, check_value, None, default)
    if f.kind == "message":
        return lambda owner: RepeatedCompositeContainer(owner, cls)
    check = _CHECKERS[f.type]
    return lambda owner: RepeatedScalarContainer(owner, check)


def _tag(number: int, wire: int) -> bytes:
    return _varint_bytes((number << 3) | wire)


def _field_encoder(f: FieldDescriptor):
    """enc(out, value, deterministic) for one field's stored value."""
    if f.kind == "map":
        entry_tag = _tag(f.number, 2)
        kput, _ = _encoder(f.key_type)
        ktag = _tag(1, _WIRE.get(f.key_type, 0))
        vtag = _tag(2, 2 if f.message_type is not None else _WIRE.get(f.type, 0))
        if f.message_type is None:
            sput, _ = _encoder(f.type)

            def vput(out, v, deterministic):
                sput(out, v)
        else:
            def vput(out, m, deterministic):
                body = bytearray()
                m._encode(body, deterministic)
                _put_varint(out, len(body))
                out.extend(body)

        order = _map_order(f.key_type)

        def enc_map(out, c, deterministic):
            items = c._d
            keys = sorted(items, key=order) if deterministic else items
            for k in keys:
                entry = bytearray(ktag)
                kput(entry, k)
                entry.extend(vtag)
                vput(entry, items[k], deterministic)
                out.extend(entry_tag)
                _put_varint(out, len(entry))
                out.extend(entry)

        return enc_map
    if f.kind == "message":
        tag = _tag(f.number, 2)
        if f.repeated:
            def enc_msgs(out, c, deterministic):
                for m in c._items:
                    body = bytearray()
                    m._encode(body, deterministic)
                    out.extend(tag)
                    _put_varint(out, len(body))
                    out.extend(body)

            return enc_msgs

        def enc_msg(out, m, deterministic):
            body = bytearray()
            m._encode(body, deterministic)
            out.extend(tag)
            _put_varint(out, len(body))
            out.extend(body)

        return enc_msg
    put, present = _encoder(f.type)
    wire = _WIRE.get(f.type, 0)
    if f.repeated:
        if wire == 2:
            tag = _tag(f.number, 2)

            def enc_rep(out, c, deterministic):
                for v in c._items:
                    out.extend(tag)
                    put(out, v)

            return enc_rep
        ptag = _tag(f.number, 2)

        def enc_packed(out, c, deterministic):
            if not c._items:
                return
            body = bytearray()
            for v in c._items:
                put(body, v)
            out.extend(ptag)
            _put_varint(out, len(body))
            out.extend(body)

        return enc_packed
    tag = _tag(f.number, wire)
    if f.oneof is not None:
        def enc_oneof(out, v, deterministic):
            out.extend(tag)
            put(out, v)

        return enc_oneof

    def enc_scalar(out, v, deterministic):
        if present(v):
            out.extend(tag)
            put(out, v)

    return enc_scalar


def _field_decoders(f: FieldDescriptor) -> dict:
    """{tag: handler(msg, data, pos) -> pos} for one field."""
    name = f.name
    if f.kind == "map":
        kget = _decoder(f.key_type)
        kwire = _WIRE.get(f.key_type, 0)
        kdefault = _default(f.key_type)
        cls = f.message_type
        vget = None if cls is not None else _decoder(f.type)
        vwire = 2 if cls is not None else _WIRE.get(f.type, 0)

        ktag = (1 << 3) | kwire
        vtag = (2 << 3) | vwire

        def dec_entry(msg, data, pos):
            n = data[pos]
            if n < 0x80:
                pos += 1
            else:
                n, pos = _get_varint(data, pos)
            end = pos + n
            if end > len(data):
                raise DecodeError("truncated map entry")
            if vget is not None and n and data[pos] == ktag:
                # the usual entry: its key, then its scalar value, nothing else
                key, p = kget(data, pos + 1)
                if p < end and data[p] == vtag:
                    value, p = vget(data, p + 1)
                    if p == end:
                        c = msg._f.get(name)
                        if c is None:
                            c = msg._container(f)
                        c._d[key] = value
                        return end
            key = kdefault
            value = None
            while pos < end:
                tag, pos = _get_varint(data, pos)
                number, wire = tag >> 3, tag & 7
                if number == 1 and wire == kwire:
                    key, pos = kget(data, pos)
                elif number == 2 and wire == vwire:
                    if cls is not None:
                        ln, pos = _get_varint(data, pos)
                        if value is None:
                            value = _blank(cls)
                        value._decode(data, pos, pos + ln)
                        pos += ln
                    else:
                        value, pos = vget(data, pos)
                else:
                    pos = _skip(data, pos, wire, number)
            if pos != end:
                raise DecodeError("truncated map entry")
            if value is None:
                value = cls() if cls is not None else _default(f.type)
            msg._container(f)._d[key] = value
            return end

        return {(f.number << 3) | 2: dec_entry}
    if f.kind == "message":
        cls = f.message_type

        def read_body(data, pos):
            n, pos = _get_varint(data, pos)
            end = pos + n
            if end > len(data):
                raise DecodeError("truncated sub-message")
            return pos, end

        if f.repeated:
            def dec_msgs(msg, data, pos):
                pos, end = read_body(data, pos)
                m = _blank(cls)
                m._decode(data, pos, end)
                msg._container(f)._items.append(m)
                return end

            return {(f.number << 3) | 2: dec_msgs}

        def dec_msg(msg, data, pos):
            n = data[pos]
            if n < 0x80:
                pos += 1
                end = pos + n
                if end > len(data):
                    raise DecodeError("truncated sub-message")
            else:
                pos, end = read_body(data, pos)
            m = msg._f.get(name)
            if m is None:
                m = _blank(cls)
                if f.oneof is not None:
                    msg._select(f)
                msg._f[name] = m
            m._decode(data, pos, end)
            return end

        return {(f.number << 3) | 2: dec_msg}
    get = _decoder(f.type)
    wire = _WIRE.get(f.type, 0)
    if f.type == "string" and not f.repeated and f.oneof is None:
        def dec_string(msg, data, pos):
            n = data[pos]
            if n < 0x80:
                pos += 1
            else:
                n, pos = _get_varint(data, pos)
            end = pos + n
            if end > len(data):
                raise DecodeError("truncated string")
            try:
                msg._f[name] = data[pos:end].decode("utf-8")
            except UnicodeDecodeError:
                raise DecodeError("string field is not valid UTF-8") from None
            return end

        return {(f.number << 3) | 2: dec_string}
    if wire == 0 and f.type not in ("sint32", "sint64") and not f.repeated and f.oneof is None:
        as_bool = f.type == "bool"

        def dec_varint(msg, data, pos):
            b = data[pos]
            if b < 0x80:
                msg._f[name] = (b != 0) if as_bool else b
                return pos + 1
            v, pos = get(data, pos)
            msg._f[name] = v
            return pos

        return {(f.number << 3): dec_varint}
    if f.repeated:
        def dec_one(msg, data, pos):
            v, pos = get(data, pos)
            msg._container(f)._items.append(v)
            return pos

        handlers = {(f.number << 3) | wire: dec_one}
        if wire != 2:
            def dec_packed(msg, data, pos):
                n, pos = _get_varint(data, pos)
                end = pos + n
                if end > len(data):
                    raise DecodeError("truncated packed field")
                items = msg._container(f)._items
                while pos < end:
                    v, pos = get(data, pos)
                    items.append(v)
                if pos != end:
                    raise DecodeError("truncated packed field")
                return end

            handlers[(f.number << 3) | 2] = dec_packed
        return handlers
    if f.oneof is not None:
        def dec_oneof_scalar(msg, data, pos):
            v, pos = get(data, pos)
            msg._select(f)
            msg._f[name] = v
            return pos

        return {(f.number << 3) | wire: dec_oneof_scalar}

    def dec_scalar(msg, data, pos):
        v, pos = get(data, pos)
        msg._f[name] = v
        return pos

    return {(f.number << 3) | wire: dec_scalar}


def _make_classes(descs: list) -> dict:
    """One Message subclass per descriptor, by name."""
    classes: dict = {}
    for d in descs:
        ns = {"__slots__": (), "DESCRIPTOR": d, "__module__": __name__,
              "__qualname__": d.name}
        classes[d.name] = type(d.name, (Message,), ns)
    for d in descs:
        cls = classes[d.name]
        d.by_number = sorted(d.fields, key=lambda f: f.number)
        for f in d.fields:
            if f.kind == "message" or (f.kind == "map" and f.type not in _SCALARS):
                f.message_type = classes[f.type]
            if f.kind == "map" or f.repeated:
                f.new_container = _container_factory(f)
        for f in d.fields:
            if f.kind == "scalar" and not f.repeated:
                prop = _scalar_property(f)
            elif f.kind == "message" and not f.repeated:
                prop = _message_property(f)
            else:
                prop = _container_property(f)
            setattr(cls, f.name, prop)
        cls._fields = dict(d.fields_by_name)
        cls._inits = {f.name: _field_init(f) for f in d.fields}
        cls._encoders = tuple((f.name, _field_encoder(f)) for f in d.by_number)
        decoders: dict = {}
        for f in d.fields:
            decoders.update(_field_decoders(f))
        cls._decoders = decoders
    return classes


# Adopting temporaries: a sub-message passed to a constructor is copied, as
# protobuf copies it, unless CPython's reference count shows that nothing
# but the call itself holds it (then no one can see the difference).  The
# count such a temporary has inside init_message is measured here, once,
# through the same path; if a temporary and a held message cannot be told
# apart, nothing is adopted.
_refs = sys.getrefcount
_ADOPT_REFS = 0


def _calibrate_adoption() -> int:
    global _refs
    seen: list = []
    _refs = lambda v: seen.append(sys.getrefcount(v) - 1) or 1 << 30  # noqa: E731
    try:
        _Probe(sub=_ProbeSub())
        held = _ProbeSub()
        _Probe(sub=held)
    finally:
        _refs = sys.getrefcount
    temporary, kept = seen
    return temporary if kept > temporary else 0


_probes = _make_classes(parse_proto(
    "syntax = \"proto3\"; message ProbeSub { int64 x = 1; } message Probe { ProbeSub sub = 1; }"
)[1])
_Probe, _ProbeSub = _probes["Probe"], _probes["ProbeSub"]
_ADOPT_REFS = _calibrate_adoption()

with open(PROTO_PATH) as _f:
    PACKAGE, _DESCRIPTORS = parse_proto(_f.read())
MESSAGES = _make_classes(_DESCRIPTORS)
globals().update(MESSAGES)

__all__ = ["DecodeError", "Descriptor", "FieldDescriptor", "MESSAGES", "Message",
           "PACKAGE", "parse_proto", *MESSAGES]
