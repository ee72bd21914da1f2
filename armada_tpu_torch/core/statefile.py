"""Atomic durable state files: the ONE write path for cursors, snapshots
and election records.

Every file that survives a crash and is trusted on the next boot -- the
leader lease, checkpoint snapshots, any future cursor file -- must be
written tmp + flush + fsync + rename, and the rename's directory entry must
itself be fsynced or the file can vanish with the directory's page cache.
Hand-rolled versions of this pattern keep missing one of the steps (the
pre-refactor lease write skipped the directory fsync), so armada-lint's
``atomic-state-file`` rule flags any ``os.replace``/``os.rename`` outside
this module: centralizing the sequence is what makes it checkable.

Two formats:

* :func:`write_json` / :func:`read_json` -- plain JSON content with atomic
  replacement semantics, for records other code reads directly (the lease
  file stays ``json.load``-able).
* :func:`write_blob` / :func:`read_blob` -- a checksummed, versioned binary
  envelope (magic + version + length + crc32 + payload) for snapshots: a
  torn or bit-rotted file fails :class:`CorruptStateFile`, never parses as
  truncated-but-plausible state.  The CRC is the same insurance the native
  event log carries per record (native/eventlog.cc).
"""

from __future__ import annotations

import json
import os
import struct
import zlib

_MAGIC = b"ASTF"
_HEADER = struct.Struct("<4sIQI")  # magic, version, payload length, crc32


class CorruptStateFile(ValueError):
    """The file is torn, truncated, bit-rotted, or from an unknown
    format version: callers fall back (previous snapshot, full replay),
    never trust the contents."""


def _fsync_dir(path: str) -> None:
    """fsync the directory entry after a rename: without it the new name
    can be lost on power failure even though the data blocks survived."""
    dirfd = os.open(os.path.dirname(os.path.abspath(path)) or ".", os.O_RDONLY)
    try:
        os.fsync(dirfd)
    finally:
        os.close(dirfd)


def _atomic_replace(path: str, data: bytes) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(path)


def write_json(path: str, obj) -> None:
    """Atomically replace `path` with the JSON encoding of `obj`.  The file
    is PLAIN JSON (no envelope): existing readers (json.load on the lease
    record) keep working."""
    _atomic_replace(path, json.dumps(obj).encode())


def read_json(path: str):
    """json.load with the same failure surface as read_blob: a torn or
    invalid file raises CorruptStateFile (FileNotFoundError passes through
    -- absent and corrupt are different conditions for callers)."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        return json.loads(data.decode())
    except (ValueError, UnicodeDecodeError) as e:
        raise CorruptStateFile(f"{path}: invalid JSON state file: {e}") from e


def write_blob(path: str, payload: bytes, version: int = 1) -> None:
    """Atomically write `payload` inside the checksummed envelope."""
    header = _HEADER.pack(_MAGIC, version, len(payload), zlib.crc32(payload))
    _atomic_replace(path, header + payload)


def read_blob(path: str) -> tuple[int, bytes]:
    """Read and verify an envelope; returns (version, payload).  Raises
    CorruptStateFile on any mismatch; FileNotFoundError passes through."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < _HEADER.size:
        raise CorruptStateFile(f"{path}: truncated header ({len(data)} bytes)")
    magic, version, length, crc = _HEADER.unpack_from(data)
    if magic != _MAGIC:
        raise CorruptStateFile(f"{path}: bad magic {magic!r}")
    payload = data[_HEADER.size :]
    if len(payload) != length:
        raise CorruptStateFile(
            f"{path}: payload length {len(payload)} != header {length}"
        )
    if zlib.crc32(payload) != crc:
        raise CorruptStateFile(f"{path}: checksum mismatch")
    return version, payload
