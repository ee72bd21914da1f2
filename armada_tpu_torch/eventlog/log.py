"""ctypes binding for the native partitioned event log (eventlog.cc).

The log is the framework's Pulsar equivalent (internal/common/pulsarutils in
the reference): ordered partitions, byte-offset message ids, replay from any
consumer position.

The port carries its own copy of the JAX package's eventlog.cc, beside this
module, and builds it at first use with `g++ -O2 -fPIC -std=c++17 -shared`
(the JAX package's native Makefile flags) into armada_tpu_torch/_build/,
under a file lock and keyed by a hash of the source and flags. A failed
build raises with the compiler's output; there is no Python fallback. The
on-disk format is the JAX package's, so each package reads a log that the
other wrote.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import struct
import subprocess
import time
from typing import Iterator, NamedTuple, Optional

from armada_tpu_torch.analysis.tsan import make_lock

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "eventlog.cc")
_BUILD_DIR = os.path.join(_HERE, os.pardir, "_build")
CXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-Wall", "-shared")

_build_lock = make_lock("eventlog.native_build")
_lib = None
# What the build used: the compiler, its version line, and the seconds the
# build took (0.0 when the library was already there).
BUILD_INFO: dict = {}


def _compiler() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not cxx:
        raise RuntimeError("no C++ compiler (g++) found to build the event log")
    return cxx


def build() -> str:
    """Compile eventlog.cc if needed; the path of the shared library."""
    with open(_SRC, "rb") as f:
        src = f.read()
    cxx = _compiler()
    digest = hashlib.sha256(src + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    os.makedirs(_BUILD_DIR, exist_ok=True)
    so_path = os.path.realpath(os.path.join(_BUILD_DIR, f"libeventlog-{digest}.so"))
    version = subprocess.run([cxx, "--version"], capture_output=True, text=True)
    BUILD_INFO["compiler"] = cxx
    lines = (version.stdout or version.stderr).splitlines()
    BUILD_INFO["version"] = lines[0] if lines else ""
    if os.path.exists(so_path):
        BUILD_INFO.setdefault("seconds", 0.0)
        return so_path
    # A cross-process flock keeps concurrent first users (pytest-xdist
    # workers) from racing the build output.
    with open(so_path + ".lock", "w") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)
        if os.path.exists(so_path):
            BUILD_INFO.setdefault("seconds", 0.0)
            return so_path
        t0 = time.perf_counter()
        tmp = so_path + f".{os.getpid()}.tmp"
        proc = subprocess.run(
            [cxx, *CXX_FLAGS, "-o", tmp, _SRC], capture_output=True, text=True
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"building the event log failed ({cxx}, rc {proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, so_path)
        BUILD_INFO["seconds"] = time.perf_counter() - t0
    return so_path


def _load_lib() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    with _build_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build())
        lib.el_open.restype = ctypes.c_void_p
        lib.el_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.el_close.argtypes = [ctypes.c_void_p]
        lib.el_num_partitions.restype = ctypes.c_int
        lib.el_num_partitions.argtypes = [ctypes.c_void_p]
        lib.el_append.restype = ctypes.c_int64
        lib.el_append.argtypes = [
            ctypes.c_void_p,
            ctypes.c_int,
            ctypes.c_char_p,
            ctypes.c_int,
            ctypes.c_char_p,
            ctypes.c_int,
        ]
        lib.el_end_offset.restype = ctypes.c_int64
        lib.el_end_offset.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.el_read.restype = ctypes.c_int64
        lib.el_read.argtypes = [
            ctypes.c_void_p,
            ctypes.c_int,
            ctypes.c_int64,
            ctypes.c_char_p,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.el_flush.restype = ctypes.c_int
        lib.el_flush.argtypes = [ctypes.c_void_p]
        lib.el_reset.restype = ctypes.c_int
        lib.el_reset.argtypes = [ctypes.c_void_p]
        lib.el_truncate.restype = ctypes.c_int
        lib.el_truncate.argtypes = [
            ctypes.c_void_p,
            ctypes.c_int,
            ctypes.c_int64,
        ]
        _lib = lib
    return _lib


class Message(NamedTuple):
    """One log record: `offset` is its id; `next_offset` the resume position."""

    partition: int
    offset: int
    next_offset: int
    key: bytes
    payload: bytes


class EventLog:
    """A durable partitioned append-only log (thread-safe appends)."""

    DEFAULT_PARTITIONS = 4

    def __init__(self, directory: str, num_partitions: Optional[int] = None):
        self._lib = _load_lib()
        os.makedirs(directory, exist_ok=True)
        # The partition count is a permanent property of a log (it keys the
        # jobset -> partition routing); persist it and reject mismatched opens
        # rather than silently hiding partitions or re-routing keys.
        # num_partitions=None ADOPTS an existing log's persisted count (the
        # restart path: `serve` without --log-partitions must reopen a log
        # created at any width), falling back to DEFAULT_PARTITIONS only for
        # a fresh directory.
        meta_path = os.path.join(directory, "META")
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                existing = int(f.read().strip())
            if num_partitions is None:
                num_partitions = existing
            elif existing != num_partitions:
                raise ValueError(
                    f"event log at {directory} has {existing} partitions; "
                    f"requested {num_partitions}"
                )
        else:
            if num_partitions is None:
                num_partitions = self.DEFAULT_PARTITIONS
            with open(meta_path, "w") as f:
                f.write(str(num_partitions))
        self._handle = self._lib.el_open(directory.encode(), num_partitions)
        if not self._handle:
            raise OSError(f"failed to open event log at {directory}")
        self.directory = directory
        self.num_partitions = num_partitions
        self._closed = False

    def close(self) -> None:
        if not self._closed:
            self._lib.el_close(self._handle)
            self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _check_open(self) -> None:
        # Guard every native call: the handle is freed memory after close().
        if self._closed:
            raise ValueError(f"event log at {self.directory} is closed")

    def append(self, partition: int, key: bytes, payload: bytes) -> int:
        """Append one record; returns its offset (the message id)."""
        self._check_open()
        off = self._lib.el_append(
            self._handle, partition, key, len(key), payload, len(payload)
        )
        if off < 0:
            raise OSError(f"append to partition {partition} failed")
        return off

    def end_offset(self, partition: int) -> int:
        self._check_open()
        return self._lib.el_end_offset(self._handle, partition)

    def flush(self) -> None:
        self._check_open()
        if self._lib.el_flush(self._handle) != 0:
            raise OSError("event log fsync failed")

    def reset(self) -> None:
        self._check_open()
        if self._lib.el_reset(self._handle) != 0:
            raise OSError("event log reset failed")

    def truncate(self, partition: int, offset: int) -> None:
        """Drop everything at/after `offset` in one partition (divergence
        recovery -- eventlog/replicator.py).  `offset` must be a record
        boundary at or before the current end."""
        self._check_open()
        if self._lib.el_truncate(self._handle, partition, offset) != 0:
            raise OSError(
                f"truncate of partition {partition} to {offset} failed"
            )

    def read_raw(
        self,
        partition: int,
        offset: int,
        max_bytes: int = 1 << 20,
        max_msgs: int = 1 << 30,
    ) -> tuple[bytes, int]:
        """Whole records from `offset` with their framing intact, plus the
        next read offset.  The zero-framing read for shard workers
        (the partitioned ingester): the Python record walk moves to whoever consumes
        the buffer (a converter subprocess), off this thread's GIL.  Empty
        bytes means caught up."""
        self._check_open()
        end = self.end_offset(partition)
        if offset >= end:
            return b"", offset  # caught up: skip the buffer allocation
        max_bytes = min(max_bytes, end - offset)
        while True:
            buf = ctypes.create_string_buffer(max_bytes)
            next_off = ctypes.c_int64(0)
            n = self._lib.el_read(
                self._handle,
                partition,
                offset,
                buf,
                max_bytes,
                max_msgs,
                ctypes.byref(next_off),
            )
            if n == -3:
                # One record larger than the buffer: grow and retry rather
                # than mis-reporting "caught up".
                max_bytes *= 4
                continue
            if n == -2:
                raise OSError(
                    f"corrupt record in partition {partition} at/after offset {offset}"
                )
            if n < 0:
                raise OSError(f"read from partition {partition} failed")
            return buf.raw[:n], next_off.value

    def read(
        self,
        partition: int,
        offset: int,
        max_bytes: int = 1 << 20,
        max_msgs: int = 1 << 30,
    ) -> list[Message]:
        """Read whole records from `offset`; empty list means caught up."""
        data, next_off = self.read_raw(partition, offset, max_bytes, max_msgs)
        n = len(data)
        out: list[Message] = []
        pos = 0
        rec_off = offset
        while pos < n:
            paylen, keylen = struct.unpack_from("<II", data, pos)
            key = bytes(data[pos + 8 : pos + 8 + keylen])
            payload = bytes(data[pos + 8 + keylen : pos + 8 + keylen + paylen])
            total = 8 + keylen + paylen + 4
            out.append(Message(partition, rec_off, rec_off + total, key, payload))
            pos += total
            rec_off += total
        assert n == 0 or rec_off == next_off
        return out

    def iter_from(self, partition: int, offset: int) -> Iterator[Message]:
        """Iterate all records currently in the partition from `offset`."""
        while True:
            batch = self.read(partition, offset)
            if not batch:
                return
            yield from batch
            offset = batch[-1].next_offset
