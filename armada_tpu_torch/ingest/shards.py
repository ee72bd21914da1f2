"""The framing helpers of the partitioned ingester.

The port's dead-letter isolation (ingest/dlq.py) walks raw event-log
buffers with these. The partitioned ingester itself
(`PartitionedIngestionPipeline`, its converter subprocesses and the
control-plane barrier) comes in the next slice of the port; until then the
serial `IngestionPipeline` is the port's ingester.
"""

from __future__ import annotations

import struct

from armada_tpu_torch.eventlog.publisher import jobset_key

# The reserved control-plane stream key (the control plane's
# CONTROL_PLANE_JOBSET, duplicated here by value).
CONTROL_PLANE_JOBSET = "$control-plane"
_CONTROL_KEY = jobset_key("", CONTROL_PLANE_JOBSET)


def _iter_frames(buf: bytes):
    """Yield (key_start, key_len, payload_start, payload_len, total) per
    record of a read_raw buffer -- the Python mirror of the native
    framing ([u32 paylen][u32 keylen][key][payload][u32 crc],
    eventlog/eventlog.cc; EventLog.read carries the only other copy)."""
    pos = 0
    n = len(buf)
    while pos < n:
        paylen, keylen = struct.unpack_from("<II", buf, pos)
        kstart = pos + 8
        yield kstart, keylen, kstart + keylen, paylen, 8 + keylen + paylen + 4
        pos += 8 + keylen + paylen + 4


def _frame_records(buf: bytes, base_offset: int) -> list[tuple[bytes, bytes, int]]:
    """(key, payload, next_offset) triples out of a raw buffer."""
    out = []
    off = base_offset
    for ks, kl, ps, pl, total in _iter_frames(buf):
        off += total
        out.append((bytes(buf[ks : ks + kl]), bytes(buf[ps : ps + pl]), off))
    return out
