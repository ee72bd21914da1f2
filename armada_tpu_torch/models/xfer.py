"""Per-cycle host/device transfer accounting: the slab delta cache counts
every host-to-device array it ships (slab.DeviceDeltaCache) and the decode
counts its compact fetch, so a regression that adds transfers or payload to
the cycle shows in the counters without a profiler.

On a mesh (parallel/mesh_slab.py) an upload of a node-axis-sharded field
lands nbytes / shards per shard: `up_chip_bytes` accumulates that share
(equal to `up_bytes` when nothing is sharded) and `up_sharded_transfers`
counts those uploads.  On one card every shard lies on the same device, so
the share is an accounting of the layout, not of separate memories.  Each
transfer is also an instant note on the active cycle trace (ops/trace.py:
`xfer_up`, `xfer_down`)."""

from __future__ import annotations

from armada_tpu_torch.ops.trace import recorder as _trace


class TransferStats:
    __slots__ = ("up_transfers", "up_bytes", "down_transfers", "down_bytes", "up_chip_bytes",
                 "up_sharded_transfers")

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.up_transfers = 0
        self.up_bytes = 0
        self.down_transfers = 0
        self.down_bytes = 0
        self.up_chip_bytes = 0
        self.up_sharded_transfers = 0

    def count_up(self, nbytes: int, shards: int = 1) -> None:
        self.up_transfers += 1
        self.up_bytes += int(nbytes)
        per_chip = (int(nbytes) + shards - 1) // shards if shards > 1 else int(nbytes)
        self.up_chip_bytes += per_chip
        if shards > 1:
            self.up_sharded_transfers += 1
            _trace().note("xfer_up", bytes=int(nbytes), shards=int(shards))
        else:
            _trace().note("xfer_up", bytes=int(nbytes))

    def count_down(self, nbytes: int) -> None:
        self.down_transfers += 1
        self.down_bytes += int(nbytes)
        _trace().note("xfer_down", bytes=int(nbytes))

    def snapshot(self) -> dict:
        out = {
            "up_transfers": self.up_transfers,
            "up_bytes": self.up_bytes,
            "down_transfers": self.down_transfers,
            "down_bytes": self.down_bytes,
        }
        if self.up_sharded_transfers:
            out["up_chip_bytes"] = self.up_chip_bytes
            out["up_sharded_transfers"] = self.up_sharded_transfers
        return out


TRANSFER_STATS = TransferStats()
