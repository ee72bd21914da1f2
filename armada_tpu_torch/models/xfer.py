"""Per-cycle host/device transfer accounting: the slab delta cache counts
every host-to-device array it ships (slab.DeviceDeltaCache) and the decode
counts its compact fetch, so a regression that adds transfers or payload to
the cycle shows in the counters without a profiler."""

from __future__ import annotations


class TransferStats:
    __slots__ = ("up_transfers", "up_bytes", "down_transfers", "down_bytes")

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.up_transfers = 0
        self.up_bytes = 0
        self.down_transfers = 0
        self.down_bytes = 0

    def count_up(self, nbytes: int) -> None:
        self.up_transfers += 1
        self.up_bytes += int(nbytes)

    def count_down(self, nbytes: int) -> None:
        self.down_transfers += 1
        self.down_bytes += int(nbytes)

    def snapshot(self) -> dict:
        return {
            "up_transfers": self.up_transfers,
            "up_bytes": self.up_bytes,
            "down_transfers": self.down_transfers,
            "down_bytes": self.down_bytes,
        }


TRANSFER_STATS = TransferStats()
