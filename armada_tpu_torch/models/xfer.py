"""Per-cycle device-to-host transfer accounting: the decode counts its one
compact fetch here, so a regression that adds transfers to the decode path
shows in the counters without a profiler."""

from __future__ import annotations


class TransferStats:
    __slots__ = ("down_transfers", "down_bytes")

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.down_transfers = 0
        self.down_bytes = 0

    def count_down(self, nbytes: int) -> None:
        self.down_transfers += 1
        self.down_bytes += int(nbytes)

    def snapshot(self) -> dict:
        return {"down_transfers": self.down_transfers, "down_bytes": self.down_bytes}


TRANSFER_STATS = TransferStats()
