"""Leader election: only the leader schedules; followers mirror state.

Equivalent of the reference's `internal/scheduler/leader` (leader.go:19-190):
a LeaderController hands out tokens and validates them, so a scheduler that
loses leadership mid-cycle discards its work instead of publishing with stale
authority (token fencing, scheduler.go:263).  Two implementations:

* StandaloneLeaderController -- always leader (leader.go:64, dev/single-replica).
* FileLeaseLeaderController -- a lease file on shared storage stands in for the
  reference's Kubernetes coordination/v1 Lease (leader.go:112-186): holders
  renew before expiry; on expiry any replica may take over, bumping the fencing
  generation so stale holders fail validation.
"""

from __future__ import annotations

import dataclasses
import fcntl
import json
import os
import time
from typing import Callable, Optional, Protocol


@dataclasses.dataclass(frozen=True)
class LeaderToken:
    leader: bool
    generation: int = 0


class LeaderController(Protocol):
    def get_token(self) -> LeaderToken:
        """Current leadership claim; cheap, called once per cycle."""

    def validate_token(self, token: LeaderToken) -> bool:
        """True iff `token` still confers leadership (fencing re-check before
        publishing, scheduler.go:263,355)."""

    def leader_address(self) -> Optional[str]:
        """READ-ONLY leadership peek for followers that proxy leader-local
        queries (the reference's LeaderClientConnectionProvider,
        leader/leader_client.go).  Must not acquire/renew (query paths call
        this).  Returns None when this process holds the lease (serve
        locally), the leader's advertised address when another holder does,
        and "" when another holder is known but advertised no address."""

    def current_generation(self) -> int:
        """READ-ONLY peek at the election record's fencing generation
        (monotonic epoch).  Must not acquire/renew -- the publisher's epoch
        fence reads it on every publish to reject writes from a deposed
        leader without waiting for the next cycle's validate_token."""


class StandaloneLeaderController:
    """Always leader (leader.go StandaloneLeaderController:64)."""

    def get_token(self) -> LeaderToken:
        return LeaderToken(leader=True, generation=0)

    def validate_token(self, token: LeaderToken) -> bool:
        return token.leader

    def leader_address(self) -> Optional[str]:
        return None  # we ARE the leader

    def current_generation(self) -> int:
        return 0  # no elections, no epochs


class FileLeaseLeaderController:
    """Lease-file election with fencing generations.

    The lease file holds {holder, generation, expiry}.  acquire-or-renew runs
    under an exclusive flock on a sidecar lock file, so exactly one replica
    wins each expiry race.  Generations only grow; a token from generation g
    is invalid once any replica has acquired generation > g -- the property the
    reference gets from Lease resourceVersion fencing (leader.go:149-186).
    """

    def __init__(
        self,
        lease_path: str,
        holder_id: str,
        lease_duration_s: float = 15.0,
        clock: Callable[[], float] = time.time,
        advertised_address: str = "",
    ):
        self._path = lease_path
        self._holder = holder_id
        self._duration = lease_duration_s
        self._clock = clock
        # Rides in the lease record so followers can proxy leader-local
        # queries (reports).  Often set post-construction once the gRPC
        # port is bound (set_advertised_address).
        self._address = advertised_address

    def set_advertised_address(self, address: str) -> None:
        self._address = address  # picked up by the next acquire/renew write

    def leader_address(self) -> Optional[str]:
        lease = self._locked(self._read)
        if lease is None:
            # No election yet: "" maps to the retryable UNAVAILABLE in the
            # reports proxy; answering None here would have a replica that
            # never won serve report queries from its empty local repository
            # (ADVICE r4).
            return ""
        if lease.get("holder") == self._holder:
            # Our lease -- even just-expired: local state is current and the
            # next cycle's get_token renews/re-acquires.  Comparing our own
            # write against our own clock can't skew-flap.
            return None
        if self._clock() >= lease.get("expiry", 0):
            return ""  # expired foreign lease: election gap, retry
        return lease.get("address") or ""

    def current_generation(self) -> int:
        """The record's fencing generation, whoever holds it (0 before any
        election).  Read-only: a deposed leader peeking here must not renew
        itself back into authority."""
        lease = self._locked(self._read)
        return int(lease["generation"]) if lease else 0

    # --- lease file access (always under flock) -----------------------------

    def _locked(self, fn):
        os.makedirs(os.path.dirname(os.path.abspath(self._path)), exist_ok=True)
        with open(self._path + ".lock", "w") as lockf:
            fcntl.flock(lockf, fcntl.LOCK_EX)
            return fn()

    def _read(self) -> Optional[dict]:
        try:
            with open(self._path) as f:
                return json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            return None

    def _write(self, lease: dict) -> None:
        # Election records are durable state files: the shared helper adds
        # the directory fsync a hand-rolled tmp+rename misses
        # (core/statefile.py; armada-lint atomic-state-file).
        from armada_tpu_torch.core import statefile

        statefile.write_json(self._path, lease)

    # --- LeaderController ---------------------------------------------------

    def get_token(self) -> LeaderToken:
        def attempt() -> LeaderToken:
            now = self._clock()
            lease = self._read()
            if lease is None or now >= lease["expiry"]:
                generation = (lease["generation"] + 1) if lease else 1
                self._write(
                    {
                        "holder": self._holder,
                        "generation": generation,
                        "expiry": now + self._duration,
                        "address": self._address,
                    }
                )
                return LeaderToken(leader=True, generation=generation)
            if lease["holder"] == self._holder:
                # renew
                lease["expiry"] = now + self._duration
                lease["address"] = self._address
                self._write(lease)
                return LeaderToken(leader=True, generation=lease["generation"])
            return LeaderToken(leader=False, generation=lease["generation"])

        return self._locked(attempt)

    def validate_token(self, token: LeaderToken) -> bool:
        if not token.leader:
            return False

        def check() -> bool:
            lease = self._read()
            return (
                lease is not None
                and lease["holder"] == self._holder
                and lease["generation"] == token.generation
                and self._clock() < lease["expiry"]
            )

        return self._locked(check)
