"""External scheduling-input providers: bid prices and priority overrides.

Equivalent of the reference's optional provider services:
  * bid prices per (queue, price band) for market-driven pools
    (internal/scheduler/pricing/bid_price.go + client.go; pkg/bidstore proto)
  * per-(pool, queue) priority overrides
    (internal/scheduler/priorityoverride/service_provider.go; pkg/priorityoverride)

The reference polls external gRPC services; here providers are pluggable
objects with the same refresh-cached-state shape -- a static in-config
implementation ships, and a remote one can implement the same protocol.

The port's copy of the JAX package's scheduler/providers.py (the polling
gRPC clients of external_providers.py are not ported).
"""

from __future__ import annotations

from typing import Mapping, Optional, Protocol


def most_specific_bid(
    prices: Mapping, queue: str, band: str, pool: str = ""
) -> float:
    """The bid-price fallback chain (pricing/bid_price.go): most specific
    match wins -- (queue, band, pool) > (queue, band, any pool) >
    (queue, default band, pool) > (queue, default band).  0 = no bid
    (market pools never schedule it, market_iterator.go).  Shared by the
    polling client (external_providers.py) and the sidecar's synced table
    so the semantics cannot diverge."""
    for k in (
        (queue, band, pool),
        (queue, band, ""),
        (queue, "", pool),
        (queue, "", ""),
    ):
        v = prices.get(k)
        if v is not None:
            return v
    return 0.0


class BidPriceProvider(Protocol):
    def price(self, queue: str, band: str) -> float:
        """Bid price for jobs of `queue` in price band `band` (0 = no bid)."""


class PriorityOverrideProvider(Protocol):
    def override(self, pool: str, queue: str) -> Optional[float]:
        """Replacement fair-share weight for (pool, queue); None = no override."""


class StaticBidPriceProvider:
    """In-config prices: {(queue, band): price}; `default` catches the rest."""

    def __init__(
        self,
        prices: Mapping[tuple[str, str], float],
        default: float = 0.0,
    ):
        self._prices = dict(prices)
        self._default = default

    def price(self, queue: str, band: str) -> float:
        key = (queue, band)
        if key in self._prices:
            return self._prices[key]
        return self._prices.get((queue, ""), self._default)


class StaticPriorityOverrideProvider:
    """In-config overrides: {(pool, queue): weight}."""

    def __init__(self, overrides: Mapping[tuple[str, str], float]):
        self._overrides = dict(overrides)

    def override(self, pool: str, queue: str) -> Optional[float]:
        return self._overrides.get((pool, queue))


class NoOpProviders:
    """Absence of both providers (the default deployment)."""

    def price(self, queue: str, band: str) -> float:
        return 0.0

    def override(self, pool: str, queue: str) -> Optional[float]:
        return None
