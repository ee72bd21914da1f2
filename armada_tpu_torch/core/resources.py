"""Exact host-side resource vectors and their quantization to device units.

Plays the role of the reference's `internaltypes.ResourceList`
(the reference's internal/scheduler/internaltypes/resource_list.go:22-33): a fixed-order
vector of int64 quantities interpreted through a shared factory, with arithmetic
(Add/Subtract/Cap/Multiply), dominant-resource comparison, and floor/ceil quantization to
per-resource *resolution units* (resource_list.go:225-310; resolution rounding as in
nodedb.go:91-103).

Design difference from the reference: quantization is not just an indexing trick here --
it is the bridge onto the device.  Device tensors hold resolution units as float32 (kept
integral and small enough to be exact in a 24-bit mantissa), so fit comparisons on the
device are exact while DRF cost math stays in fast float32.
"""

from __future__ import annotations

import dataclasses
import re
from fractions import Fraction
from typing import Iterable, Mapping, Sequence

import numpy as np

# Kubernetes-style quantity suffixes -> multiplier, expressed such that parsing
# "100m" cpu yields exact milli-units.  We canonicalise every resource to an int64
# "atom" count where one atom is 1/1000 of the base unit (so cpu "1" = 1000 atoms,
# memory "1" = 1000 atoms); this makes "m" exact and keeps Ki/Mi/Gi exact too.
_ATOMS_PER_UNIT = 1000
_SUFFIX = {
    "": Fraction(1),
    "m": Fraction(1, 1000),
    "k": Fraction(10**3),
    "M": Fraction(10**6),
    "G": Fraction(10**9),
    "T": Fraction(10**12),
    "P": Fraction(10**15),
    "E": Fraction(10**18),
    "Ki": Fraction(2**10),
    "Mi": Fraction(2**20),
    "Gi": Fraction(2**30),
    "Ti": Fraction(2**40),
    "Pi": Fraction(2**50),
    "Ei": Fraction(2**60),
}

_QUANTITY_RE = re.compile(
    r"^\s*([0-9]*\.?[0-9]+(?:[eE][+-]?[0-9]+)?)\s*([A-Za-z]{0,2})\s*$"
)


def parse_quantity(q: "str | int | float") -> int:
    """Parse a Kubernetes-style quantity into int64 atoms (1 atom = 1/1000 base
    unit).  Exact: the string path goes through Fraction, never float, so every
    spelling of a quantity yields identical atoms.  Supports decimal (k/M/G/...),
    binary (Ki/Mi/...) suffixes and scientific notation ('1e3')."""
    if isinstance(q, bool):
        raise ValueError(f"invalid quantity: {q!r}")
    if isinstance(q, (int, np.integer)):
        return int(q) * _ATOMS_PER_UNIT
    if isinstance(q, float):
        return round(q * _ATOMS_PER_UNIT)
    m = _QUANTITY_RE.match(q)
    if not m:
        raise ValueError(f"invalid quantity: {q!r}")
    value, suffix = m.groups()
    # 'e'/'E' in the number part is scientific notation, not a suffix; the regex
    # keeps it with the value.
    if suffix not in _SUFFIX:
        raise ValueError(f"invalid quantity suffix: {q!r}")
    frac = Fraction(value) * _SUFFIX[suffix] * _ATOMS_PER_UNIT
    return round(frac)


def format_quantity(atoms: int) -> str:
    """Exact decimal rendering of atoms, re-parseable by parse_quantity."""
    sign = "-" if atoms < 0 else ""
    whole, rem = divmod(abs(atoms), _ATOMS_PER_UNIT)
    if rem == 0:
        return f"{sign}{whole}"
    return f"{sign}{whole}.{rem:03d}".rstrip("0")


@dataclasses.dataclass(frozen=True)
class ResourceListFactory:
    """Shared registry fixing the order, names and resolutions of resources.

    Mirrors `internaltypes.ResourceListFactory` (resource_list_factory.go): every
    ResourceList produced by one factory shares the same axis order, so vectors add
    positionally.  `resolutions` holds atoms-per-resolution-unit for each resource
    (from config `supportedResourceTypes[].resolution`,
    the reference's config/scheduler/config.yaml:73-82).
    """

    names: tuple[str, ...]
    resolutions: tuple[int, ...]  # atoms per device resolution unit

    def __post_init__(self):
        if len(self.names) != len(set(self.names)):
            raise ValueError(f"duplicate resource names: {self.names}")
        if len(self.resolutions) != len(self.names):
            raise ValueError("resolutions must match names")
        if any(r <= 0 for r in self.resolutions):
            raise ValueError(f"resolutions must be positive: {self.resolutions}")
        # name -> axis position; tuple.index is an O(R) scan and the proto
        # conversion path resolves names per resource per job (frozen
        # dataclass, so the cache rides object.__setattr__)
        object.__setattr__(
            self, "index_map", {n: i for i, n in enumerate(self.names)}
        )

    @staticmethod
    def from_config(resource_types: Sequence[tuple[str, "str | int"]]) -> "ResourceListFactory":
        names = tuple(name for name, _ in resource_types)
        resolutions = tuple(parse_quantity(res) for _, res in resource_types)
        return ResourceListFactory(names, resolutions)

    @property
    def num_resources(self) -> int:
        return len(self.names)

    def index_of(self, name: str) -> int:
        idx = self.index_map.get(name)
        if idx is None:  # keep tuple.index's exception type
            raise ValueError(f"unknown resource name: {name!r}")
        return idx

    def from_mapping(self, quantities: Mapping[str, "str | int | float"]) -> "ResourceList":
        vec = np.zeros(len(self.names), dtype=np.int64)
        for name, q in quantities.items():
            idx = self.index_map.get(name)
            if idx is None:
                # Unsupported resources are dropped, as in the reference factory
                # (resource_list_factory.go FromJobResourceListIgnoreUnknown).
                continue
            vec[idx] = parse_quantity(q)
        return ResourceList(self, vec)

    def zero(self) -> "ResourceList":
        return ResourceList(self, np.zeros(len(self.names), dtype=np.int64))

    def from_atoms(self, atoms: np.ndarray) -> "ResourceList":
        atoms = np.asarray(atoms, dtype=np.int64)
        if atoms.shape != (len(self.names),):
            raise ValueError(f"bad shape {atoms.shape}")
        return ResourceList(self, atoms.copy())

    # --- quantization to device resolution units -------------------------------
    def floor_units(self, atoms: np.ndarray) -> np.ndarray:
        """Round down to resolution units (node allocatable: conservative)."""
        res = np.asarray(self.resolutions, dtype=np.int64)
        return (np.asarray(atoms, dtype=np.int64) // res).astype(np.int64)

    def ceil_units(self, atoms: np.ndarray) -> np.ndarray:
        """Round up to resolution units (job requests: conservative)."""
        res = np.asarray(self.resolutions, dtype=np.int64)
        a = np.asarray(atoms, dtype=np.int64)
        return -((-a) // res)

    def multipliers_for(self, names_to_mult: Mapping[str, float]) -> np.ndarray:
        """Per-resource DRF multipliers in *unit* space.

        DRF cost divides allocation by total per-resource, so the resolution scale
        cancels; multipliers map straight through (fairness.go:99-103).
        """
        out = np.zeros(len(self.names), dtype=np.float64)
        for name, mult in names_to_mult.items():
            if name in self.names:
                out[self.index_of(name)] = mult
        return out


@dataclasses.dataclass(frozen=True)
class ResourceList:
    """Immutable exact resource vector (int64 atoms) bound to a factory.

    Mirrors `internaltypes.ResourceList` semantics: arithmetic, dominance checks.
    """

    factory: ResourceListFactory
    atoms: np.ndarray  # int64[R]

    def atoms_tuple(self) -> tuple:
        """Hashable atoms, cached: the scheduling-key hot path converts each
        job's vector exactly once however often keys are recomputed."""
        cached = getattr(self, "_atoms_tuple", None)
        if cached is None:
            cached = tuple(int(a) for a in self.atoms)
            object.__setattr__(self, "_atoms_tuple", cached)
        return cached

    def _check(self, other: "ResourceList"):
        if other.factory is not self.factory and other.factory != self.factory:
            raise ValueError("resource lists from different factories")

    def add(self, other: "ResourceList") -> "ResourceList":
        self._check(other)
        return ResourceList(self.factory, self.atoms + other.atoms)

    def subtract(self, other: "ResourceList") -> "ResourceList":
        self._check(other)
        return ResourceList(self.factory, self.atoms - other.atoms)

    def multiply_scalar(self, k: int) -> "ResourceList":
        return ResourceList(self.factory, self.atoms * int(k))

    def cap(self, other: "ResourceList") -> "ResourceList":
        self._check(other)
        return ResourceList(self.factory, np.minimum(self.atoms, other.atoms))

    def exceeds(self, other: "ResourceList") -> bool:
        """True if any component of self > other (resource_list.go Exceeds:172)."""
        self._check(other)
        return bool(np.any(self.atoms > other.atoms))

    def fits_within(self, other: "ResourceList") -> bool:
        return not self.exceeds(other)

    def all_zero(self) -> bool:
        return bool(np.all(self.atoms == 0))

    def is_empty(self) -> bool:
        return self.all_zero()

    def has_negative(self) -> bool:
        return bool(np.any(self.atoms < 0))

    def get(self, name: str) -> int:
        return int(self.atoms[self.factory.index_of(name)])

    def to_dict(self) -> dict[str, str]:
        return {
            name: format_quantity(int(a))
            for name, a in zip(self.factory.names, self.atoms)
            if a != 0
        }

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, ResourceList)
            and self.factory == other.factory
            and bool(np.array_equal(self.atoms, other.atoms))
        )

    def __repr__(self) -> str:
        return f"ResourceList({self.to_dict()})"


def sum_resource_lists(factory: ResourceListFactory, rls: Iterable[ResourceList]) -> ResourceList:
    total = np.zeros(factory.num_resources, dtype=np.int64)
    for rl in rls:
        total += rl.atoms
    return ResourceList(factory, total)
