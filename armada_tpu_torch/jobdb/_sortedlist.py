"""Chunked sorted-key list: the SortedKeyList subset JobDb uses.

Drop-in for ``sortedcontainers.SortedKeyList`` (add / discard / len / ordered
iteration) when that package is absent from the toolchain.  Same design:
values live in bounded chunks kept in key order, with a per-chunk max-key
index, so ``add``/``discard`` cost one bisect over the chunk index plus one
O(load) list insert -- not an O(n) memmove of a million-entry flat list
(the JobDb's per-queue queued index reaches backlog scale).
"""

from __future__ import annotations

from bisect import bisect_left, bisect_right
from typing import Callable, Iterable, Optional

_LOAD = 1024


class SortedKeyList:
    __slots__ = ("_key", "_chunks", "_keys", "_maxes", "_len")

    def __init__(self, iterable: Optional[Iterable] = None, key: Callable = None):
        if key is None:
            raise TypeError("SortedKeyList requires a key function")
        self._key = key
        self._chunks: list[list] = []
        self._keys: list[list] = []
        self._maxes: list = []
        self._len = 0
        if iterable is not None:
            values = sorted(iterable, key=key)
            for lo in range(0, len(values), _LOAD):
                chunk = values[lo : lo + _LOAD]
                self._chunks.append(chunk)
                self._keys.append([key(v) for v in chunk])
                self._maxes.append(self._keys[-1][-1])
            self._len = len(values)

    @property
    def key(self) -> Callable:
        return self._key

    def __len__(self) -> int:
        return self._len

    def __iter__(self):
        for chunk in self._chunks:
            yield from chunk

    def __repr__(self) -> str:
        return f"SortedKeyList({list(self)!r})"

    def add(self, value) -> None:
        k = self._key(value)
        if not self._maxes:
            self._chunks.append([value])
            self._keys.append([k])
            self._maxes.append(k)
            self._len = 1
            return
        ci = bisect_left(self._maxes, k)
        if ci == len(self._maxes):
            ci -= 1
        keys = self._keys[ci]
        pos = bisect_right(keys, k)
        keys.insert(pos, k)
        self._chunks[ci].insert(pos, value)
        self._maxes[ci] = keys[-1]
        self._len += 1
        if len(keys) > 2 * _LOAD:
            self._split(ci)

    def _split(self, ci: int) -> None:
        keys = self._keys[ci]
        chunk = self._chunks[ci]
        half = len(keys) // 2
        self._keys[ci : ci + 1] = [keys[:half], keys[half:]]
        self._chunks[ci : ci + 1] = [chunk[:half], chunk[half:]]
        self._maxes[ci : ci + 1] = [self._keys[ci][-1], self._keys[ci + 1][-1]]

    def discard(self, value) -> None:
        k = self._key(value)
        if not self._maxes:
            return
        ci = bisect_left(self._maxes, k)
        # equal keys may straddle a chunk boundary: scan forward while the
        # chunk can still hold this key
        while ci < len(self._maxes):
            keys = self._keys[ci]
            pos = bisect_left(keys, k)
            while pos < len(keys) and keys[pos] == k:
                if self._chunks[ci][pos] == value:
                    del keys[pos]
                    del self._chunks[ci][pos]
                    self._len -= 1
                    if not keys:
                        del self._keys[ci]
                        del self._chunks[ci]
                        del self._maxes[ci]
                    else:
                        self._maxes[ci] = keys[-1]
                    return
                pos += 1
            if pos < len(keys):
                return  # key range exhausted within this chunk
            ci += 1

    def update(self, iterable) -> None:
        for v in iterable:
            self.add(v)
