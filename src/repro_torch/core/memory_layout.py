"""Address-space layout of the accelerators' data structures.

Per the paper (Sect. 2.2): "we assume that the different data structures lie
adjacent in memory as plain arrays.  We generate memory addresses according
to this memory layout and the width of the array types in bytes."

A MemoryLayout allocates named regions sequentially (row-buffer aligned so
distinct structures never share a DRAM row, which matches placing them in
separate physical regions).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class MemoryLayout:
    align: int = 8192  # row-buffer alignment
    _cursor: int = 0
    regions: dict[str, tuple[int, int]] = dataclasses.field(default_factory=dict)

    def alloc(self, name: str, nbytes: int) -> int:
        """Allocate a region; returns its base byte address."""
        base = self._cursor
        self.regions[name] = (base, nbytes)
        self._cursor = -(-(base + nbytes) // self.align) * self.align
        return base

    def base(self, name: str) -> int:
        return self.regions[name][0]

    @property
    def total_bytes(self) -> int:
        return self._cursor

    def contains(self, line: int) -> bool:
        return 0 <= line * 64 < self._cursor
