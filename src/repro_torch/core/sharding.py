"""Time-range shard partitioner + rank assignment (paper §3, Data generation).

The paper: "We evenly partition the full time range into N non-overlapping
shards ... Given P MPI ranks, we choose block partitioning over cyclic
partitioning because the dataset is static and workload predictability is
high. Block partitioning assigns contiguous shards to each rank, reducing
query overhead, improving data locality, and enabling efficient SQL query
execution."

Both block and cyclic assignments are implemented (the paper's choice is the
default; the benchmark harness compares them — cyclic forces each rank to
issue N/P scattered range queries instead of one contiguous range).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """A partition of [t_start, t_end) into n_shards equal time shards."""

    t_start: int              # ns, inclusive
    t_end: int                # ns, exclusive
    n_shards: int

    def __post_init__(self):
        if self.t_end <= self.t_start:
            raise ValueError("empty time range")
        if self.n_shards <= 0:
            raise ValueError("n_shards must be positive")

    @property
    def width(self) -> float:
        return (self.t_end - self.t_start) / self.n_shards

    def boundaries(self) -> np.ndarray:
        """(n_shards+1,) int64 boundaries; last == t_end exactly."""
        edges = self.t_start + np.round(
            np.arange(self.n_shards + 1) * self.width).astype(np.int64)
        edges[0] = self.t_start
        edges[-1] = self.t_end
        return edges

    def shard_bounds(self, idx: int) -> Tuple[int, int]:
        e = self.boundaries()
        return int(e[idx]), int(e[idx + 1])

    def shard_of(self, timestamps: np.ndarray) -> np.ndarray:
        """Map int64 ns timestamps -> shard index (clipped into range).

        The offset from ``t_start`` is taken in int64 BEFORE any float
        conversion: epoch-scale ns (~1.7e18) round to multiples of 256 in
        float64, so converting the absolute timestamp first mis-binned
        events within ~256 ns of a shard boundary. The small relative
        offset is exactly representable."""
        ts = np.asarray(timestamps)
        if ts.dtype.kind == "f":
            ts = ts.astype(np.int64)
        rel = (ts - self.t_start).astype(np.float64) / self.width
        return np.clip(rel.astype(np.int64), 0, self.n_shards - 1)

    @staticmethod
    def from_interval(t_start: int, t_end: int,
                      interval_ns: int) -> "ShardPlan":
        """Paper default: fixed user-defined duration (interval = 1 s)."""
        n = max(1, int(np.ceil((t_end - t_start) / interval_ns)))
        return ShardPlan(t_start=t_start,
                         t_end=int(t_start + n * interval_ns),
                         n_shards=n)

    def extended_to(self, t_end: int) -> "ShardPlan":
        """Append-mode re-derivation: the smallest plan covering
        ``[t_start, >= t_end)`` whose boundaries keep THIS plan's shard
        boundaries as an exact prefix (same integral shard width, more
        shards). Existing shard files therefore keep their indices and
        time bounds; only shards past the old ``t_end`` are new."""
        if t_end <= self.t_end:
            return self
        width = (self.t_end - self.t_start) / self.n_shards
        if width != int(width):
            raise ValueError(
                f"plan with non-integral shard width {width!r} ns cannot "
                "be extended without moving existing boundaries")
        return ShardPlan.from_interval(self.t_start, t_end, int(width))


def block_assignment(n_shards: int, n_ranks: int) -> List[np.ndarray]:
    """Contiguous shard blocks per rank; sizes differ by at most one."""
    if n_ranks <= 0:
        raise ValueError("n_ranks must be positive")
    counts = np.full(n_ranks, n_shards // n_ranks, dtype=np.int64)
    counts[: n_shards % n_ranks] += 1
    offsets = np.concatenate([[0], np.cumsum(counts)])
    return [np.arange(offsets[r], offsets[r + 1], dtype=np.int64)
            for r in range(n_ranks)]


def cyclic_assignment(n_shards: int, n_ranks: int) -> List[np.ndarray]:
    """Round-robin shard ownership: rank r owns shards r, r+P, r+2P, ..."""
    if n_ranks <= 0:
        raise ValueError("n_ranks must be positive")
    return [np.arange(r, n_shards, n_ranks, dtype=np.int64)
            for r in range(n_ranks)]


def assignment(n_shards: int, n_ranks: int, kind: str) -> List[np.ndarray]:
    if kind == "block":
        return block_assignment(n_shards, n_ranks)
    if kind == "cyclic":
        return cyclic_assignment(n_shards, n_ranks)
    raise ValueError(f"unknown partitioning {kind!r}")


def owner_of_shards(n_shards: int, n_ranks: int, kind: str) -> np.ndarray:
    """(n_shards,) array mapping shard -> owning rank."""
    owner = np.zeros(n_shards, dtype=np.int64)
    for r, idxs in enumerate(assignment(n_shards, n_ranks, kind)):
        owner[idxs] = r
    return owner


def contiguous_rank_range(plan: ShardPlan, shard_ids: np.ndarray
                          ) -> Tuple[int, int]:
    """Time bounds covering a rank's *contiguous* block of shards.

    This is what makes block partitioning cheap: a rank's whole workload is
    ONE indexed SQL range query instead of N/P scattered ones.
    """
    if len(shard_ids) == 0:
        return (plan.t_start, plan.t_start)
    lo, _ = plan.shard_bounds(int(shard_ids.min()))
    _, hi = plan.shard_bounds(int(shard_ids.max()))
    return lo, hi
