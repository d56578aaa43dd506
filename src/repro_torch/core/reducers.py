"""Pluggable mergeable-reducer suite for per-(bin, group, metric) stats.

The aggregation engine (see :mod:`repro_torch.core.aggregation`) streams shard
files once and reduces each sample into per-time-bin statistics. This
module defines WHAT is reduced: a registry of *mergeable reducers*, each a
small dataclass of numpy arrays satisfying a common contract so every
layer of the engine — per-rank accumulation, group densify, round-robin
merge, the device (torch) backend, the versioned summary cache — is
generic over the statistic being computed:

  zeros(n_bins, trailing)   merge identity, shape (n_bins, *trailing, ...)
  bin_grouped(...)          accumulate raw samples (numpy reference path)
  merge(other)              associative + commutative combine
  take_bins(idx)            slice the bin axis (round-robin ownership)
  take_group(gi)            slice one group off a dense tensor
  stack_groups(parts)       densify: stack per-group states on axis 1
  merge_groups()            reduce the group axis (== ungrouped statistic)
  select_metric(j)          1-D view of one metric
  to_payload()/from_payload()  flat dict of arrays for the summary cache
  device_reduce(...)        device path: segment reduce of raw samples
                            on a torch device (the port's CUDA kernels)
  from_device_block(block)  decode one shard's slice of the device output
                            into a host state (the cached device partial)

Registered reducers:

  ``"moments"``   :class:`BinStats` — count/sum/sumsq/min/max partial
    moments (Chan et al. pairwise merge; EXACT across any partitioning).
  ``"quantile"``  :class:`QuantileSketch` — fixed-width log2-bucket
    histogram, mergeable by pure addition, answering P50/P95/P99 and
    within-bin IQR with bounded relative error (:data:`QUANTILE_REL_ERR`).

The merge for every reducer is associative and commutative elementwise
array arithmetic, which is exactly the property the round-robin
collaborative reduction and the device backend's per-shard partials
all rely on (property-tested in tests/test_reducers.py).
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar, Dict, List, Sequence, Tuple, Type

import numpy as np
import torch


def _on(x, dtype: torch.dtype, device) -> torch.Tensor:
    """``x`` as a contiguous ``dtype`` tensor on ``device`` (no copy when
    it already is one)."""
    return torch.as_tensor(x, dtype=dtype, device=device).contiguous()


# --- quantile sketch bucketization constants -------------------------------
# Fixed log2 buckets: bucket(v) = clip(floor(log2(max(v, V_FLOOR)) *
# SUBDIV), 0, N_BUCKETS-1). SUBDIV buckets per octave; N_BUCKETS covers
# [V_FLOOR, V_FLOOR * 2^(N_BUCKETS/SUBDIV)) — 48 octaves ≈ [1ns, 78h] for
# duration metrics.
N_BUCKETS = 384
SUBDIV = 8
V_FLOOR = 1.0

# In-range values are estimated by the geometric midpoint of their bucket,
# so the worst-case relative error is 2^(1/(2*SUBDIV)) - 1 (~4.4%).
QUANTILE_REL_ERR = float(2.0 ** (1.0 / (2 * SUBDIV)) - 1.0)

# Representative (estimate) value per bucket: geometric bucket midpoint.
BUCKET_VALUES = V_FLOOR * np.exp2((np.arange(N_BUCKETS) + 0.5) / SUBDIV)

REDUCER_REGISTRY: Dict[str, Type["MergeableReducer"]] = {}


def register_reducer(cls: Type["MergeableReducer"]):
    """Class decorator: register ``cls`` under ``cls.name``."""
    REDUCER_REGISTRY[cls.name] = cls
    return cls


def get_reducer(name: str) -> Type["MergeableReducer"]:
    try:
        return REDUCER_REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown reducer {name!r}; registered: "
                       f"{sorted(REDUCER_REGISTRY)}") from None


def normalize_reducers(reducers: Sequence[str]) -> Tuple[str, ...]:
    """Validated, de-duplicated suite with ``"moments"`` always first.

    Moments are mandatory: the legacy 1-D result view, the anomaly mean/
    std scores and the Fig-1b byte breakdown all derive from them, and
    they are cheap next to any additional reducer.
    """
    out: List[str] = ["moments"]
    for name in reducers:
        get_reducer(name)
        if name not in out:
            out.append(name)
    return tuple(out)


class MergeableReducer:
    """Shared generic machinery; subclasses are dataclasses of ndarrays.

    ``fields`` names the array attributes. Array layout contract: axis 0
    is the time bin; a dense grouped tensor carries (group, metric) as
    axes 1 and 2; a reducer may append private trailing axes after those
    (the quantile sketch appends its bucket axis last).
    """

    name: ClassVar[str]
    fields: ClassVar[Tuple[str, ...]]

    def _map(self, fn, *others):
        cls = type(self)
        return cls(**{f: fn(getattr(self, f),
                             *(getattr(o, f) for o in others))
                      for f in self.fields})

    @property
    def n_bins(self) -> int:
        return int(getattr(self, self.fields[0]).shape[0])

    @property
    def trailing(self) -> Tuple[int, ...]:
        """Public trailing shape between the bin axis and any private
        reducer axes — () for 1-D, (G, M) for a dense grouped tensor.
        Subclasses with private trailing axes (bucket axis) override."""
        return tuple(getattr(self, self.fields[0]).shape[1:])

    def take_bins(self, idx: np.ndarray):
        """Slice along the bin axis (keeps any trailing axes)."""
        return self._map(lambda a: a[idx])

    def take_group(self, gi: int):
        """Slice group ``gi`` off a dense (n_bins, G, ...) tensor."""
        return self._map(lambda a: a[:, gi])

    def take_metrics(self, idx: np.ndarray):
        """Reorder/select the metric axis of a dense (n_bins, G, M, ...)
        tensor by index vector — how the query engine presents tensors
        computed in canonical metric order back in the caller's order
        (exact: metrics accumulate independently, so this is a pure
        relabeling). Subclasses whose private axes trail the metric axis
        (the quantile sketch's bucket axis) override."""
        idx = np.asarray(idx, np.int64)
        return self._map(lambda a: a[..., idx])

    @classmethod
    def stack_groups(cls, parts: Sequence["MergeableReducer"]):
        """Densify: stack per-group states into the (n_bins, G, ...)
        tensor (inverse of :meth:`take_group`)."""
        return cls(**{f: np.stack([getattr(p, f) for p in parts], axis=1)
                      for f in cls.fields})

    def assign_bins(self, idx: np.ndarray, seg: "MergeableReducer") -> None:
        """Write ``seg`` into this state at bin rows ``idx`` (round-robin
        merge writeback)."""
        for f in self.fields:
            getattr(self, f)[idx] = getattr(seg, f)

    def merge_at(self, idx: np.ndarray, seg: "MergeableReducer") -> None:
        """In-place sparse merge: combine ``seg`` (whose bin axis is the
        rows ``idx``) into this state's rows ``idx``, leaving every other
        bin untouched. Same per-row semantics as :meth:`merge` — this is
        how the incremental engine folds a shard's sparse partial into a
        dense rank state without materializing a full-width tensor per
        shard. Subclasses must override (field ops differ: sums add,
        min/max clamp)."""
        raise NotImplementedError

    # -- device (torch) partial export ---------------------------------------
    @classmethod
    def device_reduce(cls, seg_ids, values, n_seg: int, device,
                      valid) -> np.ndarray:
        """Segment reduce of raw samples on ``device``.

        ``seg_ids``/``valid`` are (N,) arrays, ``values`` is
        (n_metrics, N) — numpy or tensors already on ``device`` (the
        batched driver uploads once and shares the tensors across the
        suite). Returns the post-segment-reduce tensor as a HOST array of
        shape ``(n_seg, n_metrics, *private)`` — the raw material of the
        per-shard device partials the torch driver caches. Subclasses
        with a device path override."""
        raise NotImplementedError(
            f"reducer {cls.name!r} has no device path")

    @classmethod
    def from_device_block(cls, block: np.ndarray) -> "MergeableReducer":
        """Decode one shard's ``(B, G, M, *private)`` slice of the
        :meth:`device_reduce` output into a host state — float64 arrays
        holding the device's float32 values exactly, with empty cells
        restored to the merge identity, so the host ``merge_at`` fold
        over device partials is deterministic and cacheable."""
        raise NotImplementedError(
            f"reducer {cls.name!r} has no device path")

    # -- summary-cache (de)serialization ------------------------------------
    @classmethod
    def payload_prefix(cls) -> str:
        # moments keep their historical bare key names (count/sum/...)
        return "" if cls.name == "moments" else f"{cls.name}__"

    def to_payload(self) -> Dict[str, np.ndarray]:
        p = self.payload_prefix()
        return {p + f: getattr(self, f) for f in self.fields}

    @classmethod
    def from_payload(cls, payload: Dict[str, np.ndarray]):
        p = cls.payload_prefix()
        return cls(**{f: payload[p + f] for f in cls.fields})


@register_reducer
@dataclasses.dataclass
class BinStats(MergeableReducer):
    """Per-bin partial moments. Shapes all (n_bins,) in the single-metric
    case, or (n_bins, n_groups, n_metrics) for the grouped tensor — every
    operation below is elementwise over the trailing axes."""

    count: np.ndarray     # float64
    sum: np.ndarray       # float64
    sumsq: np.ndarray     # float64
    min: np.ndarray       # float64 (+inf where empty)
    max: np.ndarray       # float64 (-inf where empty)

    name: ClassVar[str] = "moments"
    fields: ClassVar[Tuple[str, ...]] = ("count", "sum", "sumsq",
                                         "min", "max")

    @staticmethod
    def zeros(n_bins: int, trailing: Tuple[int, ...] = ()) -> "BinStats":
        shape = (n_bins, *trailing)
        return BinStats(
            count=np.zeros(shape), sum=np.zeros(shape),
            sumsq=np.zeros(shape),
            min=np.full(shape, np.inf), max=np.full(shape, -np.inf))

    def merge(self, other: "BinStats") -> "BinStats":
        """Associative, commutative merge — the collaborative-reduce op."""
        return BinStats(
            count=self.count + other.count,
            sum=self.sum + other.sum,
            sumsq=self.sumsq + other.sumsq,
            min=np.minimum(self.min, other.min),
            max=np.maximum(self.max, other.max))

    def merge_at(self, idx: np.ndarray, seg: "BinStats") -> None:
        self.count[idx] += seg.count
        self.sum[idx] += seg.sum
        self.sumsq[idx] += seg.sumsq
        self.min[idx] = np.minimum(self.min[idx], seg.min)
        self.max[idx] = np.maximum(self.max[idx], seg.max)

    def merge_groups(self) -> "BinStats":
        """Reduce the group axis of a (n_bins, G, M) tensor — every sample
        belongs to exactly one group, so this IS the ungrouped statistic."""
        if self.count.ndim < 3:
            return self
        return BinStats(
            count=self.count.sum(axis=1), sum=self.sum.sum(axis=1),
            sumsq=self.sumsq.sum(axis=1),
            min=self.min.min(axis=1), max=self.max.max(axis=1))

    def select_metric(self, j: int) -> "BinStats":
        """1-D view of metric ``j`` from a (..., n_metrics) tensor."""
        if self.count.ndim == 1:
            return self
        return self._map(lambda a: a[..., j])

    @classmethod
    def bin_grouped(cls, timestamps: np.ndarray, values: np.ndarray,
                    group_ids: np.ndarray, n_groups: int,
                    plan) -> "BinStats":
        """Single-pass grouped multi-metric moment accumulation (numpy).

        values   : (n_events, n_metrics) float64
        group_ids: (n_events,) int in [0, n_groups)

        Each metric column is accumulated with its own ``np.add.at`` over
        the same flat (bin, group) index, so per-metric results are
        bit-identical to a single-metric run over the same rows.
        """
        n_bins = plan.n_shards
        values = np.asarray(values, np.float64)
        if values.ndim == 1:
            values = values[:, None]
        n_metrics = values.shape[1]
        out = cls.zeros(n_bins, (n_groups, n_metrics))
        if np.asarray(timestamps).size == 0:
            return out
        flat = plan.shard_of(timestamps) * n_groups + np.asarray(group_ids)
        nbg = n_bins * n_groups
        # additive channels go through np.bincount, which accumulates in
        # input order exactly like np.add.at (bitwise-identical float64
        # sums) but several times faster; min/max have no bincount form
        cnt = np.bincount(flat, minlength=nbg).astype(np.float64)
        out.count[...] = np.broadcast_to(
            cnt.reshape(n_bins, n_groups, 1), out.count.shape)
        for j in range(n_metrics):
            v = values[:, j]
            s = np.bincount(flat, weights=v, minlength=nbg)
            ss = np.bincount(flat, weights=v * v, minlength=nbg)
            mn = np.full(nbg, np.inf)
            mx = np.full(nbg, -np.inf)
            np.minimum.at(mn, flat, v)
            np.maximum.at(mx, flat, v)
            out.sum[:, :, j] = s.reshape(n_bins, n_groups)
            out.sumsq[:, :, j] = ss.reshape(n_bins, n_groups)
            out.min[:, :, j] = mn.reshape(n_bins, n_groups)
            out.max[:, :, j] = mx.reshape(n_bins, n_groups)
        return out

    @classmethod
    def device_reduce(cls, seg_ids, values, n_seg: int, device,
                      valid) -> np.ndarray:
        from ..kernels.binstats.ops import disordered
        from .distributed import distributed_moments_flat
        out = distributed_moments_flat(
            _on(seg_ids, torch.int32, device),
            _on(values, torch.float32, device), n_seg,
            valid=_on(valid, torch.bool, device)).cpu().numpy()
        # the kernel's order verdict arrives in this copy (a NaN count)
        if disordered(out):
            raise ValueError("binstats_flat: rows are not segment-ordered "
                             "(seg must be non-decreasing on CUDA tensors)")
        return np.moveaxis(out, 0, 1)   # (n_seg, M, 5)

    @classmethod
    def from_device_block(cls, block: np.ndarray) -> "BinStats":
        """(B, G, M, 5) device moments -> host state. Cells no sample
        reached carry the device's finite min/max sentinels — restored
        to the ±inf merge identity here (count is exact for them: a sum
        of zero weights)."""
        count = block[..., 0].astype(np.float64)
        occupied = count > 0
        return BinStats(
            count=count,
            sum=block[..., 1].astype(np.float64),
            sumsq=block[..., 2].astype(np.float64),
            min=np.where(occupied, block[..., 3].astype(np.float64),
                         np.inf),
            max=np.where(occupied, block[..., 4].astype(np.float64),
                         -np.inf))

    # -- derived statistics (paper reports min / max / std) -----------------
    @property
    def mean(self) -> np.ndarray:
        c = np.maximum(self.count, 1.0)
        return self.sum / c

    @property
    def var(self) -> np.ndarray:
        c = np.maximum(self.count, 1.0)
        v = self.sumsq / c - (self.sum / c) ** 2
        return np.maximum(v, 0.0)

    @property
    def std(self) -> np.ndarray:
        return np.sqrt(self.var)

    def finite_min(self) -> np.ndarray:
        return np.where(np.isfinite(self.min), self.min, 0.0)

    def finite_max(self) -> np.ndarray:
        return np.where(np.isfinite(self.max), self.max, 0.0)


def bucket_of(values: np.ndarray) -> np.ndarray:
    """Quantile-sketch bucket index per value (numpy float64 host path).

    Non-positive / sub-floor values land in the underflow bucket 0; values
    beyond the covered range clip into the top bucket — both keep counts
    conserved, at the cost of the error bound for those samples.
    """
    v = np.maximum(np.asarray(values, np.float64), V_FLOOR)
    idx = np.floor(np.log2(v) * SUBDIV).astype(np.int64)
    return np.clip(idx, 0, N_BUCKETS - 1)


@register_reducer
@dataclasses.dataclass
class QuantileSketch(MergeableReducer):
    """Fixed-width log2-bucket histogram sketch of per-bin distributions.

    ``counts`` is (n_bins, N_BUCKETS) in the 1-D case or
    (n_bins, n_groups, n_metrics, N_BUCKETS) for the grouped tensor — the
    bucket axis is always LAST. Merging is pure elementwise addition,
    which makes the sketch exact under any partitioning/merge order. The
    device backend counts segment-ordered rows with shared-memory integer
    atomics, one block per range of segments, and writes each count once;
    rows out of order reach :meth:`device_reduce` as NaN counts, and it
    raises.

    Quantile answers carry bounded relative error
    :data:`QUANTILE_REL_ERR` for values within the covered range (the
    type-1 / inverted-CDF order statistic is located exactly; only the
    within-bucket position is approximated by the geometric midpoint).
    """

    counts: np.ndarray    # float64, bucket axis last

    name: ClassVar[str] = "quantile"
    fields: ClassVar[Tuple[str, ...]] = ("counts",)

    @staticmethod
    def zeros(n_bins: int,
              trailing: Tuple[int, ...] = ()) -> "QuantileSketch":
        return QuantileSketch(
            counts=np.zeros((n_bins, *trailing, N_BUCKETS)))

    @property
    def trailing(self) -> Tuple[int, ...]:
        return tuple(self.counts.shape[1:-1])   # bucket axis is private

    def merge(self, other: "QuantileSketch") -> "QuantileSketch":
        return QuantileSketch(counts=self.counts + other.counts)

    def merge_at(self, idx: np.ndarray, seg: "QuantileSketch") -> None:
        self.counts[idx] += seg.counts

    def merge_groups(self) -> "QuantileSketch":
        if self.counts.ndim < 4:
            return self
        return QuantileSketch(counts=self.counts.sum(axis=1))

    def select_metric(self, j: int) -> "QuantileSketch":
        if self.counts.ndim == 2:
            return self
        return QuantileSketch(counts=self.counts[..., j, :])

    def take_metrics(self, idx: np.ndarray) -> "QuantileSketch":
        idx = np.asarray(idx, np.int64)
        return QuantileSketch(counts=self.counts[..., idx, :])

    @classmethod
    def bin_grouped(cls, timestamps: np.ndarray, values: np.ndarray,
                    group_ids: np.ndarray, n_groups: int,
                    plan) -> "QuantileSketch":
        """Single-pass grouped multi-metric histogram accumulation."""
        n_bins = plan.n_shards
        values = np.asarray(values, np.float64)
        if values.ndim == 1:
            values = values[:, None]
        n_metrics = values.shape[1]
        out = cls.zeros(n_bins, (n_groups, n_metrics))
        if np.asarray(timestamps).size == 0:
            return out
        bg = plan.shard_of(timestamps) * n_groups + np.asarray(group_ids)
        size = n_bins * n_groups * N_BUCKETS
        for j in range(n_metrics):
            flat = bg * N_BUCKETS + bucket_of(values[:, j])
            c = np.bincount(flat, minlength=size).astype(np.float64)
            out.counts[:, :, j, :] = c.reshape(n_bins, n_groups,
                                               N_BUCKETS)
        return out

    @classmethod
    def device_reduce(cls, seg_ids, values, n_seg: int, device,
                      valid) -> np.ndarray:
        from ..kernels.histbin.ops import disordered
        from .distributed import distributed_histogram_flat
        out = distributed_histogram_flat(
            _on(seg_ids, torch.int32, device),
            _on(values, torch.float32, device), n_seg,
            valid=_on(valid, torch.bool, device)).cpu().numpy()
        # the kernel's order verdict arrives in this copy (NaN counts)
        if disordered(out):
            raise ValueError("histbin_flat: rows are not segment-ordered "
                             "(seg must be non-decreasing on CUDA tensors)")
        return np.moveaxis(out, 0, 1)   # (n_seg, M, NB)

    @classmethod
    def from_device_block(cls, block: np.ndarray) -> "QuantileSketch":
        """(B, G, M, N_BUCKETS) device counts -> host state (bucket axis
        is already last; counts are additive so no identity fixup)."""
        return QuantileSketch(counts=block.astype(np.float64))

    # -- queries ------------------------------------------------------------
    def total(self) -> np.ndarray:
        """Per-bin sample count (leading shape of ``counts``)."""
        return self.counts.sum(axis=-1)

    def quantile(self, q: float) -> np.ndarray:
        """Per-bin q-quantile estimate; 0.0 for empty bins.

        Locates the type-1 (inverted-CDF) order statistic in the bucket
        cumsum, then estimates it by the bucket's geometric midpoint."""
        c = self.counts
        n = c.sum(axis=-1)
        rank = np.maximum(np.ceil(q * n), 1.0)
        cdf = np.cumsum(c, axis=-1)
        idx = np.argmax(cdf >= rank[..., None], axis=-1)
        return np.where(n > 0, BUCKET_VALUES[idx], 0.0)

    def iqr(self) -> np.ndarray:
        """Per-bin within-bin interquartile range (Q3 - Q1) estimate."""
        return np.maximum(self.quantile(0.75) - self.quantile(0.25), 0.0)
