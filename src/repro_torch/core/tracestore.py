"""Columnar shard store — the framework's "parquet" stand-in.

The paper's data-generation phase writes each shard's query results to a
consistently named parquet file so the aggregation phase can address shards
without coordination. pyarrow is not available offline, so we provide a
self-contained columnar store with the same contract:

  - one file per (rank-agnostic) shard index: ``shard_{idx:06d}.npz``
  - a JSON manifest recording the global partition (time range, shard count,
    interval, rank assignment, schema) so any process can locate any shard.

Files are written atomically (tmp + rename) so a crashed writer never leaves
a torn shard — part of the fault-tolerance story.

Two-level derived-data cache
----------------------------
The incremental analysis engine keeps TWO kinds of derived files next to
the shards, both round-tripped through the reducer ``to_payload`` /
``from_payload`` contract (:mod:`repro_torch.core.reducers`):

``pack_{idx:06d}.bin`` — per-shard partial PACK
    ALL of one shard's pre-merge reducer states, one logical entry per
    query. Each 16-hex entry key (``qkey``) hashes the QUERY only: the
    canonical form of a :class:`repro_torch.core.query.Query`
    (version-stamped; order-insensitive metrics, group_by, reducer
    suite, and the row predicates — time window, rank / kernel-name /
    transfer-kind subsets), the plan's ``(t_start, width)``, and — for
    the torch backend's DEVICE partials — a ``precision="torch-float32"``
    namespace salt, so the float32 post-segment-reduce tensors never
    masquerade as exact host partials. Payload tensors are stored in
    CANONICAL metric order (readers permute back to the caller's
    order), which is what lets ``metrics=("a", "b")`` and ``("b", "a")``
    share one entry. Each payload embeds the ``(size, mtime_ns)``
    fingerprint of the shard file it was computed from; a fingerprint
    mismatch at read time is a miss, so a partial can never be served
    for rewritten shard data. ``write_shard`` invalidates ONLY the
    written shard's pack (one unlink, no summary files touched) — which
    is what makes appending new trace O(dirty shards): every clean
    shard's pack survives and the next aggregation merges it back in
    without touching the raw shard.

    On-disk pack layout (append-friendly: a new batch of entries lands
    as ONE in-place append; entry removal is an atomic tmp+rename
    rewrite — see :meth:`TraceStore.write_partials` /
    :meth:`TraceStore.compact_pack`)::

      [record bytes ...]                 one packed payload per entry
      [json footer]                      {"entries": {qkey: [off, len,
                                          {"version", "fingerprint"}]}}
      [8-byte LE footer length][8-byte magic "RPPACK01"]

    The footer rides the END of the file so an append never rewrites
    existing records, and its per-entry ``meta`` duplicates each
    payload's version + fingerprint stamps so liveness sweeps
    (:meth:`TraceStore.gc_stale`) and classification probes validate
    every entry of a shard from ONE O(footer) tail read. A torn or
    corrupt footer makes every entry a miss (never a crash): the shard
    is reclassified dirty, rescanned, and the next write rewrites the
    pack clean. Each record is the payload packed into one buffer
    (length-prefixed json index + concatenated array bytes,
    :meth:`TraceStore._pack_arrays`) so a bulk delta load costs one
    sequential read per SHARD — not one file open per (query, shard),
    the syscall floor that capped fused-batch speedup when every entry
    was its own ``partial_{idx:06d}_{qkey}.npy`` file. Those per-file
    entries are still READ as a migration path (pack entry first, then
    the legacy file) and swept by gc; new writes only ever produce
    packs. ``io_counts`` tallies both views: ``partial_reads`` /
    ``partial_writes`` count logical entries (what the per-file scheme
    would have done), ``pack_reads`` / ``pack_writes`` count physical
    pack file operations — the fused-batch IO win is the ratio.
    Logical payload arrays (bin axis = the ``bins`` actually touched,
    so a partial is O(rows-of-one-shard), not O(n_bins)):

      ``version, t_start, t_end, n_shards``  engine + plan stamp
      ``idx, fingerprint``                   shard index + (size, mtime_ns)
      ``metrics, group_by, group_keys``      query + local group keys
      ``reducers``                           suite in order
      ``bins``                               (B,) int64 bins present
      ``count,sum,...`` / ``quantile__counts``  (B, G, M[, buckets])
      ``kind_keys, kind_bytes``              (K,), (K, n_bins) byte bins

``summary_{key}.npz`` — merged-suite summary cache
    The fully merged result of one query over the whole store. The
    ``key`` hashes the same canonical query form plus the full plan
    triple and ``precision`` (host float64 paths share ``"exact"``; the
    torch float32 device path is keyed apart). The shard fingerprint is NOT in the key any more: the payload
    records the ``covered`` fingerprint list — sorted
    ``(shard_idx, size, mtime_ns)`` triples — and
    :func:`repro_torch.core.aggregation.lookup_summary` treats any mismatch
    with the store's current fingerprint as a miss. A recompute then
    overwrites the same file, so stale summaries never accumulate per
    query; summaries orphaned by shard rewrites are garbage-collected
    once at manifest-write time (:meth:`TraceStore.gc_stale`), not on
    every shard write. A payload whose embedded ``version`` differs from
    the running SUMMARY_VERSION is likewise a miss, never a crash.
    Payload layout (on top of the bookkeeping arrays above):

      ``count,sum,sumsq,min,max``     (n_bins, G, M) float64 moments
      ``{name}__...``                 any extra reducer's arrays
      ``covered``                     (S, 3) int64 fingerprint triples

Summaries are O(n_bins) — repeat queries are answered without touching the
raw shards; partials make a CHANGED store answerable in O(dirty shards)
(see :func:`repro_torch.core.aggregation.run_aggregation`).
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import io
import itertools
import json
import os
import threading
import time
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# SUMMARY_VERSION lives with the canonical query form (the cache keys
# hash it); re-exported here because every payload reader stamps it.
from .query import Query, SUMMARY_VERSION  # noqa: F401  (re-export)


def shard_filename(idx: int) -> str:
    return f"shard_{idx:06d}.npz"


def summary_filename(key: str) -> str:
    return f"summary_{key}.npz"


def partial_filename(idx: int, qkey: str) -> str:
    """LOGICAL name of one (shard, query) partial entry. Pre-pack
    stores hold these as real ``.npy`` files (still readable — the
    migration path); pack-era stores only synthesize the names so
    per-entry bookkeeping (``partial_names`` counts, gc accounting)
    stays comparable across layouts."""
    return f"partial_{idx:06d}_{qkey}.npy"


def pack_filename(idx: int) -> str:
    """One consolidated partial PACK per shard (module docstring has
    the record + footer layout)."""
    return f"pack_{idx:06d}.bin"


@dataclasses.dataclass
class StoreManifest:
    t_start: int
    t_end: int
    n_shards: int
    n_ranks: int
    partitioning: str                  # "block" | "cyclic"
    columns: List[str]
    shard_owner: List[int]             # rank owning each shard (generation)
    extra: Dict = dataclasses.field(default_factory=dict)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_json(s: str) -> "StoreManifest":
        return StoreManifest(**json.loads(s))


class TraceStore:
    """Directory of columnar shard files + manifest + partial/summary cache.

    ``io_counts`` tallies this instance's file traffic (``shard_reads``,
    ``partial_reads``, ``partial_writes``, ``summary_reads``,
    ``summary_writes`` count logical entries; ``pack_reads``,
    ``pack_writes`` count physical partial-pack file operations) — the
    incremental-path tests assert through it that a delta aggregation
    touches only dirty shard files, and the fused-batch IO claim is the
    logical/physical ratio. Generation/append runs add the ingest pair:
    ``ingest_rows_read`` (event rows actually fetched from the source
    SQLite exports) and ``ingest_rows_skipped`` (rows an ingest-time
    pushdown predicate excluded SQL-side — counted, never
    materialized); their ratio is the pushdown IO win the ingest bench
    gates on. Updates are lock-protected: the background partial
    writer and concurrent serving threads share one instance.
    """

    MANIFEST = "manifest.json"
    _PACK_MAGIC = b"RPPACK01"
    # raw pack bytes cached per shard (stat-validated); bounds a
    # long-lived serving instance without an explicit byte budget —
    # packs are O(active queries x one shard's touched bins)
    _PACK_CACHE_MAX = 512
    # a cached shard stat-snapshot is trusted only while the directory
    # mtime is unchanged AND the snapshot was taken with the directory
    # already quiet for this long — two renames inside one filesystem
    # timestamp granule could alias, a directory idle for longer cannot
    _STAT_GRACE_NS = 100_000_000          # 100 ms
    _SUMMARY_CACHE_MAX = 128

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self.io_counts: collections.Counter = collections.Counter()
        self._io_lock = threading.Lock()
        # serializes pack read-modify-write cycles within this process;
        # cross-process safety comes from tmp+rename (and from the
        # schedulers never handing one shard to two writers)
        self._pack_lock = threading.RLock()
        # idx -> [stat key, entries|None (None = corrupt), data_end, raw]
        self._pack_cache: collections.OrderedDict = collections.OrderedDict()
        # (dir mtime_ns, {idx: fingerprint}) — see shard_stats
        self._stat_lock = threading.Lock()
        self._stat_snapshot: Optional[
            Tuple[int, Dict[int, Tuple[int, int, int]]]] = None
        # (snapshot dict, (n, 3) int64 array) — identity-keyed memo of
        # the ndarray form summary-freshness compares want
        self._fp_array: Optional[Tuple[Dict, np.ndarray]] = None
        # summary-key -> ((size, mtime_ns), read-only payload) memo
        self._summary_lock = threading.Lock()
        self._summary_cache: collections.OrderedDict = \
            collections.OrderedDict()

    def _count(self, name: str, n: int = 1) -> None:
        with self._io_lock:
            self.io_counts[name] += n

    # -- manifest ----------------------------------------------------------
    def write_manifest(self, manifest: StoreManifest) -> None:
        """Persist the manifest, then garbage-collect derived files
        orphaned by whatever shard writes preceded it (the once-per-batch
        replacement for the old per-shard-write summary purge)."""
        self._atomic_write(os.path.join(self.root, self.MANIFEST),
                           manifest.to_json().encode())
        self.gc_stale()

    def read_manifest(self) -> StoreManifest:
        with open(os.path.join(self.root, self.MANIFEST)) as f:
            return StoreManifest.from_json(f.read())

    # -- shards ------------------------------------------------------------
    def write_shard(self, idx: int, columns: Dict[str, np.ndarray]) -> str:
        """Atomically write one shard's columns.

        Invalidation is per-shard: only THIS shard's partial-cache files
        are unlinked. Summaries validate their ``covered`` fingerprints at
        read time and are swept by :meth:`gc_stale` at manifest-write
        time, so concurrent rank writers no longer race on a store-wide
        cache purge here."""
        path = os.path.join(self.root, shard_filename(idx))
        self._atomic_savez(path, columns)
        self.clear_partials(idx)
        return path

    # -- staged shard commit (write-ahead append) --------------------------
    # A multi-shard mutation (run_append) is not atomic as a sequence even
    # though each write_shard is: a crash mid-sequence used to leave the
    # store unrecoverable. Staging splits every shard write into a PREPARE
    # (materialize the full new contents under a ``.stage`` sibling — no
    # reader ever sees it) and a COMMIT (one rename + partial
    # invalidation, idempotent), so a journal listing the staged indices
    # can be rolled FORWARD after a crash: replayed commits are no-ops
    # for shards already published, renames for the rest.

    STAGE_SUFFIX = ".stage"

    def stage_shard(self, idx: int, columns: Dict[str, np.ndarray]) -> str:
        """Write one shard's FUTURE contents to its staged sibling
        (``shard_{idx}.npz.stage``) without publishing it. Readers,
        ``shard_stats`` and gc never see staged files; nothing is
        invalidated until :meth:`commit_staged_shard`."""
        path = os.path.join(self.root, shard_filename(idx)) \
            + self.STAGE_SUFFIX
        self._atomic_savez(path, columns)
        return path

    def commit_staged_shard(self, idx: int) -> bool:
        """Publish a staged shard: one atomic rename over the live file,
        then per-shard partial invalidation (the :meth:`write_shard`
        contract). Idempotent — returns False when there is no staged
        file, which is exactly the crash-recovery replay case where an
        earlier attempt already committed this shard."""
        final = os.path.join(self.root, shard_filename(idx))
        try:
            os.replace(final + self.STAGE_SUFFIX, final)
        except FileNotFoundError:
            return False
        self.clear_partials(idx)
        return True

    def staged_shard_indices(self) -> List[int]:
        out = []
        suffix = ".npz" + self.STAGE_SUFFIX
        for name in os.listdir(self.root):
            if name.startswith("shard_") and name.endswith(suffix):
                out.append(int(name[len("shard_"):-len(suffix)]))
        return sorted(out)

    def discard_staged_shards(self) -> int:
        """Drop every un-committed staged file (orphans from a preparer
        that died BEFORE journaling — their rows were never published
        and will be re-read from the source DBs)."""
        n = 0
        for idx in self.staged_shard_indices():
            n += self._quiet_remove(
                os.path.join(self.root, shard_filename(idx))
                + self.STAGE_SUFFIX)
        return n

    def read_shard(self, idx: int) -> Dict[str, np.ndarray]:
        path = os.path.join(self.root, shard_filename(idx))
        self._count("shard_reads")
        return self._load_npz(path)

    def has_shard(self, idx: int) -> bool:
        return os.path.exists(os.path.join(self.root, shard_filename(idx)))

    def shard_indices(self) -> List[int]:
        out = []
        for name in os.listdir(self.root):
            if name.startswith("shard_") and name.endswith(".npz"):
                out.append(int(name[len("shard_"):-len(".npz")]))
        # numeric sort, NOT filename sort: {idx:06d} widens past 6 digits
        # at 1e6+ shards and lexicographic order would diverge (breaking
        # the covered-fingerprint compare, which assumes index order)
        return sorted(out)

    # -- fingerprints ------------------------------------------------------
    def stat_shard(self, idx: int) -> Optional[Tuple[int, int, int]]:
        """(idx, size, mtime_ns) for one shard file; None if absent."""
        path = os.path.join(self.root, shard_filename(idx))
        try:
            st = os.stat(path)
        except FileNotFoundError:
            return None
        return (int(idx), int(st.st_size), int(st.st_mtime_ns))

    def shard_stats(self) -> Dict[int, Tuple[int, int, int]]:
        """``{idx: (idx, size, mtime_ns)}`` for every shard file — the
        bulk stat pass behind dirty classification, summary freshness
        checks and gc. Memoized against the store directory's OWN
        mtime: every shard create, rewrite and unlink is a rename or
        unlink of a direct child and bumps it, so on a read-mostly
        store (a warm query service ticking over an unchanged dataset)
        the whole pass collapses to one ``os.stat``. A snapshot is
        cached only when the directory has already been quiet for
        ``_STAT_GRACE_NS`` — inside one timestamp granule two
        modifications can alias to the same mtime, beyond it they
        cannot — so concurrent writers degrade this to exactly the old
        per-shard stat pass, never to stale data."""
        try:
            dir_mtime = int(os.stat(self.root).st_mtime_ns)
        except FileNotFoundError:
            return {}
        with self._stat_lock:
            snap = self._stat_snapshot
        if snap is not None and snap[0] == dir_mtime:
            return snap[1]
        out: Dict[int, Tuple[int, int, int]] = {}
        with os.scandir(self.root) as it:
            for entry in it:
                name = entry.name
                if not (name.startswith("shard_")
                        and name.endswith(".npz")):
                    continue
                try:
                    st = entry.stat()
                except FileNotFoundError:
                    continue                  # unlinked mid-listing
                idx = int(name[len("shard_"):-len(".npz")])
                out[idx] = (idx, int(st.st_size), int(st.st_mtime_ns))
        if time.time_ns() - dir_mtime > self._STAT_GRACE_NS:
            with self._stat_lock:
                self._stat_snapshot = (dir_mtime, out)
        return out

    def shard_fingerprint(self) -> List[Tuple[int, int, int]]:
        """Sorted (idx, size, mtime_ns) for every shard file — one
        memoized bulk stat pass (see :meth:`shard_stats`); any shard
        rewrite changes the fingerprint."""
        snap = self.shard_stats()
        return [snap[idx] for idx in sorted(snap)]

    def shard_fingerprint_array(self) -> np.ndarray:
        """:meth:`shard_fingerprint` as the read-only (n, 3) int64
        ndarray every summary-freshness compare wants, memoized by
        snapshot identity so the sort + asarray runs once per store
        change instead of once per probe."""
        snap = self.shard_stats()
        with self._stat_lock:
            cached = self._fp_array
        if cached is not None and cached[0] is snap:
            return cached[1]
        arr = np.asarray([snap[idx] for idx in sorted(snap)],
                         np.int64).reshape(-1, 3)
        arr.setflags(write=False)
        with self._stat_lock:
            # memoize only against a snapshot that is itself memoized —
            # identity of a one-shot dict would never hit again
            if (self._stat_snapshot is not None
                    and self._stat_snapshot[1] is snap):
                self._fp_array = (snap, arr)
        return arr

    # -- cache keys --------------------------------------------------------
    @staticmethod
    def _as_query(metrics: Optional[Sequence[str]],
                  group_by: Optional[str], reducers: Sequence[str],
                  query: Optional[Query]) -> Query:
        """Canonical-query carrier for both key methods. Legacy callers
        pass (metrics, group_by, reducers) and get a Query built for
        them — which is the back-compat contract: an old-style call and
        a Query-style call describing the same question mint the SAME
        key (order-insensitive in metrics and reducers)."""
        if query is not None:
            return query
        if metrics is None:
            raise ValueError("either metrics or query must be given")
        warnings.warn(
            "passing (metrics, group_by, reducers) to summary_key/"
            "partial_key is deprecated — build a repro_torch.core.query.Query "
            "and pass query=...; the folded Query mints an IDENTICAL "
            "cache key, so existing cache entries stay valid",
            DeprecationWarning, stacklevel=3)
        return Query(metrics=tuple(metrics), group_by=group_by,
                     reducers=tuple(reducers))

    def summary_key(self, plan_key: Sequence[int],
                    metrics: Optional[Sequence[str]] = None,
                    group_by: Optional[str] = None,
                    precision: str = "exact",
                    reducers: Sequence[str] = ("moments",),
                    query: Optional[Query] = None) -> str:
        """Cache key over the QUERY: the canonical query form
        (:meth:`repro_torch.core.query.Query.canonical` — version-stamped,
        order-insensitive in metrics/reducers, predicates included) plus
        the bin plan and ``precision``. ``precision`` keeps numerically
        distinct producers apart: the float64 host path shares ``"exact"``
        entries, while the torch backend's float32 device results are
        keyed ``"torch-float32"`` so they are never served to a caller expecting
        exact moments. The shard fingerprint is NOT part of the key — the
        payload's ``covered`` array is validated against the live store
        at read time instead, so a recompute after a shard write
        overwrites the stale entry in place."""
        q = self._as_query(metrics, group_by, reducers, query)
        blob = {"plan": [int(x) for x in plan_key],
                "precision": precision, "query": q.canonical()}
        return hashlib.sha256(
            json.dumps(blob, sort_keys=True).encode()).hexdigest()[:16]

    def partial_key(self, plan_key: Sequence[int],
                    metrics: Optional[Sequence[str]] = None,
                    group_by: Optional[str] = None,
                    precision: str = "exact",
                    reducers: Sequence[str] = ("moments",),
                    query: Optional[Query] = None) -> str:
        """Per-shard partial-cache key over the same canonical query form
        (salted apart from summary keys), EXCEPT that the plan is keyed
        by ``(t_start, shard width)`` rather than its end: an
        append-extended plan (``ShardPlan.extended_to``) keeps every
        existing boundary, so pre-append partials remain addressable —
        and valid — after the store grows. ``precision`` namespaces the
        two partial producers apart, exactly like the summary key: the
        float64 host scan writes ``"exact"`` partials, the torch backend's
        DEVICE partials (the post-segment-reduce float32 tensors) live
        under ``"torch-float32"`` and are never merged into an exact-path
        result. Both namespaces are entries of the SAME per-shard pack,
        so per-shard invalidation (:meth:`write_shard` →
        :meth:`clear_partials`) and the liveness sweep (:meth:`gc_stale`)
        cover device partials with no extra machinery."""
        t_start, t_end, n_shards = (int(x) for x in plan_key)
        q = self._as_query(metrics, group_by, reducers, query)
        blob = {"kind": "partial", "t_start": t_start,
                "width": (t_end - t_start) / n_shards,
                "query": q.canonical()}
        if precision != "exact":      # legacy keys predate the namespace
            blob["precision"] = precision
        return hashlib.sha256(
            json.dumps(blob, sort_keys=True).encode()).hexdigest()[:16]

    # -- per-shard partial pack --------------------------------------------
    def write_partial(self, idx: int, qkey: str,
                      arrays: Dict[str, np.ndarray]) -> str:
        """Persist ONE shard partial (single-entry form of
        :meth:`write_partials`)."""
        return self.write_partials(idx, {qkey: arrays})

    def write_partials(self, idx: int,
                       payloads: Dict[str, Dict[str, np.ndarray]]) -> str:
        """Persist many queries' partial payloads for ONE shard in a
        single pack operation — the fused producer hands every lane of a
        shard here at once, so L lanes cost one file write, not L.

        Every payload is serialized FULLY before the filesystem is
        touched (a writer that dies materializing an array leaves the
        existing pack intact — the crash-safety tests pin this). Disjoint
        new entries take the in-place append fast path (records never
        move; the footer is rewritten at the tail). A qkey collision or
        a corrupt/absent existing pack takes the atomic tmp+rename
        rewrite path; sibling entries ride along untouched — dropping
        STALE ones is :meth:`gc_stale` / :meth:`compact_pack`'s job,
        exactly as per-file partials were only ever unlinked by gc."""
        path = self._pack_path(idx)
        if not payloads:
            return path
        records = {}
        for qkey, arrays in payloads.items():
            meta = {}
            if "version" in arrays:
                meta["version"] = int(np.asarray(arrays["version"]))
            if "fingerprint" in arrays:
                meta["fingerprint"] = [
                    int(x)
                    for x in np.asarray(arrays["fingerprint"]).ravel()]
            records[qkey] = (self._pack_arrays(arrays, meta).tobytes(),
                             meta)
        with self._pack_lock:
            hit = self._load_pack(idx, want_raw=True)
            entries = hit[1] if hit else None
            if (entries is not None and hit[3] is not None
                    and not set(records) & set(entries)):
                self._append_pack(idx, path, hit, records)
            else:
                self._rewrite_pack(idx, path, hit, records)
        self._count("partial_writes", len(records))
        return path

    def read_partial(self, idx: int,
                     qkey: str) -> Optional[Dict[str, np.ndarray]]:
        """Partial payload for (shard, query), or None on a miss. Pack
        entry first; a pre-pack ``partial_{idx}_{qkey}.npy`` file is the
        read-only migration fallback."""
        rec = self._pack_record(idx, qkey)
        if rec is not None:
            try:
                payload = self._unpack_raw(rec)
            except (ValueError, TypeError, KeyError):
                return None            # torn record -> miss
            self._count("partial_reads")
            return payload
        path = os.path.join(self.root, partial_filename(idx, qkey))
        try:
            payload = self._unpack_arrays(np.load(path))
        except (OSError, ValueError, TypeError, KeyError):
            return None                # absent or torn/corrupt -> miss
        self._count("partial_reads")
        return payload

    def has_partial(self, idx: int, qkey: str) -> bool:
        hit = self._load_pack(idx, want_raw=False)
        if hit and hit[1] is not None and qkey in hit[1]:
            return True
        return os.path.exists(
            os.path.join(self.root, partial_filename(idx, qkey)))

    def partial_names(self, idx: Optional[int] = None) -> List[str]:
        """LOGICAL partial-entry names (``partial_{idx}_{qkey}.npy``
        shaped), optionally for one shard index — pack entries
        synthesized from the O(footer) tail index, plus any real
        pre-pack files still on disk. Corrupt packs contribute no names
        (their entries are unservable)."""
        names = set()
        indices = [idx] if idx is not None else self._pack_indices()
        for i in indices:
            hit = self._load_pack(i, want_raw=False)
            if hit and hit[1] is not None:
                names.update(partial_filename(i, q) for q in hit[1])
        prefix = ("partial_" if idx is None else f"partial_{idx:06d}_")
        with os.scandir(self.root) as it:
            names.update(e.name for e in it
                         if e.name.startswith(prefix)
                         and e.name.endswith(".npy"))
        return sorted(names)

    def clear_partials(self, idx: Optional[int] = None) -> int:
        """Drop cached partials — for one shard (``write_shard``'s
        per-shard invalidation: ONE unlink) or the whole store. Returns
        the number of logical entries dropped. Tolerant of a concurrent
        writer unlinking the same files."""
        n = 0
        indices = [idx] if idx is not None else self._pack_indices()
        with self._pack_lock:
            for i in indices:
                hit = self._load_pack(i, want_raw=False)
                if hit is not None:
                    n += len(hit[1]) if hit[1] is not None else 1
                self._quiet_remove(self._pack_path(i))
                self._pack_cache.pop(i, None)
        prefix = ("partial_" if idx is None else f"partial_{idx:06d}_")
        with os.scandir(self.root) as it:
            legacy = [e.name for e in it
                      if e.name.startswith(prefix)
                      and e.name.endswith(".npy")]
        for name in legacy:
            n += self._quiet_remove(os.path.join(self.root, name))
        return n

    def pack_sizes(self) -> Dict[int, int]:
        """``{shard idx -> pack file bytes}`` for every partial pack on
        disk — ONE directory scan, no pack reads. Feeds the serving
        layer's byte-budgeted pack LRU."""
        out: Dict[int, int] = {}
        with os.scandir(self.root) as it:
            for e in it:
                if e.name.startswith("pack_") and e.name.endswith(".bin"):
                    try:
                        out[int(e.name[len("pack_"):-len(".bin")])] = (
                            e.stat().st_size)
                    except FileNotFoundError:
                        pass           # concurrent eviction: skip
        return dict(sorted(out.items()))

    def compact_pack(self, idx: int) -> int:
        """Rewrite shard ``idx``'s pack keeping only LIVE entries
        (version == engine version, fingerprint == the shard file's
        current ``(size, mtime_ns)``) via atomic tmp+rename; a pack left
        with no live entries — or an unparseable one — is removed
        outright. Returns the number of entries dropped (a corrupt pack
        counts as one). No-op (0) when every entry is live."""
        with self._pack_lock:
            hit = self._load_pack(idx, want_raw=True)
            if hit is None:
                return 0
            _, entries, _, raw = hit
            if entries is None or raw is None:
                self._quiet_remove(self._pack_path(idx))
                self._pack_cache.pop(idx, None)
                return 1
            fp = self.stat_shard(idx)
            live = {q: (raw[off:off + ln], meta)
                    for q, (off, ln, meta) in entries.items()
                    if self._entry_is_live(meta, fp)}
            dropped = len(entries) - len(live)
            if not dropped:
                return 0
            if live:
                self._write_pack_file(idx, self._pack_path(idx), live)
            else:
                self._quiet_remove(self._pack_path(idx))
                self._pack_cache.pop(idx, None)
            return dropped

    # -- pack internals ----------------------------------------------------
    def _pack_path(self, idx: int) -> str:
        return os.path.join(self.root, pack_filename(idx))

    def _pack_indices(self) -> List[int]:
        out = []
        with os.scandir(self.root) as it:
            for e in it:
                if e.name.startswith("pack_") and e.name.endswith(".bin"):
                    out.append(int(e.name[len("pack_"):-len(".bin")]))
        return sorted(out)

    @classmethod
    def _parse_pack(cls, raw: bytes) -> Tuple[Dict, int]:
        """(entries, data_end) from full pack bytes; raises ValueError
        on any structural damage (callers treat that as all-miss)."""
        if len(raw) < 16 or raw[-8:] != cls._PACK_MAGIC:
            raise ValueError("bad pack magic")
        n_foot = int.from_bytes(raw[-16:-8], "little")
        data_end = len(raw) - 16 - n_foot
        if n_foot <= 0 or data_end < 0:
            raise ValueError("bad pack footer length")
        entries = json.loads(raw[data_end:-16].decode())["entries"]
        for off, ln, _meta in entries.values():
            if not (0 <= off and 0 <= ln and off + ln <= data_end):
                raise ValueError("pack entry out of range")
        return entries, data_end

    def _load_pack(self, idx: int, want_raw: bool) -> Optional[list]:
        """Stat-validated cache entry ``[stat key, entries, data_end,
        raw]`` for shard ``idx``'s pack — ``entries is None`` marks a
        corrupt pack (negative result cached too, so L lanes probing it
        cost one read, not L); returns None when the file is absent.
        ``want_raw=False`` settles for the O(footer) tail read that
        serves footer-only callers (names, liveness, has_partial)."""
        path = self._pack_path(idx)
        with self._pack_lock:
            try:
                st = os.stat(path)
            except OSError:
                self._pack_cache.pop(idx, None)
                return None
            key = (int(st.st_size), int(st.st_mtime_ns))
            hit = self._pack_cache.get(idx)
            if (hit is not None and hit[0] == key
                    and (hit[3] is not None or not want_raw
                         or hit[1] is None)):
                self._pack_cache.move_to_end(idx)
                return hit
            size = key[0]
            try:
                if want_raw or size <= 1 << 16:
                    with open(path, "rb") as f:
                        raw = f.read()
                    entries, data_end = self._parse_pack(raw)
                else:
                    entries, data_end, raw = *self._read_pack_footer(
                        path, size), None
            except (OSError, ValueError, KeyError, TypeError):
                hit = [key, None, 0, None]
            else:
                hit = [key, entries, data_end, raw]
            self._count("pack_reads")
            self._pack_cache[idx] = hit
            self._pack_cache.move_to_end(idx)
            while len(self._pack_cache) > self._PACK_CACHE_MAX:
                self._pack_cache.popitem(last=False)
            return hit

    @classmethod
    def _read_pack_footer(cls, path: str, size: int) -> Tuple[Dict, int]:
        """(entries, data_end) from the pack's tail only — O(footer), no
        record bytes read. Raises ValueError on damage."""
        with open(path, "rb") as f:
            if size < 16:
                raise ValueError("pack too small")
            f.seek(size - 16)
            tail = f.read(16)
            if tail[8:] != cls._PACK_MAGIC:
                raise ValueError("bad pack magic")
            n_foot = int.from_bytes(tail[:8], "little")
            data_end = size - 16 - n_foot
            if n_foot <= 0 or data_end < 0:
                raise ValueError("bad pack footer length")
            f.seek(data_end)
            entries = json.loads(f.read(n_foot).decode())["entries"]
        for off, ln, _meta in entries.values():
            if not (0 <= off and 0 <= ln and off + ln <= data_end):
                raise ValueError("pack entry out of range")
        return entries, data_end

    def _pack_record(self, idx: int, qkey: str) -> Optional[bytes]:
        """Raw record bytes for one pack entry, or None."""
        with self._pack_lock:
            hit = self._load_pack(idx, want_raw=True)
            if hit is None or hit[1] is None or qkey not in hit[1]:
                return None
            off, ln, _meta = hit[1][qkey]
            return hit[3][off:off + ln]

    @staticmethod
    def _entry_is_live(meta: Dict,
                       fp: Optional[Tuple[int, int, int]]) -> bool:
        if fp is None:
            return False              # shard file gone
        return (int(meta.get("version", -1)) == SUMMARY_VERSION
                and meta.get("fingerprint") == [int(x) for x in fp])

    def _append_pack(self, idx: int, path: str, hit: list,
                     records: Dict[str, Tuple[bytes, Dict]]) -> None:
        """In-place append: new records land where the old footer stood,
        then footer + length + magic are re-laid at the tail. A writer
        torn mid-append leaves a bad tail -> every entry misses -> the
        next rescan's write rewrites the pack clean (self-healing)."""
        _, entries, data_end, raw = hit
        new_entries = dict(entries)
        chunks, off = [], data_end
        for q, (blob, _meta) in records.items():
            new_entries[q] = [off, len(blob), records[q][1]]
            chunks.append(blob)
            off += len(blob)
        foot = json.dumps({"entries": new_entries}).encode()
        tail = (b"".join(chunks) + foot
                + len(foot).to_bytes(8, "little") + self._PACK_MAGIC)
        with open(path, "r+b") as f:
            f.seek(data_end)
            f.write(tail)
            f.truncate()
        self._count("pack_writes")
        self._refresh_pack_cache(idx, path, new_entries, off,
                                 raw[:data_end] + tail)

    def _rewrite_pack(self, idx: int, path: str, hit: Optional[list],
                      records: Dict[str, Tuple[bytes, Dict]]) -> None:
        """Atomic tmp+rename rewrite: every non-colliding entry of the
        existing pack + the new records (an unparseable existing pack
        contributes nothing — the self-heal). The path every collision,
        corrupt pack, and first write takes."""
        keep: Dict[str, Tuple[bytes, Dict]] = {}
        if hit is not None and hit[1] is not None and hit[3] is not None:
            for q, (off, ln, meta) in hit[1].items():
                if q not in records:
                    keep[q] = (hit[3][off:off + ln], meta)
        keep.update(records)
        self._write_pack_file(idx, path, keep)

    def _write_pack_file(self, idx: int, path: str,
                         records: Dict[str, Tuple[bytes, Dict]]) -> None:
        """Serialize a whole pack (records in key order + footer) and
        land it with the shared atomic tmp+rename writer."""
        entries, chunks, off = {}, [], 0
        for q in sorted(records):
            blob, meta = records[q]
            entries[q] = [off, len(blob), meta]
            chunks.append(blob)
            off += len(blob)
        foot = json.dumps({"entries": entries}).encode()
        raw = (b"".join(chunks) + foot
               + len(foot).to_bytes(8, "little") + self._PACK_MAGIC)
        self._atomic_write(path, raw)
        self._count("pack_writes")
        self._refresh_pack_cache(idx, path, entries, off, raw)

    def _refresh_pack_cache(self, idx: int, path: str, entries: Dict,
                            data_end: int, raw: bytes) -> None:
        with self._pack_lock:
            try:
                st = os.stat(path)
            except OSError:
                self._pack_cache.pop(idx, None)
                return
            self._pack_cache[idx] = [
                (int(st.st_size), int(st.st_mtime_ns)),
                entries, data_end, raw]
            self._pack_cache.move_to_end(idx)

    # -- summary cache -----------------------------------------------------
    def has_summary(self, key: str) -> bool:
        return os.path.exists(os.path.join(self.root, summary_filename(key)))

    def write_summary(self, key: str,
                      arrays: Dict[str, np.ndarray]) -> str:
        """Atomically persist one summary payload (see module docstring)."""
        path = os.path.join(self.root, summary_filename(key))
        self._atomic_savez(path, arrays)
        self._count("summary_writes")
        return path

    def read_summary(self, key: str) -> Optional[Dict[str, np.ndarray]]:
        """Summary payload for ``key``, or None on a cache miss. A file
        unlinked between the existence probe and the read (a concurrent
        LRU eviction in a pipelined service) is a miss, never a crash —
        summaries are pure derived data, so the caller just recomputes.

        Payloads are memoized against the file's own (size, mtime_ns)
        and handed out READ-ONLY: a summary's content is a pure
        function of its key and the ``covered`` fingerprints embedded
        in it (which every consumer re-validates against the live
        store), so a memo hit can never serve wrong data — it only
        skips a redundant np.load on the repeated per-tick probes a
        serving loop makes."""
        path = os.path.join(self.root, summary_filename(key))
        try:
            sig_st = os.stat(path)
        except FileNotFoundError:
            return None
        sig = (int(sig_st.st_size), int(sig_st.st_mtime_ns))
        with self._summary_lock:
            hit = self._summary_cache.get(key)
            if hit is not None and hit[0] == sig:
                self._summary_cache.move_to_end(key)
                payload = hit[1]
            else:
                payload = None
        if payload is not None:
            self._count("summary_memo_hits")
            return payload
        self._count("summary_reads")
        try:
            payload = self._load_npz(path)
        except FileNotFoundError:
            return None
        for arr in payload.values():
            arr.setflags(write=False)
        with self._summary_lock:
            self._summary_cache[key] = (sig, payload)
            self._summary_cache.move_to_end(key)
            while len(self._summary_cache) > self._SUMMARY_CACHE_MAX:
                self._summary_cache.popitem(last=False)
        return payload

    def summary_keys(self) -> List[str]:
        out = []
        for name in sorted(os.listdir(self.root)):
            if name.startswith("summary_") and name.endswith(".npz"):
                out.append(name[len("summary_"):-len(".npz")])
        return out

    def clear_summaries(self) -> int:
        """Drop every cached summary (pure derived data; tolerant of a
        concurrent writer pruning the same files)."""
        n = 0
        for key in self.summary_keys():
            try:
                os.remove(os.path.join(self.root, summary_filename(key)))
                n += 1
            except FileNotFoundError:
                pass
        return n

    # -- garbage collection ------------------------------------------------
    def gc_stale(self) -> int:
        """One sweep dropping derived data the live store can no longer
        serve: summaries whose ``covered`` fingerprints (or version) no
        longer match, pack entries whose embedded shard fingerprint is
        stale or whose shard file is gone (each pack compacted in place
        via :meth:`compact_pack` — one O(footer) read per pack decides,
        only packs with casualties are rewritten), and any pre-pack
        per-file partials failing the same liveness test. Runs once per
        manifest write — the amortized replacement for the old
        purge-on-every-shard-write. Returns the number of stale
        summaries + partial entries removed."""
        removed = 0
        current = {fp[0]: fp for fp in self.shard_fingerprint()}
        cur_sorted = sorted(current.values())
        for key in self.summary_keys():
            path = os.path.join(self.root, summary_filename(key))
            if not self._summary_is_live(path, cur_sorted):
                removed += self._quiet_remove(path)
        for idx in self._pack_indices():
            removed += self.compact_pack(idx)
        with os.scandir(self.root) as it:
            legacy = [e.name for e in it
                      if e.name.startswith("partial_")
                      and e.name.endswith(".npy")]
        for name in sorted(legacy):
            path = os.path.join(self.root, name)
            # split, don't slice: {idx:06d} widens past 6 digits at 1e6+
            idx = int(name.split("_")[1])
            if not self._partial_is_live(path, current.get(idx)):
                removed += self._quiet_remove(path)
        return removed

    @staticmethod
    def _summary_is_live(path: str, covered_now: List[Tuple[int, int, int]],
                         ) -> bool:
        try:
            with np.load(path) as z:
                if int(z["version"]) != SUMMARY_VERSION:
                    return False
                covered = z["covered"]
        except (KeyError, OSError, ValueError):
            return False
        return covered.shape == (len(covered_now), 3) and bool(
            np.array_equal(covered,
                           np.asarray(covered_now, np.int64).reshape(-1, 3)))

    @classmethod
    def _partial_is_live(cls, path: str,
                         fp: Optional[Tuple[int, int, int]]) -> bool:
        if fp is None:
            return False              # shard file gone
        try:
            meta = cls._read_packed_head(path).get("meta", {})
        except (KeyError, OSError, ValueError):
            return False
        return (int(meta.get("version", -1)) == SUMMARY_VERSION
                and meta.get("fingerprint") == [int(x) for x in fp])

    @staticmethod
    def _quiet_remove(path: str) -> int:
        try:
            os.remove(path)
            return 1
        except FileNotFoundError:
            return 0

    # -- util ----------------------------------------------------------------
    @staticmethod
    def _load_npz(path: str) -> Dict[str, np.ndarray]:
        """np.load over an in-memory copy of the file — one sequential
        disk read instead of zipfile's per-member seek/tell traffic
        (~2x on plain npz shards/summaries)."""
        with open(path, "rb") as f:
            buf = io.BytesIO(f.read())
        with np.load(buf) as z:
            return {k: z[k] for k in z.files}

    @staticmethod
    def _pack_arrays(arrays: Dict[str, np.ndarray],
                     meta: Optional[Dict] = None) -> np.ndarray:
        """Pack an array dict into ONE uint8 buffer:
        ``[8-byte LE header length][json header][concatenated array
        bytes]`` — loadable with a single ``np.load`` regardless of how
        many arrays the payload holds. The json header carries the array
        index plus an optional small ``meta`` dict that
        :meth:`_read_packed_head` can recover WITHOUT reading the array
        bytes (how gc_stale validates a partial from its prefix)."""
        index, chunks, off = [], [], 0
        for k, v in arrays.items():
            a = np.asarray(v)
            if a.ndim:                 # ascontiguousarray promotes 0-d
                a = np.ascontiguousarray(a)
            b = a.tobytes()
            index.append([k, a.dtype.str, list(a.shape), off, len(b)])
            chunks.append(b)
            off += len(b)
        head = json.dumps({"meta": meta or {}, "arrays": index}).encode()
        raw = len(head).to_bytes(8, "little") + head + b"".join(chunks)
        return np.frombuffer(raw, np.uint8)

    @classmethod
    def _unpack_arrays(cls, packed: np.ndarray) -> Dict[str, np.ndarray]:
        """Inverse of :meth:`_pack_arrays` (raises on a malformed
        buffer — callers treat that as a cache miss)."""
        return cls._unpack_raw(packed.tobytes())

    @staticmethod
    def _unpack_raw(raw: bytes) -> Dict[str, np.ndarray]:
        """Bytes form of :meth:`_unpack_arrays` — what pack records are
        decoded with (no intermediate ndarray copy)."""
        n_head = int.from_bytes(raw[:8], "little")
        index = json.loads(raw[8:8 + n_head].decode())["arrays"]
        base = 8 + n_head
        return {k: np.frombuffer(raw[base + o:base + o + n],
                                 dtype=np.dtype(d)).reshape(s).copy()
                for k, d, s, o, n in index}

    @staticmethod
    def _read_packed_head(path: str) -> Dict:
        """Json header (meta + array index) of a packed ``.npy`` file,
        read WITHOUT loading the array bytes — an O(header) prefix read
        no matter how large the payload is."""
        with open(path, "rb") as f:
            magic = np.lib.format.read_magic(f)
            if magic == (1, 0):
                np.lib.format.read_array_header_1_0(f)
            else:
                np.lib.format.read_array_header_2_0(f)
            n_head = int.from_bytes(f.read(8), "little")
            return json.loads(f.read(n_head).decode())

    # unique-per-process tmp names without tempfile.mkstemp's random-name
    # probe loop — at partial-cache write rates (one write per dirty
    # shard per query lane) mkstemp's extra syscalls were a measurable
    # slice of the fused scan
    _tmp_seq = itertools.count()

    def _atomic_savez(self, path: str, arrays: Dict[str, np.ndarray]) -> None:
        # serialize FULLY before touching the filesystem: a writer that
        # dies materializing an array leaves no file at all, not a torn
        # tmp (the crash-safety tests pin this)
        buf = io.BytesIO()
        np.savez(buf, **arrays)
        self._atomic_write(path, buf.getbuffer())

    @classmethod
    def _atomic_write(cls, path: str, data) -> None:
        tmp = f"{path}.{os.getpid()}.{next(cls._tmp_seq)}.tmp"
        fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_EXCL, 0o644)
        try:
            try:
                view = memoryview(data)
                while view.nbytes:            # write(2) may be short
                    view = view[os.write(fd, view):]
            finally:
                os.close(fd)
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise
