"""Trace diff & regression engine — "what got slower between two runs?"

The paper's framework integrates performance analytics into automated
workflows; the most common automated question is a *comparison*: did this
commit / driver / cluster change make some kernels slower? This module
answers it from two trace stores in one fused pass each:

1. **Align** kernel groups across the stores by name. Real traces spell
   the "same" kernel differently between builds — Itanium mangling with
   different template arguments, Triton specialization suffixes
   (``_0d1d2de3de``) and compile-hash tails, demangled C++ templates —
   so matching is tiered: exact string fast path, then a normalized form
   (demangle-lite + template/specialization stripping), then a
   token-overlap fallback. Matching is deterministic, symmetric, and
   independent of store enumeration order.

2. **Score** each matched group per (time bin, group) off the quantile
   sketches the reducer suite already caches: the signed earth-mover
   distance between the two log2-bucket histograms
   (:func:`repro_torch.core.anomaly.sketch_shift`) measures the distribution
   shift in octaves — ``2**shift`` is the geometric-mean slowdown ratio
   — plus arithmetic mean and p99 ratios from the same pass. When both
   stores' summaries are warm this reads ZERO shard files; cold stores
   cost exactly one fused scan each (``TraceStore.io_counts`` proves
   it).

3. **Report**: a ranked :class:`DiffReport` (which kernels got slower,
   by how much, in which time bins) with a machine-readable
   ``pass``/``regressed`` verdict against configurable
   :class:`DiffThresholds` — the shape ``benchmarks/check_bench.py``
   gates on in CI (see the ``trace-regression`` workflow).
"""

from __future__ import annotations

import dataclasses
import json
import re
from collections import defaultdict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .anomaly import sketch_shift
from .query import Query, diff_cache_key, diff_query  # noqa: F401
from .reducers import QuantileSketch

__all__ = [
    "normalize_kernel_name", "kernel_name_tokens", "match_kernel_names",
    "NameMatch", "MatchResult", "DiffThresholds", "GroupDiff",
    "DiffReport", "diff_results",
]


# ---------------------------------------------------------------------------
# Fuzzy kernel-name matching
# ---------------------------------------------------------------------------

# trailing compile-hash tail (Triton caches key their specializations)
_HASH_SUFFIX_RE = re.compile(r"_[0-9a-f]{6,}$")
# a run of Triton arg-specialization markers: _0d1d2de3de ("d"ivisible /
# "c"onstexpr / "e"qual-to-1 per argument index, concatenated after one
# underscore). Two+ groups required so a meaningful suffix like "_2d" in
# a kernel's own name survives.
_SPEC_SUFFIX_RE = re.compile(r"_(?:\d+[cde]{1,3}){2,}$")
_TOKEN_SPLIT_RE = re.compile(r"[^a-z0-9]+")
# tokens carrying no kernel identity (ubiquitous in GPU kernel names)
_STOP_TOKENS = frozenset({
    "kernel", "void", "float", "double", "const", "int", "long", "bool",
    "cuda", "cutlass", "triton", "unsigned",
})


def _itanium_base(name: str) -> str:
    """Demangle-lite: the length-prefixed identifier path of an Itanium
    ``_Z`` symbol (``_ZN7cutlass6KernelI...`` -> ``cutlass::Kernel``,
    ``_Z11gemm_kernelILi128EE...`` -> ``gemm_kernel``). Template
    arguments and signature encodings after the path are dropped — that
    is exactly the specialization noise the matcher must see through."""
    i = 2
    if i < len(name) and name[i] == "N":
        i += 1
    parts: List[str] = []
    while i < len(name) and name[i].isdigit():
        j = i
        while j < len(name) and name[j].isdigit():
            j += 1
        ln = int(name[i:j])
        parts.append(name[j:j + ln])
        i = j + ln
    return "::".join(parts) if parts else name


def normalize_kernel_name(name: str) -> str:
    """Canonical base spelling of a kernel name: mangling resolved,
    template arguments / call signature cut, Triton specialization and
    hash suffixes stripped, lowercased. Two spellings of the same kernel
    from different builds normalize to the same string; genuinely
    different kernels keep different strings."""
    s = name.strip()
    if s.startswith("_Z"):
        s = _itanium_base(s)
    if s.startswith("void "):
        s = s[5:]
    for cut in ("<", "("):
        pos = s.find(cut)
        if pos > 0:
            s = s[:pos]
    s = _HASH_SUFFIX_RE.sub("", s)
    s = _SPEC_SUFFIX_RE.sub("", s)
    s = s.strip("_ \t").lower()
    return s or name.strip().lower()


def kernel_name_tokens(name: str) -> frozenset:
    """Identity-bearing tokens of a (normalized) kernel name — the
    token-overlap fallback's feature set."""
    toks = _TOKEN_SPLIT_RE.split(normalize_kernel_name(name))
    return frozenset(t for t in toks
                     if len(t) > 1 and not t.isdigit()
                     and t not in _STOP_TOKENS)


@dataclasses.dataclass(frozen=True)
class NameMatch:
    name_a: str
    name_b: str
    via: str            # "exact" | "normalized" | "tokens"
    score: float        # 1.0 for exact/normalized, Jaccard for tokens


@dataclasses.dataclass
class MatchResult:
    matches: List[NameMatch]
    unmatched_a: List[str]
    unmatched_b: List[str]


def match_kernel_names(names_a: Sequence[str], names_b: Sequence[str],
                       token_threshold: float = 0.6) -> MatchResult:
    """Align two stores' kernel-name sets, tiered:

    1. exact string equality (fast path — unchanged spellings),
    2. equal :func:`normalize_kernel_name` forms (re-specialized builds;
       colliding groups pair positionally in sorted order),
    3. greedy token-overlap (Jaccard >= ``token_threshold``), ties broken
       on the unordered name pair.

    Deterministic and independent of input order (everything iterates in
    sorted order); ``match(A, B)`` mirrors ``match(B, A)``.
    """
    a_left = sorted(set(names_a))
    b_left = sorted(set(names_b))
    matches: List[NameMatch] = []

    exact = set(a_left) & set(b_left)
    matches += [NameMatch(n, n, "exact", 1.0) for n in sorted(exact)]
    a_left = [n for n in a_left if n not in exact]
    b_left = [n for n in b_left if n not in exact]

    norm_a: Dict[str, List[str]] = defaultdict(list)
    norm_b: Dict[str, List[str]] = defaultdict(list)
    for n in a_left:
        norm_a[normalize_kernel_name(n)].append(n)
    for n in b_left:
        norm_b[normalize_kernel_name(n)].append(n)
    used_a, used_b = set(), set()
    for norm in sorted(set(norm_a) & set(norm_b)):
        for x, y in zip(norm_a[norm], norm_b[norm]):  # both sorted
            matches.append(NameMatch(x, y, "normalized", 1.0))
            used_a.add(x)
            used_b.add(y)
    a_left = [n for n in a_left if n not in used_a]
    b_left = [n for n in b_left if n not in used_b]

    cands = []
    tok_b = {y: kernel_name_tokens(y) for y in b_left}
    for x in a_left:
        tx = kernel_name_tokens(x)
        if not tx:
            continue
        for y, ty in tok_b.items():
            if not ty:
                continue
            j = len(tx & ty) / len(tx | ty)
            if j >= token_threshold:
                cands.append((-j, min(x, y), max(x, y), x, y))
    used_a, used_b = set(), set()
    for neg_j, _, _, x, y in sorted(cands):
        if x in used_a or y in used_b:
            continue
        matches.append(NameMatch(x, y, "tokens", -neg_j))
        used_a.add(x)
        used_b.add(y)
    return MatchResult(
        matches=sorted(matches, key=lambda m: (m.name_a, m.name_b)),
        unmatched_a=[n for n in a_left if n not in used_a],
        unmatched_b=[n for n in b_left if n not in used_b])


# ---------------------------------------------------------------------------
# Distribution-shift scoring + report
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DiffThresholds:
    """When is a matched group *regressed*? All gates must agree:

    - enough evidence on both sides (``min_count`` samples),
    - the whole distribution moved up by ``shift_octaves`` octaves
      (0.25 oct ~= 1.19x geometric slowdown — below that, log-bucket
      quantization and run-to-run noise dominate), AND
    - the arithmetic mean or the p99 tail grew by the ratio gates
      (catches both uniform slowdowns and tail blowups).
    """

    mean_ratio: float = 1.25
    p99_ratio: float = 1.25
    shift_octaves: float = 0.25
    min_count: int = 32

    def to_dict(self) -> Dict[str, float]:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class GroupDiff:
    """One matched kernel group's A-vs-B comparison."""

    name_a: str
    name_b: str
    matched_via: str
    count_a: int
    count_b: int
    mean_a: float
    mean_b: float
    mean_ratio: float
    p99_a: float
    p99_b: float
    p99_ratio: float
    shift_octaves: float          # signed log2 EMD; > 0 means B slower
    spread_octaves: float         # unsigned EMD (reshape detector)
    geo_ratio: float              # 2**shift_octaves, geometric slowdown
    bin_shift: np.ndarray         # (n_bins,) per-time-bin signed shift
    top_bins: List[int]           # bins driving the shift, worst first
    top_windows: np.ndarray       # (k, 2) int64 ns bounds of top_bins
    regressed: bool

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["bin_shift"] = np.asarray(self.bin_shift).round(4).tolist()
        d["top_windows"] = np.asarray(self.top_windows).tolist()
        return d


@dataclasses.dataclass
class DiffReport:
    """Ranked two-store comparison + machine verdict (CI's gate input)."""

    store_a: str
    store_b: str
    metric: str
    key: str                       # diff_cache_key of the query pair
    thresholds: DiffThresholds
    groups: List[GroupDiff]        # ranked: largest shift first
    unmatched_a: List[str]
    unmatched_b: List[str]
    shard_reads_a: int             # fused-pass proof: 0 when warm,
    shard_reads_b: int             # n_shards on a cold store
    seconds: float = 0.0
    from_cache: bool = False       # served from the diff-result cache

    @property
    def verdict(self) -> str:
        return "regressed" if any(g.regressed for g in self.groups) \
            else "pass"

    def regressions(self) -> List[GroupDiff]:
        return [g for g in self.groups if g.regressed]

    def provenance(self) -> str:
        if self.from_cache:
            return (f"diff-result cache hit (key {self.key}, no "
                    f"queries run)")
        warm = self.shard_reads_a == 0 and self.shard_reads_b == 0
        how = ("both summaries warm" if warm
               else "one fused scan per cold store")
        return (f"{self.shard_reads_a} + {self.shard_reads_b} shard "
                f"reads ({how})")

    # -- diff-result cache round trip ---------------------------------------
    def to_payload(self) -> Dict[str, Any]:
        """Full-fidelity JSON form (unlike ``to_record``, nothing is
        rounded or truncated) — what the diff-result cache persists."""
        d = dataclasses.asdict(self)
        d["thresholds"] = self.thresholds.to_dict()
        for g in d["groups"]:
            g["bin_shift"] = np.asarray(g["bin_shift"]).tolist()
            g["top_windows"] = np.asarray(g["top_windows"]).tolist()
            g["top_bins"] = [int(b) for b in g["top_bins"]]
        d.pop("from_cache")        # a load is marked at load time
        return d

    @classmethod
    def from_payload(cls, d: Dict[str, Any]) -> "DiffReport":
        groups = []
        for g in d["groups"]:
            g = dict(g)
            g["bin_shift"] = np.asarray(g["bin_shift"], np.float64)
            g["top_windows"] = np.asarray(
                g["top_windows"], np.int64).reshape(-1, 2)
            groups.append(GroupDiff(**g))
        return cls(store_a=d["store_a"], store_b=d["store_b"],
                   metric=d["metric"], key=d["key"],
                   thresholds=DiffThresholds(**d["thresholds"]),
                   groups=groups, unmatched_a=list(d["unmatched_a"]),
                   unmatched_b=list(d["unmatched_b"]),
                   shard_reads_a=int(d["shard_reads_a"]),
                   shard_reads_b=int(d["shard_reads_b"]),
                   seconds=float(d["seconds"]), from_cache=True)

    def to_record(self, smoke: bool = False) -> Dict[str, Any]:
        """The machine-readable verdict in the shape
        ``benchmarks/check_bench.py`` consumes: flat JSON, ``*_ok``
        flags that must all be true, rankable context fields."""
        regs = self.regressions()
        return {
            "name": "diff_verdict",
            "kind": "diff",
            "smoke": bool(smoke),
            "diff_cached": bool(self.from_cache),
            "verdict": self.verdict,
            "diff_key": self.key,
            "metric": self.metric,
            "matched_groups": len(self.groups),
            "regressed_groups": len(regs),
            "unmatched_a": len(self.unmatched_a),
            "unmatched_b": len(self.unmatched_b),
            "shard_reads_a": int(self.shard_reads_a),
            "shard_reads_b": int(self.shard_reads_b),
            "thresholds": self.thresholds.to_dict(),
            "top": [{
                "name_a": g.name_a, "name_b": g.name_b,
                "matched_via": g.matched_via,
                "geo_ratio": round(g.geo_ratio, 4),
                "mean_ratio": round(g.mean_ratio, 4),
                "p99_ratio": round(g.p99_ratio, 4),
                "shift_octaves": round(g.shift_octaves, 4),
                "regressed": g.regressed,
            } for g in self.groups[:5]],
            "seconds": round(self.seconds, 6),
        }

    def to_json(self, smoke: bool = False) -> str:
        return json.dumps(self.to_record(smoke=smoke), indent=2)

    def render(self, top_k: int = 10) -> str:
        """Human-readable ranked table ("what got slower and where")."""
        lines = [
            f"trace diff: {self.store_a} vs {self.store_b} "
            f"(metric {self.metric}, key {self.key})",
            f"verdict: {self.verdict.upper()} "
            f"({len(self.regressions())} regressed / "
            f"{len(self.groups)} matched groups, "
            f"{len(self.unmatched_a)}+{len(self.unmatched_b)} unmatched; "
            f"{self.shard_reads_a}+{self.shard_reads_b} shard reads)",
            f"{'':2}{'geo x':>7} {'mean x':>7} {'p99 x':>7} "
            f"{'shift':>7}  {'bins':<12} kernel",
        ]
        for g in self.groups[:top_k]:
            flag = "!" if g.regressed else " "
            bins = ",".join(str(b) for b in g.top_bins[:4]) or "-"
            name = (g.name_a if g.name_a == g.name_b
                    else f"{g.name_a} ~ {g.name_b} [{g.matched_via}]")
            lines.append(
                f"{flag:2}{g.geo_ratio:>7.3f} {g.mean_ratio:>7.3f} "
                f"{g.p99_ratio:>7.3f} {g.shift_octaves:>+7.3f}  "
                f"{bins:<12} {name}")
        return "\n".join(lines)


def _ratio(b: float, a: float) -> float:
    if a > 0:
        return float(b / a)
    return float("inf") if b > 0 else 1.0


def _display_names(result, names: Optional[Dict[int, str]],
                   ) -> Dict[str, float]:
    """{display name -> group key} for one grouped result. Stores whose
    DBs predate the string table fall back to ``kernel_<id>``."""
    names = names or {}
    out: Dict[str, float] = {}
    for k in np.asarray(result.group_keys, np.float64):
        out[names.get(int(k), f"kernel_{int(k)}")] = float(k)
    return out


def diff_results(result_a, result_b, *,
                 metric: Optional[str] = None,
                 names_a: Optional[Dict[int, str]] = None,
                 names_b: Optional[Dict[int, str]] = None,
                 thresholds: Optional[DiffThresholds] = None,
                 store_a: str = "A", store_b: str = "B",
                 key: str = "", shard_reads_a: int = 0,
                 shard_reads_b: int = 0, seconds: float = 0.0,
                 top_bins_per_group: int = 5) -> DiffReport:
    """Build the :class:`DiffReport` from two kernel-grouped
    :class:`~repro_torch.core.aggregation.AggregationResult` s (each the
    answer to the same :func:`~repro_torch.core.query.diff_query`, one per
    store). Pure post-processing of cached summary tensors — no store
    I/O happens here."""
    thresholds = thresholds or DiffThresholds()
    metric = metric or result_a.metrics[0]
    by_name_a = _display_names(result_a, names_a)
    by_name_b = _display_names(result_b, names_b)
    matched = match_kernel_names(list(by_name_a), list(by_name_b))

    bounds_a = result_a.plan.boundaries()
    groups: List[GroupDiff] = []
    for m in matched.matches:
        key_a, key_b = by_name_a[m.name_a], by_name_b[m.name_b]
        st_a = result_a.select(metric, group=key_a)
        st_b = result_b.select(metric, group=key_b)
        sk_a = result_a.sketch(metric, group=key_a)
        sk_b = result_b.sketch(metric, group=key_b)
        count_a = int(st_a.count.sum())
        count_b = int(st_b.count.sum())
        mean_a = float(st_a.sum.sum() / count_a) if count_a else 0.0
        mean_b = float(st_b.sum.sum() / count_b) if count_b else 0.0
        # whole-run distributions: bucket counts are additive over bins
        ca = sk_a.counts.sum(axis=0)
        cb = sk_b.counts.sum(axis=0)
        p99_a = float(QuantileSketch(ca[None]).quantile(0.99)[0])
        p99_b = float(QuantileSketch(cb[None]).quantile(0.99)[0])
        shift, spread = sketch_shift(ca, cb)
        shift, spread = float(shift), float(spread)
        # per-time-bin shifts over the common bin prefix (stores bin the
        # same relative timeline; lengths differ when runs differ)
        nb = min(sk_a.counts.shape[0], sk_b.counts.shape[0])
        bin_shift, _ = sketch_shift(sk_a.counts[:nb], sk_b.counts[:nb])
        order = np.argsort(-bin_shift, kind="stable")
        top = [int(i) for i in order[:top_bins_per_group]
               if bin_shift[i] > 0]
        wins = (np.stack([bounds_a[top], bounds_a[np.asarray(top) + 1]],
                         axis=1).astype(np.int64) if top
                else np.zeros((0, 2), np.int64))
        mean_ratio = _ratio(mean_b, mean_a)
        p99_ratio = _ratio(p99_b, p99_a)
        regressed = (
            min(count_a, count_b) >= thresholds.min_count
            and shift >= thresholds.shift_octaves
            and (mean_ratio >= thresholds.mean_ratio
                 or p99_ratio >= thresholds.p99_ratio))
        groups.append(GroupDiff(
            name_a=m.name_a, name_b=m.name_b, matched_via=m.via,
            count_a=count_a, count_b=count_b,
            mean_a=mean_a, mean_b=mean_b, mean_ratio=mean_ratio,
            p99_a=p99_a, p99_b=p99_b, p99_ratio=p99_ratio,
            shift_octaves=shift, spread_octaves=spread,
            geo_ratio=float(2.0 ** shift),
            bin_shift=np.asarray(bin_shift, np.float64),
            top_bins=top, top_windows=wins, regressed=regressed))

    groups.sort(key=lambda g: (-g.shift_octaves, g.name_a))
    return DiffReport(
        store_a=store_a, store_b=store_b, metric=metric, key=key,
        thresholds=thresholds, groups=groups,
        unmatched_a=matched.unmatched_a, unmatched_b=matched.unmatched_b,
        shard_reads_a=int(shard_reads_a), shard_reads_b=int(shard_reads_b),
        seconds=seconds)
