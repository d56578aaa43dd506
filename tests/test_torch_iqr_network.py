"""The ``iqr`` kernel's sorting network and bookkeeping, emulated on the
CPU, against ``np.sort`` and the port's plain version.

``csrc/iqr.cu`` does not run here, so this test replays its exact schedule
with numpy, with the constants read from the source:

- layout L0: key ``r`` of thread ``t`` of CTA ``x`` is global index
  ``x * CTA_KEYS + t * KEYS + r``; merge step ``k`` runs strides ``k/2 ..
  1`` and the pair ``(i, i | j)`` goes up when ``i & k == 0``;
- strides below ``KEYS`` inside the thread, below ``32 * KEYS`` by lane
  shuffles, ``256`` and ``512`` of merge steps 512 and 1,024 through one
  shared-memory exchange each, the three warp strides of a step
  ``k >= CTA_KEYS`` through a transpose into layout LW (key ``r`` of
  thread ``t`` at local position ``r * THREADS + t``) and back, strides
  ``>= CTA_KEYS`` by pushing each CTA's keys into its partner's shared
  memory; a pairwise exchange puts key ``r`` of thread ``t`` at slot
  ``r * THREADS + t``, the transposes and the sorted slice address by
  position, swizzled as the kernel swizzles it;
- the exchange buffers rotate as in the kernel, and the emulation counts
  the barriers: a buffer is written again only after a barrier that every
  reader of its last contents has passed (a CTA barrier for CTA-local
  buffers, a cluster barrier for the ones written or read across the
  cluster), and no CTA writes or reads another's shared memory before the
  barrier that every CTA arrives at as it starts;
- the single-tile kernel (``n_p <= TILE``, tables below ``CTA_KEYS``
  padded to it) reads the warp counts and the order statistics from the
  emulated per-CTA slices; the large path sorts tiles, merges every level
  by grid passes of up to three strides and a finishing cluster pass, and
  takes the fences from the sorted scratch.

What must hold: every 0-1 input at ``n_p <= 16`` is sorted (0-1
principle, exhaustive); seeded float64 and float32 tables with ties,
negatives, ``-0.0`` and padding are sorted as ``np.sort`` sorts them,
with every key's bits kept (the network permutes); the sorted table, the
flags and the stats equal ``iqr_fences_plain``'s exactly (bit for bit
where no ``-0.0`` can reach a quartile); one launch for a single tile,
8 at 120,000 scores.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels.iqr import iqr_fences_plain
from repro_torch.kernels.iqr.ops import next_pow2

SRC = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
       / "iqr.cu").read_text()


def _define(name):
    return int(re.search(rf"#define {name} (\d+)", SRC).group(1))


def _swizzle_shift(type_name):
    body = re.search(rf"struct Key<{type_name}> {{(.*?)}};", SRC, re.S)
    return int(re.search(r"SWZ = (\d+)", body.group(1)).group(1))


THREADS, KEYS, CLUSTER = _define("THREADS"), _define("KEYS"), \
    _define("CLUSTER")
WARPS = THREADS // 32
CTA_KEYS = THREADS * KEYS
TILE = CTA_KEYS * CLUSTER
SHIFT = {np.float32: _swizzle_shift("float"),
         np.float64: _swizzle_shift("double"),
         np.uint64: 4}
PAD = {np.float32: np.float32(3.4e38), np.float64: np.float64(np.inf)}
T_IDX = np.arange(THREADS)
R_IDX = np.arange(KEYS)
P0 = T_IDX[:, None] * KEYS + R_IDX[None, :]          # (T, K) in L0
PW = R_IDX[None, :] * THREADS + T_IDX[:, None]       # (T, K) in LW


def swz(p, shift):
    return p ^ ((p >> shift) & 7)


class Values:
    """Compare-exchanges on keys: a pair swaps only out of order, each side
    a ``keep`` (the kernel's ``ce`` is two of them)."""

    @staticmethod
    def keep(mine, other, take_min):
        return np.where(take_min, np.where(mine > other, other, mine),
                        np.where(other > mine, other, mine))

    @classmethod
    def ce(cls, a, b, asc):
        return cls.keep(a, b, asc), cls.keep(b, a, ~asc)


class Bits:
    """Compare-exchanges on 0-1 inputs packed as bit planes (bit b of a
    word is input b's key): min is and, max is or."""

    @staticmethod
    def ce(a, b, asc):
        lo, hi = a & b, a | b
        return np.where(asc, lo, hi), np.where(asc, hi, lo)

    @staticmethod
    def keep(mine, other, take_min):
        return np.where(take_min, mine & other, mine | other)


class Launch:
    """One launch of ``iqr_cluster_kernel``: ``ctas`` CTAs in clusters of
    ``cluster``, state ``v`` of shape (ctas, THREADS, KEYS, batch)."""

    def __init__(self, ops, ctas, cluster, shift):
        self.ops, self.ctas, self.cluster, self.shift = ops, ctas, cluster, \
            shift
        x = np.arange(ctas)
        self.rank = x % cluster
        self.cta0 = x * CTA_KEYS
        self.g0 = self.cta0[:, None] + T_IDX[None, :] * KEYS
        self.le = self.de = 0
        self.bars = self.cluster_bars = 0
        self.bufs, self.read_at = {}, {}
        self.joined = False

    def join(self):
        """The wait on the barrier every CTA arrived at as it started: the
        kernel's first cluster barrier, before any remote access."""
        if not self.joined:
            self.barrier(True)
            self.joined = True

    def _counter(self, key):
        return self.cluster_bars if key[0] == "d" else self.bars

    def barrier(self, cluster):
        self.bars += 1
        self.cluster_bars += cluster

    def write(self, key, v, slots, dst=None):
        """Each CTA's ``v`` (thread, register) into ``slots`` of the buffer
        ``key`` of CTA ``dst`` (its own by default)."""
        if key in self.read_at:
            assert self._counter(key) > self.read_at[key], \
                f"buffer {key} written before its readers passed a barrier"
        assert np.array_equal(np.sort(slots, axis=None), np.arange(CTA_KEYS))
        buf = np.empty((self.ctas, CTA_KEYS) + v.shape[3:], v.dtype)
        assert dst is None or self.joined, "remote write before the join"
        dst = np.arange(self.ctas) if dst is None else dst
        buf[dst[:, None, None], slots[None]] = v
        self.bufs[key] = buf

    def read(self, key, slots, src=None):
        self.read_at[key] = self._counter(key)
        buf = self.bufs[key] if src is None else self.bufs[key][src]
        return buf[:, slots]

    def pos(self, p):
        """The slot of local position ``p`` (swizzled)."""
        return swz(p, self.shift)

    def reg_stage(self, v, k, J):
        lo = [r for r in range(KEYS) if not r & J]
        hi = [r | J for r in lo]
        asc = ((self.g0[:, :, None] | np.array(lo)) & k) == 0
        a, b = self.ops.ce(v[:, :, lo], v[:, :, hi], asc[..., None])
        v = v.copy()
        v[:, :, lo], v[:, :, hi] = a, b
        return v

    def shfl_stage(self, v, k, j):
        m = j // KEYS
        assert 0 < m < 32
        take_min = ((self.g0 & j) == 0) == ((self.g0 & k) == 0)
        return self.ops.keep(v, v[:, T_IDX ^ m], take_min[:, :, None, None])

    def smem_stage(self, v, k, j):
        key = ("l", self.le & 1)
        self.le += 1
        self.write(key, v, PW)
        self.barrier(False)
        take_min = ((self.g0 & j) == 0) == ((self.g0 & k) == 0)
        return self.ops.keep(v, self.read(key, PW[T_IDX ^ (j // KEYS)]),
                             take_min[:, :, None, None])

    def warp_stages(self, v, k):
        ka = ("l", self.le & 1)
        self.le += 1
        self.write(ka, v, self.pos(P0))
        self.barrier(False)
        w = self.read(ka, self.pos(PW))
        asc = ((self.cta0 & k) == 0)[:, None, None, None]
        s = KEYS // 2
        while s:
            lo = [r for r in range(KEYS) if not r & s]
            hi = [r | s for r in lo]
            a, b = self.ops.ce(w[:, :, lo], w[:, :, hi], asc)
            w = w.copy()
            w[:, :, lo], w[:, :, hi] = a, b
            s >>= 1
        kb = ("l", self.le & 1)
        self.le += 1
        self.write(kb, w, self.pos(PW))
        self.barrier(False)
        return self.read(kb, self.pos(P0))

    def cluster_stage(self, v, k, j):
        self.join()
        key = ("d", self.de & 1)
        self.de += 1
        m = j // CTA_KEYS
        partner = np.arange(self.ctas) ^ m
        assert (partner // self.cluster
                == np.arange(self.ctas) // self.cluster).all()
        self.write(key, v, PW, dst=partner)
        self.barrier(True)
        take_min = ((self.rank & m) == 0)[:, None] == ((self.g0 & k) == 0)
        return self.ops.keep(v, self.read(key, PW),
                             take_min[:, :, None, None])

    def merge(self, v, k, j):
        while j >= CTA_KEYS:
            v = self.cluster_stage(v, k, j)
            j >>= 1
        if j == CTA_KEYS // 2:
            v = self.warp_stages(v, k)
            j = 16 * KEYS
        while j >= 32 * KEYS:
            v = self.smem_stage(v, k, j)
            j >>= 1
        while j >= KEYS:
            v = self.shfl_stage(v, k, j)
            j >>= 1
        J = KEYS // 2
        while J:
            if j >= J:
                v = self.reg_stage(v, k, J)
            J >>= 1
        return v

    def sort(self, v, size):
        k = 2
        while k <= size:
            v = self.merge(v, k, k // 2)
            k <<= 1
        return v


def load(scores, occ, ctas, dtype):
    """(keys in L0 with a batch axis of 1, per-(CTA, warp) occupied
    counts), as a load of ``ctas`` CTAs from the score table."""
    n = len(scores)
    total = ctas * CTA_KEYS
    o = np.zeros(total, bool)
    o[:n] = occ
    keys = np.full(total, PAD[dtype], dtype)
    keys[:n] = np.where(occ, scores, PAD[dtype])
    warp_cnt = o.reshape(ctas, WARPS, 32 * KEYS).sum(-1)
    return keys.reshape(ctas, THREADS, KEYS, 1), warp_cnt


def safe_key(x, dtype):
    return np.where(x >= PAD[dtype], dtype(0), x).astype(dtype)


def pct(fetch, n_p, count, q, dtype):
    """The kernel's pct over the positions ``fetch`` reads."""
    if dtype == np.float32:
        f = np.float32
        n_occ = f(max(count, 1))
        pos = f(q) * (n_occ - f(1))
        lo = min(max(int(np.floor(pos)), 0), n_p - 1)
        hi = min(lo + 1, n_p - 1)
        frac = pos - f(lo)
        vlo, vhi = safe_key(fetch(lo), f)[()], safe_key(fetch(hi), f)[()]
        return vlo + frac * (vhi - vlo) if n_occ > f(1) else vlo
    n_occ = max(count, 1)
    pos = np.float64(n_occ - 1) * np.float64(q)
    lo = int(np.floor(pos))
    hi = min(lo + 1, n_occ - 1)
    t = pos - np.float64(lo)
    a = safe_key(fetch(lo), np.float64)[()]
    b = safe_key(fetch(hi), np.float64)[()]
    d = b - a
    return b - d * (np.float64(1) - t) if t >= 0.5 else a + d * t


def fences(fetch, n_p, count, k, dtype):
    q1 = pct(fetch, n_p, count, 0.25, dtype)
    q3 = pct(fetch, n_p, count, 0.75, dtype)
    iqr = q3 - q1
    kq = dtype(k) * iqr
    return np.array([q1, q3, iqr, q1 - kq, q3 + kq, max(count, 1), 0, 0],
                    dtype)


def merge_grid(ops, keys, n_p, level, lb, nb):
    """``iqr_merge_kernel<T, nb>``: strides 2^lb .. 2^(lb + nb - 1)."""
    t = np.arange(n_p >> nb)
    i0 = ((t >> lb) << (lb + nb)) | (t & ((1 << lb) - 1))
    idx = i0[:, None] + (np.arange(1 << nb) << lb)[None, :]
    assert np.array_equal(np.sort(idx, axis=None), np.arange(n_p))
    w = keys[idx]
    asc = ((i0 & level) == 0)[:, None, None]
    s = (1 << nb) // 2
    while s:
        lo = [r for r in range(1 << nb) if not r & s]
        hi = [r | s for r in lo]
        a, b = ops.ce(w[:, lo], w[:, hi], asc)
        w = w.copy()
        w[:, lo], w[:, hi] = a, b
        s >>= 1
    keys = keys.copy()
    keys[idx] = w
    return keys


def emulate(scores, occ, k=1.5):
    """(padded sorted keys, sorted, flags, stats, launches) as the kernel
    computes them for ``scores`` of dtype float32 or float64."""
    dtype = scores.dtype.type
    shift = SHIFT[dtype]
    n = len(scores)
    n_p = next_pow2(n)
    if n_p <= TILE:
        ctas = max(n_p // CTA_KEYS, 1)
        net = Launch(Values, ctas, ctas, shift)
        v, warp_cnt = load(scores, occ, ctas, dtype)
        v = net.sort(v, ctas * CTA_KEYS)
        key = ("d", net.de & 1)
        net.write(key, v, net.pos(P0))
        net.join()
        net.barrier(True)
        count = int(warp_cnt.sum())

        def fetch(i):
            net.read_at[key] = net.cluster_bars
            out = net.bufs[key]
            return out[i // CTA_KEYS, swz(i % CTA_KEYS, shift), 0]
        stats = fences(fetch, n_p, count, k, dtype)
        keys = net.read(key, net.pos(np.arange(CTA_KEYS)))[..., 0].reshape(-1)
        net.barrier(True)
        launches = 1
    else:
        ctas = n_p // CTA_KEYS
        net = Launch(Values, ctas, CLUSTER, shift)
        v, warp_cnt = load(scores, occ, ctas, dtype)
        keys = net.sort(v, TILE).reshape(-1, 1)
        counts = warp_cnt.sum(1)
        launches = 1
        level = 2 * TILE
        top = TILE.bit_length() - 1
        while level <= n_p:
            hb = level.bit_length() - 2
            while hb >= top:
                nb = min(3, hb - top + 1)
                keys = merge_grid(Values, keys, n_p, level, hb - nb + 1, nb)
                launches += 1
                hb -= nb
            net = Launch(Values, ctas, CLUSTER, shift)
            v = net.merge(keys.reshape(ctas, THREADS, KEYS, 1), level,
                          TILE // 2)
            keys = v.reshape(-1, 1)
            launches += 1
            level <<= 1
        keys = keys[:, 0]
        stats = fences(lambda i: keys[i], n_p, int(counts.sum()), k, dtype)
        launches += 1
    flags = ((scores > stats[4]) & occ).astype(np.int32)
    return keys, safe_key(keys[:n], dtype), flags, stats, launches


def _table(seed, n, dtype):
    """Scores with ties, negatives, -0.0 and +0.0, and ~20% unoccupied."""
    rng = np.random.default_rng(seed)
    s = (rng.integers(-40, 40, n) / 4).astype(dtype)
    wide = rng.random(n) < 0.5
    s[wide] = rng.lognormal(3.0, 2.0, wide.sum()).astype(dtype)
    s[rng.random(n) < 0.05] = dtype(-0.0)
    s[rng.random(n) < 0.05] = dtype(0.0)
    return s, rng.random(n) < 0.8


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_swizzle_is_a_conflict_free_bijection(dtype):
    """Each slot once, and each warp access of L0 or LW (a fixed key
    register across 32 consecutive threads) spreads over the 4-byte banks
    as evenly as its width allows."""
    shift = SHIFT[dtype]
    p = np.arange(CTA_KEYS)
    assert np.array_equal(np.sort(swz(p, shift)), p)
    words = np.dtype(dtype).itemsize // 4
    for layout in (P0, PW):
        for w in range(WARPS):
            for r in range(KEYS):
                slots = swz(layout[32 * w:32 * w + 32, r], shift)
                banks = ((slots[:, None] * words + np.arange(words))
                         % 32).ravel()
                assert np.bincount(banks, minlength=32).max() == words


def test_network_sorts_every_0_1_input():
    """All 2^16 0-1 tables of 16 keys, padded with 1s (the padding key is
    the largest) to the 2,048 keys of one CTA, as 1,024 words of bit
    planes: by the 0-1 principle the network sorts every table of
    n_p <= 16."""
    n = 16
    inputs = np.arange(1 << n, dtype=np.uint32)
    planes = np.full((CTA_KEYS, (1 << n) // 64), np.uint64(~np.uint64(0)))
    for i in range(n):
        bits = ((inputs >> i) & 1).astype(np.uint8)
        planes[i] = np.packbits(bits, bitorder="little").view(np.uint64)
    net = Launch(Bits, 1, 1, SHIFT[np.uint64])
    out = net.sort(planes.reshape(1, THREADS, KEYS, -1), CTA_KEYS)
    out = out.reshape(CTA_KEYS, -1)
    # sorted: no position holds a 1 where the next holds a 0
    assert not (out[:-1] & ~out[1:]).any()
    ones = np.unpackbits(out[:n].view(np.uint8), bitorder="little")
    want = np.unpackbits(planes[:n].view(np.uint8), bitorder="little")
    assert ones.reshape(n, -1).sum(0).tolist() == \
        want.reshape(n, -1).sum(0).tolist()


CASES = [(np.float64, n) for n in (1, 2, 3, 17, 2_048, 2_049, 4_096, 12_000,
                                   16_385, 40_000, 120_000)] + \
        [(np.float32, n) for n in (1, 1_000, 4_096, 16_384, 32_769,
                                   120_000)]


@pytest.mark.parametrize("dtype,n", CASES)
def test_network_equals_np_sort_and_plain(dtype, n):
    s, occ = _table(n, n, dtype)
    keys, srt, flags, stats, launches = emulate(s, occ)
    n_p = next_pow2(n)
    padded = np.full(max(n_p, CTA_KEYS), PAD[dtype], dtype)
    padded[:n] = np.where(occ, s, PAD[dtype])
    want = np.sort(padded)
    np.testing.assert_array_equal(keys, want)
    # a permutation: every key's bits (-0.0 and +0.0 apart) kept
    bits = np.uint64 if dtype == np.float64 else np.uint32
    np.testing.assert_array_equal(np.sort(keys.view(bits)),
                                  np.sort(padded.view(bits)))
    plain = iqr_fences_plain(torch.from_numpy(s), torch.from_numpy(occ))
    np.testing.assert_array_equal(srt, plain["sorted"].numpy())
    np.testing.assert_array_equal(flags, plain["flags"].numpy())
    np.testing.assert_array_equal(stats, plain["stats"].numpy())
    assert launches == (1 if n_p <= TILE else
                        {2 ** 15: 4, 2 ** 16: 6, 2 ** 17: 8}[n_p])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_fences_bit_for_bit(dtype):
    """Without -0.0 in the table the stats match the plain version's bits,
    at a single tile and on the large path."""
    for n in (12_000, 40_000):
        rng = np.random.default_rng(n)
        s = np.clip(rng.lognormal(np.log(1e7), 0.8, n), 1e6,
                    1e8).astype(dtype)
        occ = rng.random(n) < 0.8
        stats = emulate(s, occ)[3]
        plain = iqr_fences_plain(torch.from_numpy(s), torch.from_numpy(occ))
        assert stats.tobytes() == plain["stats"].numpy().tobytes()
