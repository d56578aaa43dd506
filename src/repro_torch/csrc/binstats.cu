// Per-segment moments (count, sum, sumsq, min, max) on Hopper.
//
// Replaces the TPU kernel src/repro/kernels/binstats/kernel.py
// (_binstats_kernel / binstats_pallas), which binned float32 timestamps and
// scattered rows into bins as a one-hot matmul on the MXU, the TPU's answer
// to having no atomics. Two entry points:
//
//  * binstats_flat: the phase-2 main path, one launch, no scratch. Rows
//    arrive segment-ordered (a stable order of each slot's rows by segment,
//    built by the producer on the host). A block owns SEGS consecutive
//    segments: two binary searches over the ordered ids give its rows, one
//    coalesced pass over their ids gives each segment's first row (where
//    the id steps up to it), and a group of GROUP lanes then reduces one
//    segment: it reads the rows coalesced across its lanes (lane l takes
//    rows first + l, first + l + GROUP, ... in order) and combines the
//    lanes in a fixed xor tree. Lanes are numbered from the segment's
//    first row, not from an absolute row position, so each cell's float32
//    sum and sumsq are a fixed-order function of that segment's rows alone:
//    no float atomics and no tiles cut at absolute row positions, so a
//    delta run over dirty shards and a cold run over every shard produce
//    bit-identical partials. Products and sums are written with
//    __fmul_rn/__fadd_rn so the compiler cannot contract them into FMAs.
//    The order check rides the same pass: binary search is monotone in the
//    target even over unordered ids, so the blocks' row ranges tile [0, n)
//    in order whatever the input, and each block checks that its ids never
//    step down and stay among its own segments. All checks pass exactly
//    when the ids are non-decreasing. A block that finds disorder writes
//    NaN as its cells' count: the caller's copy of the table carries the
//    verdict, with no flag buffer, memset or synchronisation.
//  * binstats_ts: the TPU kernel's own contract. The bin is computed
//    in-register from the relative timestamp. When the table fits a CTA's
//    shared memory (n_bins * (1 + 4 * n_metrics) * 4 bytes), one launch of
//    one thread-block cluster of CLUSTER CTAs: each CTA accumulates its
//    share of the rows into a private table in shared memory (an integer
//    count per bin; float sum and sumsq and order-preserving unsigned
//    min/max per metric, all shared-memory atomics), the cluster syncs, and
//    each cell is then written once by one thread, which merges the CTAs'
//    tables in rank order through distributed shared memory and applies
//    the sentinels. No global atomics, no initialisation or finalisation
//    pass. Larger tables (the Table-1 form: 12,000 bins x 3 metrics) take
//    three launches: zero the output, global atomics (integer count, float
//    sums, ordered-int min/max), then the count and sentinels. Sums ride
//    float atomics in both, so their rounding depends on arrival order
//    (rtol 1e-5 against the plain version); counts, min and max are exact.
//
// Bound on the card: bytes. Each row is read once (4 bytes per metric + 1
// valid byte + 4 segment or timestamp bytes) and each cell written once
// (20 bytes per metric); the work is a handful of flops per row.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define POS_CAP 3.4e38f
#define NEG_CAP -3.4e38f
#define GROUP 8                      // lanes per segment (flat form)
#define FLAT_THREADS 256
#define SEGS (FLAT_THREADS / GROUP)  // segments per block (flat form)
#define CLUSTER 8                    // CTAs per cluster (timestamp form)
#define TS_THREADS 1024
#define TS_SMEM_MAX (227 * 1024)     // one CTA's shared memory

namespace {

__device__ __forceinline__ int clamp_seg(int s, int n_seg) {
  return s < 0 ? 0 : (s >= n_seg ? n_seg - 1 : s);
}

// first row whose clipped id is >= s (n when there is none). Monotone in s
// for any ids: once two searches for s1 < s2 take different sides of a
// probe, s1 stays left of it and s2 right of it.
__device__ long lower_bound(const int* __restrict__ seg, long n, int n_seg,
                            int s) {
  long lo = 0, hi = n;
  while (lo < hi) {
    long mid = (lo + hi) >> 1;
    if (clamp_seg(__ldg(seg + mid), n_seg) < s)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int d = GROUP / 2; d > 0; d >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, d, GROUP));
  return v;
}

__device__ __forceinline__ float group_min(float v) {
#pragma unroll
  for (int d = GROUP / 2; d > 0; d >>= 1)
    v = fminf(v, __shfl_xor_sync(0xffffffffu, v, d, GROUP));
  return v;
}

__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int d = GROUP / 2; d > 0; d >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, d, GROUP));
  return v;
}

// one block per SEGS consecutive segments, one GROUP-lane group per
// segment; every lane of the warp runs every shuffle (groups past n_seg
// take an empty range)
__global__ void __launch_bounds__(FLAT_THREADS)
binstats_seg_kernel(const int* __restrict__ seg,
                    const float* __restrict__ values,
                    const uint8_t* __restrict__ valid, long n, int n_seg,
                    int n_metrics, float* __restrict__ out) {
  __shared__ long long first[SEGS + 1];   // first[k]: segment s0 + k's row
  const int s0 = blockIdx.x * SEGS;
  const int nsb = n_seg - s0 < SEGS ? n_seg - s0 : SEGS;
  // the block's rows: two binary searches, one per thread
  if (threadIdx.x < 2)
    first[threadIdx.x ? nsb : 0] =
        lower_bound(seg, n, n_seg, s0 + (threadIdx.x ? nsb : 0));
  __syncthreads();
  const long long a = first[0], b = first[nsb];
  for (int k = threadIdx.x + 1; k < nsb; k += FLAT_THREADS) first[k] = b;
  __syncthreads();
  // one coalesced pass over the block's ids: each segment's first row is
  // where the id steps up to it, and a step down or an id outside the
  // block's segments is disorder
  bool foreign = false;
  for (long long r = a + threadIdx.x; r < b; r += FLAT_THREADS) {
    const int cur = clamp_seg(__ldg(seg + r), n_seg) - s0;
    const int prev = r == a ? 0 : clamp_seg(__ldg(seg + r - 1), n_seg) - s0;
    if (cur < prev || cur >= nsb) {
      foreign = true;
      continue;
    }
    for (int k = prev + 1; k <= cur; ++k) first[k] = r;
  }
  const bool disordered = __syncthreads_or(foreign);
  const int g = threadIdx.x & (GROUP - 1);          // lane in the group
  const int k = threadIdx.x / GROUP;                // segment in the block
  const bool active = k < nsb;
  const long long lo = active ? first[k] : 0, hi = active ? first[k + 1] : 0;
  for (int m = 0; m < n_metrics; ++m) {
    const float* v = values + (long)m * n;
    float c = 0.f, sm = 0.f, ss = 0.f, mn = POS_CAP, mx = NEG_CAP;
    for (long long r = lo + g; r < hi; r += GROUP) {
      float x = __ldg(v + r);
      bool ok = __ldg(valid + r) != 0;
      float w = ok ? 1.f : 0.f;
      c = __fadd_rn(c, w);
      sm = __fadd_rn(sm, __fmul_rn(x, w));
      ss = __fadd_rn(ss, __fmul_rn(__fmul_rn(x, x), w));
      if (ok) {
        mn = fminf(mn, x);
        mx = fmaxf(mx, x);
      }
    }
    c = group_sum(c);
    sm = group_sum(sm);
    ss = group_sum(ss);
    mn = group_min(mn);
    mx = group_max(mx);
    if (active && g == 0) {
      float* o = out + ((long)m * n_seg + s0 + k) * 5;
      o[0] = disordered ? CUDART_NAN_F : c;
      o[1] = sm;
      o[2] = ss;
      o[3] = isfinite(mn) ? mn : POS_CAP;
      o[4] = isfinite(mx) ? mx : NEG_CAP;
    }
  }
}

__device__ __forceinline__ int ts_bin(float rel_ts, float inv_width,
                                      int n_bins) {
  float t = __fmul_rn(rel_ts, inv_width);
  t = fminf(fmaxf(t, 0.f), (float)(n_bins - 1));
  return __float2int_rz(t);
}

// order-preserving float <-> unsigned maps (for integer min/max atomics)
__device__ __forceinline__ unsigned ord(float f) {
  unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float unord(unsigned u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

// one cluster of CLUSTER CTAs (the whole grid); per CTA shared memory:
// cnt[n_bins] int, then per metric sum, sumsq (float) and min, max
// (ordered unsigned) over n_bins each
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(TS_THREADS)
binstats_ts_cluster_kernel(const float* __restrict__ rel_ts,
                           const float* __restrict__ values,
                           const uint8_t* __restrict__ valid, long n,
                           int n_metrics, int n_bins, float inv_width,
                           float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const long cells = (long)n_metrics * n_bins;
  int* cnt = reinterpret_cast<int*>(smem);
  float* sum = reinterpret_cast<float*>(cnt + n_bins);
  float* ssq = sum + cells;
  unsigned* mn = reinterpret_cast<unsigned*>(ssq + cells);
  unsigned* mx = mn + cells;
  for (int i = threadIdx.x; i < n_bins; i += TS_THREADS) cnt[i] = 0;
  for (long i = threadIdx.x; i < cells; i += TS_THREADS) {
    sum[i] = 0.f;
    ssq[i] = 0.f;
    mn[i] = 0xffffffffu;
    mx[i] = 0u;
  }
  __syncthreads();
  const long stride = (long)gridDim.x * TS_THREADS;
  for (long r = (long)blockIdx.x * TS_THREADS + threadIdx.x; r < n;
       r += stride) {
    if (!valid[r]) continue;
    const int b = ts_bin(rel_ts[r], inv_width, n_bins);
    atomicAdd(cnt + b, 1);
    for (int m = 0; m < n_metrics; ++m) {
      const float x = values[(long)m * n + r];
      const long c = (long)m * n_bins + b;
      atomicAdd(sum + c, x);
      atomicAdd(ssq + c, __fmul_rn(x, x));
      atomicMin(mn + c, ord(x));
      atomicMax(mx + c, ord(x));
    }
  }
  cluster.sync();                    // every CTA's table is complete
  const int ranks = (int)cluster.num_blocks();
  const long step = (long)ranks * TS_THREADS;
  for (long c = (long)cluster.block_rank() * TS_THREADS + threadIdx.x;
       c < cells; c += step) {
    const int b = (int)(c % n_bins);
    int count = 0;
    float s = 0.f, q = 0.f;
    unsigned lo = 0xffffffffu, hi = 0u;
    for (int k = 0; k < ranks; ++k) {
      const int* rc = cluster.map_shared_rank(cnt, k);
      const float* rs = cluster.map_shared_rank(sum, k);
      const float* rq = cluster.map_shared_rank(ssq, k);
      const unsigned* rl = cluster.map_shared_rank(mn, k);
      const unsigned* rh = cluster.map_shared_rank(mx, k);
      count += rc[b];
      s = __fadd_rn(s, rs[c]);
      q = __fadd_rn(q, rq[c]);
      lo = min(lo, rl[c]);
      hi = max(hi, rh[c]);
    }
    const float vlo = unord(lo), vhi = unord(hi);
    float* o = out + c * 5;
    o[0] = (float)count;
    o[1] = s;
    o[2] = q;
    o[3] = (count > 0 && isfinite(vlo)) ? vlo : POS_CAP;
    o[4] = (count > 0 && isfinite(vhi)) ? vhi : NEG_CAP;
  }
  cluster.sync();                    // keep each table until all have read
}

__device__ __forceinline__ void atomic_min_f32(float* addr, float v) {
  if (v >= 0.f)
    atomicMin(reinterpret_cast<int*>(addr), __float_as_int(v));
  else
    atomicMax(reinterpret_cast<unsigned int*>(addr), __float_as_uint(v));
}

__device__ __forceinline__ void atomic_max_f32(float* addr, float v) {
  if (v >= 0.f)
    atomicMax(reinterpret_cast<int*>(addr), __float_as_int(v));
  else
    atomicMin(reinterpret_cast<unsigned int*>(addr), __float_as_uint(v));
}

__global__ void ts_init_kernel(float* __restrict__ out, int* __restrict__ cnt,
                               long cells, int n_bins) {
  long stride = (long)gridDim.x * blockDim.x;
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < cells;
       i += stride) {
    float* o = out + i * 5;
    o[0] = 0.f;
    o[1] = 0.f;
    o[2] = 0.f;
    o[3] = POS_CAP;
    o[4] = NEG_CAP;
    if (i < n_bins) cnt[i] = 0;
  }
}

__global__ void ts_accumulate_kernel(const float* __restrict__ rel_ts,
                                     const float* __restrict__ values,
                                     const uint8_t* __restrict__ valid,
                                     long n, int n_metrics, int n_bins,
                                     float inv_width, float* __restrict__ out,
                                     int* __restrict__ cnt) {
  long stride = (long)gridDim.x * blockDim.x;
  for (long r = (long)blockIdx.x * blockDim.x + threadIdx.x; r < n;
       r += stride) {
    if (!valid[r]) continue;
    int b = ts_bin(rel_ts[r], inv_width, n_bins);
    atomicAdd(cnt + b, 1);
    for (int m = 0; m < n_metrics; ++m) {
      float x = values[(long)m * n + r];
      float* o = out + ((long)m * n_bins + b) * 5;
      atomicAdd(o + 1, x);
      atomicAdd(o + 2, __fmul_rn(x, x));
      atomic_min_f32(o + 3, x);
      atomic_max_f32(o + 4, x);
    }
  }
}

__global__ void ts_finalize_kernel(const int* __restrict__ cnt,
                                   float* __restrict__ out, long cells,
                                   int n_bins) {
  long stride = (long)gridDim.x * blockDim.x;
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < cells;
       i += stride) {
    float* o = out + i * 5;
    o[0] = (float)cnt[i % n_bins];
    if (!isfinite(o[3])) o[3] = POS_CAP;
    if (!isfinite(o[4])) o[4] = NEG_CAP;
  }
}

int grid_for(long work, int threads) {
  long blocks = (work + threads - 1) / threads;
  if (blocks < 1) blocks = 1;
  if (blocks > 132L * 32) blocks = 132L * 32;
  return (int)blocks;
}

}  // namespace

extern "C" {

// seg (n,) int32 segment-ordered, values (n_metrics, n) f32, valid (n,) u8,
// out (n_metrics, n_seg, 5) f32. Rows out of segment order leave NaN in
// the count of at least one cell.
int binstats_flat(const int* seg, const float* values, const uint8_t* valid,
                  long n, int n_seg, int n_metrics, float* out,
                  void* stream) {
  if (n_seg < 1 || n_metrics < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long blocks = (n_seg + SEGS - 1) / SEGS;
  binstats_seg_kernel<<<(unsigned)blocks, FLAT_THREADS, 0, st>>>(
      seg, values, valid, n, n_seg, n_metrics, out);
  return (int)cudaGetLastError();
}

// The int32 scratch (in elements) binstats_ts needs: n_bins when the
// table exceeds a CTA's shared memory, else 0 (one cluster launch).
long binstats_ts_scratch(int n_bins, int n_metrics) {
  return (long)n_bins * (1 + 4L * n_metrics) * 4 > TS_SMEM_MAX ? n_bins : 0;
}

// rel_ts (n,) f32, values (n_metrics, n) f32, valid (n,) u8,
// out (n_metrics, n_bins, 5) f32; cnt (n_bins,) int32 scratch when
// binstats_ts_scratch asks for it, else unused.
int binstats_ts(const float* rel_ts, const float* values,
                const uint8_t* valid, long n, int n_metrics, int n_bins,
                float inv_width, int* cnt, float* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long cells = (long)n_metrics * n_bins;
  const long smem = (long)n_bins * (1 + 4L * n_metrics) * 4;
  if (smem <= TS_SMEM_MAX) {
    // the kernel's shared-memory limit is raised once per device, to the
    // largest table seen
    static int raised[64];
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev >= 64) return (int)cudaErrorInvalidDevice;
    if (smem > raised[dev]) {
      e = cudaFuncSetAttribute(binstats_ts_cluster_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
      if (e != cudaSuccess) return (int)e;
      raised[dev] = (int)smem;
    }
    binstats_ts_cluster_kernel<<<CLUSTER, TS_THREADS, (size_t)smem, st>>>(
        rel_ts, values, valid, n, n_metrics, n_bins, inv_width, out);
    return (int)cudaGetLastError();
  }
  if (cnt == nullptr) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  ts_init_kernel<<<grid_for(cells, threads), threads, 0, st>>>(
      out, cnt, cells, n_bins);
  if (n > 0)
    ts_accumulate_kernel<<<grid_for(n, threads), threads, 0, st>>>(
        rel_ts, values, valid, n, n_metrics, n_bins, inv_width, out, cnt);
  ts_finalize_kernel<<<grid_for(cells, threads), threads, 0, st>>>(
      cnt, out, cells, n_bins);
  return (int)cudaGetLastError();
}

}  // extern "C"
