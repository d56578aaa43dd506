// Per-(metric, segment) log2-bucket histogram counts on Hopper.
//
// Replaces the TPU kernel src/repro/kernels/histbin/kernel.py
// (_histbin_kernel / histbin_pallas), which contracted a bucket one-hot
// against a bin one-hot on the MXU, once more because the TPU has no
// atomics. Counts are integers, so on Hopper they are exact under integer
// atomics in any order. Two entry points:
//
//  * histbin_flat (the quantile reducer's phase-2 path): one launch, no
//    scratch, each output cell written once. Rows arrive segment-ordered
//    (the producer orders them for binstats_flat, and both reducers share
//    the upload). A block owns SEGS consecutive segments: two binary
//    searches over the ordered ids give its rows, which it counts into a
//    SEGS x 384 int32 table in shared memory with shared-memory atomics,
//    one metric at a time; it then writes its SEGS x 384 cells of that
//    metric, zeros included, as float32 with 16-byte stores (12 KB
//    contiguous a metric) and clears the table for the next metric. Ids
//    outside [0, n_seg) and invalid rows are dropped: the searches run
//    over ids clipped to [-1, n_seg], so ids below 0 lead the rows and ids
//    at or above n_seg trail them, and the first and the last block own
//    those rows too. The order check rides the first pass over the ids:
//    binary search is monotone in its target over any ids, so the blocks'
//    ranges tile the rows in order, and each block checks that its clipped
//    ids never step down and stay among its own segments. All checks pass
//    exactly when the clipped ids are non-decreasing. A block that finds
//    disorder writes NaN into every cell it owns, so the caller's copy of
//    the table carries the verdict (bucket 0 of every cell is enough to
//    read it), with no flag buffer, memset or synchronisation.
//  * histbin_ts (the TPU kernel's contract, on no path): the bin is
//    computed in-register from the relative timestamp and clipped. The
//    output buffer is zeroed, counted into with 32-bit global atomics as
//    int32 and converted in place to float32 (three launches).
//
// Bucket (same float32 contract as the JAX device path):
//   clip(floor(log2(max(v, 1)) * 8), 0, 383)
// log2f is CUDA's correctly-rounded-within-1-ulp version (no fast math), so
// a value on a bucket edge may land one bucket away from XLA's or
// PyTorch's float32 log2, as it may between any two float32 libraries.
//
// Bound on the card: bytes. The output, M * n_seg * 384 float32 (221 MB at
// the main path's 3 x 48,000 segments), dwarfs the input (about 9 bytes
// per row and metric). histbin_flat writes it once; at 8 segments a block
// (6,000 blocks of 256 threads, 12 KB of shared memory each) enough blocks
// are in flight to keep the stores streaming.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#define N_BUCKETS 384
#define SUBDIV 8.0f
#define V_FLOOR 1.0f
#define SEGS 8                // segments per block (flat form)
#define SEG_THREADS 256

namespace {

__device__ __forceinline__ int bucket_of(float v) {
  float b = floorf(__fmul_rn(log2f(fmaxf(v, V_FLOOR)), SUBDIV));
  b = fminf(fmaxf(b, 0.f), (float)(N_BUCKETS - 1));
  return (int)b;
}

__global__ void zero_kernel(int* __restrict__ out, long n) {
  long stride = (long)gridDim.x * blockDim.x;
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride)
    out[i] = 0;
}

__global__ void to_float_kernel(int* __restrict__ out, long n) {
  long stride = (long)gridDim.x * blockDim.x;
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride)
    reinterpret_cast<float*>(out)[i] = (float)out[i];
}

__device__ __forceinline__ int clip_key(int s, int n_seg) {
  return s < 0 ? -1 : (s >= n_seg ? n_seg : s);
}

// first row whose clipped id is >= s (n when there is none); monotone in s
// for any ids
__device__ __forceinline__ long lower_bound(const int* __restrict__ seg,
                                            long n, int n_seg, int s) {
  long lo = 0, hi = n;
  while (lo < hi) {
    long mid = (lo + hi) >> 1;
    if (clip_key(__ldg(seg + mid), n_seg) < s)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// one block per SEGS consecutive segments; see the note at the top. Six
// blocks an SM: 12 KB of shared memory and up to 42 registers each (at
// ptxas's own choice, 32, it spilled)
__global__ void __launch_bounds__(SEG_THREADS, 6)
    histbin_seg_kernel(const int* __restrict__ seg,
                       const float* __restrict__ values,
                       const uint8_t* __restrict__ valid, long n, int n_seg,
                       int n_metrics, float* __restrict__ out) {
  __shared__ __align__(16) int table[SEGS * N_BUCKETS];
  __shared__ long long range[2];
  const int s0 = blockIdx.x * SEGS;
  const int nsb = n_seg - s0 < SEGS ? n_seg - s0 : SEGS;
  const bool first = blockIdx.x == 0, last = s0 + nsb == n_seg;
  if (threadIdx.x < 2) {
    const int k = threadIdx.x;
    range[k] = k == 0 ? (first ? 0 : lower_bound(seg, n, n_seg, s0))
                      : (last ? n : lower_bound(seg, n, n_seg, s0 + nsb));
  }
  int4* t4 = reinterpret_cast<int4*>(table);
  for (int i = threadIdx.x; i < SEGS * N_BUCKETS / 4; i += SEG_THREADS)
    t4[i] = make_int4(0, 0, 0, 0);
  __syncthreads();
  const long long a = range[0], b = range[1];
  // the order check: clipped ids stay among the block's segments (or -1 in
  // the first block, n_seg in the last) and never step down
  const int k_lo = first ? -1 : s0, k_hi = last ? n_seg : s0 + nsb - 1;
  bool bad = false;
  for (long long r = a + threadIdx.x; r < b; r += SEG_THREADS) {
    const int cur = clip_key(__ldg(seg + r), n_seg);
    const int prev = r == a ? k_lo : clip_key(__ldg(seg + r - 1), n_seg);
    bad |= cur < prev || cur < k_lo || cur > k_hi;
  }
  const bool disordered = __syncthreads_or(bad);
  const int cells = nsb * N_BUCKETS;
  for (int m = 0; m < n_metrics; ++m) {
    const float* v = values + (long)m * n;
    for (long long r = a + threadIdx.x; r < b; r += SEG_THREADS) {
      const int s = __ldg(seg + r);
      if (s < s0 || s >= s0 + nsb || !__ldg(valid + r)) continue;
      atomicAdd(table + (s - s0) * N_BUCKETS + bucket_of(__ldg(v + r)), 1);
    }
    __syncthreads();
    // the block's cells of metric m are contiguous: 16-byte stores, and
    // each table entry is cleared as it is read
    float4* o4 = reinterpret_cast<float4*>(out + ((long)m * n_seg + s0) *
                                                     N_BUCKETS);
    for (int i = threadIdx.x; i < cells / 4; i += SEG_THREADS) {
      const int4 c = t4[i];
      t4[i] = make_int4(0, 0, 0, 0);
      const float nan = CUDART_NAN_F;
      o4[i] = disordered ? make_float4(nan, nan, nan, nan)
                         : make_float4((float)c.x, (float)c.y, (float)c.z,
                                       (float)c.w);
    }
    __syncthreads();
  }
}

__global__ void ts_count_kernel(const float* __restrict__ rel_ts,
                                const float* __restrict__ values,
                                const uint8_t* __restrict__ valid, long n,
                                int n_bins, int n_metrics, float inv_width,
                                int* __restrict__ out) {
  long stride = (long)gridDim.x * blockDim.x;
  for (long r = (long)blockIdx.x * blockDim.x + threadIdx.x; r < n;
       r += stride) {
    if (!valid[r]) continue;
    float t = __fmul_rn(rel_ts[r], inv_width);
    t = fminf(fmaxf(t, 0.f), (float)(n_bins - 1));
    int s = __float2int_rz(t);
    for (int m = 0; m < n_metrics; ++m) {
      int b = bucket_of(values[(long)m * n + r]);
      atomicAdd(out + ((long)m * n_bins + s) * N_BUCKETS + b, 1);
    }
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
// out (n_metrics, n_seg, 384) f32, 16-byte aligned. Rows out of segment
// order leave NaN in every cell of at least one segment.
int histbin_flat(const int* seg, const float* values, const uint8_t* valid,
                 long n, int n_seg, int n_metrics, float* out, void* stream) {
  if (n_seg < 1 || n_metrics < 1 || n < 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long blocks = (n_seg + SEGS - 1) / SEGS;
  histbin_seg_kernel<<<(unsigned)blocks, SEG_THREADS, 0, st>>>(
      seg, values, valid, n, n_seg, n_metrics, out);
  return (int)cudaGetLastError();
}

// rel_ts (n,) f32, values (n_metrics, n) f32, valid (n,) u8,
// out (n_metrics, n_bins, 384) f32.
int histbin_ts(const float* rel_ts, const float* values, const uint8_t* valid,
               long n, int n_bins, int n_metrics, float inv_width, float* out,
               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  int* o = reinterpret_cast<int*>(out);
  long cells = (long)n_metrics * n_bins * N_BUCKETS;
  zero_kernel<<<grid_for(cells, threads), threads, 0, st>>>(o, cells);
  if (n > 0)
    ts_count_kernel<<<grid_for(n, threads), threads, 0, st>>>(
        rel_ts, values, valid, n, n_bins, n_metrics, inv_width, o);
  to_float_kernel<<<grid_for(cells, threads), threads, 0, st>>>(o, cells);
  return (int)cudaGetLastError();
}

}  // extern "C"
