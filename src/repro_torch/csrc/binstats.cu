// Per-segment moments (count, sum, sumsq, min, max) on Hopper.
//
// Replaces the TPU kernel src/repro/kernels/binstats/kernel.py
// (_binstats_kernel / binstats_pallas), which binned float32 timestamps and
// scattered rows into bins as a one-hot matmul on the MXU, the TPU's answer
// to having no atomics. Two entry points:
//
//  * binstats_flat: the phase-2 main path. Rows arrive segment-ordered
//    (a stable order of each slot's rows by segment, built by the producer
//    on the host); one thread owns one (metric, segment) cell and walks its
//    rows in row order, accumulating in registers. Each cell's float32 sum
//    and sumsq are therefore a fixed-order function of that segment's rows
//    alone: no float atomics and no tiles cut at absolute row positions, so
//    a delta run over dirty shards and a cold run over every shard produce
//    bit-identical partials. The products and sums are written with
//    __fmul_rn/__fadd_rn so the compiler cannot contract them into FMAs:
//    the arithmetic per row is the plain version's.
//  * binstats_ts: the TPU kernel's own contract. The bin is computed
//    in-register from the relative timestamp; count rides 32-bit integer
//    atomics (exact), sum/sumsq float atomics (order-dependent rounding,
//    rtol 1e-5 against the plain version), min/max the ordered-int atomics.
//
// Bound on the card: bytes. Each row is read once (4 bytes per metric + 1
// valid byte + 4 segment bytes) and each cell written once (20 bytes per
// metric); the work is a handful of flops per row. The flat design reads
// rows contiguously per thread (the warp's 32 threads walk 32 neighbouring
// segments, so a warp touches a few consecutive cache lines per step); it
// makes no attempt yet at coalescing or at sharing one segment between the
// threads of a warp.

#include <cuda_runtime.h>
#include <stdint.h>

#define POS_CAP 3.4e38f
#define NEG_CAP -3.4e38f

namespace {

__device__ __forceinline__ int clamp_seg(int s, int n_seg) {
  return s < 0 ? 0 : (s >= n_seg ? n_seg - 1 : s);
}

// offsets[s] = first row whose (clipped) segment is >= s; offsets[n_seg] = n.
// Rows out of segment order set *err (the wrapper raises).
__global__ void csr_offsets_kernel(const int* __restrict__ seg, long n,
                                   int n_seg, int* __restrict__ offsets,
                                   int* __restrict__ err) {
  long stride = (long)gridDim.x * blockDim.x;
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i <= n;
       i += stride) {
    int prev = (i == 0) ? -1 : clamp_seg(seg[i - 1], n_seg);
    int cur = (i == n) ? n_seg : clamp_seg(seg[i], n_seg);
    if (cur < prev) {
      atomicExch(err, 1);
      continue;
    }
    for (int s = prev + 1; s <= cur; ++s) offsets[s] = (int)i;
  }
}

__global__ void binstats_csr_kernel(const int* __restrict__ offsets,
                                    const float* __restrict__ values,
                                    const uint8_t* __restrict__ valid,
                                    long n, int n_seg, int n_metrics,
                                    float* __restrict__ out) {
  long cell = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (cell >= (long)n_metrics * n_seg) return;
  int m = (int)(cell / n_seg);
  int s = (int)(cell % n_seg);
  const float* v = values + (long)m * n;
  float c = 0.f, sm = 0.f, ss = 0.f, mn = POS_CAP, mx = NEG_CAP;
  int end = offsets[s + 1];
  for (int r = offsets[s]; r < end; ++r) {
    float x = v[r];
    bool ok = valid[r] != 0;
    float w = ok ? 1.f : 0.f;
    c = __fadd_rn(c, w);
    sm = __fadd_rn(sm, __fmul_rn(x, w));
    ss = __fadd_rn(ss, __fmul_rn(__fmul_rn(x, x), w));
    if (ok) {
      mn = fminf(mn, x);
      mx = fmaxf(mx, x);
    }
  }
  float* o = out + cell * 5;
  o[0] = c;
  o[1] = sm;
  o[2] = ss;
  o[3] = isfinite(mn) ? mn : POS_CAP;
  o[4] = isfinite(mx) ? mx : NEG_CAP;
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
    float t = __fmul_rn(rel_ts[r], inv_width);
    t = fminf(fmaxf(t, 0.f), (float)(n_bins - 1));
    int b = __float2int_rz(t);
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
// offsets (n_seg + 1,) int32 scratch, err (1,) int32 set to 1 when the rows
// are not segment-ordered, out (n_metrics, n_seg, 5) f32.
int binstats_flat(const int* seg, const float* values, const uint8_t* valid,
                  long n, int n_seg, int n_metrics, int* offsets, int* err,
                  float* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  cudaError_t e = cudaMemsetAsync(err, 0, sizeof(int), st);
  if (e != cudaSuccess) return (int)e;
  csr_offsets_kernel<<<grid_for(n + 1, threads), threads, 0, st>>>(
      seg, n, n_seg, offsets, err);
  long cells = (long)n_metrics * n_seg;
  if (cells > 0) {
    long blocks = (cells + threads - 1) / threads;
    binstats_csr_kernel<<<(unsigned)blocks, threads, 0, st>>>(
        offsets, values, valid, n, n_seg, n_metrics, out);
  }
  return (int)cudaGetLastError();
}

// rel_ts (n,) f32, values (n_metrics, n) f32, valid (n,) u8, cnt (n_bins,)
// int32 scratch, out (n_metrics, n_bins, 5) f32.
int binstats_ts(const float* rel_ts, const float* values,
                const uint8_t* valid, long n, int n_metrics, int n_bins,
                float inv_width, int* cnt, float* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  long cells = (long)n_metrics * n_bins;
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
