// Per-(metric, segment) log2-bucket histogram counts on Hopper.
//
// Replaces the TPU kernel src/repro/kernels/histbin/kernel.py
// (_histbin_kernel / histbin_pallas), which contracted a bucket one-hot
// against a bin one-hot on the MXU, once more because the TPU has no
// atomics. Counts are integers, so on Hopper each valid row adds 1 to its
// (metric, segment, bucket) cell with a 32-bit integer atomic: exact and
// independent of the order in which rows arrive. The output buffer is
// zeroed, counted into as int32 and converted in place to float32, so the
// kernel needs no scratch of its own.
//
// Bucket (same float32 contract as the JAX device path):
//   clip(floor(log2(max(v, 1)) * 8), 0, 383)
// log2f is CUDA's correctly-rounded-within-1-ulp version (no fast math), so
// a value on a bucket edge may land one bucket away from XLA's or
// PyTorch's float32 log2, as it may between any two float32 libraries.
//
// Entry points: histbin_flat (segment id per row, the quantile reducer's
// phase-2 path; rows in any order, ids outside [0, n_seg) are dropped as a
// segment_sum drops them) and histbin_ts (the TPU kernel's contract: the bin
// is computed in-register from the relative timestamp and clipped).
//
// Bound on the card: bytes. The output, M * n_seg * 384 float32, dwarfs the
// input (about 9 bytes per row and metric); it is written three times here
// (zero, atomics, convert). A design that keeps a block's segment range in
// shared memory and writes each cell once is later work.

#include <cuda_runtime.h>
#include <stdint.h>

#define N_BUCKETS 384
#define SUBDIV 8.0f
#define V_FLOOR 1.0f

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

__global__ void flat_count_kernel(const int* __restrict__ seg,
                                  const float* __restrict__ values,
                                  const uint8_t* __restrict__ valid, long n,
                                  int n_seg, int n_metrics,
                                  int* __restrict__ out) {
  long stride = (long)gridDim.x * blockDim.x;
  for (long r = (long)blockIdx.x * blockDim.x + threadIdx.x; r < n;
       r += stride) {
    int s = seg[r];
    if (!valid[r] || s < 0 || s >= n_seg) continue;
    for (int m = 0; m < n_metrics; ++m) {
      int b = bucket_of(values[(long)m * n + r]);
      atomicAdd(out + ((long)m * n_seg + s) * N_BUCKETS + b, 1);
    }
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

// seg (n,) int32, values (n_metrics, n) f32, valid (n,) u8,
// out (n_metrics, n_seg, 384) f32.
int histbin_flat(const int* seg, const float* values, const uint8_t* valid,
                 long n, int n_seg, int n_metrics, float* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  int* o = reinterpret_cast<int*>(out);
  long cells = (long)n_metrics * n_seg * N_BUCKETS;
  zero_kernel<<<grid_for(cells, threads), threads, 0, st>>>(o, cells);
  if (n > 0)
    flat_count_kernel<<<grid_for(n, threads), threads, 0, st>>>(
        seg, values, valid, n, n_seg, n_metrics, o);
  to_float_kernel<<<grid_for(cells, threads), threads, 0, st>>>(o, cells);
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
