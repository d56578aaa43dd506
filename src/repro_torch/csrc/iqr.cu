// IQR fences over a per-bin score table on Hopper: ascending sort of the
// occupied scores, Q1/Q3 by linear interpolation (as np.percentile), Tukey
// fences with factor k, and flags score > hi & occupied.
//
// Replaces the TPU kernel src/repro/kernels/iqr/kernel.py (_iqr_kernel,
// iqr_pallas, _bitonic_sort, _pct), which ran a statically unrolled bitonic
// network over the whole table in VMEM. The table here is padded to a
// power of two n_p with +3.4e38 (unoccupied bins take the same key and sort
// to the top), and:
//
//  * n_p <= 32768 (128 KB of keys, inside the 227 KB a block may hold): one
//    CTA of 1024 threads loads the keys into shared memory, runs the
//    bitonic network there with one __syncthreads per stage, computes the
//    quartiles and fences on one thread, and writes the sorted table and
//    the flags. One launch.
//  * larger tables: the keys go to a global scratch buffer, each bitonic
//    stage (k, j) is one launch over n_p/2 compare-exchange pairs, one
//    block counts the occupied bins and computes the fences, and a grid
//    pass writes the sorted table and the flags.
//
// No library sort anywhere. Bound on the card: at the main path's sizes
// (n of tens of thousands) the table is a few hundred KB, so the work is
// latency: log2(n_p)*(log2(n_p)+1)/2 dependent stages. The single-CTA path
// keeps every stage in shared memory; the multi-launch path pays one launch
// per stage and is there for size, not speed.
//
// The fence arithmetic uses __fmul_rn/__fadd_rn so it rounds as the plain
// float32 version does (no FMA contraction).

#include <cuda_runtime.h>
#include <stdint.h>

#define POS_CAP 3.4e38f
#define SMEM_MAX_KEYS 32768

namespace {

__device__ __forceinline__ float safe_key(float x) {
  return x >= POS_CAP ? 0.f : x;
}

__device__ float pct(const float* srt, int n_p, float n_occ, float q) {
  float pos = __fmul_rn(q, __fsub_rn(n_occ, 1.f));
  int lo = (int)floorf(pos);
  lo = lo < 0 ? 0 : (lo > n_p - 1 ? n_p - 1 : lo);
  int hi = lo + 1 > n_p - 1 ? n_p - 1 : lo + 1;
  float frac = __fsub_rn(pos, (float)lo);
  float vlo = safe_key(srt[lo]);
  float vhi = safe_key(srt[hi]);
  if (n_occ > 1.f) return __fadd_rn(vlo, __fmul_rn(frac, __fsub_rn(vhi, vlo)));
  return vlo;
}

// stats8 = (q1, q3, iqr, lo_fence, hi_fence, n_occ, 0, 0)
__device__ void fences(const float* srt, int n_p, int count, float k,
                       float* stats) {
  float n_occ = (float)(count > 1 ? count : 1);
  float q1 = pct(srt, n_p, n_occ, 0.25f);
  float q3 = pct(srt, n_p, n_occ, 0.75f);
  float iqr = __fsub_rn(q3, q1);
  float kq = __fmul_rn(k, iqr);
  stats[0] = q1;
  stats[1] = q3;
  stats[2] = iqr;
  stats[3] = __fsub_rn(q1, kq);
  stats[4] = __fadd_rn(q3, kq);
  stats[5] = n_occ;
  stats[6] = 0.f;
  stats[7] = 0.f;
}

__device__ __forceinline__ void compare_exchange(float* a, int i, int l,
                                                 bool asc) {
  float x = a[i], y = a[l];
  if ((x > y) == asc) {
    a[i] = y;
    a[l] = x;
  }
}

__global__ void iqr_smem_kernel(const float* __restrict__ scores,
                                const uint8_t* __restrict__ occ, int n,
                                int n_p, float k, float* __restrict__ sorted,
                                int* __restrict__ flags,
                                float* __restrict__ stats) {
  extern __shared__ float keys[];
  __shared__ int count;
  __shared__ float st[8];
  if (threadIdx.x == 0) count = 0;
  __syncthreads();
  int local = 0;
  for (int i = threadIdx.x; i < n_p; i += blockDim.x) {
    bool o = i < n && occ[i];
    keys[i] = o ? scores[i] : POS_CAP;
    local += o;
  }
  atomicAdd(&count, local);
  __syncthreads();
  for (int kk = 2; kk <= n_p; kk <<= 1) {
    for (int j = kk >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < n_p / 2; t += blockDim.x) {
        int i = ((t & ~(j - 1)) << 1) | (t & (j - 1));
        compare_exchange(keys, i, i | j, (i & kk) == 0);
      }
      __syncthreads();
    }
  }
  if (threadIdx.x == 0) fences(keys, n_p, count, k, st);
  __syncthreads();
  float hi = st[4];
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    sorted[i] = safe_key(keys[i]);
    flags[i] = (scores[i] > hi && occ[i]) ? 1 : 0;
  }
  if (threadIdx.x < 8) stats[threadIdx.x] = st[threadIdx.x];
}

__global__ void load_kernel(const float* __restrict__ scores,
                            const uint8_t* __restrict__ occ, int n, int n_p,
                            float* __restrict__ keys) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n_p;
       i += gridDim.x * blockDim.x)
    keys[i] = (i < n && occ[i]) ? scores[i] : POS_CAP;
}

__global__ void stage_kernel(float* __restrict__ keys, int n_p, int kk,
                             int j) {
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_p / 2) return;
  int i = ((t & ~(j - 1)) << 1) | (t & (j - 1));
  compare_exchange(keys, i, i | j, (i & kk) == 0);
}

__global__ void fence_kernel(const float* __restrict__ keys,
                             const uint8_t* __restrict__ occ, int n, int n_p,
                             float k, float* __restrict__ stats) {
  __shared__ int count;
  if (threadIdx.x == 0) count = 0;
  __syncthreads();
  int local = 0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) local += occ[i] != 0;
  atomicAdd(&count, local);
  __syncthreads();
  if (threadIdx.x == 0) fences(keys, n_p, count, k, stats);
}

__global__ void output_kernel(const float* __restrict__ keys,
                              const float* __restrict__ scores,
                              const uint8_t* __restrict__ occ, int n,
                              const float* __restrict__ stats,
                              float* __restrict__ sorted,
                              int* __restrict__ flags) {
  float hi = stats[4];
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    sorted[i] = safe_key(keys[i]);
    flags[i] = (scores[i] > hi && occ[i]) ? 1 : 0;
  }
}

}  // namespace

extern "C" {

int iqr_smem_max_keys() { return SMEM_MAX_KEYS; }

// scores (n,) f32, occ (n,) u8, n_p = next power of two >= max(n, 2);
// keys (n_p,) f32 scratch, used only when n_p > SMEM_MAX_KEYS;
// sorted (n,) f32, flags (n,) int32, stats (8,) f32.
int iqr_fences(const float* scores, const uint8_t* occ, int n, int n_p,
               float k, float* keys, float* sorted, int* flags, float* stats,
               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_p <= SMEM_MAX_KEYS) {
    size_t smem = (size_t)n_p * sizeof(float);
    cudaError_t e = cudaFuncSetAttribute(
        iqr_smem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    iqr_smem_kernel<<<1, 1024, smem, st>>>(scores, occ, n, n_p, k, sorted,
                                           flags, stats);
    return (int)cudaGetLastError();
  }
  const int threads = 256;
  int pair_blocks = (n_p / 2 + threads - 1) / threads;
  load_kernel<<<(n_p + threads - 1) / threads, threads, 0, st>>>(
      scores, occ, n, n_p, keys);
  for (int kk = 2; kk <= n_p; kk <<= 1)
    for (int j = kk >> 1; j > 0; j >>= 1)
      stage_kernel<<<pair_blocks, threads, 0, st>>>(keys, n_p, kk, j);
  fence_kernel<<<1, 1024, 0, st>>>(keys, occ, n, n_p, k, stats);
  output_kernel<<<(n + threads - 1) / threads, threads, 0, st>>>(
      keys, scores, occ, n, stats, sorted, flags);
  return (int)cudaGetLastError();
}

}  // extern "C"
