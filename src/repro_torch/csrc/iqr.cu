// IQR fences over a per-bin score table on Hopper: ascending sort of the
// occupied scores, Q1/Q3 by linear interpolation (as np.percentile), Tukey
// fences with factor k, and flags score > hi & occupied.
//
// Replaces the TPU kernel src/repro/kernels/iqr/kernel.py (_iqr_kernel,
// iqr_pallas, _bitonic_sort, _pct), which ran a statically unrolled bitonic
// network over the whole table in VMEM. The table here is padded to a
// power of two n_p with the key PAD (unoccupied bins take the same key and
// sort to the top), and:
//
//  * n_p * sizeof(key) <= 128 KB (32,768 float keys, 16,384 double keys,
//    inside the 227 KB a block may hold): one CTA of 1024 threads loads the
//    keys into shared memory, runs the bitonic network there with one
//    __syncthreads per stage, computes the quartiles and fences on one
//    thread, and writes the sorted table and the flags. One launch.
//  * larger tables: the keys go to a global scratch buffer, each bitonic
//    stage (k, j) is one launch over n_p/2 compare-exchange pairs, one
//    block counts the occupied bins and computes the fences, and a grid
//    pass writes the sorted table and the flags.
//
// Two key types, one template. float keeps the TPU kernel's contract
// (PAD = 3.4e38, everything float32, n_occ as a float). double serves the
// analysis path, whose reference takes the quartiles with np.percentile in
// float64: PAD = +inf sorts above every finite double, the virtual index
// is (n_occ - 1) * q, the interpolation is numpy's _lerp (a + (b - a) * t,
// or b - (b - a) * (1 - t) when t >= 0.5) and the fences are q3 + k * iqr
// and q1 - k * iqr, each product and sum rounded on its own
// (__dmul_rn / __dadd_rn, no FMA contraction), so Q1, Q3 and the fences
// equal np.percentile's bit for bit.
//
// No library sort anywhere. Bound on the card: at the main path's sizes
// (n of tens of thousands) the table is a few hundred KB, so the work is
// latency: log2(n_p)*(log2(n_p)+1)/2 dependent stages. The single-CTA path
// keeps every stage in shared memory; the multi-launch path pays one launch
// per stage and is there for size, not speed.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#define SMEM_MAX_BYTES (128 * 1024)

namespace {

template <typename T>
struct Key;

template <>
struct Key<float> {
  static __device__ __forceinline__ float pad() { return 3.4e38f; }
};

template <>
struct Key<double> {
  static __device__ __forceinline__ double pad() { return CUDART_INF; }
};

// a padding key reads as 0
template <typename T>
__device__ __forceinline__ T safe_key(T x) {
  return x >= Key<T>::pad() ? T(0) : x;
}

// float32: the TPU kernel's _pct, rounded as the plain float32 version
__device__ float pct(const float* srt, int n_p, int count, float q) {
  float n_occ = (float)(count > 1 ? count : 1);
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

// float64: np.percentile(method="linear") over the n_occ smallest keys
__device__ double pct(const double* srt, int n_p, int count, double q) {
  int n_occ = count > 1 ? count : 1;
  double pos = __dmul_rn((double)(n_occ - 1), q);
  int lo = (int)floor(pos);
  int hi = lo + 1 < n_occ ? lo + 1 : n_occ - 1;
  double t = __dsub_rn(pos, (double)lo);
  double a = safe_key(srt[lo]);
  double b = safe_key(srt[hi]);
  double d = __dsub_rn(b, a);
  if (t >= 0.5) return __dsub_rn(b, __dmul_rn(d, __dsub_rn(1.0, t)));
  return __dadd_rn(a, __dmul_rn(d, t));
}

__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}

// stats8 = (q1, q3, iqr, lo_fence, hi_fence, n_occ, 0, 0)
template <typename T>
__device__ void fences(const T* srt, int n_p, int count, T k, T* stats) {
  T q1 = pct(srt, n_p, count, T(0.25));
  T q3 = pct(srt, n_p, count, T(0.75));
  T iqr = sub_rn(q3, q1);
  T kq = mul_rn(k, iqr);
  stats[0] = q1;
  stats[1] = q3;
  stats[2] = iqr;
  stats[3] = sub_rn(q1, kq);
  stats[4] = add_rn(q3, kq);
  stats[5] = (T)(count > 1 ? count : 1);
  stats[6] = T(0);
  stats[7] = T(0);
}

template <typename T>
__device__ __forceinline__ void compare_exchange(T* a, int i, int l,
                                                 bool asc) {
  T x = a[i], y = a[l];
  if ((x > y) == asc) {
    a[i] = y;
    a[l] = x;
  }
}

template <typename T>
__global__ void iqr_smem_kernel(const T* __restrict__ scores,
                                const uint8_t* __restrict__ occ, int n,
                                int n_p, T k, T* __restrict__ sorted,
                                int* __restrict__ flags,
                                T* __restrict__ stats) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* keys = reinterpret_cast<T*>(smem);
  __shared__ int count;
  __shared__ T st[8];
  if (threadIdx.x == 0) count = 0;
  __syncthreads();
  int local = 0;
  for (int i = threadIdx.x; i < n_p; i += blockDim.x) {
    bool o = i < n && occ[i];
    keys[i] = o ? scores[i] : Key<T>::pad();
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
  T hi = st[4];
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    sorted[i] = safe_key(keys[i]);
    flags[i] = (scores[i] > hi && occ[i]) ? 1 : 0;
  }
  if (threadIdx.x < 8) stats[threadIdx.x] = st[threadIdx.x];
}

template <typename T>
__global__ void load_kernel(const T* __restrict__ scores,
                            const uint8_t* __restrict__ occ, int n, int n_p,
                            T* __restrict__ keys) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n_p;
       i += gridDim.x * blockDim.x)
    keys[i] = (i < n && occ[i]) ? scores[i] : Key<T>::pad();
}

template <typename T>
__global__ void stage_kernel(T* __restrict__ keys, int n_p, int kk, int j) {
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_p / 2) return;
  int i = ((t & ~(j - 1)) << 1) | (t & (j - 1));
  compare_exchange(keys, i, i | j, (i & kk) == 0);
}

template <typename T>
__global__ void fence_kernel(const T* __restrict__ keys,
                             const uint8_t* __restrict__ occ, int n, int n_p,
                             T k, T* __restrict__ stats) {
  __shared__ int count;
  if (threadIdx.x == 0) count = 0;
  __syncthreads();
  int local = 0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) local += occ[i] != 0;
  atomicAdd(&count, local);
  __syncthreads();
  if (threadIdx.x == 0) fences(keys, n_p, count, k, stats);
}

template <typename T>
__global__ void output_kernel(const T* __restrict__ keys,
                              const T* __restrict__ scores,
                              const uint8_t* __restrict__ occ, int n,
                              const T* __restrict__ stats,
                              T* __restrict__ sorted,
                              int* __restrict__ flags) {
  T hi = stats[4];
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    sorted[i] = safe_key(keys[i]);
    flags[i] = (scores[i] > hi && occ[i]) ? 1 : 0;
  }
}

template <typename T>
int launch(const T* scores, const uint8_t* occ, int n, int n_p, T k, T* keys,
           T* sorted, int* flags, T* stats, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((size_t)n_p * sizeof(T) <= SMEM_MAX_BYTES) {
    size_t smem = (size_t)n_p * sizeof(T);
    cudaError_t e = cudaFuncSetAttribute(
        iqr_smem_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    iqr_smem_kernel<T><<<1, 1024, smem, st>>>(scores, occ, n, n_p, k, sorted,
                                              flags, stats);
    return (int)cudaGetLastError();
  }
  const int threads = 256;
  int pair_blocks = (n_p / 2 + threads - 1) / threads;
  load_kernel<T><<<(n_p + threads - 1) / threads, threads, 0, st>>>(
      scores, occ, n, n_p, keys);
  for (int kk = 2; kk <= n_p; kk <<= 1)
    for (int j = kk >> 1; j > 0; j >>= 1)
      stage_kernel<T><<<pair_blocks, threads, 0, st>>>(keys, n_p, kk, j);
  fence_kernel<T><<<1, 1024, 0, st>>>(keys, occ, n, n_p, k, stats);
  output_kernel<T><<<(n + threads - 1) / threads, threads, 0, st>>>(
      keys, scores, occ, n, stats, sorted, flags);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// scores (n,) f32, occ (n,) u8, n_p = next power of two >= max(n, 2);
// keys (n_p,) f32 scratch, used only when 4 * n_p > SMEM_MAX_BYTES (the
// wrapper mirrors that limit);
// sorted (n,) f32, flags (n,) int32, stats (8,) f32.
int iqr_fences(const float* scores, const uint8_t* occ, int n, int n_p,
               float k, float* keys, float* sorted, int* flags, float* stats,
               void* stream) {
  return launch<float>(scores, occ, n, n_p, k, keys, sorted, flags, stats,
                       stream);
}

// The same over float64 scores, keys, sorted table and stats.
int iqr_fences_f64(const double* scores, const uint8_t* occ, int n, int n_p,
                   double k, double* keys, double* sorted, int* flags,
                   double* stats, void* stream) {
  return launch<double>(scores, occ, n, n_p, k, keys, sorted, flags, stats,
                        stream);
}

}  // extern "C"
