// Online-softmax attention, forward, on Hopper: causal, sliding-window and
// padding masks, grouped KV heads.
//
// Replaces the TPU kernel src/repro/kernels/flashattn/kernel.py
// (_flash_kernel / flash_attention_pallas), which is the same function as the
// reference model's chunked_attention (src/repro/models/attention.py). That
// kernel ran a static (B*H, n_q, n_kv) grid whose KV axis was sequential on
// the TPU's one core, so the running (acc, m, l) of a query tile could ride
// VMEM scratch from one KV tile to the next; fully masked tiles still ran.
// Blocks on the card run in no order, so the KV axis becomes a loop inside
// one block, and the block visits only the KV tiles that intersect
// [q_start - window + 1, q_end] (sliding window) or [0, q_end] (causal): the
// visit bound of chunked_attention, which halves the work at 2,176 positions
// and window 1024.
//
// One block owns one (batch, query head, 64-row query tile). Query head h
// reads KV head h / (H / Hkv). q, k and v are read in the model's layout
// (B, S, heads, hd) through their strides, in bf16 or fp32, and converted to
// fp32 in shared memory; the output is written once, normalised, in q's
// type, to a contiguous (B, S, H, hd) tensor. Key j is visible to query i iff
// j < S, i >= j when causal, and i - j < window when window > 0. A row that
// sees no key gives 0: the sum of its weights is divided by max(l, 1e-20).
//
// Per KV tile the block computes the 64 x 64 score tile (QK^T, scaled),
// masks it, takes each row's running maximum, rescales the row's
// accumulator, and adds P V. A thread owns 4 query rows (ty + 16 i) and 4
// key columns (tx + 16 j) of the score tile, and the same 4 rows by hd / 16
// columns of the accumulator, so the running m and l of a row live in the
// registers of the 16 threads of a half-warp and reduce with shuffles. The
// scores read Q and K rows as float4 along hd (rows padded to hd + 4 floats,
// so the 16 rows a half-warp reads spread over the banks); P goes through
// shared memory to feed P V.
//
// Bound on the card: at hymba-1.5b's prefill (B = 8, S = 2,176, H = 25,
// Hkv = 5, hd = 64, bf16) one call moves 133.7 MB (q, k, v read once, o
// written once: 0.040 ms at 3.35 TB/s) and does 256 FLOP per visible
// (query, key) pair: 1.21e11 FLOP for a global layer, 8.73e10 for a
// window-1024 layer, 0.123 / 0.088 ms on the bf16 tensor cores. This kernel
// runs scalar fp32 FMAs on the CUDA cores, whose floor is 1.81 / 1.30 ms;
// mma / wgmma tiles and TMA staging of K and V are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int BQ = 64;              // query rows per block
constexpr int BK = 64;              // keys per tile
constexpr int LDP = BK + 4;         // row stride of the P tile (floats)
static_assert(BQ == BK, "load_tile stages query and key tiles alike");
static_assert(THREADS == 16 * (BQ / 4), "a thread owns 4 rows, 4 columns");

__device__ __forceinline__ void load8(const float* p, float* f) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* f) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 t = __bfloat1622float2(h[e]);
    f[2 * e] = t.x;
    f[2 * e + 1] = t.y;
  }
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// rows [row0, row0 + 64) of one head (base points at its element (0, 0))
// into dst, row stride ld floats, in 8-element chunks; rows at or past s and
// columns at or past hd are zero.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* base,
                                          long ss, int row0, int s, int hd,
                                          int tid) {
  constexpr int CPR = HD / 8;
  for (int c = tid; c < BK * CPR; c += THREADS) {
    const int r = c / CPR, d = (c % CPR) * 8;
    float f[8];
    if (row0 + r < s && d < hd) {
      load8(base + (long)(row0 + r) * ss + d, f);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) f[e] = 0.f;
    }
    float4* out = reinterpret_cast<float4*>(dst + r * ld + d);
    out[0] = make_float4(f[0], f[1], f[2], f[3]);
    out[1] = make_float4(f[4], f[5], f[6], f[7]);
  }
}

template <int HD>
constexpr long smem_floats() {
  return 2L * BQ * (HD + 4) + (long)BK * HD + (long)BQ * LDP;
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int s,
                     int n_heads, int group, int hd, long qsb, long qss,
                     long qsh, long ksb, long kss, long ksh, long vsb,
                     long vss, long vsh, float scale, int causal,
                     int window) {
  constexpr int LDQ = HD + 4;       // row stride of the Q and K tiles
  constexpr int CW = HD / 16;       // accumulator columns per thread
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + BQ * LDQ;
  float* vs = ks + BK * LDQ;
  float* ps = vs + BK * HD;

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int qt = gridDim.x - 1 - blockIdx.x;   // the longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / group;
  const int q0 = qt * BQ;

  load_tile<T, HD>(qs, LDQ, q + b * qsb + h * qsh, qss, q0, s, hd, tid);
  const T* kb = k + b * ksb + hk * ksh;
  const T* vb = v + b * vsb + hk * vsh;

  float acc[4][CW];
  float m_run[4], l_run[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
#pragma unroll
    for (int j = 0; j < CW; ++j) acc[i][j] = 0.f;
  }

  const int q_last = min(q0 + BQ - 1, s - 1);
  const int hi = causal ? q_last : s - 1;
  const int lo = window > 0 ? max(q0 - window + 1, 0) : 0;

  for (int kt = lo / BK; kt <= hi / BK; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();              // the last tile's readers are done
    load_tile<T, HD>(ks, LDQ, kb, kss, k0, s, hd, tid);
    load_tile<T, HD>(vs, HD, vb, vss, k0, s, hd, tid);
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(qs + (ty + 16 * i) * LDQ + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        c[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * LDQ + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float t = sc[i][j];
          t = fmaf(a[i].x, c[j].x, t);
          t = fmaf(a[i].y, c[j].y, t);
          t = fmaf(a[i].z, c[j].z, t);
          t = fmaf(a[i].w, c[j].w, t);
          sc[i][j] = t;
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool ok = col < s && (!causal || row >= col) &&
                        (window <= 0 || row - col < window);
        sc[i][j] = ok ? sc[i][j] * scale : -INFINITY;
        mt = fmaxf(mt, sc[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m_run[i], mt);
      // a row that has seen no key yet keeps m = -inf, l = 0 and acc = 0
      const float alpha =
          m_run[i] == -INFINITY ? 0.f : expf(m_run[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p =
            sc[i][j] == -INFINITY ? 0.f : expf(sc[i][j] - m_new);
        ps[(ty + 16 * i) * LDP + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l_run[i] = l_run[i] * alpha + rs;
      m_run[i] = m_new;
#pragma unroll
      for (int j = 0; j < CW; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();              // the P tile is complete

#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float4 p4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p4[i] =
            *reinterpret_cast<const float4*>(ps + (ty + 16 * i) * LDP + kk);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float vv[CW];
#pragma unroll
        for (int j = 0; j < CW; ++j) vv[j] = vs[(kk + e) * HD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pe = e == 0 ? p4[i].x
                           : e == 1 ? p4[i].y
                           : e == 2 ? p4[i].z
                                    : p4[i].w;
#pragma unroll
          for (int j = 0; j < CW; ++j) acc[i][j] = fmaf(pe, vv[j], acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= s) continue;       // padded query rows write nothing
    const float den = fmaxf(l_run[i], 1e-20f);
    T* orow = o + (((long)b * s + row) * n_heads + h) * hd;
#pragma unroll
    for (int j = 0; j < CW; ++j) {
      const int d = tx + 16 * j;
      if (d < hd) store1(orow + d, acc[i][j] / den);
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int b, int s,
           int h, int hkv, int hd, const long* st, float scale, int causal,
           int window, cudaStream_t stream) {
  const int smem = (int)(smem_floats<HD>() * sizeof(float));
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((s + BQ - 1) / BQ, h, b);
  flash_fwd_kernel<T, HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), s, h, h / hkv, hd, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], scale, causal,
      window);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int b,
             int s, int h, int hkv, int hd, const long* st, float scale,
             int causal, int window, cudaStream_t stream) {
  if (hd <= 16)
    return launch<T, 16>(q, k, v, o, b, s, h, hkv, hd, st, scale, causal,
                         window, stream);
  if (hd <= 32)
    return launch<T, 32>(q, k, v, o, b, s, h, hkv, hd, st, scale, causal,
                         window, stream);
  if (hd <= 64)
    return launch<T, 64>(q, k, v, o, b, s, h, hkv, hd, st, scale, causal,
                         window, stream);
  return launch<T, 128>(q, k, v, o, b, s, h, hkv, hd, st, scale, causal,
                        window, stream);
}

}  // namespace

extern "C" {

// q (b, s, h, hd), k and v (b, s, hkv, hd), all bf16 when bf16 is 1 and f32
// when it is 0, each addressed through its (batch, position, head) strides in
// elements (st: q's three, then k's, then v's; the last dimension is
// contiguous). o (b, s, h, hd), contiguous, q's type, is written. hd is a
// multiple of 8 up to 128, h a multiple of hkv, every stride a multiple of 8
// and every pointer 16-byte aligned. Returns a CUDA error code
// (cudaErrorInvalidValue for arguments outside those limits).
int flash_attn(const void* q, const void* k, const void* v, void* o, int bf16,
               int b, int s, int h, int hkv, int hd, const long* strides,
               float scale, int causal, int window, void* stream) {
  if (b < 1 || s < 1 || h < 1 || hkv < 1 || h % hkv != 0 || hd < 8 ||
      hd > 128 || hd % 8 != 0 || b > 65535 || h > 65535)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 9; ++i)
    if (strides[i] % 8 != 0) return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return dispatch<__nv_bfloat16>(q, k, v, o, b, s, h, hkv, hd, strides,
                                   scale, causal, window, st);
  return dispatch<float>(q, k, v, o, b, s, h, hkv, hd, strides, scale, causal,
                         window, st);
}

}  // extern "C"
