// Mamba2 SSD chunk scan, forward, on Hopper.
//
// Replaces the TPU kernel src/repro/kernels/ssd/kernel.py (_ssd_kernel /
// ssd_pallas). That kernel ran a (B*H, n_chunks) grid whose chunk axis was
// sequential on the TPU's one core, so the (P, N) state could ride a VMEM
// scratch from one chunk to the next. Blocks on the card run in no order, so
// the sequential axis becomes a loop over chunks inside one block, and the
// state lives in that block's shared memory for the whole sequence.
//
// Per chunk of q rows (cum = cumsum(dtA) inside the chunk, dtA <= 0):
//   y[i, p] = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) xbar[j, p]
//             + exp(cum_i) (C_i . h[p, :])
//   h'[p, n] = exp(cum_last) h[p, n]
//              + sum_j xbar[j, p] B[j, n] exp(cum_last - cum_j)
// Every exponent is <= 0: exp is taken only on the causal triangle.
//
// Columns p of y and of the state depend only on xbar[:, p], so a block owns
// one (head, P-tile) pair: head bh reads group bh / hg of B and C. The
// chunk's B and C (fp32, rows padded to n + 1 floats so that the 32 lanes of
// a warp reading 32 rows at one column hit 32 banks), the state tile, the
// chunk's xbar tile, one 32-row tile of the masked score matrix and cum live
// in dynamic shared memory: 215 KB at q = 128, N = 128, P = 64, which needs
// the MaxDynamicSharedMemorySize attribute and leaves one block per SM.
//
// The three products of a chunk (the masked scores C B^T, y, and the state
// update) are register-tiled: a warp's lanes own neighbouring columns, its
// warps own rows, and each thread keeps a small tile of sums (2 x 4, 2 x 2,
// 4 x 4), so one shared-memory load feeds several FMAs. Score columns wholly
// above the diagonal of a row tile are skipped.
//
// Bound on the card: at the serving path's shapes (B*H = 256, S = 2048,
// q = 128, P = 64, N = 128) one call does about 43 GFLOP (2q^2 N + 2q^2 P +
// 4qNP per head and chunk) and its wrapper moves about 153 MB (bf16 x, B, C
// and y, fp32 dt and state); the kernel itself reads xbar and dtA in fp32
// and writes y in fp32, about 287 MB. That is 0.046 ms (or 0.086 ms) of
// memory traffic against 0.043 ms on the bf16 tensor cores or 0.64 ms on the
// fp32 CUDA cores. This kernel runs scalar fp32 FMAs from shared memory on
// the CUDA cores, so it sits well above either bound. wgmma tiles, TMA loads
// and one C B^T shared by the heads of a group are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int ROW_TILE = 32;          // rows of the masked scores per pass
constexpr int MAX_Q = 128;            // chunk: a lane's 4 score columns
constexpr int MAX_N = 128;            // d_state: a lane's 4 state columns
constexpr int P_TILE = 64;            // widest P-tile a block owns
constexpr int GR = ROW_TILE / WARPS;  // score / y rows per thread
constexpr int GC = MAX_Q / 32;        // score columns per thread
constexpr int YC = P_TILE / 32;       // y columns per thread
constexpr int SR = P_TILE / WARPS;    // state rows per thread
constexpr int SC = MAX_N / 32;        // state columns per thread

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

int p_tile(int p) { return p < P_TILE ? p : P_TILE; }

long smem_bytes(int q, int n, int pt) {
  const long ld = n + 1;
  return (long)sizeof(float) *
         (2L * q * ld + (long)pt * ld + (long)q * pt + (long)ROW_TILE * q +
          2L * q);
}

// xbar (BH, S, P) f32; dta (BH, S) f32; bmat, cmat (BG, S, N);
// y (BH, S, P) f32; state (BH, P, N) f32. S is a multiple of q; q <= MAX_Q,
// n <= MAX_N, pt <= P_TILE.
template <typename TBC>
__global__ void __launch_bounds__(THREADS)
    ssd_scan_kernel(const float* __restrict__ xbar,
                    const float* __restrict__ dta,
                    const TBC* __restrict__ bmat, const TBC* __restrict__ cmat,
                    float* __restrict__ y, float* __restrict__ state, int s,
                    int p, int n, int q, int hg, int pt) {
  extern __shared__ float smem[];
  const int ld = n + 1;
  float* bs = smem;                // q x ld     B of the chunk
  float* cs = bs + q * ld;         // q x ld     C of the chunk
  float* hs = cs + q * ld;         // pt x ld    state tile
  float* xs = hs + pt * ld;        // q x pt     xbar tile of the chunk
  float* gs = xs + q * pt;         // ROW_TILE x q  masked scores
  float* cum = gs + ROW_TILE * q;  // q
  float* dec = cum + q;            // q          exp(cum_last - cum)

  const int n_ptiles = p / pt;
  const long bh = blockIdx.x / n_ptiles;
  const int p0 = (blockIdx.x % n_ptiles) * pt;
  const long g = bh / hg;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nc = s / q;

  for (int k = tid; k < pt * ld; k += THREADS) hs[k] = 0.f;

  for (int c = 0; c < nc; ++c) {
    const long t0 = (long)c * q;
    const TBC* bsrc = bmat + (g * s + t0) * n;
    const TBC* csrc = cmat + (g * s + t0) * n;
    for (int k = tid; k < q * n; k += THREADS) {
      const int i = k / n, m = k - i * n;
      bs[i * ld + m] = to_f32(bsrc[k]);
      cs[i * ld + m] = to_f32(csrc[k]);
    }
    const float* xsrc = xbar + (bh * s + t0) * p + p0;
    for (int k = tid; k < q * pt; k += THREADS) {
      const int i = k / pt, pp = k - i * pt;
      xs[k] = xsrc[(long)i * p + pp];
    }
    if (warp == 0) {
      // inclusive cumsum of the chunk's dtA: 4 rows a lane, then a warp scan
      const float* a = dta + bh * s + t0;
      float v[4], run = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = lane * 4 + k;
        run += i < q ? a[i] : 0.f;
        v[k] = run;
      }
      float tot = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, tot, off);
        if (lane >= off) tot += t;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = lane * 4 + k;
        if (i < q) cum[i] = (tot - run) + v[k];
      }
    }
    __syncthreads();
    const float last = cum[q - 1];
    for (int i = tid; i < q; i += THREADS) dec[i] = expf(last - cum[i]);

    float* ydst = y + (bh * s + t0) * p + p0;
    for (int i0 = 0; i0 < q; i0 += ROW_TILE) {
      const int rows = min(ROW_TILE, q - i0);
      const int jmax = i0 + rows;  // columns j < jmax can be causal
      // masked scores of rows i0 .. i0 + rows: (C_i . B_j) exp(cum_i - cum_j)
      {
        float acc[GR][GC];
#pragma unroll
        for (int a = 0; a < GR; ++a)
#pragma unroll
          for (int b = 0; b < GC; ++b) acc[a][b] = 0.f;
        for (int m = 0; m < n; ++m) {
          float cv[GR], bv[GC];
#pragma unroll
          for (int a = 0; a < GR; ++a) {
            const int r = warp + WARPS * a;
            cv[a] = r < rows ? cs[(i0 + r) * ld + m] : 0.f;
          }
#pragma unroll
          for (int b = 0; b < GC; ++b) {
            const int j = lane + 32 * b;
            bv[b] = (32 * b < jmax && j < q) ? bs[j * ld + m] : 0.f;
          }
#pragma unroll
          for (int a = 0; a < GR; ++a)
#pragma unroll
            for (int b = 0; b < GC; ++b)
              acc[a][b] = fmaf(cv[a], bv[b], acc[a][b]);
        }
#pragma unroll
        for (int a = 0; a < GR; ++a) {
          const int r = warp + WARPS * a, i = i0 + r;
#pragma unroll
          for (int b = 0; b < GC; ++b) {
            const int j = lane + 32 * b;
            if (r < rows && j < q)
              gs[r * q + j] = j <= i ? acc[a][b] * expf(cum[i] - cum[j]) : 0.f;
          }
        }
      }
      __syncthreads();
      // y rows i0 .. i0 + rows: exp(cum_i) (C_i . h) + sum_j scores x̄_j
      {
        float inter[GR][YC], intra[GR][YC];
#pragma unroll
        for (int a = 0; a < GR; ++a)
#pragma unroll
          for (int b = 0; b < YC; ++b) inter[a][b] = intra[a][b] = 0.f;
        for (int m = 0; m < n; ++m) {
          float cv[GR], hv[YC];
#pragma unroll
          for (int a = 0; a < GR; ++a) {
            const int r = warp + WARPS * a;
            cv[a] = r < rows ? cs[(i0 + r) * ld + m] : 0.f;
          }
#pragma unroll
          for (int b = 0; b < YC; ++b) {
            const int pp = lane + 32 * b;
            hv[b] = pp < pt ? hs[pp * ld + m] : 0.f;
          }
#pragma unroll
          for (int a = 0; a < GR; ++a)
#pragma unroll
            for (int b = 0; b < YC; ++b)
              inter[a][b] = fmaf(cv[a], hv[b], inter[a][b]);
        }
        for (int j = 0; j < jmax; ++j) {
          float gv[GR], xv[YC];
#pragma unroll
          for (int a = 0; a < GR; ++a) {
            const int r = warp + WARPS * a;
            gv[a] = r < rows ? gs[r * q + j] : 0.f;
          }
#pragma unroll
          for (int b = 0; b < YC; ++b) {
            const int pp = lane + 32 * b;
            xv[b] = pp < pt ? xs[j * pt + pp] : 0.f;
          }
#pragma unroll
          for (int a = 0; a < GR; ++a)
#pragma unroll
            for (int b = 0; b < YC; ++b)
              intra[a][b] = fmaf(gv[a], xv[b], intra[a][b]);
        }
#pragma unroll
        for (int a = 0; a < GR; ++a) {
          const int r = warp + WARPS * a, i = i0 + r;
          if (r >= rows) continue;
          const float e = expf(cum[i]);
#pragma unroll
          for (int b = 0; b < YC; ++b) {
            const int pp = lane + 32 * b;
            if (pp < pt)
              ydst[(long)i * p + pp] = fmaf(e, inter[a][b], intra[a][b]);
          }
        }
      }
      __syncthreads();
    }

    // state: h'[pp, m] = exp(last) h[pp, m] + sum_j x̄[j, pp] dec[j] B[j, m]
    {
      float acc[SR][SC];
#pragma unroll
      for (int a = 0; a < SR; ++a)
#pragma unroll
        for (int b = 0; b < SC; ++b) acc[a][b] = 0.f;
      for (int j = 0; j < q; ++j) {
        const float d = dec[j];
        float xv[SR], bv[SC];
#pragma unroll
        for (int a = 0; a < SR; ++a) {
          const int pp = warp + WARPS * a;
          xv[a] = pp < pt ? xs[j * pt + pp] * d : 0.f;
        }
#pragma unroll
        for (int b = 0; b < SC; ++b) {
          const int m = lane + 32 * b;
          bv[b] = m < n ? bs[j * ld + m] : 0.f;
        }
#pragma unroll
        for (int a = 0; a < SR; ++a)
#pragma unroll
          for (int b = 0; b < SC; ++b)
            acc[a][b] = fmaf(xv[a], bv[b], acc[a][b]);
      }
      const float el = expf(last);
#pragma unroll
      for (int a = 0; a < SR; ++a) {
        const int pp = warp + WARPS * a;
#pragma unroll
        for (int b = 0; b < SC; ++b) {
          const int m = lane + 32 * b;
          if (pp < pt && m < n)
            hs[pp * ld + m] = fmaf(el, hs[pp * ld + m], acc[a][b]);
        }
      }
    }
    __syncthreads();
  }

  float* sdst = state + (bh * p + p0) * n;
  for (int k = tid; k < pt * n; k += THREADS) {
    const int pp = k / n, m = k - pp * n;
    sdst[(long)pp * n + m] = hs[pp * ld + m];
  }
}

template <typename TBC>
int launch(const float* xbar, const float* dta, const void* b, const void* c,
           float* y, float* state, long bh, int s, int p, int n, int q, int hg,
           cudaStream_t st) {
  const int pt = p_tile(p);
  const long smem = smem_bytes(q, n, pt);
  cudaError_t e = cudaFuncSetAttribute(
      ssd_scan_kernel<TBC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long blocks = bh * (p / pt);
  ssd_scan_kernel<TBC><<<(unsigned)blocks, THREADS, (size_t)smem, st>>>(
      xbar, dta, static_cast<const TBC*>(b), static_cast<const TBC*>(c), y,
      state, s, p, n, q, hg, pt);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// xbar (bh, s, p) f32, dta (bh, s) f32, b and c (bh / hg, s, n) in bf16 when
// bc_bf16 is 1 and f32 when it is 0; y (bh, s, p) f32 and state (bh, p, n)
// f32 are written. s is a multiple of q; q <= 128; n <= 128; p is at most 64
// or a multiple of 64. Returns a CUDA error code (cudaErrorInvalidValue for
// arguments outside those limits).
int ssd_scan(const float* xbar, const float* dta, const void* b, const void* c,
             int bc_bf16, float* y, float* state, long bh, int s, int p, int n,
             int q, int hg, void* stream) {
  const int pt = p_tile(p);
  if (bh < 1 || s < 1 || p < 1 || n < 1 || n > MAX_N || q < 1 || q > MAX_Q ||
      hg < 1 || s % q != 0 || p % pt != 0 || bh * (p / pt) > INT_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bc_bf16)
    return launch<__nv_bfloat16>(xbar, dta, b, c, y, state, bh, s, p, n, q, hg,
                                 st);
  return launch<float>(xbar, dta, b, c, y, state, bh, s, p, n, q, hg, st);
}

}  // extern "C"
