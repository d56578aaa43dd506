// Mamba2 SSD chunk scan, forward, on Hopper.
//
// Replaces the TPU kernel src/repro/kernels/ssd/kernel.py (_ssd_kernel :39,
// ssd_pallas :94). That kernel ran a (B*H, n_chunks) grid whose chunk axis
// was sequential on the TPU's one core, so the (P, N) state could ride a
// VMEM scratch from one chunk to the next, and it took a head-major float32
// xbar = dt x made by its wrapper. Blocks on the card run in no order, so
// the sequential axis becomes a loop over chunks inside one block.
//
// Per chunk of q rows (cum = cumsum(dtA) inside the chunk, dtA <= 0):
//   y[i, p] = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x[j, p]
//             + exp(cum_i) (C_i . h[p, :]) + D x[i, p]
//   h'[p, n] = exp(cum_last) h[p, n]
//              + sum_j x[j, p] dt_j exp(cum_last - cum_j) B[j, n]
// Every exponent is <= 0: exp is taken only on the causal triangle.
//
// Two kernels, chosen by the wrapper (kernels/ssd/ops.py) from the inputs:
//
// ssd_wgmma (bfloat16 x, B and C, chunk 128, P <= 64 and N <= 128, both
// multiples of 16: the serving path). It reads the model's layout in place
// and writes y = SSD(dt x) + D x in bfloat16 (one rounding, where the plain
// version's .to(xs.dtype) is) and the (P, N) float32 state of every head;
// the wrapper allocates the two outputs and launches once. One CTA per
// (batch, head), 288 threads in three roles:
//   - one producer warp. One thread streams each chunk's x (128 x 64), B
//     and C (128 x N) tiles with TMA into a two-stage ring (full and empty
//     mbarriers per stage). The tensor maps are 4-d, over (P, H, S, b) and
//     (N, G, S, b), built on the host from the tensors' own strides, and
//     TMA's zero fill supplies the rows past S and the columns past P or N.
//     The warp's 32 lanes read the chunk's dt (0 past S: the identity
//     step), form dtA = dt (-exp(A_log)), its inclusive cumsum (4 rows a
//     lane, then a warp scan) and coef_j = dt_j exp(cum_last - cum_j) into
//     the stage, and arrive on its full barrier;
//   - two consumer warpgroups; group g owns chunk rows [64 g, 64 g + 64).
//     Each product takes one operand that is exact in bfloat16 and folds
//     every float32 factor into the other, which is split into a bf16 hi
//     part and a bf16 lo part, hi = bf16(v) and lo = bf16(v - hi), issued
//     as two wgmma into one float32 accumulator:
//       scores S = C B^T       both exact (m64 n64|n128 k16: group 0 sees
//                              only keys j < 64, so it skips half);
//       inter  Y = C h^T       C exact; h, the state after the previous
//                              chunk, split; then Y *= exp(cum_i) in
//                              registers;
//       intra  Y += M x        x exact (MN-major B operand);
//                              M = S exp(cum_i - cum_j) dt_j on the causal
//                              triangle (ex2 of the producer's
//                              cum log2(e)), split, from the S accumulator
//                              as the register A operand (no shared
//                              memory);
//       state  h = exp(last) h + x^T W
//                              x exact (MN-major A operand); W = coef_j
//                              B[j, :], split, written over the chunk's
//                              B (hi) and C (lo) tiles, which no product
//                              reads any more.
//     A single bf16 rounding of any of the three split operands breaks
//     the tolerance (rtol = atol = 1e-4 on the state, one bf16 rounding
//     step on y; tests/test_torch_ssd_tiles.py shows each), so each keeps
//     its lo part. The state tile (64 x N float32) is the state product's
//     accumulator and stays in registers for the whole sequence, in group
//     0, whose scores and M take half of group 1's registers (split
//     between the groups at N = 128, group 1 spilled at the 168 registers
//     a thread ptxas gives three warpgroups). Its bf16 hi/lo copy goes to
//     shared memory once a chunk, as the B operand of the next chunk's
//     inter product; the copy starts at zero, so every chunk issues the
//     same products (a branch among them made ptxas serialise them). The
//     W pass waits for M x to land, so that M's fragments are free (at
//     N = 128 they spilled). y (+ D x, x read from the chunk's swizzled
//     tile) is written from the accumulator as bf16 pairs; rows past S
//     write nothing.
//   Shared memory: two stages of x, B and C (2 x 80 KB at N = 128) and the
//   state's hi/lo copy (32 KB): one CTA per SM, so the 256 (mamba2) and 400
//   (hymba) CTAs run 1.94 and 3.03 waves. The chunk-parallel form (chunk
//   states in parallel, a short sequential pass, outputs in parallel) would
//   fill the card in one wave but writes and reads every chunk's P x N
//   float32 state through device memory (134 MB at mamba2's shapes, three
//   times the inputs); the sequential form keeps the state on chip and
//   overlaps the next chunk's loads with the current chunk's products.
//   The scores do not depend on the head; on the tensor cores they are a
//   quarter of a chunk's products and are computed per head.
//
// ssd_scan_kernel (everything else: float32 inputs, or bfloat16 shapes
// outside those limits): the head-major float32 xbar and dtA the wrapper
// makes, one block per (head, P-tile), the state in shared memory, scalar
// fp32 FMAs from shared memory on the CUDA cores.
//
// Bound on the card, at the serving path's shapes: mamba2 (b 8, S 2048,
// H 32, P 64, N 128) moves 34 MB of bf16 x and y, 8 MB of B and C and
// 8 MB of dt and state (50 MB, 0.015 ms at 3.35 TB/s) and does 2q^2 N +
// 2q^2 P + 4qNP = 6.3 MFLOP per (head, chunk), 43 GFLOP a call: 0.043 ms on
// the bf16 tensor cores, so it is bound by operations. This kernel issues
// about 1.5 times that on the tensor cores (the three lo products, less
// group 0's skipped half of the scores and of M x): 64 GFLOP, 0.065 ms at
// their peak, and one exp per element of M it forms, 3 q^2 / 4 a (head,
// chunk), on the multi-function units.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

// --- ssd_scan_kernel: the CUDA-core kernel ---------------------------------

namespace cc {

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

}  // namespace cc

// --- ssd_wgmma: bfloat16 on the tensor cores --------------------------------

namespace tc {

constexpr int Q = 128;                  // chunk rows
constexpr int PT = 64;                  // P tile: wgmma M of the state
constexpr int CONSUMERS = 2 * 128;      // two consumer warpgroups
constexpr int THREADS = CONSUMERS + 32; // and one producer warp
constexpr int STAGES = 2;
constexpr int BAR_ALL = 1;              // named barrier of the consumers

// Shared-memory geometry for a state width NS (16, 32, 64 or 128; a
// smaller N runs in the next one with zero-filled columns). A tile of
// rows x NS bf16 is NCH boxes of CH columns, each rows x ROWB bytes, as
// TMA writes one box with the swizzle of ROWB bytes; x is one 128-byte
// box of 64 columns.
template <int NS>
struct Geo {
  static constexpr int ROWB = NS * 2 < 128 ? NS * 2 : 128;
  static constexpr int CH = ROWB / 2;
  static constexpr int NCH = NS / CH;
  static constexpr uint32_t X_BYTES = Q * PT * 2;
  static constexpr uint32_t BC_BYTES = Q * NS * 2;     // one of B, C
  static constexpr uint32_t STAGE = X_BYTES + 2 * BC_BYTES;
  static constexpr uint32_t H_BYTES = PT * NS * 2;     // h's hi or lo part
  // + 1024: the dynamic base is aligned up to the 1024-byte swizzle atom
  static constexpr int SMEM = 1024 + STAGES * STAGE + 2 * H_BYTES;
  // wgmma descriptor layout type: 1 = 128-byte, 2 = 64-byte, 3 = 32-byte
  static constexpr uint64_t LAYOUT = ROWB == 128 ? 1 : ROWB == 64 ? 2 : 3;
  static constexpr uint32_t MASK = ROWB == 128 ? 7 : ROWB == 64 ? 3 : 1;
  static_assert(NS == 16 || NS == 32 || NS == 64 || NS == 128, "NS");
  static_assert(SMEM <= 227 * 1024, "shared memory");
};

struct Args {
  const float* dt;        // (b, s, H), contiguous
  const float* a_log;     // (H,)
  const float* d;         // (H,)
  __nv_bfloat16* y;       // (b, s, H, P), contiguous
  float* state;           // (b, H, P, N), contiguous
  int s, h, p, n, hg, nc;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed. A
// wait of 10 s means a broken pipeline: trap, so that the launch fails
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint64_t t0 = 0;
  for (uint32_t n = 0;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if ((n & 1023) == 1023) {
      uint64_t now;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
      if (t0 == 0) t0 = now;
      else if (now - t0 > 10000000000ull) __trap();
    }
  }
}

// One TMA box of a 4-d tensor map at coordinates (c0, c1, c2, c3) into
// shared memory at dst; completion is counted in bytes on barrier bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units) and the swizzle layout type.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo, uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (layout << 62);
}

// The byte offset, from a swizzle-atom-aligned base, at which TMA's
// swizzle of a box whose rows take 128, 64 or 32 bytes (MASK 7, 3, 1)
// stores logical byte o: the 16-byte unit within a row is xor-ed with row
// bits, so an element never leaves its row.
template <uint32_t MASK>
__device__ __forceinline__ uint32_t swz(uint32_t o) {
  return o ^ (((o >> 7) & MASK) << 4);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed wgmma groups of this thread are pending
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Tie registers to this point: after a wgmma wait, so that no read of an
// accumulator moves above it; before a wgmma fence, so that every write of
// an operand or accumulator lands ahead of it (else ptxas injects fences of
// its own between the products).
template <int N>
__device__ __forceinline__ void hold(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void hold(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// generic-proxy writes to shared memory, made visible to wgmma's reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(BAR_ALL), "n"(CONSUMERS)
               : "memory");
}

// D (64 x 16, f32) {=, +=} A (64 x 16) * B (16 x 16), both in shared
// memory (descriptors); TA / TB: 1 when the operand is MN-major
template <int TA, int TB>
__device__ __forceinline__ void mma_ss_n16(float* d, uint64_t da, uint64_t db,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1, %11, %12;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

// D (64 x 32, f32) {=, +=} A (64 x 16) * B (16 x 32), both in shared
// memory (descriptors); TA / TB: 1 when the operand is MN-major
template <int TA, int TB>
__device__ __forceinline__ void mma_ss_n32(float* d, uint64_t da, uint64_t db,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

// D (64 x 64, f32) {=, +=} A (64 x 16) * B (16 x 64), both in shared
// memory (descriptors); TA / TB: 1 when the operand is MN-major
template <int TA, int TB>
__device__ __forceinline__ void mma_ss_n64(float* d, uint64_t da, uint64_t db,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

// D (64 x 128, f32) {=, +=} A (64 x 16) * B (16 x 128), both in shared
// memory (descriptors); TA / TB: 1 when the operand is MN-major
template <int TA, int TB>
__device__ __forceinline__ void mma_ss_n128(float* d, uint64_t da, uint64_t db,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

template <int N, int TA, int TB>
__device__ __forceinline__ void mma_ss(float* d, uint64_t da, uint64_t db,
                                       int accumulate) {
  if constexpr (N == 16) mma_ss_n16<TA, TB>(d, da, db, accumulate);
  else if constexpr (N == 32) mma_ss_n32<TA, TB>(d, da, db, accumulate);
  else if constexpr (N == 64) mma_ss_n64<TA, TB>(d, da, db, accumulate);
  else mma_ss_n128<TA, TB>(d, da, db, accumulate);
}

// D (64 x 64, f32) += A (64 x 16, bf16 pairs in registers) *
// B (16 x 64, MN-major in shared memory, a descriptor)
__device__ __forceinline__ void mma_rs_n64(float* d, const uint32_t* a,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// (a, b) as two bf16 pairs, each packed with a in the low half (the
// A-fragment order of wgmma): hi = bf16(a, b), lo = bf16 of the remainders.
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// The stage's scalars, one per chunk row: cum (inclusive cumsum of dtA),
// cum2 = cum log2(e) (M's exponents, taken with ex2), dt (0 past S) and
// coef = dt exp(cum_last - cum).
struct Scalars {
  float cum[Q], cum2[Q], dt[Q], coef[Q];
};

// One consumer warpgroup WG of the (batch bb, head h) CTA. In an m64nN
// accumulator, thread (warp w, lane) of the group holds rows
// 16 w + lane / 4 and that + 8 at columns 8 k + cq and 8 k + cq + 1 of
// every 8-column group k: registers 4 k, 4 k + 1 and 4 k + 2, 4 k + 3.
template <int NS, int WG>
__device__ __forceinline__ void consume(const Args& a, uint32_t base,
                                        uint8_t* gbase, uint32_t bar0,
                                        const Scalars* scal, int bb, int h) {
  using G = Geo<NS>;
  constexpr int KJ = 64 * (WG + 1);   // the keys rows of this group can see
  // group 0 owns the state: its scores and M take half of group 1's
  // registers (KJ), which leaves room for the state's NS / 2
  constexpr bool OWN = WG == 0;
  constexpr uint32_t L = G::LAYOUT;
  const int t = threadIdx.x % 128, w = t / 32, lane = t % 32;
  const int row0 = 64 * WG + 16 * w + lane / 4, row1 = row0 + 8;
  const int cq = 2 * (lane % 4);
  const int prow = 16 * w + lane / 4;   // the state rows p, p + 8
  const uint32_t h_hi = base + STAGES * G::STAGE, h_lo = h_hi + G::H_BYTES;
  const float dh = __ldg(a.d + h);

  float hacc[OWN ? NS / 2 : 1];
#pragma unroll
  for (int r = 0; r < (OWN ? NS / 2 : 1); ++r) hacc[r] = 0.f;
  // the state before the first chunk is 0: its hi/lo copy too, so that
  // every chunk runs the inter product (no branch among the products)
  for (uint32_t o = 16 * threadIdx.x; o < 2 * G::H_BYTES; o += 16 * CONSUMERS)
    *reinterpret_cast<uint4*>(gbase + (h_hi - base) + o) =
        make_uint4(0, 0, 0, 0);
  fence_async_smem();

  for (int c = 0; c < a.nc; ++c) {
    const int st = c % STAGES;
    const uint32_t par = (c / STAGES) & 1;
    const uint32_t sx = base + st * G::STAGE, sb = sx + G::X_BYTES,
                   sc = sb + G::BC_BYTES;
    const Scalars& sv = scal[st];
    consumers_sync();                  // h of chunk c - 1 is written
    mbar_wait(bar0 + 8 * st, par);

    // S = C B^T and Y = C h^T (hi, then lo): C's rows of this group are
    // the A operand, K-major; NS / 16 steps of depth 16, each 32 bytes
    // further along a swizzled row or in the next column box
    float sacc[KJ / 2], yacc[PT / 2];
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < NS / 16; ++ks) {
      const uint32_t off = (ks * 16 / G::CH) * Q * G::ROWB +
                           (ks * 16 % G::CH) * 2;
      mma_ss<KJ, 0, 0>(sacc,
                       desc(sc + off + 64 * WG * G::ROWB, 16, 8 * G::ROWB, L),
                       desc(sb + off, 16, 8 * G::ROWB, L), ks > 0);
    }
#pragma unroll
    for (int part = 0; part < 2; ++part)
#pragma unroll
      for (int ks = 0; ks < NS / 16; ++ks) {
        const int cb = ks * 16 / G::CH, col = ks * 16 % G::CH;
        const uint32_t off = cb * Q * G::ROWB + col * 2;
        const uint32_t hoff = cb * PT * G::ROWB + col * 2;
        mma_ss<PT, 0, 0>(
            yacc, desc(sc + off + 64 * WG * G::ROWB, 16, 8 * G::ROWB, L),
            desc((part ? h_lo : h_hi) + hoff, 16, 8 * G::ROWB, L),
            part | ks);
      }
    wg_commit();
    wg_wait<0>();
    hold<KJ / 2>(sacc);
    hold<PT / 2>(yacc);

    // Y *= exp(cum_i); M = S 2^(cum2_i - cum2_j) dt_j on the causal
    // triangle, split: keys [16 ks, 16 ks + 16) are accumulator registers
    // 8 ks .. 8 ks + 7, already in the A fragment's order
    const float e0 = expf(sv.cum[row0]), e1 = expf(sv.cum[row1]);
    const float ci0 = sv.cum2[row0], ci1 = sv.cum2[row1];
#pragma unroll
    for (int r = 0; r < PT / 2; r += 4) {
      yacc[r] *= e0;
      yacc[r + 1] *= e0;
      yacc[r + 2] *= e1;
      yacc[r + 3] *= e1;
    }
    // the state's decay over the chunk, now: no accumulator of a wgmma may
    // change while another wgmma is in flight
    if constexpr (OWN) {
      const float el = expf(sv.cum[Q - 1]);
#pragma unroll
      for (int r = 0; r < NS / 2; ++r) hacc[r] *= el;
    }
    uint32_t mh[KJ / 16][4], ml[KJ / 16][4];
#pragma unroll
    for (int ks = 0; ks < KJ / 16; ++ks)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = (r & 1) ? row1 : row0;
        const float ci = (r & 1) ? ci1 : ci0;
        const int j = 8 * (2 * ks + r / 2) + cq;
        const float2 cj = *reinterpret_cast<const float2*>(sv.cum2 + j);
        const float2 dj = *reinterpret_cast<const float2*>(sv.dt + j);
        const float s0 = sacc[8 * ks + 2 * r], s1 = sacc[8 * ks + 2 * r + 1];
        const float m0 = j <= i ? s0 * ex2(ci - cj.x) * dj.x : 0.f;
        const float m1 = j + 1 <= i ? s1 * ex2(ci - cj.y) * dj.y : 0.f;
        split2(m0, m1, mh[ks][r], ml[ks][r]);
      }
    // Y += M x: x's rows are the depth, 16 a step (MN-major B operand)
    hold<KJ / 4>(&mh[0][0]);
    hold<KJ / 4>(&ml[0][0]);
    hold<PT / 2>(yacc);
    if constexpr (OWN) hold<NS / 2>(hacc);
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < KJ / 16; ++ks) {
      const uint64_t dx = desc(sx + ks * 16 * 128, Q * 128, 8 * 128, 1);
      mma_rs_n64(yacc, mh[ks], dx);
      mma_rs_n64(yacc, ml[ks], dx);
    }
    wg_commit();

    wg_wait<0>();                      // M x has landed: M's fragments are
    hold<PT / 2>(yacc);                // free (at N = 128 they spilled)

    // W = coef_j B[j, :], split, over B (hi) and C (lo) once both groups'
    // S and C h^T products have landed; a 16-byte unit keeps its row under
    // the swizzle, so W takes B's layout unit by unit
    consumers_sync();
    {
      uint8_t* gb = gbase + (sb - base);
      uint8_t* gc = gbase + (sc - base);
      for (uint32_t o = 16 * threadIdx.x; o < G::BC_BYTES;
           o += 16 * CONSUMERS) {
        const float cf = sv.coef[(o % (Q * G::ROWB)) / G::ROWB];
        uint4 v = *reinterpret_cast<const uint4*>(gb + o);
        uint32_t* u = reinterpret_cast<uint32_t*>(&v);
        uint4 hi4, lo4;
        uint32_t* hi = reinterpret_cast<uint32_t*>(&hi4);
        uint32_t* lo = reinterpret_cast<uint32_t*>(&lo4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(u + e));
          split2(f.x * cf, f.y * cf, hi[e], lo[e]);
        }
        *reinterpret_cast<uint4*>(gb + o) = hi4;
        *reinterpret_cast<uint4*>(gc + o) = lo4;
      }
    }
    fence_async_smem();
    consumers_sync();

    // h = exp(last) h + x^T W (hi, then lo): x^T is the MN-major A operand,
    // W the MN-major B operand, the chunk's rows the depth
    if constexpr (OWN) {
      wg_fence();
#pragma unroll
      for (int part = 0; part < 2; ++part)
#pragma unroll
        for (int ks = 0; ks < Q / 16; ++ks) {
          const uint32_t wb = (part ? sc : sb) + ks * 16 * G::ROWB;
          mma_ss<NS, 1, 1>(hacc, desc(sx + ks * 16 * 128, Q * 128, 8 * 128, 1),
                           desc(wb, Q * G::ROWB, 8 * G::ROWB, L), 1);
        }
      wg_commit();
    }

    // y = Y + D x, x read from the chunk's tile, as bf16 pairs
    {
      const uint8_t* gx = gbase + (sx - base);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = half ? row1 : row0;
        const long tt = (long)c * Q + i;
        if (tt >= a.s) continue;
        __nv_bfloat16* yrow = a.y + (((long)bb * a.s + tt) * a.h + h) * a.p;
#pragma unroll
        for (int k = 0; k < PT / 8; ++k) {
          const int p = 8 * k + cq;
          if (p >= a.p) continue;
          const float2 x = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(
                  gx + swz<7>(i * 128 + p * 2)));
          *reinterpret_cast<__nv_bfloat162*>(yrow + p) =
              __floats2bfloat162_rn(fmaf(dh, x.x, yacc[4 * k + 2 * half]),
                                    fmaf(dh, x.y, yacc[4 * k + 2 * half + 1]));
        }
      }
    }
    if constexpr (OWN) {
      wg_wait<0>();                    // the state product has landed
      hold<NS / 2>(hacc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(bar0 + 8 * (STAGES + st));   // stage free

    // the state's hi/lo copy: the next chunk's inter product reads it
    if constexpr (OWN) {
      if (c + 1 < a.nc) {
        uint8_t* ghi = gbase + (h_hi - base);
        uint8_t* glo = gbase + (h_lo - base);
#pragma unroll
        for (int k = 0; k < NS / 8; ++k)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int n = 8 * k + cq;
            const uint32_t o = (n / G::CH) * PT * G::ROWB +
                               swz<G::MASK>((prow + 8 * half) * G::ROWB +
                                            (n % G::CH) * 2);
            uint32_t hi, lo;
            split2(hacc[4 * k + 2 * half], hacc[4 * k + 2 * half + 1], hi,
                   lo);
            *reinterpret_cast<uint32_t*>(ghi + o) = hi;
            *reinterpret_cast<uint32_t*>(glo + o) = lo;
          }
        fence_async_smem();
      }
    }
  }

  if constexpr (OWN) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int p = prow + 8 * half;
      if (p >= a.p) continue;
      float* srow = a.state + (((long)bb * a.h + h) * a.p + p) * a.n;
#pragma unroll
      for (int k = 0; k < NS / 8; ++k) {
        const int n = 8 * k + cq;
        if (n < a.n) srow[n] = hacc[4 * k + 2 * half];
        if (n + 1 < a.n) srow[n + 1] = hacc[4 * k + 2 * half + 1];
      }
    }
  }
}

// Barriers, 8 bytes each from `bars`: st the full barrier of stage st (the
// TMA bytes and the producer's arrival after its scalars), STAGES + st its
// release by the 8 consumer warps. Chunk c uses stage c % STAGES in round
// c / STAGES, whose parity every role tracks alike.
template <int NS>
__global__ void __launch_bounds__(THREADS, 1)
    ssd_wgmma(const __grid_constant__ CUtensorMap tx,
              const __grid_constant__ CUtensorMap tb,
              const __grid_constant__ CUtensorMap tcm, const Args a) {
  using G = Geo<NS>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * STAGES];
  __shared__ __align__(16) Scalars scal[STAGES];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);
  const uint32_t bar0 = smem_addr(bars);
  const int tid = threadIdx.x;
  const int bb = blockIdx.x / a.h, h = blockIdx.x % a.h;

  if (tid == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(bar0 + 8 * st, 2);
      mbar_init(bar0 + 8 * (STAGES + st), CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // the producer warp
    const int lane = tid - CONSUMERS;
    const float A = -expf(__ldg(a.a_log + h));
    const int g = h / a.hg;
    for (int c = 0; c < a.nc; ++c) {
      const int st = c % STAGES;
      const uint32_t par = (c / STAGES) & 1;
      const uint32_t full = bar0 + 8 * st;
      mbar_wait(bar0 + 8 * (STAGES + st), par ^ 1);   // stage free
      const int t0 = c * Q;
      const uint32_t sx = base + st * G::STAGE, sb = sx + G::X_BYTES,
                     sc = sb + G::BC_BYTES;
      if (lane == 0) {
        mbar_expect_tx(full, G::STAGE);
        tma_load(sx, &tx, full, 0, h, t0, bb);
        for (int k = 0; k < G::NCH; ++k) {
          tma_load(sb + k * Q * G::ROWB, &tb, full, k * G::CH, g, t0, bb);
          tma_load(sc + k * Q * G::ROWB, &tcm, full, k * G::CH, g, t0, bb);
        }
      }
      // dt (0 past s: the identity step) and the inclusive cumsum of dtA:
      // 4 rows a lane, then a warp scan
      float d[4], v[4], run = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int t = t0 + lane * 4 + k;
        d[k] = t < a.s ? __ldg(a.dt + ((long)bb * a.s + t) * a.h + h) : 0.f;
        run += d[k] * A;
        v[k] = run;
      }
      float tot = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, tot, off);
        if (lane >= off) tot += u;
      }
      float cum[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) cum[k] = (tot - run) + v[k];
      const float last = __shfl_sync(0xffffffffu, cum[3], 31);
      Scalars& sv = scal[st];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = lane * 4 + k;
        sv.cum[i] = cum[k];
        sv.cum2[i] = cum[k] * LOG2E;
        sv.dt[i] = d[k];
        sv.coef[i] = d[k] * expf(last - cum[k]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(full);
    }
  } else if (tid < 128) {
    consume<NS, 0>(a, base, gbase, bar0, scal, bb, h);
  } else {
    consume<NS, 1>(a, base, gbase, bar0, scal, bb, h);
  }
}

// cuTensorMapEncodeTiled, fetched from the driver at run time (the library
// links no driver library).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A 4-d map over (cols, heads, S, b) of a bf16 tensor whose head, position
// and batch strides are sh, ss and sb elements; a box is `chunk` columns of
// Q rows of one head. Reads past cols or S give zeros.
bool tensor_map(CUtensorMap* map, const void* base, int cols, int heads,
                int s, int b, long sh, long ss, long sb, int chunk,
                CUtensorMapSwizzle swizzle) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  // a dimension of size 1 never takes its stride: give a zero one a legal
  // value
  auto bytes = [](long st, int n) {
    return static_cast<cuuint64_t>(n == 1 && st == 0 ? 16 : st * 2);
  };
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {bytes(sh, heads), bytes(ss, s), bytes(sb, b)};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(chunk), 1,
                             static_cast<cuuint32_t>(Q), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NS>
int launch(const void* x, const float* dt, const float* a_log, const void* b,
           const void* c, const float* d, void* y, float* state, int bsz,
           int s, int h, int p, int g, int n, const long* st,
           cudaStream_t stream) {
  using G = Geo<NS>;
  constexpr CUtensorMapSwizzle sw = G::ROWB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                    : G::ROWB == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                    : CU_TENSOR_MAP_SWIZZLE_32B;
  CUtensorMap mx, mb, mc;
  if (!tensor_map(&mx, x, p, h, s, bsz, st[2], st[1], st[0], PT,
                  CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tensor_map(&mb, b, n, g, s, bsz, st[5], st[4], st[3], G::CH, sw) ||
      !tensor_map(&mc, c, n, g, s, bsz, st[8], st[7], st[6], G::CH, sw))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      ssd_wgmma<NS>, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (e != cudaSuccess) return (int)e;
  const Args a{dt, a_log, d, static_cast<__nv_bfloat16*>(y), state,
               s, h, p, n, h / g, (s + Q - 1) / Q};
  ssd_wgmma<NS><<<(unsigned)(bsz * h), THREADS, G::SMEM, stream>>>(
      mx, mb, mc, a);
  return (int)cudaGetLastError();
}

}  // namespace tc

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
  const int pt = cc::p_tile(p);
  if (bh < 1 || s < 1 || p < 1 || n < 1 || n > cc::MAX_N || q < 1 ||
      q > cc::MAX_Q || hg < 1 || s % q != 0 || p % pt != 0 ||
      bh * (p / pt) > INT_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bc_bf16)
    return cc::launch<__nv_bfloat16>(xbar, dta, b, c, y, state, bh, s, p, n,
                                     q, hg, st);
  return cc::launch<float>(xbar, dta, b, c, y, state, bh, s, p, n, q, hg, st);
}

// The tensor-core kernel (ssd_wgmma) on the model's layout: x (bsz, s, h,
// p), b and c (bsz, s, g, n), all bf16, each addressed through its
// (batch, position, head|group) strides in elements (strides: x's three,
// then b's, then c's; the last dimension is contiguous); dt (bsz, s, h)
// f32 contiguous; a_log and d (h,) f32. y (bsz, s, h, p) bf16 and state
// (bsz, h, p, n) f32, both contiguous, are written. chunk 128; p and n
// multiples of 16, p <= 64, n <= 128; h a multiple of g; every stride a
// multiple of 8 and x, b, c 16-byte aligned. Returns a CUDA error code
// (cudaErrorInvalidValue for arguments outside those limits).
int ssd_scan_bf16(const void* x, const float* dt, const float* a_log,
                  const void* b, const void* c, const float* d, void* y,
                  float* state, int bsz, int s, int h, int p, int g, int n,
                  const long* strides, void* stream) {
  if (bsz < 1 || s < 1 || h < 1 || g < 1 || h % g != 0 || p < 16 ||
      p > tc::PT || p % 16 != 0 || n < 16 || n > 128 || n % 16 != 0 ||
      (long)bsz * h > INT_MAX)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 9; ++i)
    if (strides[i] % 8 != 0) return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(b) |
       reinterpret_cast<uintptr_t>(c)) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 16)
    return tc::launch<16>(x, dt, a_log, b, c, d, y, state, bsz, s, h, p, g,
                          n, strides, st);
  if (n <= 32)
    return tc::launch<32>(x, dt, a_log, b, c, d, y, state, bsz, s, h, p, g,
                          n, strides, st);
  if (n <= 64)
    return tc::launch<64>(x, dt, a_log, b, c, d, y, state, bsz, s, h, p, g,
                          n, strides, st);
  return tc::launch<128>(x, dt, a_log, b, c, d, y, state, bsz, s, h, p, g, n,
                         strides, st);
}

}  // extern "C"
