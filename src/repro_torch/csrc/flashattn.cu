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
// q and k are read in the model's layout (B, S, heads, hd), v as (B, S, Hkv,
// hdv) with hdv <= hd (MLA's split head dims: deepseek-v2 attends with
// qk 192 = 128 nope + 64 rope and v 128), all through their strides; query
// head h reads KV head h / (H / Hkv). Key j is visible to
// query i iff j < S, i >= j when causal, and i - j < window when window > 0.
// A row that sees no key gives 0: the sum of its weights is divided by
// max(l, 1e-20). The output is written once, normalised, in q's type, to a
// contiguous (B, S, H, hdv) tensor; padded query rows write nothing.
//
// Two kernels, chosen by the inputs' type:
//
// flash_fwd_wgmma (bfloat16, the serving path). Both products run on the
// tensor cores with wgmma; K and V stream through shared memory by TMA.
// One CTA owns one (batch, query head, 128-row query tile), the CTA with the
// longest rows first, and has three roles:
//   - one producer warp, of which one thread loads the Q tile once, then the
//     visited 64-key K and V tiles, last tile first, into a ring of STAGES
//     stages with TMA (full and empty mbarriers per stage; K and V complete
//     on separate barriers, so S = Q K^T starts before V has landed). Each
//     tensor has a 4-d tensor map over (hd, heads, S, B) built on the host
//     from its own strides, so views of a fused projection need no copy, and
//     TMA's zero fill supplies the rows past S and the columns past hd. Tiles
//     land with the 128-, 64- or 32-byte swizzle that matches a row of the
//     instantiation's head dimension, and the wgmma descriptors name the
//     same swizzle;
//   - two consumer warpgroups, 64 query rows each (wgmma's M). Per KV tile:
//     S = Q K^T with wgmma m64n64k16 (both operands K-major in shared
//     memory, fp32 accumulators in registers); the online softmax in
//     registers (a row's 16 scores of a thread reduce with the 3 other
//     threads of its row by shuffles; scale * log2(e) folds into one FFMA
//     before ex2; alpha = p = 0 while a row's max is -inf); only tiles that
//     cross the causal diagonal, the window's lower edge or S are masked;
//     then O += P V with wgmma m64n{hdv}k16, P taken from the S accumulators
//     as the register A operand and V as an MN-major B operand in shared
//     memory. P goes through no shared memory;
//   - the overlap: a tile's softmax runs while the tensor cores still do
//     the previous tile's P V, and the two consumer warpgroups take turns
//     to issue their products (named barriers), so that one group's
//     products run during the other's softmax.
// Tiles of 64 keys keep S, P and O of two tiles within the 168 registers a
// thread that ptxas gives this kernel (it counts the 288 threads as three
// warpgroups, 65536 / 384); setmaxnreg moved none to the consumers' code, so
// the kernel does without it.
// P is split into two bf16 parts, hi = bf16(p) and lo = bf16(p - hi), and P V
// is issued twice (hi V + lo V): p rounded once to bf16 keeps a 2^-9
// relative error per weight, which breaks the one-rounding-step tolerance on
// rows whose output is a small difference of large values
// (tests/test_torch_flash_tiles.py shows both). The row sums l take the
// unsplit fp32 p.
// Each instantiation has its own (HD, HDV): Q and K tiles of HD columns,
// V and O of HDV, each with its own row width, swizzle and byte count (the
// K and V barriers expect their own). Instantiated for (16, 16), (32, 32),
// (64, 64), (128, 128) and (192, 128); a call runs in the smallest with
// HD >= hd and HDV >= hdv, with TMA's zero fill in the columns past hd and
// hdv. At (192, 128) S = Q K^T takes 12 k-steps over three 128-byte column
// chunks where hd 128 takes 8 over two; Q stays in shared memory, so the
// wider QK costs steps, not registers, and the consumers keep the hd-128
// accumulators (O: 64 floats a thread). Shared memory: Q 48 KiB and three
// stages of 24 KiB K + 16 KiB V, 169 KiB.
//
// flash_fwd_f32 (float32, the reference-precision path): one block per
// (batch, query head, 64-row query tile), scalar fp32 FMAs on the CUDA
// cores, Q, K and V staged in shared memory by plain loads. Its tolerance
// (rtol = atol = 2e-4) rules out TF32's 10-bit mantissa, and no model runs
// attention in float32 on the card.
//
// Bound on the card: at hymba-1.5b's prefill (B = 8, S = 2,176, H = 25,
// Hkv = 5, hd = 64, bf16) one call moves 133.7 MB (q, k, v read once, o
// written once: 0.040 ms at 3.35 TB/s) and does 256 FLOP per visible
// (query, key) pair: 1.21e11 FLOP for a global layer, 8.73e10 for a
// window-1024 layer, 0.123 / 0.088 ms on the bf16 tensor cores, so the
// function is bound by operations. The bf16 kernel does 1.5 times that on
// the tensor cores (the second P V product) and one exp2 per visited pair on
// the multi-function units, whose rate (16 a clock per SM) matches the
// tensor cores' at hd 64.
// At deepseek-v2's MLA prefill (B = 4, S = 2,048, H = Hkv = 128, hd 192,
// hdv 128, bf16, causal) a call moves 1.342 GB (0.401 ms) and does 2 (hd +
// hdv) = 640 FLOP per visible pair, 6.875e11 FLOP (0.695 ms): bound by
// operations.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <utility>

namespace {

// --- flash_fwd_f32: float32 on the CUDA cores ------------------------------

namespace f32 {

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

// rows [row0, row0 + 64) of one head (base points at its element (0, 0))
// into dst, row stride ld floats, in 8-element chunks; rows at or past s and
// columns at or past hd are zero.
template <int HD>
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* base,
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

// Q and K tiles of HD columns (row stride HD + 4), V of HDV, P of BK
template <int HD, int HDV>
constexpr long smem_floats() {
  return 2L * BQ * (HD + 4) + (long)BK * HDV + (long)BQ * LDP;
}

template <int HD, int HDV>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o, int s,
                  int n_heads, int group, int hd, int hdv, long qsb, long qss,
                  long qsh, long ksb, long kss, long ksh, long vsb, long vss,
                  long vsh, float scale, int causal, int window) {
  constexpr int LDQ = HD + 4;       // row stride of the Q and K tiles
  constexpr int CW = HDV / 16;      // accumulator columns per thread
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + BQ * LDQ;
  float* vs = ks + BK * LDQ;
  float* ps = vs + BK * HDV;

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int qt = gridDim.x - 1 - blockIdx.x;   // the longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / group;
  const int q0 = qt * BQ;

  load_tile<HD>(qs, LDQ, q + b * qsb + h * qsh, qss, q0, s, hd, tid);
  const float* kb = k + b * ksb + hk * ksh;
  const float* vb = v + b * vsb + hk * vsh;

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
    load_tile<HD>(ks, LDQ, kb, kss, k0, s, hd, tid);
    load_tile<HDV>(vs, HDV, vb, vss, k0, s, hdv, tid);
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
        for (int j = 0; j < CW; ++j) vv[j] = vs[(kk + e) * HDV + tx + 16 * j];
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
    float* orow = o + (((long)b * s + row) * n_heads + h) * hdv;
#pragma unroll
    for (int j = 0; j < CW; ++j) {
      const int d = tx + 16 * j;
      if (d < hdv) orow[d] = acc[i][j] / den;
    }
  }
}

template <int HD, int HDV>
int launch(const float* q, const float* k, const float* v, float* o, int b,
           int s, int h, int hkv, int hd, int hdv, const long* st,
           float scale, int causal, int window, cudaStream_t stream) {
  const int smem = (int)(smem_floats<HD, HDV>() * sizeof(float));
  static_assert(smem_floats<HD, HDV>() * sizeof(float) <= 227 * 1024,
                "shared memory");
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_f32<HD, HDV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((s + BQ - 1) / BQ, h, b);
  flash_fwd_f32<HD, HDV><<<grid, THREADS, smem, stream>>>(
      q, k, v, o, s, h, h / hkv, hd, hdv, st[0], st[1], st[2], st[3], st[4],
      st[5], st[6], st[7], st[8], scale, causal, window);
  return (int)cudaGetLastError();
}

}  // namespace f32

// --- flash_fwd_wgmma: bfloat16 on the tensor cores -------------------------

namespace tc {

constexpr int BQ = 128;                 // query rows per CTA
constexpr int BK = 64;                  // keys per tile
constexpr int WG_ROWS = 64;             // query rows per consumer warpgroup
constexpr int CONSUMERS = 2 * 128;      // two consumer warpgroups
constexpr int THREADS = CONSUMERS + 32; // and one producer warp
constexpr float LOG2E = 1.4426950408889634f;

// The shared-memory layout of a tile of rows x W bf16 columns: NCH column
// chunks of ROWB bytes a row (the swizzle's width: 128 bytes, or the whole
// row when it is shorter), each chunk rows x ROWB bytes, as TMA writes one
// box.
template <int W>
struct Cols {
  static constexpr int ROWB = W * 2 < 128 ? W * 2 : 128;
  static constexpr int CHUNK = ROWB / 2;          // columns per chunk
  static constexpr int NCH = W / CHUNK;
  // wgmma descriptor layout type: 1 = 128-byte, 2 = 64-byte, 3 = 32-byte
  static constexpr uint64_t LAYOUT = ROWB == 128 ? 1 : ROWB == 64 ? 2 : 3;
  static constexpr CUtensorMapSwizzle SWIZZLE =
      ROWB == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
      : ROWB == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                   : CU_TENSOR_MAP_SWIZZLE_32B;
  static_assert(W == 16 || W == 32 || W == 64 || W % 64 == 0, "width");
};

// Shared-memory geometry of one instantiation: Q and K tiles of HD
// columns, V tiles (and the O accumulators) of HDV.
template <int HD, int HDV>
struct Geo {
  using QK = Cols<HD>;
  using V = Cols<HDV>;
  static constexpr int STAGES = HD >= 128 ? 3 : 4;
  static constexpr uint32_t Q_BYTES = BQ * HD * 2;
  static constexpr uint32_t K_BYTES = BK * HD * 2;    // one K tile
  static constexpr uint32_t V_BYTES = BK * HDV * 2;   // one V tile
  static constexpr uint32_t STAGE_BYTES = K_BYTES + V_BYTES;
  // + 1024: the dynamic base is aligned up to the 1024-byte swizzle atom
  static constexpr int SMEM = 1024 + Q_BYTES + STAGES * STAGE_BYTES;
  static_assert(HDV <= HD && HDV <= 128, "wgmma_pv takes n <= 128");
  static_assert(K_BYTES % 1024 == 0 && V_BYTES % 1024 == 0,
                "each tile starts on a swizzle atom");
  static_assert(SMEM <= 227 * 1024, "shared memory");
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
// byte offsets (16-byte units) and the swizzle layout type of a tile laid
// out as C (a Cols).
template <class C>
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (C::LAYOUT << 62);
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

// Tie accumulator registers to this point, so that no read of them moves
// above the preceding wgmma wait.
template <int N>
__device__ __forceinline__ void hold(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D (64 x 64, f32) {=, +=} A (64 x 16, K-major in shared memory) *
// B (16 x 64, K-major in shared memory); A and B are descriptors.
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// The same product with both descriptors built inside its PTX from the
// 32-bit shared addresses a + AOFF and b + BOFF (the low word ((addr &
// 0x3FFFF) >> 4) | LO, the high word HI, as desc builds them), so that no
// descriptor is a value the compiler can hoist: the HD > 128 path of
// S = Q K^T (issue_s says why).
template <uint32_t AOFF, uint32_t BOFF, uint32_t LO, uint32_t HI>
__device__ __forceinline__ void wgmma_ss_n64_at(float* d, uint32_t a,
                                                uint32_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b32 la, lb, hi;\n.reg .b64 da, db;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "add.u32 la, %32, %35;\nand.b32 la, la, 262143;\n"
      "shr.u32 la, la, 4;\nor.b32 la, la, %37;\n"
      "add.u32 lb, %33, %36;\nand.b32 lb, lb, 262143;\n"
      "shr.u32 lb, lb, 4;\nor.b32 lb, lb, %37;\n"
      "mov.b32 hi, %38;\n"
      "mov.b64 da, {la, hi};\nmov.b64 db, {lb, hi};\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "da, db, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a), "r"(b), "r"(accumulate), "n"(AOFF), "n"(BOFF), "n"(LO),
        "n"(HI));
}

// Step KS of S = Q K^T by wgmma_ss_n64_at, its offsets constants.
template <class QK, int KS>
__device__ __forceinline__ void s_step_at(float* sacc, uint32_t aq,
                                          uint32_t ak) {
  constexpr int c = KS * 16 / QK::CHUNK, col = KS * 16 % QK::CHUNK;
  constexpr uint32_t LO = (16 >> 4) << 16;
  constexpr uint32_t HI = ((8 * QK::ROWB) >> 4) |
                          static_cast<uint32_t>(QK::LAYOUT << 30);
  wgmma_ss_n64_at<c * BQ * QK::ROWB + col * 2, c * BK * QK::ROWB + col * 2,
                  LO, HI>(sacc, aq, ak, KS > 0);
}

template <class QK, int... KS>
__device__ __forceinline__ void s_steps_at(float* sacc, uint32_t aq,
                                           uint32_t ak,
                                           std::integer_sequence<int, KS...>) {
  (s_step_at<QK, KS>(sacc, aq, ak), ...);
}

// D (64 x 16, f32) += A (64 x 16, bf16 pairs in registers) *
// B (16 x 16, MN-major in shared memory, a descriptor)
__device__ __forceinline__ void wgmma_rs_n16(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 32, f32) += A (64 x 16, bf16 pairs in registers) *
// B (16 x 32, MN-major in shared memory, a descriptor)
__device__ __forceinline__ void wgmma_rs_n32(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 64, f32) += A (64 x 16, bf16 pairs in registers) *
// B (16 x 64, MN-major in shared memory, a descriptor)
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
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

// D (64 x 128, f32) += A (64 x 16, bf16 pairs in registers) *
// B (16 x 128, MN-major in shared memory, a descriptor)
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Named barriers 1 and 2 order the two consumer warpgroups' turns at the
// tensor cores: a group waits on its own (bar.sync) and hands the turn to
// the other (bar.arrive); 256 threads take part in each.
__device__ __forceinline__ void turn_wait(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void turn_pass(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// A thread's two accumulator rows: running max of the raw scores, its part
// of the row sums, and the factor alpha by which the newest tile rescales O.
struct Rows {
  float m0, m1, l0, l1, a0, a1;
};

// The online softmax of one S tile in place: raw scores in, P = 2^(s sl2 -
// m sl2) out, with m the rows' new running max (sl2 = scale * log2(e) > 0,
// so the max of the raw scores is the max of the scaled ones and the scale
// folds into one FFMA a score). In the m64nN accumulator, thread (warp w,
// lane) of a consumer warpgroup holds rows row0 = 16 w + lane / 4 and
// row1 = row0 + 8 at columns 8 j + cq and 8 j + cq + 1 of every 8-column
// group j: registers 4 j, 4 j + 1 (row0) and 4 j + 2, 4 j + 3 (row1). Only
// a tile that crosses the causal diagonal, the window's lower edge or s can
// hide a key from one of the group's 64 rows [r_lo, r_lo + 64); only such a
// tile is masked.
__device__ __forceinline__ void softmax_tile(float* sc, Rows& rw, int k0,
                                             int s, int r_lo, int row0,
                                             int cq, int causal, int window,
                                             float sl2) {
  const int row1 = row0 + 8;
  if (k0 + BK > s || (causal && k0 + BK - 1 > r_lo) ||
      (window > 0 && r_lo + WG_ROWS - 1 - k0 >= window)) {
#pragma unroll
    for (int r = 0; r < BK / 2; ++r) {
      const int row = (r & 2) ? row1 : row0;
      const int col = k0 + 8 * (r / 4) + cq + (r & 1);
      const bool ok = col < s && (!causal || row >= col) &&
                      (window <= 0 || row - col < window);
      if (!ok) sc[r] = -INFINITY;
    }
  }
  float mx0 = rw.m0, mx1 = rw.m1;
#pragma unroll
  for (int r = 0; r < BK / 2; r += 4) {
    mx0 = fmaxf(mx0, fmaxf(sc[r], sc[r + 1]));
    mx1 = fmaxf(mx1, fmaxf(sc[r + 2], sc[r + 3]));
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  // a row that has seen no key keeps m = -inf: exponents against 0 then
  // give alpha = p = 0, and l and O stay 0
  const float mu0 = mx0 == -INFINITY ? 0.f : mx0 * sl2;
  const float mu1 = mx1 == -INFINITY ? 0.f : mx1 * sl2;
  rw.a0 = ex2(rw.m0 * sl2 - mu0);
  rw.a1 = ex2(rw.m1 * sl2 - mu1);
  rw.m0 = mx0;
  rw.m1 = mx1;
  float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
  for (int r = 0; r < BK / 2; r += 4) {
    sc[r] = ex2(fmaf(sc[r], sl2, -mu0));
    sc[r + 1] = ex2(fmaf(sc[r + 1], sl2, -mu0));
    sc[r + 2] = ex2(fmaf(sc[r + 2], sl2, -mu1));
    sc[r + 3] = ex2(fmaf(sc[r + 3], sl2, -mu1));
    rs0 += sc[r] + sc[r + 1];
    rs1 += sc[r + 2] + sc[r + 3];
  }
  rw.l0 = rw.l0 * rw.a0 + rs0;
  rw.l1 = rw.l1 * rw.a1 + rs1;
}

template <int HDV>
__device__ __forceinline__ void wgmma_pv(float* o, const uint32_t* a,
                                         uint64_t db) {
  if constexpr (HDV == 16) wgmma_rs_n16(o, a, db);
  else if constexpr (HDV == 32) wgmma_rs_n32(o, a, db);
  else if constexpr (HDV == 64) wgmma_rs_n64(o, a, db);
  else wgmma_rs_n128(o, a, db);
}

// (a, b) as two bf16 pairs, each packed with a in the low half (the
// A-fragment order of wgmma): hi = bf16(a, b), lo = bf16 of the remainders.
// hi + lo is within 2^-17 of the values.
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// Barriers, 8 bytes each from `bars`: 0 the Q tile; 1 + st the K tile of
// stage st (K_BYTES); 1 + ST + st its V tile (V_BYTES); 1 + 2 ST + st the
// stage's release by the 8 consumer warps. Tile i of a CTA's visit (k0 =
// (t_hi - i) * BK) uses stage i % ST in round i / ST, whose parity every
// role tracks alike.
template <int HD, int HDV>
__global__ void __launch_bounds__(THREADS, 1)
    flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    __nv_bfloat16* __restrict__ o, int s, int n_heads,
                    int group, int hdv, float scale_log2, int causal,
                    int window) {
  using G = Geo<HD, HDV>;
  using QK = typename G::QK;
  using VC = typename G::V;
  constexpr int ST = G::STAGES;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 3 * ST];
  const uint32_t sq = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t skv = sq + G::Q_BYTES;
  const uint32_t bar0 = smem_addr(bars);

  const int tid = threadIdx.x;
  const int qt = gridDim.x - 1 - blockIdx.x;   // the longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * BQ;
  const int q_last = min(q0 + BQ - 1, s - 1);
  const int hi = causal ? q_last : s - 1;
  const int lo = window > 0 ? max(q0 - window + 1, 0) : 0;
  const int t_hi = hi / BK;
  const int n_tiles = t_hi - lo / BK + 1;

  if (tid == 0) {
    mbar_init(bar0, 1);
    for (int st = 0; st < ST; ++st) {
      mbar_init(bar0 + 8 * (1 + st), 1);
      mbar_init(bar0 + 8 * (1 + ST + st), 1);
      mbar_init(bar0 + 8 * (1 + 2 * ST + st), CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // the producer warp: one thread issues every load
    if (tid == CONSUMERS) {
      const int hk = h / group;
      mbar_expect_tx(bar0, G::Q_BYTES);
      for (int c = 0; c < QK::NCH; ++c)
        tma_load(sq + c * BQ * QK::ROWB, &tq, bar0, c * QK::CHUNK, h, q0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % ST;
        const uint32_t par = (i / ST) & 1;
        mbar_wait(bar0 + 8 * (1 + 2 * ST + st), par ^ 1);   // stage free
        const int k0 = (t_hi - i) * BK;
        const uint32_t sk = skv + st * G::STAGE_BYTES, sv = sk + G::K_BYTES;
        const uint32_t fk = bar0 + 8 * (1 + st), fv = bar0 + 8 * (1 + ST + st);
        mbar_expect_tx(fk, G::K_BYTES);
        for (int c = 0; c < QK::NCH; ++c)
          tma_load(sk + c * BK * QK::ROWB, &tk, fk, c * QK::CHUNK, hk, k0, b);
        mbar_expect_tx(fv, G::V_BYTES);
        for (int c = 0; c < VC::NCH; ++c)
          tma_load(sv + c * BK * VC::ROWB, &tv, fv, c * VC::CHUNK, hk, k0, b);
      }
    }
  } else {
    // consumer warpgroup wg owns rows [r_lo, r_lo + 64); the thread's two
    // accumulator rows are row0 and row0 + 8 (softmax_tile)
    const int wg = tid / 128, w = (tid % 128) / 32, lane = tid % 32;
    const int r_lo = q0 + WG_ROWS * wg;
    const int row0 = r_lo + 16 * w + lane / 4, row1 = row0 + 8;
    const int cq = 2 * (lane % 4);
    const uint32_t sqw = sq + WG_ROWS * wg * QK::ROWB;  // this group's Q rows

    float oacc[HDV / 2];
#pragma unroll
    for (int i = 0; i < HDV / 2; ++i) oacc[i] = 0.f;
    Rows rw{-INFINITY, -INFINITY, 0.f, 0.f, 0.f, 0.f};
    float sacc[BK / 2];            // S of the newest tile, then its P in fp32
    uint32_t ph[BK / 16][4], pl[BK / 16][4];   // P of the tile in P V

    // S = Q K^T with the K tile of stage st into sacc (issued, not awaited):
    // HD / 16 steps of depth 16, each 32 bytes further along a swizzled row
    // or in the next column chunk. At HD 192 the compiler hoisted the 12
    // steps' Q descriptors out of the tile loop, and those registers, live
    // through the softmax, spilled (ptxas: 168 registers, 28 bytes of spill
    // stores); unrolling by 4 instead avoided the spill but serialised the
    // products (ptxas C7520; 3.16 ms a deepseek call against 1.86). So
    // HD > 128 builds each descriptor inside the product's PTX
    // (wgmma_ss_n64_at: 161 registers, no spill), and HD <= 128 keeps the
    // C++ descriptors, 7% faster at hd 128 (both on one NVIDIA H100 80GB
    // HBM3, 700 W)
    auto issue_s = [&](int st) {
      const uint32_t sk = skv + st * G::STAGE_BYTES;
      wg_fence();
      if constexpr (HD > 128) {
        s_steps_at<QK>(sacc, sqw, sk,
                       std::make_integer_sequence<int, HD / 16>{});
      } else {
#pragma unroll
        for (int ks = 0; ks < HD / 16; ++ks) {
          const int c = ks * 16 / QK::CHUNK, col = ks * 16 % QK::CHUNK;
          wgmma_ss_n64(sacc,
                       desc<QK>(sqw + c * BQ * QK::ROWB + col * 2, 16,
                                8 * QK::ROWB),
                       desc<QK>(sk + c * BK * QK::ROWB + col * 2, 16,
                                8 * QK::ROWB),
                       ks > 0);
        }
      }
      wg_commit();
    };
    // O = alpha O + P V with the V tile of stage st (issued, not awaited):
    // V's rows are the depth, 16 keys (two 8-row groups) a step, each step
    // once with P's hi part and once with its lo part
    auto issue_pv = [&](int st) {
      const uint32_t sv = skv + st * G::STAGE_BYTES + G::K_BYTES;
#pragma unroll
      for (int r = 0; r < HDV / 2; r += 4) {
        oacc[r] *= rw.a0;
        oacc[r + 1] *= rw.a0;
        oacc[r + 2] *= rw.a1;
        oacc[r + 3] *= rw.a1;
      }
      hold<HDV / 2>(oacc);
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks) {
        const uint64_t dv =
            desc<VC>(sv + ks * 16 * VC::ROWB, BK * VC::ROWB, 8 * VC::ROWB);
        wgmma_pv<HDV>(oacc, ph[ks], dv);
        wgmma_pv<HDV>(oacc, pl[ks], dv);
      }
      wg_commit();
    };
    // P as the A operand: keys [16 ks, 16 ks + 16) are accumulator registers
    // 8 ks .. 8 ks + 7, already in the A fragment's order
    auto split_p = [&]() {
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          split2(sacc[8 * ks + 2 * r], sacc[8 * ks + 2 * r + 1], ph[ks][r],
                 pl[ks][r]);
    };
    auto k0_of = [&](int i) { return (t_hi - i) * BK; };
    auto full_k = [&](int i) { return bar0 + 8 * (1 + i % ST); };
    auto full_v = [&](int i) { return bar0 + 8 * (1 + ST + i % ST); };
    auto parity = [&](int i) { return static_cast<uint32_t>((i / ST) & 1); };

    // S(i) and P V(i - 1) are issued together; S(i) is awaited and tile i's
    // softmax runs while P V(i - 1) is still on the tensor cores; then
    // P V(i - 1) is awaited and stage i - 1 released. The two
    // warpgroups take turns to issue (ping-pong), so that one group's
    // products run while the other's softmax does; group 1 lets group 0
    // go first and takes no turn after its last.
    const int mine = 1 + wg, theirs = 2 - wg;
    mbar_wait(bar0, 0);
    if (wg == 1) turn_pass(theirs);
    mbar_wait(full_k(0), parity(0));
    turn_wait(mine);
    issue_s(0);
    turn_pass(theirs);
    wg_wait<0>();
    hold<BK / 2>(sacc);
    softmax_tile(sacc, rw, k0_of(0), s, r_lo, row0, cq, causal, window,
                 scale_log2);
    split_p();
    for (int i = 1; i < n_tiles; ++i) {
      mbar_wait(full_k(i), parity(i));
      turn_wait(mine);
      issue_s(i % ST);
      mbar_wait(full_v(i - 1), parity(i - 1));
      issue_pv((i - 1) % ST);
      turn_pass(theirs);
      wg_wait<1>();              // S(i) has landed
      hold<BK / 2>(sacc);
      softmax_tile(sacc, rw, k0_of(i), s, r_lo, row0, cq, causal, window,
                   scale_log2);
      wg_wait<0>();              // P V(i - 1) has landed
      hold<HDV / 2>(oacc);
      if (lane == 0) mbar_arrive(bar0 + 8 * (1 + 2 * ST + (i - 1) % ST));
      split_p();
    }
    mbar_wait(full_v(n_tiles - 1), parity(n_tiles - 1));
    turn_wait(mine);
    issue_pv((n_tiles - 1) % ST);
    if (wg == 0) turn_pass(theirs);
    wg_wait<0>();
    hold<HDV / 2>(oacc);
    float l0 = rw.l0, l1 = rw.l1;

#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float d0 = fmaxf(l0, 1e-20f), d1 = fmaxf(l1, 1e-20f);
    const long base = static_cast<long>(b) * s;
    __nv_bfloat16* o0 = o + ((base + row0) * n_heads + h) * hdv;
    __nv_bfloat16* o1 = o + ((base + row1) * n_heads + h) * hdv;
#pragma unroll
    for (int j = 0; j < HDV / 8; ++j) {
      const int col = 8 * j + cq;
      if (col >= hdv) continue;   // zero-filled columns past hdv
      if (row0 < s)
        *reinterpret_cast<__nv_bfloat162*>(o0 + col) =
            __floats2bfloat162_rn(oacc[4 * j] / d0, oacc[4 * j + 1] / d0);
      if (row1 < s)
        *reinterpret_cast<__nv_bfloat162*>(o1 + col) =
            __floats2bfloat162_rn(oacc[4 * j + 2] / d1, oacc[4 * j + 3] / d1);
    }
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

// A 4-d map over (hd, heads, S, B) of a bf16 tensor whose head, position
// and batch strides are sh, ss and sb elements; a box is `chunk` columns of
// `rows` rows of one head. Reads past hd or S give zeros.
bool tensor_map(CUtensorMap* map, const void* base, int hd, int heads, int s,
                int b, long sh, long ss, long sb, int chunk, int rows,
                CUtensorMapSwizzle swizzle) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  // a dimension of size 1 never takes its stride: give a zero one a legal
  // value
  auto bytes = [](long st, int n) {
    return static_cast<cuuint64_t>(n == 1 && st == 0 ? 16 : st * 2);
  };
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {bytes(sh, heads), bytes(ss, s), bytes(sb, b)};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(chunk), 1,
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD, int HDV>
int launch(const void* q, const void* k, const void* v, void* o, int b, int s,
           int h, int hkv, int hd, int hdv, const long* st, float scale,
           int causal, int window, cudaStream_t stream) {
  using G = Geo<HD, HDV>;
  using QK = typename G::QK;
  using VC = typename G::V;
  CUtensorMap mq, mk, mv;
  if (!tensor_map(&mq, q, hd, h, s, b, st[2], st[1], st[0], QK::CHUNK, BQ,
                  QK::SWIZZLE) ||
      !tensor_map(&mk, k, hd, hkv, s, b, st[5], st[4], st[3], QK::CHUNK, BK,
                  QK::SWIZZLE) ||
      !tensor_map(&mv, v, hdv, hkv, s, b, st[8], st[7], st[6], VC::CHUNK, BK,
                  VC::SWIZZLE))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_wgmma<HD, HDV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      G::SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((s + BQ - 1) / BQ, h, b);
  flash_fwd_wgmma<HD, HDV><<<grid, THREADS, G::SMEM, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), s, h, h / hkv, hdv,
      scale * LOG2E, causal, window);
  return (int)cudaGetLastError();
}

}  // namespace tc

// The instantiations, (HD, HDV) each, smallest first: a call runs in the
// first that takes its (hd, hdv).
struct Inst {
  int hd, hdv;
};
constexpr Inst INSTANCES[] = {{16, 16}, {32, 32}, {64, 64}, {128, 128},
                              {192, 128}};

Inst pick(int hd, int hdv) {
  for (const Inst& i : INSTANCES)
    if (hd <= i.hd && hdv <= i.hdv) return i;
  return {0, 0};
}

// Arguments both kernels take: hd and hdv multiples of 8 with hdv <= hd and
// an instantiation that takes them, h a multiple of hkv, strides multiples
// of 8 elements, 16-byte aligned pointers.
bool valid_args(const void* q, const void* k, const void* v, int b, int s,
                int h, int hkv, int hd, int hdv, const long* strides) {
  if (b < 1 || s < 1 || h < 1 || hkv < 1 || h % hkv != 0 || hdv < 8 ||
      hdv > hd || hd % 8 != 0 || hdv % 8 != 0 || pick(hd, hdv).hd == 0 ||
      b > 65535 || h > 65535)
    return false;
  for (int i = 0; i < 9; ++i)
    if (strides[i] % 8 != 0) return false;
  return (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
          reinterpret_cast<uintptr_t>(v)) % 16 == 0;
}

// One launch of namespace NS's kernel (tc or f32) in the instantiation that
// takes (hd, hdv).
#define FLASH_DISPATCH(NS, ...)                                        \
  do {                                                                 \
    const Inst inst = pick(hd, hdv);                                   \
    if (inst.hd == 16) return NS::launch<16, 16>(__VA_ARGS__);         \
    if (inst.hd == 32) return NS::launch<32, 32>(__VA_ARGS__);         \
    if (inst.hd == 64) return NS::launch<64, 64>(__VA_ARGS__);         \
    if (inst.hd == 128) return NS::launch<128, 128>(__VA_ARGS__);      \
    return NS::launch<192, 128>(__VA_ARGS__);                          \
  } while (0)

}  // namespace

extern "C" {

// q (b, s, h, hd), k (b, s, hkv, hd) and v (b, s, hkv, hdv), each addressed
// through its (batch, position, head) strides in elements (strides: q's
// three, then k's, then v's; the last dimension is contiguous). o (b, s, h,
// hdv), contiguous, q's type, is written. hd and hdv are multiples of 8,
// hdv <= hd, and (hd, hdv) fits an instantiation (flash_attn_instance); h
// is a multiple of hkv, every stride a multiple of 8 and every pointer
// 16-byte aligned. Each returns a CUDA error code (cudaErrorInvalidValue
// for arguments outside those limits).

// The instantiation a call with head dims (hd, hdv) runs in, as
// HD << 16 | HDV, or 0 when none takes them.
int flash_attn_instance(int hd, int hdv) {
  const Inst i = pick(hd, hdv);
  return i.hd << 16 | i.hdv;
}

// bfloat16 on the tensor cores (flash_fwd_wgmma); scale > 0.
int flash_attn_bf16(const void* q, const void* k, const void* v, void* o,
                    int b, int s, int h, int hkv, int hd, int hdv,
                    const long* strides, float scale, int causal, int window,
                    void* stream) {
  if (!valid_args(q, k, v, b, s, h, hkv, hd, hdv, strides) || !(scale > 0.f))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(tc, q, k, v, o, b, s, h, hkv, hd, hdv, strides, scale,
                 causal, window, st);
}

// float32 on the CUDA cores (flash_fwd_f32).
int flash_attn_f32(const float* q, const float* k, const float* v, float* o,
                   int b, int s, int h, int hkv, int hd, int hdv,
                   const long* strides, float scale, int causal, int window,
                   void* stream) {
  if (!valid_args(q, k, v, b, s, h, hkv, hd, hdv, strides))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(f32, q, k, v, o, b, s, h, hkv, hd, hdv, strides, scale,
                 causal, window, st);
}

}  // extern "C"
