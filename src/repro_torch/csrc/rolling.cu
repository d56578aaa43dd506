// Trailing-window rolling mean and population std of a series on Hopper:
// out[i] = (mean, std) over x[max(0, i - window + 1) .. i], with
// n_eff = min(i + 1, window) and the variance clamped at >= 0.
//
// Replaces the TPU kernel src/repro/kernels/rolling/kernel.py
// (_rolling_kernel, rolling_pallas). There each grid step saw its own block
// and the previous one through two overlapped BlockSpecs, took a local
// cumsum of both and read the window's start with a jnp.roll, so the window
// had to fit in one block (ops.py grew the block to the window). Here the
// blocks run in parallel and carry nothing between them:
//
//  * one CTA of 1024 threads owns a tile of up to 1024 outputs starting at
//    t0 and reads its own halo and tile, x[t0 - window + 1 .. t0 + tile),
//    with zeros before the series start;
//  * it scans that span in chunks of 1024 (warp shuffles, then the 32 warp
//    totals), carrying a running sum from chunk to chunk, so a window of
//    any length fits without growing shared memory: only the prefixes the
//    tile's outputs read are kept, 2 x 1024 of x and 2 x 1024 of x^2;
//  * each output is written once, as the difference of two prefixes over
//    n_eff. No atomics.
//
// The prefixes are float64. In float32, E[x^2] - mean^2 cancels: at window
// 1 the true variance is 0 and float32 prefixes over a 1024-long span leave
// a residue of about eps32 * sum(x^2), whose square root is ~1e-2 |x|. In
// float64 the residue is ~1e-16 * sum(x^2). Squares of float32 values are
// exact in float64. The result is rounded to float32 once, at the end.
//
// Bound on the card: 4 bytes read and 8 written per element, about 0.12 us
// for the micro-bench's 32,768 values at 3.35 TB/s; at these sizes the
// kernel is one launch and a few microseconds of latency. A window longer
// than the tile makes each CTA rescan its halo (N * window / 1024 reads);
// a single read of each halo is later work.

#include <cuda_runtime.h>
#include <stdint.h>

#define TILE 1024
#define THREADS 1024
#define WARPS (THREADS / 32)

namespace {

__device__ __forceinline__ void warp_scan(double& a, double& b, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    double ua = __shfl_up_sync(0xffffffffu, a, d);
    double ub = __shfl_up_sync(0xffffffffu, b, d);
    if (lane >= d) {
      a += ua;
      b += ub;
    }
  }
}

// lo_*[j] = prefix over span[0 .. j - 1], hi_*[j] = prefix over
// span[0 .. j + window - 1], so output j's window sum is hi[j] - lo[j].
__global__ void __launch_bounds__(THREADS)
rolling_kernel(const float* __restrict__ x, long long n, int window,
               float2* __restrict__ out) {
  __shared__ double lo_s[TILE], lo_ss[TILE], hi_s[TILE], hi_ss[TILE];
  __shared__ double warp_s[WARPS], warp_ss[WARPS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long t0 = (long long)blockIdx.x * TILE;
  const long long left = n - t0;
  const int tile = left < TILE ? (int)left : TILE;
  const long long s0 = t0 - window + 1;          // span start (may be < 0)
  const long long span = (long long)tile + window - 1;
  double run_s = 0.0, run_ss = 0.0;              // the same in every thread
  if (tid == 0) {
    lo_s[0] = 0.0;
    lo_ss[0] = 0.0;
  }
  for (long long base = 0; base < span; base += THREADS) {
    const long long k = base + tid;
    const long long pos = s0 + k;
    double a = (k < span && pos >= 0) ? (double)x[pos] : 0.0;
    double b = a * a;
    warp_scan(a, b, lane);
    if (lane == 31) {
      warp_s[warp] = a;
      warp_ss[warp] = b;
    }
    __syncthreads();
    if (warp == 0) {
      double wa = warp_s[lane], wb = warp_ss[lane];
      warp_scan(wa, wb, lane);
      warp_s[lane] = wa;
      warp_ss[lane] = wb;
    }
    __syncthreads();
    if (warp > 0) {
      a += warp_s[warp - 1];
      b += warp_ss[warp - 1];
    }
    a += run_s;
    b += run_ss;
    if (k < span) {
      if (k + 1 < tile) {
        lo_s[k + 1] = a;
        lo_ss[k + 1] = b;
      }
      const long long h = k - (window - 1);
      if (h >= 0 && h < tile) {
        hi_s[h] = a;
        hi_ss[h] = b;
      }
    }
    run_s += warp_s[WARPS - 1];
    run_ss += warp_ss[WARPS - 1];
    __syncthreads();                             // warp_* is reused
  }
  for (int j = tid; j < tile; j += THREADS) {
    const long long g = t0 + j;
    const double n_eff = (double)(g + 1 < window ? g + 1 : window);
    const double mean = (hi_s[j] - lo_s[j]) / n_eff;
    const double var = fmax((hi_ss[j] - lo_ss[j]) / n_eff - mean * mean, 0.0);
    out[g] = make_float2((float)mean, (float)sqrt(var));
  }
}

}  // namespace

extern "C" {

// x (n,) f32, out (n, 2) f32, both contiguous on the device; n >= 1,
// window >= 1. A window longer than the series is the series' length
// (n_eff = i + 1 either way).
int rolling_stats(const float* x, long long n, long long window, float* out,
                  void* stream) {
  if (n < 1 || window < 1) return (int)cudaErrorInvalidValue;
  const long long w = window < n ? window : n;
  const long long blocks = (n + TILE - 1) / TILE;
  if (w > 0x7fffffffLL || blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  rolling_kernel<<<(unsigned)blocks, THREADS, 0, st>>>(
      x, n, (int)w, reinterpret_cast<float2*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
