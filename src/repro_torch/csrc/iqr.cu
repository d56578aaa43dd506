// IQR fences over a per-bin score table on Hopper: ascending sort of the
// occupied scores, Q1/Q3 by linear interpolation (as np.percentile), Tukey
// fences with factor k, and flags score > hi & occupied.
//
// Replaces the TPU kernel src/repro/kernels/iqr/kernel.py (_iqr_kernel,
// iqr_pallas, _bitonic_sort, _pct), which ran a statically unrolled bitonic
// network over the whole table in VMEM. The table is padded to a power of
// two n_p with the key PAD (unoccupied bins take the same key and sort to
// the top) and sorted by the same bitonic network: merge step k (2, 4, ..,
// n_p) runs strides j = k/2 .. 1, and the pair (i, i | j) goes up when
// (i & k) == 0. The sorted table is part of the contract, so the whole
// table is sorted; a selection of four order statistics would not do.
//
// What bounds it on this card. The bytes (the table read once, the sorted
// table and the flags written once: 0.3 MB at the analysis path's 12,000
// float64 scores) take 0.1 us at 3.35 TB/s; what takes the time is the
// network's log2(n_p) (log2(n_p) + 1) / 2 dependent stages (105 at 16,384
// keys) and their 860,160 compare-exchanges. One CTA issuing them all
// needs about 20 us of its SM's issue slots and pays a barrier a stage.
// The design spreads the work over a thread-block cluster and takes each
// stride where it costs least:
//
//  * A tile of up to TILE = 16,384 keys is sorted by one cluster of up to
//    CLUSTER = 8 CTAs, CTA_KEYS = 2,048 keys a CTA, KEYS = 8 keys a thread
//    held in registers. In layout L0 key r of thread t of CTA c is local
//    position t * 8 + r, global index c * 2048 + t * 8 + r: index bits
//    0-2 are registers, 3-7 lanes, 8-10 warps, 11-13 CTAs.
//  * Strides 1, 2, 4 run inside the thread, strides 8 .. 128 through
//    __shfl_xor_sync, neither with a barrier.
//  * Strides 256 .. 1024 cross the CTA's warps through shared memory. A
//    merge step that has all three (k >= 2,048) transposes once into
//    layout LW, where key r of thread t is local position r * 256 + t,
//    runs the three strides in registers and transposes back: two
//    __syncthreads instead of three. A step with one or two of them
//    exchanges through shared memory, one __syncthreads a stride.
//  * Strides >= 2,048 cross CTAs: each CTA pushes its keys into its
//    partner's shared memory over distributed shared memory (remote
//    stores; remote loads would each wait for a reply), cluster.sync(),
//    and reads the partner's keys from its own (6 of the 105 stages at
//    16,384 keys).
//  * Compare-exchanges are selects: a swap written as a branch on the
//    comparison makes a warp diverge at every pair.
//  * The exchanges alternate between two buffers, CTA-local ones and
//    cluster ones apart, so a buffer is written again only after a barrier
//    that every reader of its last contents has passed. A pairwise
//    exchange puts key r of thread t at slot r * 256 + t, where the
//    partner's thread t finds it: every warp access is one contiguous run
//    (over distributed shared memory too). The transposes and the sorted
//    slice are addressed by position, XOR-swizzled (swz) so that both
//    layouts' accesses are free of bank conflicts.
//
// At 16,384 keys that is 11 __syncthreads and 9 cluster barriers (one
// joined as the kernel starts, the 6 stages, 2 in the epilogue) in place
// of 105 barriers, on 8 SMs. On one NVIDIA H100 80GB HBM3 at 700 W the
// analysis path's call (12,000 float64 scores) takes 0.0239 ms of device
// time (chip_smoke.py's times phase) against 0.1562 ms for the one-CTA
// kernel this replaced, and scripts/iqr_stage_times.py shows the stages
// running one after another: the network's chain of dependent steps, not
// the bytes, bounds it.
//
// Bookkeeping in parallel: each warp counts its occupied keys while they
// load (one warp reduction, one value a warp in shared memory). After the
// sort every CTA writes its sorted slice to shared memory; after one
// cluster barrier every warp of every CTA reads the cluster's warp counts
// and the (at most four) order statistics that pct needs over distributed
// shared memory and computes the fences itself, so no further barrier or
// broadcast is needed; then each CTA arrives on a last cluster barrier,
// writes its slice of the sorted table and of the flags, coalesced, and
// waits there before it exits, which keeps its shared memory until every
// remote read has finished. A CTA touches another's shared memory only
// after waiting on a cluster barrier that every CTA arrived at as it
// started. One launch a call, with no memset, host sync or scratch, for
// any n_p <= TILE (tables below 2,048 keys are padded to 2,048 in one
// CTA; the extra keys are PAD and sort above every position pct reads).
//
// Larger tables (n_p > TILE) are sorted in a few launches a merge level:
// one cluster launch sorts every tile (merge steps k <= TILE, the tile's
// direction set by its index's bit k = TILE), stores the keys to a global
// scratch and each CTA's occupied count beside them; each merge level k >
// TILE then runs its strides >= TILE as grid launches over the scratch,
// up to three strides a launch (a thread holds the 2, 4 or 8 keys those
// strides pair), and one cluster launch finishes the strides below TILE
// inside every tile; one grid launch sums the counts, computes the fences
// (every block for itself) and writes the sorted table and the flags. At
// 120,000 scores (n_p = 2^17) that is 8 launches.
//
// Two key types, one template. float keeps the TPU kernel's contract
// (PAD = 3.4e38, everything float32, n_occ as a float). double serves the
// analysis path, whose reference takes the quartiles with np.percentile in
// float64: PAD = +inf sorts above every finite double, the virtual index
// is (n_occ - 1) * q, the interpolation is numpy's _lerp (a + (b - a) * t,
// or b - (b - a) * (1 - t) when t >= 0.5) and the fences are q3 + k * iqr
// and q1 - k * iqr, each product and sum rounded on its own
// (__dmul_rn / __dadd_rn, no FMA contraction), so Q1, Q3 and the fences
// equal np.percentile's bit for bit. A compare-exchange swaps only a pair
// out of order, so the network permutes the keys exactly. No library sort
// anywhere.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define THREADS 256           // threads a CTA
#define WARPS (THREADS / 32)
#define KEYS 8                // keys a thread holds
#define CTA_KEYS (THREADS * KEYS)
#define CLUSTER 8             // CTAs a cluster at most
#define TILE (CTA_KEYS * CLUSTER)
#define OUT_BLOCKS 528        // grid cap of the large path's output pass

namespace {

enum Mode { SINGLE = 0, TILE_SORT = 1, FINISH = 2 };

template <typename T>
struct Key;

template <>
struct Key<float> {
  static __device__ __forceinline__ float pad() { return 3.4e38f; }
  static constexpr int SWZ = 5;   // 32 four-byte banks
};

template <>
struct Key<double> {
  static __device__ __forceinline__ double pad() { return CUDART_INF; }
  static constexpr int SWZ = 4;   // 16 eight-byte bank pairs
};

// shared-memory slot of local position p: the low three bits XOR the bits
// that the lanes of one access vary in, for L0 and LW alike
template <typename T>
__device__ __forceinline__ int swz(int p) {
  return p ^ ((p >> Key<T>::SWZ) & 7);
}

// a padding key reads as 0
template <typename T>
__device__ __forceinline__ T safe_key(T x) {
  return x >= Key<T>::pad() ? T(0) : x;
}

// float32: the TPU kernel's _pct, rounded as the plain float32 version;
// srt(i) fetches sorted position i
template <typename F>
__device__ float pct(F srt, int n_p, int count, float q) {
  float n_occ = (float)(count > 1 ? count : 1);
  float pos = __fmul_rn(q, __fsub_rn(n_occ, 1.f));
  int lo = (int)floorf(pos);
  lo = lo < 0 ? 0 : (lo > n_p - 1 ? n_p - 1 : lo);
  int hi = lo + 1 > n_p - 1 ? n_p - 1 : lo + 1;
  float frac = __fsub_rn(pos, (float)lo);
  float vlo = safe_key<float>(srt(lo));
  float vhi = safe_key<float>(srt(hi));
  if (n_occ > 1.f) return __fadd_rn(vlo, __fmul_rn(frac, __fsub_rn(vhi, vlo)));
  return vlo;
}

// float64: np.percentile(method="linear") over the n_occ smallest keys
template <typename F>
__device__ double pct(F srt, int n_p, int count, double q) {
  int n_occ = count > 1 ? count : 1;
  double pos = __dmul_rn((double)(n_occ - 1), q);
  int lo = (int)floor(pos);
  int hi = lo + 1 < n_occ ? lo + 1 : n_occ - 1;
  double t = __dsub_rn(pos, (double)lo);
  double a = safe_key<double>(srt(lo));
  double b = safe_key<double>(srt(hi));
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
template <typename T, typename F>
__device__ void fences(F srt, int n_p, int count, T k, T* stats) {
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

// one side of a pair: the side that holds the smaller key keeps the
// smaller, ties keep their own key (both sides then agree on the swap, so
// the pair is permuted exactly); selects, no branch
template <typename T>
__device__ __forceinline__ T keep(T mine, T other, bool take_min) {
  return take_min ? (mine > other ? other : mine)
                  : (other > mine ? other : mine);
}

// the pair (a at the lower index, b) in one thread: swapped only when out
// of order. Written as two keeps: a swap written as a branch on the
// comparison makes a warp diverge at every pair.
template <typename T>
__device__ __forceinline__ void ce(T& a, T& b, bool asc) {
  const T x = keep(a, b, asc);
  b = keep(b, a, !asc);
  a = x;
}

// the cluster barrier in two halves (PTX): arrive now, wait later
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

template <typename T>
struct Net {
  cg::cluster_group cluster;
  T* lbuf;      // two CTA-local exchange buffers of CTA_KEYS keys
  T* dbuf;      // two cluster exchange buffers
  int le, de;   // exchanges made through each pair so far
  int rank;     // the CTA's rank in its cluster
  int t;        // the thread
  int cta0;     // global index of the CTA's first key
  int g0;       // global index of the thread's key 0 in L0
  bool joined;  // the kernel's first cluster barrier has been waited on
};

// Every CTA arrives on the cluster barrier as it starts; before its first
// access to another CTA's shared memory it waits there, so that every CTA
// of the cluster is known to be running. The wait comes stages later and
// costs nothing by then.
template <typename T>
__device__ __forceinline__ void join(Net<T>& c) {
  if (!c.joined) {
    cluster_wait();
    c.joined = true;
  }
}

// strides 1, 2, 4: inside the thread
template <int J, typename T>
__device__ __forceinline__ void reg_stage(T (&v)[KEYS], int g0, int k) {
#pragma unroll
  for (int r = 0; r < KEYS; ++r)
    if (!(r & J)) ce(v[r], v[r | J], ((g0 | r) & k) == 0);
}

// strides 8 .. 128: lanes
template <typename T>
__device__ __forceinline__ void shfl_stage(T (&v)[KEYS], const Net<T>& c,
                                           int k, int j) {
  const bool take_min = ((c.g0 & j) == 0) == ((c.g0 & k) == 0);
#pragma unroll
  for (int r = 0; r < KEYS; ++r)
    v[r] = keep(v[r], __shfl_xor_sync(0xffffffffu, v[r], j / KEYS),
                take_min);
}

// strides 256, 512 of merge steps 512 and 1,024: one exchange each. The
// partner thread t ^ (j / KEYS) holds the other key of each pair in the
// same register, so key r of thread t goes to slot r * THREADS + t: a
// warp's access is one contiguous run.
template <typename T>
__device__ __forceinline__ void smem_stage(T (&v)[KEYS], Net<T>& c, int k,
                                           int j) {
  T* b = c.lbuf + (c.le++ & 1) * CTA_KEYS;
#pragma unroll
  for (int r = 0; r < KEYS; ++r) b[r * THREADS + c.t] = v[r];
  __syncthreads();
  const int o = c.t ^ (j / KEYS);
  const bool take_min = ((c.g0 & j) == 0) == ((c.g0 & k) == 0);
#pragma unroll
  for (int r = 0; r < KEYS; ++r)
    v[r] = keep(v[r], b[r * THREADS + o], take_min);
}

// strides 1,024, 512, 256 of a merge step k >= 2,048: L0 -> LW, three
// stages in registers, LW -> L0
template <typename T>
__device__ __forceinline__ void warp_stages(T (&v)[KEYS], Net<T>& c,
                                            int k) {
  const int p = c.t * KEYS;
  T* a = c.lbuf + (c.le++ & 1) * CTA_KEYS;
#pragma unroll
  for (int r = 0; r < KEYS; ++r) a[swz<T>(p + r)] = v[r];
  __syncthreads();
#pragma unroll
  for (int r = 0; r < KEYS; ++r) v[r] = a[swz<T>(r * THREADS + c.t)];
  const bool asc = (c.cta0 & k) == 0;
#pragma unroll
  for (int s = KEYS / 2; s > 0; s >>= 1)
#pragma unroll
    for (int r = 0; r < KEYS; ++r)
      if (!(r & s)) ce(v[r], v[r | s], asc);
  T* b = c.lbuf + (c.le++ & 1) * CTA_KEYS;
#pragma unroll
  for (int r = 0; r < KEYS; ++r) b[swz<T>(r * THREADS + c.t)] = v[r];
  __syncthreads();
#pragma unroll
  for (int r = 0; r < KEYS; ++r) v[r] = b[swz<T>(p + r)];
}

// strides >= 2,048: each CTA pushes its keys into its partner's buffer
// over distributed shared memory (remote stores do not wait for a reply,
// remote loads would), then reads the partner's keys from its own. The
// partner's thread t holds the other key of each of thread t's pairs in
// the same register: slot r * THREADS + t, one contiguous run a warp.
template <typename T>
__device__ __forceinline__ void cluster_stage(T (&v)[KEYS], Net<T>& c,
                                              int k, int j) {
  join(c);
  T* d = c.dbuf + (c.de++ & 1) * CTA_KEYS;
  const int m = j / CTA_KEYS;
  T* to = c.cluster.map_shared_rank(d, c.rank ^ m);
#pragma unroll
  for (int r = 0; r < KEYS; ++r) to[r * THREADS + c.t] = v[r];
  c.cluster.sync();
  const bool take_min = ((c.rank & m) == 0) == ((c.g0 & k) == 0);
#pragma unroll
  for (int r = 0; r < KEYS; ++r)
    v[r] = keep(v[r], d[r * THREADS + c.t], take_min);
}

// merge step k from stride j down to 1 (inlined: v stays in registers)
template <typename T>
__device__ __forceinline__ void merge(T (&v)[KEYS], Net<T>& c, int k,
                                      int j) {
  for (; j >= CTA_KEYS; j >>= 1) cluster_stage(v, c, k, j);
  if (j == CTA_KEYS / 2) {
    warp_stages(v, c, k);
    j = 16 * KEYS;
  }
  for (; j >= 32 * KEYS; j >>= 1) smem_stage(v, c, k, j);
  for (; j >= KEYS; j >>= 1) shfl_stage(v, c, k, j);
  if (j >= 4) reg_stage<4>(v, c.g0, k);
  if (j >= 2) reg_stage<2>(v, c.g0, k);
  if (j >= 1) reg_stage<1>(v, c.g0, k);
}

template <typename T>
struct Args {
  const T* scores;
  const uint8_t* occ;
  int n, n_p;
  T k;
  int size;     // SINGLE / TILE_SORT: keys the cluster sorts
  int level;    // FINISH: the merge level
  T* keys;      // n_p > TILE: the global scratch
  int* counts;  // n_p > TILE: each CTA's occupied count
  T* sorted;
  int* flags;
  T* stats;
};

template <typename T, int MODE>
__global__ void __launch_bounds__(THREADS, 1)
iqr_cluster_kernel(const Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int warp_cnt[WARPS];
  cluster_arrive_relaxed();
  Net<T> c{cg::this_cluster(), reinterpret_cast<T*>(smem),
           reinterpret_cast<T*>(smem) + 2 * CTA_KEYS, 0, 0, 0, 0, 0, 0,
           false};
  c.rank = (int)c.cluster.block_rank();
  c.t = threadIdx.x;
  c.cta0 = blockIdx.x * CTA_KEYS;
  c.g0 = c.cta0 + c.t * KEYS;
  const int lane = c.t & 31;
  T v[KEYS];
  if (MODE == FINISH) {
#pragma unroll
    for (int r = 0; r < KEYS; ++r) v[r] = a.keys[c.g0 + r];
    merge(v, c, a.level, TILE / 2);
  } else {
    // every load issued before any is used
    uint8_t o[KEYS];
#pragma unroll
    for (int r = 0; r < KEYS; ++r) {
      const int g = c.g0 + r;
      o[r] = g < a.n ? a.occ[g] : 0;
      v[r] = g < a.n ? a.scores[g] : Key<T>::pad();
    }
    int cnt = 0;
#pragma unroll
    for (int r = 0; r < KEYS; ++r) {
      v[r] = o[r] ? v[r] : Key<T>::pad();
      cnt += o[r] != 0;
    }
    cnt = __reduce_add_sync(0xffffffffu, cnt);
    if (lane == 0) warp_cnt[c.t / 32] = cnt;
    for (int k = 2; k <= a.size; k <<= 1) merge(v, c, k, k >> 1);
  }
  if (MODE != SINGLE) {
#pragma unroll
    for (int r = 0; r < KEYS; ++r) a.keys[c.g0 + r] = v[r];
    join(c);
    c.cluster.sync();   // own counts visible; no push to this CTA pending
    if (MODE == TILE_SORT && c.t == 0) {
      int cnt = 0;
      for (int w = 0; w < WARPS; ++w) cnt += warp_cnt[w];
      a.counts[blockIdx.x] = cnt;
    }
    return;
  }
  // SINGLE: the sorted slice into the next cluster buffer (its last
  // readers passed the last cluster barrier), the fences in every warp
  T* out = c.dbuf + (c.de & 1) * CTA_KEYS;
#pragma unroll
  for (int r = 0; r < KEYS; ++r) out[swz<T>(c.t * KEYS + r)] = v[r];
  // the flags' inputs, coalesced, loaded while the barrier waits
  T sc[KEYS];
  uint8_t oc[KEYS];
#pragma unroll
  for (int r = 0; r < KEYS; ++r) {
    const int g = c.cta0 + r * THREADS + c.t;
    sc[r] = g < a.n ? a.scores[g] : T(0);
    oc[r] = g < a.n ? a.occ[g] : 0;
  }
  join(c);
  c.cluster.sync();
  const int ctas = (int)c.cluster.num_blocks();
  int count = 0;
  for (int e = lane; e < ctas * WARPS; e += 32)
    count += c.cluster.map_shared_rank(&warp_cnt[0], e / WARPS)[e % WARPS];
  count = __reduce_add_sync(0xffffffffu, count);
  T st[8];
  fences<T>([&](int i) {
    return c.cluster.map_shared_rank(out, i / CTA_KEYS)[swz<T>(i % CTA_KEYS)];
  }, a.n_p, count, a.k, st);
  // this thread's remote reads are done: arrive now, and wait (so that
  // this CTA's shared memory outlives every remote read of it) only after
  // the outputs are written
  cluster_arrive();
  if (c.rank == 0 && c.t == 0)
    for (int i = 0; i < 8; ++i) a.stats[i] = st[i];
  const T hi = st[4];
#pragma unroll
  for (int r = 0; r < KEYS; ++r) {
    const int q = r * THREADS + c.t;
    const int g = c.cta0 + q;
    if (g < a.n) {
      a.sorted[g] = safe_key(out[swz<T>(q)]);
      a.flags[g] = (oc[r] != 0) & (sc[r] > hi);
    }
  }
  cluster_wait();
}

// n_p > TILE: strides 2^lb .. 2^(lb + NB - 1) of merge level `level`, a
// thread holding the 2^NB keys they pair
template <typename T, int NB>
__global__ void __launch_bounds__(THREADS)
iqr_merge_kernel(T* __restrict__ keys, int n_p, int level, int lb) {
  const int t = blockIdx.x * THREADS + threadIdx.x;
  if (t >= (n_p >> NB)) return;
  const int i0 = ((t >> lb) << (lb + NB)) | (t & ((1 << lb) - 1));
  const bool asc = (i0 & level) == 0;
  T v[1 << NB];
#pragma unroll
  for (int r = 0; r < (1 << NB); ++r) v[r] = keys[i0 + (r << lb)];
#pragma unroll
  for (int s = (1 << NB) / 2; s > 0; s >>= 1)
#pragma unroll
    for (int r = 0; r < (1 << NB); ++r)
      if (!(r & s)) ce(v[r], v[r | s], asc);
#pragma unroll
  for (int r = 0; r < (1 << NB); ++r) keys[i0 + (r << lb)] = v[r];
}

// n_p > TILE: the count, the fences (every block for itself) and the
// outputs over the sorted scratch
template <typename T>
__global__ void __launch_bounds__(THREADS)
iqr_output_kernel(const Args<T> a, int n_counts) {
  __shared__ int part[WARPS];
  int cnt = 0;
  for (int i = threadIdx.x; i < n_counts; i += THREADS) cnt += a.counts[i];
  cnt = __reduce_add_sync(0xffffffffu, cnt);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x / 32] = cnt;
  __syncthreads();
  int count = 0;
  for (int w = 0; w < WARPS; ++w) count += part[w];
  T st[8];
  const T* keys = a.keys;
  fences<T>([&](int i) { return keys[i]; }, a.n_p, count, a.k, st);
  if (blockIdx.x == 0 && threadIdx.x == 0)
    for (int i = 0; i < 8; ++i) a.stats[i] = st[i];
  const T hi = st[4];
  for (int g = blockIdx.x * THREADS + threadIdx.x; g < a.n;
       g += gridDim.x * THREADS) {
    a.sorted[g] = safe_key(keys[g]);
    a.flags[g] = (a.occ[g] != 0) & (a.scores[g] > hi);
  }
}

template <typename T, int MODE>
cudaError_t launch_cluster(int ctas, int cluster, const Args<T>& a,
                           cudaStream_t st) {
  const size_t smem = 4 * CTA_KEYS * sizeof(T);
  if (smem > 48 * 1024) {
    // raised once per device
    static bool raised[64];
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev >= 64) return cudaErrorInvalidDevice;
    if (!raised[dev]) {
      e = cudaFuncSetAttribute(iqr_cluster_kernel<T, MODE>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
      if (e != cudaSuccess) return e;
      raised[dev] = true;
    }
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, iqr_cluster_kernel<T, MODE>, a);
}

template <typename T>
void launch_merge(T* keys, int n_p, int level, int lb, int nb,
                  cudaStream_t st) {
  const int blocks = (n_p >> nb) / THREADS;
  if (nb == 3)
    iqr_merge_kernel<T, 3><<<blocks, THREADS, 0, st>>>(keys, n_p, level, lb);
  else if (nb == 2)
    iqr_merge_kernel<T, 2><<<blocks, THREADS, 0, st>>>(keys, n_p, level, lb);
  else
    iqr_merge_kernel<T, 1><<<blocks, THREADS, 0, st>>>(keys, n_p, level, lb);
}

int log2i(int x) { return 31 - __builtin_clz(x); }

template <typename T>
int launch(const T* scores, const uint8_t* occ, int n, int n_p, T k,
           void* scratch, T* sorted, int* flags, T* stats, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Args<T> a = {scores, occ, n, n_p, k, 0, 0, nullptr, nullptr,
               sorted, flags, stats};
  if (n_p <= TILE) {
    const int ctas = n_p > CTA_KEYS ? n_p / CTA_KEYS : 1;
    a.size = ctas * CTA_KEYS;
    return (int)launch_cluster<T, SINGLE>(ctas, ctas, a, st);
  }
  if (scratch == nullptr) return (int)cudaErrorInvalidValue;
  a.keys = static_cast<T*>(scratch);
  a.counts = reinterpret_cast<int*>(a.keys + n_p);
  a.size = TILE;
  const int ctas = n_p / CTA_KEYS;
  cudaError_t e = launch_cluster<T, TILE_SORT>(ctas, CLUSTER, a, st);
  if (e != cudaSuccess) return (int)e;
  for (int level = 2 * TILE; level <= n_p; level <<= 1) {
    // strides level/2 .. TILE, the highest first, three a launch
    for (int hb = log2i(level) - 1; hb >= log2i(TILE);) {
      const int nb = hb - log2i(TILE) + 1 < 3 ? hb - log2i(TILE) + 1 : 3;
      launch_merge<T>(a.keys, n_p, level, hb - nb + 1, nb, st);
      hb -= nb;
    }
    a.level = level;
    e = launch_cluster<T, FINISH>(ctas, CLUSTER, a, st);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (n + THREADS - 1) / THREADS;
  iqr_output_kernel<T><<<blocks < OUT_BLOCKS ? blocks : OUT_BLOCKS, THREADS,
                         0, st>>>(a, ctas);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of scratch a table of n_p keys of key_bytes each needs: none up
// to TILE keys (one launch), else the keys and one int32 count per CTA.
long iqr_scratch_bytes(int n_p, int key_bytes) {
  if (n_p <= TILE) return 0;
  return (long)n_p * key_bytes + (long)(n_p / CTA_KEYS) * 4;
}

// scores (n,) f32, occ (n,) u8, n_p = next power of two >= max(n, 2);
// scratch of iqr_scratch_bytes(n_p, 4) bytes (unused when that is 0);
// sorted (n,) f32, flags (n,) int32, stats (8,) f32.
int iqr_fences(const float* scores, const uint8_t* occ, int n, int n_p,
               float k, void* scratch, float* sorted, int* flags,
               float* stats, void* stream) {
  return launch<float>(scores, occ, n, n_p, k, scratch, sorted, flags, stats,
                       stream);
}

// The same over float64 scores, sorted table and stats.
int iqr_fences_f64(const double* scores, const uint8_t* occ, int n, int n_p,
                   double k, void* scratch, double* sorted, int* flags,
                   double* stats, void* stream) {
  return launch<double>(scores, occ, n, n_p, k, scratch, sorted, flags,
                        stats, stream);
}

}  // extern "C"
