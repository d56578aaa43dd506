// PyTorch operators for the binstats, histbin, iqr and rolling kernels.
//
// A wrapper call through ctypes spent most of its host time in Python
// around one launch: argument checks, torch.empty, the stream lookup and
// the ctypes conversion (chip_smoke.py's host trace). Here each operator
// does all of that in C++ and launches through the kernels' own C entry
// points (binstats.cu, histbin.cu, iqr.cu, rolling.cu, linked into the
// same library):
//
//   torch.ops.repro_torch.rolling_stats(x, window)
//   torch.ops.repro_torch.binstats_flat(seg, values, n_seg, valid)
//   torch.ops.repro_torch.binstats_ts(rel_ts, values, valid, total_ns,
//                                     n_bins)
//   torch.ops.repro_torch.histbin_flat(seg, values, n_seg, valid)
//   torch.ops.repro_torch.histbin_ts(rel_ts, values, valid, total_ns,
//                                    n_bins)
//   torch.ops.repro_torch.iqr_fences(scores, occupied, k)
//       -> (sorted, flags, stats)
//
// Each checks its arguments (ValueError / TypeError as the plain
// versions' callers expect), allocates its outputs (and any scratch) with
// at::empty on the inputs' device, takes that device's current stream and
// launches; no synchronisation. Registered for CUDA tensors only: the
// Python wrappers send CPU tensors to the plain versions. This is the only
// source of the port that includes PyTorch's headers; it is compiled by
// the host compiler alone.

#include <ATen/core/Tensor.h>
#include <ATen/ops/empty.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <torch/library.h>

#include <cstdint>
#include <tuple>

extern "C" {
int rolling_stats(const float* x, long long n, long long window, float* out,
                  void* stream);
int binstats_flat(const int* seg, const float* values, const uint8_t* valid,
                  long n, int n_seg, int n_metrics, float* out, void* stream);
long binstats_ts_scratch(int n_bins, int n_metrics);
int binstats_ts(const float* rel_ts, const float* values,
                const uint8_t* valid, long n, int n_metrics, int n_bins,
                float inv_width, int* cnt, float* out, void* stream);
int histbin_flat(const int* seg, const float* values, const uint8_t* valid,
                 long n, int n_seg, int n_metrics, float* out, void* stream);
int histbin_ts(const float* rel_ts, const float* values, const uint8_t* valid,
               long n, int n_bins, int n_metrics, float inv_width, float* out,
               void* stream);
long iqr_scratch_bytes(int n_p, int key_bytes);
int iqr_fences(const float* scores, const uint8_t* occ, int n, int n_p,
               float k, void* scratch, float* sorted, int* flags,
               float* stats, void* stream);
int iqr_fences_f64(const double* scores, const uint8_t* occ, int n, int n_p,
                   double k, void* scratch, double* sorted, int* flags,
                   double* stats, void* stream);
}

namespace {

constexpr int64_t kStats = 5;
constexpr int64_t kBuckets = 384;   // histbin.cu's N_BUCKETS

void check_vector(const at::Tensor& t, const char* name,
                  c10::ScalarType dtype, const at::Tensor& like,
                  int64_t n, const char* like_name = "values") {
  TORCH_CHECK_TYPE(t.scalar_type() == dtype, name, ": dtype ",
                   t.scalar_type(), ", expected ", dtype);
  TORCH_CHECK_VALUE(t.device() == like.device(), name, ": on ", t.device(),
                    ", expected ", like.device());
  TORCH_CHECK_VALUE(t.dim() == 1 && t.size(0) == n, name, " ", t.sizes(),
                    " does not match ", like_name, " ", like.sizes());
  TORCH_CHECK_VALUE(t.is_contiguous(), name, ": not contiguous");
}

void check_values(const at::Tensor& values) {
  TORCH_CHECK_VALUE(values.is_cuda(), "values: on ", values.device(),
                    ", expected a CUDA device");
  TORCH_CHECK_TYPE(values.scalar_type() == at::kFloat, "values: dtype ",
                   values.scalar_type(), ", expected Float");
  TORCH_CHECK_VALUE(values.dim() == 1 || values.dim() == 2,
                    "values: ", values.dim(), "-d, expected (N,) or (M, N)");
  TORCH_CHECK_VALUE(values.is_contiguous(), "values: not contiguous");
}

void* stream_of(const at::Tensor& t) {
  return c10::cuda::getCurrentCUDAStream(t.device().index()).stream();
}

void check_launch(int code, const char* what) {
  TORCH_CHECK(code == 0, what, ": CUDA error ", code);
}

at::Tensor rolling_stats_op(const at::Tensor& x_in, int64_t window) {
  TORCH_CHECK_VALUE(x_in.is_cuda(), "x: on ", x_in.device(),
                    ", expected a CUDA device");
  TORCH_CHECK_VALUE(x_in.dim() == 1, "x must be a (N,) series, got ",
                    x_in.sizes());
  TORCH_CHECK_VALUE(x_in.size(0) >= 1,
                    "x is empty: no rolling statistics of 0 values");
  TORCH_CHECK_VALUE(window >= 1, "window must be an integer >= 1, got ",
                    window);
  const at::Tensor x = x_in.to(at::kFloat).contiguous();
  const c10::cuda::CUDAGuard guard(x.device());
  at::Tensor out = at::empty({x.size(0), 2}, x.options());
  check_launch(rolling_stats(x.data_ptr<float>(), x.size(0), window,
                             out.data_ptr<float>(), stream_of(x)),
               "rolling_stats");
  return out;
}

at::Tensor binstats_flat_op(const at::Tensor& seg, const at::Tensor& values,
                            int64_t n_seg, const at::Tensor& valid) {
  TORCH_CHECK_VALUE(n_seg >= 1, "n_seg must be >= 1, got ", n_seg);
  check_values(values);
  const int64_t n = values.size(-1);
  const int64_t m = values.dim() == 1 ? 1 : values.size(0);
  check_vector(seg, "seg", at::kInt, values, n);
  check_vector(valid, "valid", at::kBool, values, n);
  const c10::cuda::CUDAGuard guard(values.device());
  at::Tensor out = values.dim() == 1
                       ? at::empty({n_seg, kStats}, values.options())
                       : at::empty({m, n_seg, kStats}, values.options());
  check_launch(binstats_flat(seg.data_ptr<int>(), values.data_ptr<float>(),
                             reinterpret_cast<const uint8_t*>(
                                 valid.data_ptr<bool>()),
                             (long)n, (int)n_seg, (int)m,
                             out.data_ptr<float>(), stream_of(values)),
               "binstats_flat");
  return out;
}

at::Tensor binstats_ts_op(const at::Tensor& rel_ts, const at::Tensor& values,
                          const at::Tensor& valid, double total_ns,
                          int64_t n_bins) {
  TORCH_CHECK_VALUE(n_bins >= 1, "n_bins must be >= 1, got ", n_bins);
  check_values(values);
  const int64_t n = values.size(-1);
  const int64_t m = values.dim() == 1 ? 1 : values.size(0);
  check_vector(rel_ts, "rel_ts", at::kFloat, values, n);
  check_vector(valid, "valid", at::kBool, values, n);
  const c10::cuda::CUDAGuard guard(values.device());
  const long scratch = binstats_ts_scratch((int)n_bins, (int)m);
  at::Tensor cnt;
  if (scratch > 0)
    cnt = at::empty({scratch}, values.options().dtype(at::kInt));
  at::Tensor out = values.dim() == 1
                       ? at::empty({n_bins, kStats}, values.options())
                       : at::empty({m, n_bins, kStats}, values.options());
  // float32(n_bins / total_ns), as the plain version bins
  const float inv_width = (float)((double)n_bins / total_ns);
  check_launch(binstats_ts(rel_ts.data_ptr<float>(), values.data_ptr<float>(),
                           reinterpret_cast<const uint8_t*>(
                               valid.data_ptr<bool>()),
                           (long)n, (int)m, (int)n_bins, inv_width,
                           scratch > 0 ? cnt.data_ptr<int>() : nullptr,
                           out.data_ptr<float>(), stream_of(values)),
               "binstats");
  return out;
}

// (n_seg, 384) for 1-D values, (M, n_seg, 384) for 2-D ones
at::Tensor histogram_out(const at::Tensor& values, int64_t n_seg) {
  return values.dim() == 1
             ? at::empty({n_seg, kBuckets}, values.options())
             : at::empty({values.size(0), n_seg, kBuckets}, values.options());
}

at::Tensor histbin_flat_op(const at::Tensor& seg, const at::Tensor& values,
                           int64_t n_seg, const at::Tensor& valid) {
  TORCH_CHECK_VALUE(n_seg >= 1, "n_seg must be >= 1, got ", n_seg);
  check_values(values);
  const int64_t n = values.size(-1);
  const int64_t m = values.dim() == 1 ? 1 : values.size(0);
  check_vector(seg, "seg", at::kInt, values, n);
  check_vector(valid, "valid", at::kBool, values, n);
  const c10::cuda::CUDAGuard guard(values.device());
  at::Tensor out = histogram_out(values, n_seg);
  check_launch(histbin_flat(seg.data_ptr<int>(), values.data_ptr<float>(),
                            reinterpret_cast<const uint8_t*>(
                                valid.data_ptr<bool>()),
                            (long)n, (int)n_seg, (int)m,
                            out.data_ptr<float>(), stream_of(values)),
               "histbin_flat");
  return out;
}

at::Tensor histbin_ts_op(const at::Tensor& rel_ts, const at::Tensor& values,
                         const at::Tensor& valid, double total_ns,
                         int64_t n_bins) {
  TORCH_CHECK_VALUE(n_bins >= 1, "n_bins must be >= 1, got ", n_bins);
  check_values(values);
  const int64_t n = values.size(-1);
  const int64_t m = values.dim() == 1 ? 1 : values.size(0);
  check_vector(rel_ts, "rel_ts", at::kFloat, values, n);
  check_vector(valid, "valid", at::kBool, values, n);
  const c10::cuda::CUDAGuard guard(values.device());
  at::Tensor out = histogram_out(values, n_bins);
  // float32(n_bins / total_ns), as the plain version bins
  const float inv_width = (float)((double)n_bins / total_ns);
  check_launch(histbin_ts(rel_ts.data_ptr<float>(), values.data_ptr<float>(),
                          reinterpret_cast<const uint8_t*>(
                              valid.data_ptr<bool>()),
                          (long)n, (int)n_bins, (int)m, inv_width,
                          out.data_ptr<float>(), stream_of(values)),
               "histbin");
  return out;
}

// (sorted, flags, stats): iqr.cu's contract, in the scores' dtype
std::tuple<at::Tensor, at::Tensor, at::Tensor> iqr_fences_op(
    const at::Tensor& scores, const at::Tensor& occupied, double k) {
  TORCH_CHECK_VALUE(scores.is_cuda(), "scores: on ", scores.device(),
                    ", expected a CUDA device");
  const bool f64 = scores.scalar_type() == at::kDouble;
  TORCH_CHECK_TYPE(f64 || scores.scalar_type() == at::kFloat,
                   "scores: dtype ", scores.scalar_type(),
                   ", expected Float or Double");
  TORCH_CHECK_VALUE(scores.dim() == 1 && scores.size(0) >= 1,
                    "scores must be a non-empty (n,) table, got ",
                    scores.sizes());
  TORCH_CHECK_VALUE(scores.is_contiguous(), "scores: not contiguous");
  const int64_t n = scores.size(0);
  TORCH_CHECK_VALUE(n < (int64_t(1) << 30), "iqr_fences: table of ", n,
                    " entries is too large");
  check_vector(occupied, "occupied", at::kBool, scores, n, "scores");
  const c10::cuda::CUDAGuard guard(scores.device());
  int n_p = 2;
  while (n_p < n) n_p <<= 1;
  const long bytes = iqr_scratch_bytes(n_p, f64 ? 8 : 4);
  at::Tensor scratch;
  if (bytes > 0)
    scratch = at::empty({bytes}, scores.options().dtype(at::kByte));
  void* scratch_ptr = bytes > 0 ? scratch.data_ptr() : nullptr;
  at::Tensor sorted = at::empty({n}, scores.options());
  at::Tensor flags = at::empty({n}, scores.options().dtype(at::kInt));
  at::Tensor stats = at::empty({8}, scores.options());
  const uint8_t* occ =
      reinterpret_cast<const uint8_t*>(occupied.data_ptr<bool>());
  void* stream = stream_of(scores);
  const int code =
      f64 ? iqr_fences_f64(scores.data_ptr<double>(), occ, (int)n, n_p, k,
                           scratch_ptr, sorted.data_ptr<double>(),
                           flags.data_ptr<int>(), stats.data_ptr<double>(),
                           stream)
          : iqr_fences(scores.data_ptr<float>(), occ, (int)n, n_p, (float)k,
                       scratch_ptr, sorted.data_ptr<float>(),
                       flags.data_ptr<int>(), stats.data_ptr<float>(),
                       stream);
  check_launch(code, "iqr_fences");
  return {sorted, flags, stats};
}

}  // namespace

TORCH_LIBRARY(repro_torch, m) {
  m.def("rolling_stats(Tensor x, int window) -> Tensor");
  m.def("binstats_flat(Tensor seg, Tensor values, int n_seg, Tensor valid)"
        " -> Tensor");
  m.def("binstats_ts(Tensor rel_ts, Tensor values, Tensor valid, "
        "float total_ns, int n_bins) -> Tensor");
  m.def("histbin_flat(Tensor seg, Tensor values, int n_seg, Tensor valid)"
        " -> Tensor");
  m.def("histbin_ts(Tensor rel_ts, Tensor values, Tensor valid, "
        "float total_ns, int n_bins) -> Tensor");
  m.def("iqr_fences(Tensor scores, Tensor occupied, float k)"
        " -> (Tensor, Tensor, Tensor)");
}

TORCH_LIBRARY_IMPL(repro_torch, CUDA, m) {
  m.impl("rolling_stats", &rolling_stats_op);
  m.impl("binstats_flat", &binstats_flat_op);
  m.impl("binstats_ts", &binstats_ts_op);
  m.impl("histbin_flat", &histbin_flat_op);
  m.impl("histbin_ts", &histbin_ts_op);
  m.impl("iqr_fences", &iqr_fences_op);
}
