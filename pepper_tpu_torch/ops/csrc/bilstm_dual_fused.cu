// Both directions of a fused LSTM layer in one launch, for Hopper (sm_90a).
// Replaces the TPU kernel pepper_tpu/ops/lstm_kernel.py::bilstm_dual_fused
// (body _make_dual_kernel), which runs the forward and the backward
// recurrence in one kernel body so that one direction's gate math can hide
// behind the other's recurrent matmul.
//
// Design.  Blocks run in parallel on Hopper, so the two directions need no
// shared body: the grid's y index picks the direction's weights, bias,
// output and time order, and every block runs the code of
// lstm_direction_fused.cu, so each output equals one launch of that kernel.
// bfloat16: lstm_core.cuh's cluster recurrence, both directions in one
// grid; where the input projection leaves the step (the decoder), one
// projection launch computes both directions' xw (N = 8H) from one read of
// x, with the same tiles and sums as a single direction's.  float32:
// lstm::direction_body (lstm_cell.cuh) on a grid of (row blocks, 2).  The
// library also exports the decoder's two bfloat16 launches alone
// (bilstm_dual_fused_projection_launch, bilstm_dual_fused_recurrence_launch),
// so that they can be timed apart.
//
// Bound.  The sum of two lstm_direction_fused launches: 2*T*B*(F+H)*4H
// operations per direction, bound by operations at the serving shapes.
//
// Binding: a plain C launcher (no PyTorch headers) loaded with ctypes; it
// launches on the caller's stream and returns cudaGetLastError().

#include "lstm_core.cuh"

namespace {

using lstm::kMaxHidden;
using lstm::kRows;

template <typename T>
__global__ void __launch_bounds__(kMaxHidden)
    bilstm_dual_fused_kernel(const T* __restrict__ x0,
                             const T* __restrict__ x1,
                             const T* __restrict__ wf0,
                             const T* __restrict__ wf1,
                             const T* __restrict__ wb0,
                             const T* __restrict__ wb1, int F0, int F1,
                             const T* __restrict__ bias_f,
                             const T* __restrict__ bias_b,
                             const T* __restrict__ w_hh_f,
                             const T* __restrict__ w_hh_b,
                             T* __restrict__ out_f, T* __restrict__ out_b,
                             int steps, int B, int H) {
  extern __shared__ __align__(16) float smem[];
  const int backward = blockIdx.y;
  lstm::direction_body(smem, x0, x1, backward ? wb0 : wf0,
                       backward ? wb1 : wf1, F0, F1,
                       backward ? bias_b : bias_f,
                       backward ? w_hh_b : w_hh_f, backward ? out_b : out_f,
                       steps, B, H, backward,
                       static_cast<int>(blockIdx.x) * kRows);
}

struct F32Tag {};

cudaError_t launch_f32(const float* x0, const float* x1, const float* wf0,
                       const float* wf1, const float* wb0, const float* wb1,
                       int F0, int F1, const float* bias_f,
                       const float* bias_b, const float* w_hh_f,
                       const float* w_hh_b, float* out_f, float* out_b,
                       int steps, int B, int H, cudaStream_t stream) {
  auto kernel = bilstm_dual_fused_kernel<float>;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = lstm::ensure_smem_limit<F32Tag>(reinterpret_cast<const void*>(kernel),
                                        device);
  if (err != cudaSuccess) return err;
  const size_t smem = static_cast<size_t>(F0 + F1 + H) * kRows * sizeof(float);
  const dim3 grid((B + kRows - 1) / kRows, 2);
  kernel<<<grid, H, smem, stream>>>(x0, x1, wf0, wf1, wb0, wb1, F0, F1,
                                    bias_f, bias_b, w_hh_f, w_hh_b, out_f,
                                    out_b, steps, B, H);
  return cudaGetLastError();
}

constexpr int kReverse[2] = {0, 1};

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  x1/wf1/wb1 may be null with F1 == 0.
// xw_f/xw_b: float32 scratches of steps * B * 4H values each where the
// bfloat16 input projection leaves the step (F0 + F1 > 32), else null; the
// bfloat16 weights 16-byte aligned.  Returns a cudaError_t value (0 on
// success).
int bilstm_dual_fused_launch(int dtype, const void* x0, const void* x1,
                             const void* wf0, const void* wf1,
                             const void* wb0, const void* wb1, int F0,
                             int F1, const void* bias_f, const void* bias_b,
                             const void* w_hh_f, const void* w_hh_b,
                             float* xw_f, float* xw_b, void* out_f,
                             void* out_b, int steps, int B, int H,
                             void* stream) {
  if (!lstm::valid_shape(F0, F1, steps, B, H)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    using F = const float*;
    return static_cast<int>(launch_f32(
        static_cast<F>(x0), static_cast<F>(x1), static_cast<F>(wf0),
        static_cast<F>(wf1), static_cast<F>(wb0), static_cast<F>(wb1), F0,
        F1, static_cast<F>(bias_f), static_cast<F>(bias_b),
        static_cast<F>(w_hh_f), static_cast<F>(w_hh_b),
        static_cast<float*>(out_f), static_cast<float*>(out_b), steps, B, H,
        s));
  }
  if (dtype == 1) {
    const void* w0[2] = {wf0, wb0};
    const void* w1[2] = {wf1, wb1};
    const void* bias[2] = {bias_f, bias_b};
    const void* w_hh[2] = {w_hh_f, w_hh_b};
    float* xw[2] = {xw_f, xw_b};
    void* out[2] = {out_f, out_b};
    return static_cast<int>(lstm::launch_directions(
        x0, x1, F0, F1, w0, w1, bias, w_hh, xw, out, kReverse, 2, steps, B, H,
        s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The bfloat16 input projection of both directions alone (the decoder's
// first launch): xw_d = [x0 x1] @ [wd0; wd1] + bias_d in float32.
int bilstm_dual_fused_projection_launch(int dtype, const void* x0,
                                        const void* x1, const void* wf0,
                                        const void* wf1, const void* wb0,
                                        const void* wb1, int F0, int F1,
                                        const void* bias_f,
                                        const void* bias_b, float* xw_f,
                                        float* xw_b, int steps, int B, int H,
                                        void* stream) {
  if (dtype != 1 || !lstm::valid_shape(F0, F1, steps, B, H)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* w0[2] = {wf0, wb0};
  const void* w1[2] = {wf1, wb1};
  const void* bias[2] = {bias_f, bias_b};
  float* xw[2] = {xw_f, xw_b};
  return static_cast<int>(lstm::launch_projections(
      x0, x1, F0, F1, w0, w1, bias, xw, 2, steps, B, H,
      static_cast<cudaStream_t>(stream)));
}

// The bfloat16 recurrences of both directions alone (the decoder's second
// launch) over their float32 xw.
int bilstm_dual_fused_recurrence_launch(int dtype, const float* xw_f,
                                        const float* xw_b,
                                        const void* w_hh_f,
                                        const void* w_hh_b, void* out_f,
                                        void* out_b, int steps, int B, int H,
                                        void* stream) {
  if (dtype != 1 || !lstm::valid_steps(steps, B, H)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* xw[2] = {xw_f, xw_b};
  const void* w_hh[2] = {w_hh_f, w_hh_b};
  void* out[2] = {out_f, out_b};
  return static_cast<int>(lstm::launch_recurrence(
      xw, w_hh, out, kReverse, 2, steps, B, H,
      static_cast<cudaStream_t>(stream)));
}

const char* bilstm_dual_fused_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
