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
// x, with the same tiles and sums as a single direction's.  float32: the
// core's float32 projection of both directions (3xTF32, one read of x),
// then its float32 recurrence of both, the grid's second dimension picking
// the direction, as in bfloat16.  The library also exports the two
// launches alone (bilstm_dual_fused_projection_launch,
// bilstm_dual_fused_recurrence_launch, dtype 0 or 1), so that they can be
// timed apart.
//
// Bound.  The sum of two lstm_direction_fused launches: 2*T*B*(F+H)*4H
// operations per direction, bound by operations at the serving shapes.
//
// Binding: a plain C launcher (no PyTorch headers) loaded with ctypes; it
// launches on the caller's stream and returns cudaGetLastError().

#include "lstm_core.cuh"

namespace {

constexpr int kReverse[2] = {0, 1};

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  x1/wf1/wb1 may be null with F1 == 0.
// xw_f/xw_b: float32 scratches of steps * B * 4H values each where the
// input projection leaves the step (float32, or bfloat16 with F0 + F1 >
// 32), else null; the weights 16-byte aligned.  Returns a cudaError_t
// value (0 on success).
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
  const void* w0[2] = {wf0, wb0};
  const void* w1[2] = {wf1, wb1};
  const void* bias[2] = {bias_f, bias_b};
  const void* w_hh[2] = {w_hh_f, w_hh_b};
  float* xw[2] = {xw_f, xw_b};
  void* out[2] = {out_f, out_b};
  if (dtype == 0) {
    return static_cast<int>(lstm::launch_directions_f32(
        x0, x1, F0, F1, w0, w1, bias, w_hh, xw, out, kReverse, 2, steps, B, H,
        s));
  }
  if (dtype == 1) {
    return static_cast<int>(lstm::launch_directions(
        x0, x1, F0, F1, w0, w1, bias, w_hh, xw, out, kReverse, 2, steps, B, H,
        s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The input projection of both directions alone (the first launch where x
// does not join the step): xw_d = [x0 x1] @ [wd0; wd1] + bias_d in
// float32.
int bilstm_dual_fused_projection_launch(int dtype, const void* x0,
                                        const void* x1, const void* wf0,
                                        const void* wf1, const void* wb0,
                                        const void* wb1, int F0, int F1,
                                        const void* bias_f,
                                        const void* bias_b, float* xw_f,
                                        float* xw_b, int steps, int B, int H,
                                        void* stream) {
  if ((dtype != 0 && dtype != 1) || !lstm::valid_shape(F0, F1, steps, B, H)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* w0[2] = {wf0, wb0};
  const void* w1[2] = {wf1, wb1};
  const void* bias[2] = {bias_f, bias_b};
  float* xw[2] = {xw_f, xw_b};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      dtype == 0 ? lstm::launch_projections_f32(x0, x1, F0, F1, w0, w1, bias,
                                                xw, 2, steps, B, H, s)
                 : lstm::launch_projections(x0, x1, F0, F1, w0, w1, bias, xw,
                                            2, steps, B, H, s));
}

// The recurrences of both directions alone (the second launch) over their
// float32 xw.
int bilstm_dual_fused_recurrence_launch(int dtype, const float* xw_f,
                                        const float* xw_b,
                                        const void* w_hh_f,
                                        const void* w_hh_b, void* out_f,
                                        void* out_b, int steps, int B, int H,
                                        void* stream) {
  if ((dtype != 0 && dtype != 1) || !lstm::valid_steps(steps, B, H)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* xw[2] = {xw_f, xw_b};
  const void* w_hh[2] = {w_hh_f, w_hh_b};
  void* out[2] = {out_f, out_b};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      dtype == 0 ? lstm::launch_recurrence_f32(xw, w_hh, out, kReverse, 2,
                                               steps, B, H, s)
                 : lstm::launch_recurrence(xw, w_hh, out, kReverse, 2, steps,
                                           B, H, s));
}

const char* bilstm_dual_fused_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
