// One GRU direction with the input projection, for Hopper (sm_90a).
// Replaces the TPU kernel pepper_tpu/ops/gru_kernel.py::gru_direction_fused
// (body _make_fused_gru_kernel), the polish consensus model's recurrence.
// Per step, with t running T-1..0 when `reverse`:
//
//   xw = sum_i x_i[t] @ W_ih_i + b_ih ;  hw = h @ W_hh + b_hh   (f32 sums)
//   r, z = sigmoid(xw + hw) of the first two H-wide slices
//   n = tanh(xw_n + r * hw_n) ;  h = (1 - z) * n + z * h       (f32 state)
//   out[t] = h rounded to x's dtype
//
// h starts from h0, the hidden state carried from the previous sliding
// window, and up to two feature parts x_0, x_1 stand for their
// concatenation (the decoder reads the encoder's forward and backward
// streams without a concat).  x and out are float32 or bfloat16; W_ih, W_hh,
// b_ih, b_hh and h0 are float32, as the polish consensus hands them over
// in both compute dtypes, so the recurrent product reads h unrounded.  The
// caller takes the carried state from out's last step (its first when
// reversed), in out's dtype, as the TPU kernel's caller does.
//
// Design: two launches on the caller's stream, from one launcher; the
// projection alone is exported too, so that it can be timed apart.
// (1) The input projection, which does not depend on h, leaves the serial
// loop: xw = [x_0 x_1] @ [W_ih_0; W_ih_1] + b_ih for all T*B rows at once,
// into a float32 scratch (T, B, 3H) that the caller allocates
// (gru_projection.cuh, a tiled f32 product on the CUDA cores).
// (2) The recurrence over xw: gru_core.cuh, h unrounded (TH = float).
//
// Bound.  2*T*B*(F+H)*3H operations (1.36 GFLOP for the encoder and 3.77
// GFLOP for the decoder at T=100, B=128, H=128) against x in and h out:
// operations bound it.  The projection (2/3 of the decoder's operations)
// runs at a share of the f32 rate on the CUDA cores, 103 registers a thread
// leaving two blocks an SM; the recurrence is held back by the latency of
// its serial steps (gru_core.cuh, gru_recurrence.cu).
//
// Binding: a plain C launcher (no PyTorch headers) loaded with ctypes; it
// launches on the caller's stream and returns cudaGetLastError().

#include <climits>

#include "gru_core.cuh"
#include "gru_projection.cuh"

namespace {

bool valid(int x_dtype, const float* w0, const float* w1, int F0, int F1,
           int steps, int B, int H) {
  return (x_dtype == 0 || x_dtype == 1) && H > 0 && H <= gru::kMaxHidden &&
         H % 32 == 0 && F0 > 0 && F1 >= 0 && steps > 0 && B > 0 &&
         static_cast<long long>(steps) * B <= INT_MAX &&
         reinterpret_cast<uintptr_t>(w0) % 16 == 0 &&
         (F1 == 0 || reinterpret_cast<uintptr_t>(w1) % 16 == 0);
}

// xw = [x0 x1] @ [w0; w1] + b_ih for all steps * B rows
cudaError_t project(int x_dtype, const void* x0, const void* x1,
                    const float* w0, const float* w1, int F0, int F1,
                    const float* b_ih, float* xw, int steps, int B, int H,
                    cudaStream_t stream) {
  const int M = steps * B;
  const int N = 3 * H;
  if (x_dtype == 0) {
    return gru_proj::project(static_cast<const float*>(x0),
                             static_cast<const float*>(x1), w0, w1, F0, F1,
                             b_ih, xw, M, N, stream);
  }
  using bf16 = __nv_bfloat16;
  return gru_proj::project(static_cast<const bf16*>(x0),
                           static_cast<const bf16*>(x1), w0, w1, F0, F1,
                           b_ih, xw, M, N, stream);
}

}  // namespace

extern "C" {

// x_dtype: 0 = float32, 1 = bfloat16 (x0, x1 and out); the weights, biases
// and h0 are float32, W_ih and W_hh 16-byte aligned.  x1/w1 may be null
// with F1 == 0.  xw: a float32 scratch of steps * B * 3H values.  Runs the
// projection into xw, then the recurrence over it.  Returns a cudaError_t
// value (0 on success).
int gru_direction_fused_launch(int x_dtype, const void* x0, const void* x1,
                               const float* w0, const float* w1, int F0,
                               int F1, const float* b_ih, const float* w_hh,
                               const float* b_hh, const float* h0, float* xw,
                               void* out, int steps, int B, int H,
                               int reverse, void* stream) {
  if (!valid(x_dtype, w0, w1, F0, F1, steps, B, H)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      project(x_dtype, x0, x1, w0, w1, F0, F1, b_ih, xw, steps, B, H, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (x_dtype == 0) {
    return static_cast<int>(gru::launch_core<float, float, float>(
        xw, w_hh, b_hh, h0, static_cast<float*>(out), nullptr, steps, B, H,
        reverse, s));
  }
  return static_cast<int>(gru::launch_core<float, __nv_bfloat16, float>(
      xw, w_hh, b_hh, h0, static_cast<__nv_bfloat16*>(out), nullptr, steps,
      B, H, reverse, s));
}

// The projection alone (the first of the two launches), with the same
// arguments: xw = [x0 x1] @ [w0; w1] + b_ih for all steps * B rows.
int gru_direction_fused_projection_launch(int x_dtype, const void* x0,
                                          const void* x1, const float* w0,
                                          const float* w1, int F0, int F1,
                                          const float* b_ih, float* xw,
                                          int steps, int B, int H,
                                          void* stream) {
  if (!valid(x_dtype, w0, w1, F0, F1, steps, B, H)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(project(x_dtype, x0, x1, w0, w1, F0, F1, b_ih, xw,
                                  steps, B, H,
                                  static_cast<cudaStream_t>(stream)));
}

const char* gru_direction_fused_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
