// One LSTM direction over T steps with the input projection, for Hopper
// (sm_90a).  Replaces the TPU kernel
// pepper_tpu/ops/lstm_kernel.py::lstm_direction_fused (body
// _make_fused_kernel): per step
//
//   gates = f32(b) + sum_i x_i[t] @ W_ih_i + bf(h) @ W_hh      (f32 sums)
//   i, f, g, o = sigmoid, sigmoid, tanh, sigmoid of the four H-wide slices
//   c = f * c + i * g ;  h = o * tanh(c)                        (f32 state)
//   out[t] = h rounded to the input dtype
//
// where bf(h) is h rounded to the weight dtype before the recurrent product
// (h.astype(w_hh.dtype) in the TPU kernel), t runs T-1..0 when `reverse`,
// and up to two feature parts x_0, x_1 stand for their concatenation (the
// decoder reads the encoder's forward and backward streams without a
// concat).  x, W and out share one dtype: float32 or bfloat16.
//
// bfloat16, the serving default: lstm_core.cuh's tensor-core recurrence,
// W_hh split over a thread-block cluster.  The encoder's 26 features join
// the step's product; the decoder's 512 first go through the core's input
// projection into the float32 scratch xw (T, B, 4H) that the caller
// allocates, and the recurrence then reads xw.  The library also exports
// the two launches alone (lstm_direction_fused_projection_launch and
// lstm_direction_fused_recurrence_launch), so that they can be timed
// apart, and the core's launch plan (lstm_direction_fused_plan_launch,
// which launches nothing).
//
// float32: lstm_core.cuh's float32 core.  Every F is first projected by
// its float32 projection into the float32 scratch xw (3xTF32 products on
// the tensor cores), and the recurrence runs over xw with W_hh split over
// a cluster of H/32 CTAs, its products 3xTF32 too; the twin's 1e-5 holds,
// which plain TF32 products do not.  The exports above take dtype 0 as
// well.  Bound, both dtypes: 2*T*B*(F+H)*4H operations against x in and h
// out, so operations.
//
// Binding: a plain C launcher (no PyTorch headers) loaded with ctypes; it
// launches on the caller's stream and returns cudaGetLastError().

#include "lstm_core.cuh"

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  x1/w1 may be null with F1 == 0.  xw: a
// float32 scratch of steps * B * 4H values where the input projection
// leaves the step (float32, or bfloat16 with F0 + F1 > 32), else null; the
// weights 16-byte aligned.  Returns a cudaError_t value (0 on success).
int lstm_direction_fused_launch(int dtype, const void* x0, const void* x1,
                                const void* w0, const void* w1, int F0,
                                int F1, const void* bias, const void* w_hh,
                                float* xw, void* out, int steps, int B, int H,
                                int reverse, void* stream) {
  if (!lstm::valid_shape(F0, F1, steps, B, H)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return static_cast<int>(lstm::launch_directions_f32(
        x0, x1, F0, F1, &w0, &w1, &bias, &w_hh, &xw, &out, &reverse, 1, steps,
        B, H, s));
  }
  if (dtype == 1) {
    return static_cast<int>(lstm::launch_directions(
        x0, x1, F0, F1, &w0, &w1, &bias, &w_hh, &xw, &out, &reverse, 1, steps,
        B, H, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The input projection alone (the first of the two launches where x does
// not join the step), with the same arguments: xw = [x0 x1] @ [w0; w1] +
// bias in float32 for all steps * B rows.
int lstm_direction_fused_projection_launch(int dtype, const void* x0,
                                           const void* x1, const void* w0,
                                           const void* w1, int F0, int F1,
                                           const void* bias, float* xw,
                                           int steps, int B, int H,
                                           void* stream) {
  if ((dtype != 0 && dtype != 1) || !lstm::valid_shape(F0, F1, steps, B, H)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      dtype == 0 ? lstm::launch_projections_f32(x0, x1, F0, F1, &w0, &w1,
                                                &bias, &xw, 1, steps, B, H, s)
                 : lstm::launch_projections(x0, x1, F0, F1, &w0, &w1, &bias,
                                            &xw, 1, steps, B, H, s));
}

// The recurrence alone (the second launch) over a float32 xw (steps, B,
// 4H) that holds the input projection and the bias.
int lstm_direction_fused_recurrence_launch(int dtype, const float* xw,
                                           const void* w_hh, void* out,
                                           int steps, int B, int H,
                                           int reverse, void* stream) {
  if ((dtype != 0 && dtype != 1) || !lstm::valid_steps(steps, B, H)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      dtype == 0 ? lstm::launch_recurrence_f32(&xw, &w_hh, &out, &reverse, 1,
                                               steps, B, H, s)
                 : lstm::launch_recurrence(&xw, &w_hh, &out, &reverse, 1,
                                           steps, B, H, s));
}

// The core's launch plan for dtype (0 = float32, 1 = bfloat16) and dirs (1
// or 2) directions of B rows at width H, fused (1: x joins the step's
// product, bfloat16 only) or over xw: out[0] rows a cluster, out[1] CTAs a
// cluster, out[2] clusters a direction, out[3] clusters that run at once.
// Launches nothing.
int lstm_direction_fused_plan_launch(int dtype, int B, int H, int dirs,
                                     int fused, int* out,
                                     void* /*stream*/) {
  if (!lstm::valid_steps(1, B, H) || dirs < 1 || dirs > 2 ||
      (dtype != 1 && (dtype != 0 || fused))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(dtype == 0
                              ? lstm::f32_plan(B, H, dirs, out)
                              : lstm::core_plan(B, H, dirs, fused != 0, out));
}

const char* lstm_direction_fused_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
