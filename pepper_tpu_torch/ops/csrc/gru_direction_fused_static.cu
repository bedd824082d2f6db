// One GRU direction with static int8 streams, for Hopper (sm_90a).
// Replaces the TPU kernel
// pepper_tpu/ops/gru_kernel.py::gru_direction_fused_static (body
// _make_fused_gru_kernel_static), the kernel of polish's `--quantized`.
// Per step, with t running T-1..0 when `reverse`:
//
//   float x:  xw = sum_i x_i[t] @ W_ih_i + b_ih                  (f32 sums)
//   int8 x:   xw = f32(sum_i x_i[t] @ W_ih_i) * acc_scale + b_ih (int32 sums)
//   hw = bf(h) @ W_hh + b_hh                                     (f32 sums)
//   r, z = sigmoid(xw + hw) ; n = tanh(xw_n + r * hw_n)
//   h = (1 - z) * n + z * h                                      (f32 state)
//   out[t] = round(h * 127) as int8 ;  h_out = h after the last step (f32)
//
// h starts from the float32 h0.  h' is a convex mix of tanh(...) and h, so
// it stays in (-1, 1) and its int8 scale is exactly 1/127.  bf(h) is h
// rounded to W_hh's dtype.  Float x parts, W_ih and W_hh share one dtype
// (float32 or bfloat16; the encoder); int8 x (the decoder, the encoder's
// codes) takes int8 W_ih with acc_scale = w_scale/127 and a float32 or
// bfloat16 W_hh.  Biases and h0 are float32.  round() is round-half-to-even
// (__float2int_rn), as jnp.round and torch.round are, and the rescale uses
// __fmul_rn/__fadd_rn so no multiply-add is contracted.  The final h is a
// second, float32 output, so the window-to-window carry and the
// encoder->decoder handoff stay exact.
//
// Design: the layout of gru_direction_fused.cu, two launches on the
// caller's stream from one launcher; both are exported alone too, so that
// they can be timed apart.
// (1) The input projection leaves the serial loop, into a float32 scratch
// xw (T, B, 3H) that the caller allocates (19.7 MB at B=128: it stays in
// L2).  Float x: gru_projection.cuh, the f32 product of the float kernel,
// W_ih float32 or bfloat16.  int8 x: int8_projection.cuh, mma.sync
// m16n8k32 on the tensor cores over the int8 W_ih laid out k-major once
// per weight tree (ops/cuda_build.py:int8_kmajor); its int32 sums are
// exact, so its xw is the plain version's bit for bit.  A dp4a tile would
// also serve the 2.5 GOP at B=128; the tensor-core product is the one the
// LSTM's decoder needs (141.7 GOP), and one kernel serves both.
// (2) The recurrence over xw: gru_core.cuh, with int8 codes out and the
// f32 h written to h_out.  W_hh reaches it as float32; a bfloat16 W_hh is
// widened by the caller and h rounded to bfloat16 before the product (TH),
// the same math: bf16 x bf16 products are exact in f32.
//
// Every combination the wrapper takes runs on that core: float32 x with
// float32 W_hh, bfloat16 with bfloat16, int8 x with float32 or bfloat16.
//
// Bound.  2*T*B*(F+H)*3H operations, the decoder's 2*T*B*256*3H of them
// int8: at B=128, T=100, H=128 the decoder does 2.52 GOP int8 and 1.26
// GFLOP of f32 products, the encoder 1.36 GFLOP: operations bound it, the
// f32 recurrence most (gru_recurrence.cu: a chain of T serial steps).
//
// Binding: a plain C launcher (no PyTorch headers) loaded with ctypes; it
// launches on the caller's stream and returns cudaGetLastError().

#include <climits>

#include "gru_core.cuh"
#include "gru_projection.cuh"
#include "int8_projection.cuh"

namespace {

constexpr int kF32 = 0;
constexpr int kBf16 = 1;
constexpr int kInt8 = 2;

using bf16 = __nv_bfloat16;

bool valid_shape(int F0, int F1, int steps, int B, int H) {
  return H > 0 && H <= gru::kMaxHidden && H % 32 == 0 && F0 > 0 && F1 >= 0 &&
         steps > 0 && B > 0 && static_cast<long long>(steps) * B <= INT_MAX;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// xw for all steps * B rows: the float product for float x (W_ih parts w0,
// w1 of x's dtype), the int8 one for int8 x (w0 is W_ih k-major, (3H,
// F0 + F1); w1 unused)
cudaError_t project(int x_dtype, const void* x0, const void* x1,
                    const void* w0, const void* w1, int F0, int F1,
                    const float* acc_scale, const float* b_ih, float* xw,
                    int steps, int B, int H, cudaStream_t stream) {
  const int M = steps * B, N = 3 * H;
  if (x_dtype == kInt8) {
    return i8::launch_projection(
        static_cast<const int8_t*>(x0), static_cast<const int8_t*>(x1), F0,
        F1, static_cast<const int8_t*>(w0), acc_scale, b_ih, xw, M, N,
        stream);
  }
  if (!aligned16(w0) || (F1 > 0 && !aligned16(w1))) {
    return cudaErrorMisalignedAddress;
  }
  if (x_dtype == kF32) {
    return gru_proj::project(
        static_cast<const float*>(x0), static_cast<const float*>(x1),
        static_cast<const float*>(w0), static_cast<const float*>(w1), F0, F1,
        b_ih, xw, M, N, stream);
  }
  if (x_dtype == kBf16) {
    return gru_proj::project(
        static_cast<const bf16*>(x0), static_cast<const bf16*>(x1),
        static_cast<const bf16*>(w0), static_cast<const bf16*>(w1), F0, F1,
        b_ih, xw, M, N, stream);
  }
  return cudaErrorInvalidValue;
}

// The recurrence over xw: codes out, the f32 h after the last step to
// h_out, h rounded to W_hh's dtype (whh_dtype) before the product
cudaError_t recur(int whh_dtype, const float* xw, const float* w_hh,
                  const float* b_hh, const float* h0, int8_t* out,
                  float* h_out, int steps, int B, int H, int reverse,
                  cudaStream_t stream) {
  if (whh_dtype == kF32) {
    return gru::launch_core<float, int8_t, float>(
        xw, w_hh, b_hh, h0, out, h_out, steps, B, H, reverse, stream);
  }
  if (whh_dtype == kBf16) {
    return gru::launch_core<float, int8_t, bf16>(
        xw, w_hh, b_hh, h0, out, h_out, steps, B, H, reverse, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// x_dtype: 0 = float32, 1 = bfloat16 (w0/w1 of its dtype, 16-byte
// aligned, and whh_dtype equal to it), 2 = int8 (w0 is W_ih k-major, (3H,
// F0 + F1) int8, w1 unused, acc_scale read); whh_dtype: 0 = float32,
// 1 = bfloat16, the dtype h is rounded to before the recurrent product,
// while w_hh itself is float32 (a bfloat16 W_hh widened) and 16-byte
// aligned.  Biases, h0, acc_scale and h_out are float32; out is int8
// codes.  x1 may be null with F1 == 0.  xw: a float32 scratch of
// steps * B * 3H values.  Returns a cudaError_t value (0 on success).
int gru_direction_fused_static_launch(
    int x_dtype, int whh_dtype, const void* x0, const void* x1,
    const void* w0, const void* w1, int F0, int F1, const float* acc_scale,
    const float* b_ih, const float* w_hh, const float* b_hh, const float* h0,
    float* xw, void* out, float* h_out, int steps, int B, int H, int reverse,
    void* stream) {
  if (!valid_shape(F0, F1, steps, B, H) || h_out == nullptr ||
      (x_dtype != kInt8 && x_dtype != whh_dtype)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = project(x_dtype, x0, x1, w0, w1, F0, F1, acc_scale,
                                  b_ih, xw, steps, B, H, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(recur(whh_dtype, xw, w_hh, b_hh, h0,
                                static_cast<int8_t*>(out), h_out, steps, B,
                                H, reverse, s));
}

// The projection alone (the first of the two launches), with the same
// arguments.
int gru_direction_fused_static_projection_launch(
    int x_dtype, const void* x0, const void* x1, const void* w0,
    const void* w1, int F0, int F1, const float* acc_scale,
    const float* b_ih, float* xw, int steps, int B, int H, void* stream) {
  if (!valid_shape(F0, F1, steps, B, H)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(project(x_dtype, x0, x1, w0, w1, F0, F1, acc_scale,
                                  b_ih, xw, steps, B, H,
                                  static_cast<cudaStream_t>(stream)));
}

// The recurrence alone (the second launch) over a given float32 xw.
int gru_direction_fused_static_recurrence_launch(
    int whh_dtype, const float* xw, const float* w_hh, const float* b_hh,
    const float* h0, void* out, float* h_out, int steps, int B, int H,
    int reverse, void* stream) {
  if (!valid_shape(1, 0, steps, B, H) || h_out == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(recur(whh_dtype, xw, w_hh, b_hh, h0,
                                static_cast<int8_t*>(out), h_out, steps, B,
                                H, reverse,
                                static_cast<cudaStream_t>(stream)));
}

const char* gru_direction_fused_static_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
