// One LSTM direction over T steps with the input projection fused in, for
// Hopper (sm_90a).  Replaces the TPU kernel
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
// Design.  Batch rows are independent, so a block owns BT rows and runs all
// T steps itself: no grid-wide synchronisation.  Thread j owns hidden unit j
// and accumulates the four gate columns j, H+j, 2H+j, 3H+j for its BT rows
// in f32 registers, so the cell update needs no exchange and c never leaves
// registers.  Shared memory holds this step's x rows and the rounded h, both
// as f32 laid out [feature][row] so one 16-byte broadcast read feeds four
// rows.  The weights are read from global memory every step: W_hh alone is
// 512 KB in bf16 at H=256, more than one SM's shared memory, and the whole
// weight set stays resident in the 50 MB L2.  The body is
// lstm::direction_body in lstm_cell.cuh, which bilstm_dual_fused.cu runs
// for both directions in one launch.
//
// Bound.  2*T*B*(F+H)*4H operations against x in + h out bytes: at the
// serving shapes the work is far above the card's ridge point, so it is
// bound by operations.  This first version does its products as scalar f32
// FMAs, not on the tensor cores, and so runs well above the tensor-core
// bound; mma/wgmma, TMA and a cluster-split W_hh are later work.
//
// Binding: a plain C launcher (no PyTorch headers) loaded with ctypes; it
// launches on the caller's stream and returns cudaGetLastError().

#include "lstm_cell.cuh"

namespace {

using lstm::kMaxHidden;
using lstm::kRows;

template <typename T>
__global__ void __launch_bounds__(kMaxHidden)
    lstm_direction_fused_kernel(const T* __restrict__ x0,
                                const T* __restrict__ x1,
                                const T* __restrict__ w0,
                                const T* __restrict__ w1, int F0, int F1,
                                const T* __restrict__ bias,
                                const T* __restrict__ w_hh,
                                T* __restrict__ out, int steps, int B, int H,
                                int reverse) {
  extern __shared__ __align__(16) float smem[];
  lstm::direction_body(smem, x0, x1, w0, w1, F0, F1, bias, w_hh, out, steps,
                       B, H, reverse, static_cast<int>(blockIdx.x) * kRows);
}

template <typename T>
int launch(const void* x0, const void* x1, const void* w0, const void* w1,
           int F0, int F1, const void* bias, const void* w_hh, void* out,
           int steps, int B, int H, int reverse, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(F0 + F1 + H) * kRows * sizeof(float);
  auto kernel = lstm_direction_fused_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((B + kRows - 1) / kRows);
  kernel<<<grid, H, smem, stream>>>(
      static_cast<const T*>(x0), static_cast<const T*>(x1),
      static_cast<const T*>(w0), static_cast<const T*>(w1), F0, F1,
      static_cast<const T*>(bias), static_cast<const T*>(w_hh),
      static_cast<T*>(out), steps, B, H, reverse);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  x1/w1 may be null with F1 == 0.
// Returns a cudaError_t value (0 on success).
int lstm_direction_fused_launch(int dtype, const void* x0, const void* x1,
                                const void* w0, const void* w1, int F0,
                                int F1, const void* bias, const void* w_hh,
                                void* out, int steps, int B, int H,
                                int reverse, void* stream) {
  if (H <= 0 || H > kMaxHidden || H % 32 != 0 || F0 <= 0 || F1 < 0 ||
      steps <= 0 || B <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float>(x0, x1, w0, w1, F0, F1, bias, w_hh, out, steps, B,
                         H, reverse, s);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(x0, x1, w0, w1, F0, F1, bias, w_hh, out,
                                 steps, B, H, reverse, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* lstm_direction_fused_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
