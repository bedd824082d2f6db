// Both directions of a fused LSTM layer in one launch, for Hopper (sm_90a).
// Replaces the TPU kernel pepper_tpu/ops/lstm_kernel.py::bilstm_dual_fused
// (body _make_dual_kernel), which runs the forward and the backward
// recurrence in one kernel body so that one direction's gate math can hide
// behind the other's recurrent matmul.
//
// Design.  Blocks run in parallel on Hopper, so the two directions need no
// shared body: the grid is (row blocks, 2) and blockIdx.y picks the
// direction's weights, bias, output and time order; every block then runs
// lstm::direction_body (lstm_cell.cuh), the same code as
// lstm_direction_fused.cu, so each output equals one launch of that kernel.
// What one launch buys is twice the blocks in flight: at B=256 a single
// direction has 16 row blocks for 132 SMs, the pair has 32.
//
// Bound.  The sum of two lstm_direction_fused launches: 2*T*B*(F+H)*4H
// operations per direction, bound by operations at the serving shapes.
//
// Binding: a plain C launcher (no PyTorch headers) loaded with ctypes; it
// launches on the caller's stream and returns cudaGetLastError().

#include "lstm_cell.cuh"

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

template <typename T>
int launch(const void* x0, const void* x1, const void* wf0, const void* wf1,
           const void* wb0, const void* wb1, int F0, int F1,
           const void* bias_f, const void* bias_b, const void* w_hh_f,
           const void* w_hh_b, void* out_f, void* out_b, int steps, int B,
           int H, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(F0 + F1 + H) * kRows * sizeof(float);
  auto kernel = bilstm_dual_fused_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((B + kRows - 1) / kRows, 2);
  kernel<<<grid, H, smem, stream>>>(
      static_cast<const T*>(x0), static_cast<const T*>(x1),
      static_cast<const T*>(wf0), static_cast<const T*>(wf1),
      static_cast<const T*>(wb0), static_cast<const T*>(wb1), F0, F1,
      static_cast<const T*>(bias_f), static_cast<const T*>(bias_b),
      static_cast<const T*>(w_hh_f), static_cast<const T*>(w_hh_b),
      static_cast<T*>(out_f), static_cast<T*>(out_b), steps, B, H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  x1/wf1/wb1 may be null with F1 == 0.
// Returns a cudaError_t value (0 on success).
int bilstm_dual_fused_launch(int dtype, const void* x0, const void* x1,
                             const void* wf0, const void* wf1,
                             const void* wb0, const void* wb1, int F0,
                             int F1, const void* bias_f, const void* bias_b,
                             const void* w_hh_f, const void* w_hh_b,
                             void* out_f, void* out_b, int steps, int B,
                             int H, void* stream) {
  if (H <= 0 || H > kMaxHidden || H % 32 != 0 || F0 <= 0 || F1 < 0 ||
      steps <= 0 || B <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float>(x0, x1, wf0, wf1, wb0, wb1, F0, F1, bias_f, bias_b,
                         w_hh_f, w_hh_b, out_f, out_b, steps, B, H, s);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(x0, x1, wf0, wf1, wb0, wb1, F0, F1, bias_f,
                                 bias_b, w_hh_f, w_hh_b, out_f, out_b, steps,
                                 B, H, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* bilstm_dual_fused_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
