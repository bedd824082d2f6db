// The GRU recurrence over precomputed input projections, for Hopper
// (sm_90a).  Replaces the TPU kernel
// pepper_tpu/ops/gru_kernel.py::gru_recurrence_pallas (body _gru_kernel),
// the unfused path of the polish consensus (PEPPER_GRU_FUSED=0
// PEPPER_GRU_KERNEL=1).  Per step t = 0..T-1 (no reverse: the caller
// flips):
//
//   hw = bf(h) @ W_hh + b_hh                                     (f32 sums)
//   r, z = sigmoid(xw[t] + hw) ;  n = tanh(xw_n[t] + r * hw_n)
//   h = (1 - z) * n + z * h                                      (f32 state)
//   out[t] = h rounded to xw's dtype
//
// h starts from the float32 h0 (the carried hidden state); bf(h) is h
// rounded to xw's dtype before the recurrent product (h.astype(xw.dtype)
// in the TPU kernel).  xw and out are float32 or bfloat16; W_hh and b_hh
// float32.
//
// Design: gru_core.cuh alone.  For H <= 128 W_hh lives in shared memory
// (its first 96 rows in registers at one row a block, 64 at two), a block
// owns as few batch rows as let the grid cover the SMs (1 at the consensus
// batch of 128, so 128 blocks on the 132 SMs) and has 3H threads, one a
// gate column, and the next
// step's xw is loaded while the current step computes; for H up to 256
// the L2-streaming body (16 rows and H threads a block).
//
// Bound.  Per launch it must read xw (T*B*3H values) and W_hh, write h
// (T*B*H) and do 2*T*B*H*3H operations: at T=100, B=128, H=128 in float32
// that is 26.5 MB (7.9 us at 3.35 TB/s) against 2.52 GFLOP (37.6 us at the
// f32 rate), so operations bound it.  The smem body is held back instead by
// its T serial steps, each a chain of shared-memory reads (W_hh's rows
// outside registers, h as broadcasts), the product, the gates, the cell and
// two barriers; each further row a block adds its broadcasts and FMAs to
// a step and leaves fewer registers for W_hh, so the plan takes as few
// rows a block as fill the SMs.
//
// Binding: a plain C launcher (no PyTorch headers) loaded with ctypes; it
// launches on the caller's stream and returns cudaGetLastError().

#include "gru_core.cuh"

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (xw and out); W_hh (16-byte aligned),
// b_hh and h0 are float32.  Returns a cudaError_t value (0 on success).
int gru_recurrence_launch(int dtype, const void* xw, const float* w_hh,
                          const float* b_hh, const float* h0, void* out,
                          int steps, int B, int H, void* stream) {
  if (H <= 0 || H > gru::kMaxHidden || H % 32 != 0 || steps <= 0 || B <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return static_cast<int>(gru::launch_core<float, float, float>(
        static_cast<const float*>(xw), w_hh, b_hh, h0,
        static_cast<float*>(out), nullptr, steps, B, H, 0, s));
  }
  if (dtype == 1) {
    using bf16 = __nv_bfloat16;
    return static_cast<int>(gru::launch_core<bf16, bf16, bf16>(
        static_cast<const bf16*>(xw), w_hh, b_hh, h0,
        static_cast<bf16*>(out), nullptr, steps, B, H, 0, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* gru_recurrence_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
