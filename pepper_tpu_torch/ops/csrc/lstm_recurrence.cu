// The LSTM recurrence over precomputed input projections, for Hopper
// (sm_90a).  Replaces the TPU kernel
// pepper_tpu/ops/lstm_kernel.py::lstm_recurrence_pallas (body
// _lstm_kernel): per step, t = 0..T-1, or T-1..0 with `reverse`,
//
//   gates = f32(xw[t]) + bf(h) @ W_hh                           (f32 sums)
//   i, f, g, o = sigmoid, sigmoid, tanh, sigmoid of the four H-wide slices
//   c = f * c + i * g ;  h = o * tanh(c)                        (f32 state)
//   out[t] = h rounded to xw's dtype
//
// where bf(h) is h rounded to xw's dtype before the recurrent product
// (h.astype(xw.dtype) in the TPU kernel).  xw, W_hh and out share one
// dtype: float32 or bfloat16.  The dynamic int8 serving mode runs it on a
// bfloat16 xw, a direction at a time.
//
// Bound.  Per launch it must read xw (T*B*4H values) and W_hh, write h
// (T*B*H) and do 2*T*B*H*4H operations: at B=4096, T=33, H=256 in bf16 that
// is 346 MB (0.103 ms at 3.35 TB/s) against 70.9 GFLOP (0.072 ms on the
// bf16 tensor cores), so it is bound by bytes.  The serial chain of steps
// is what holds it back: a step's product needs the whole of the last
// step's h.
//
// Design, by dtype (chosen here, before the launch, never after a failure):
// * bfloat16 runs the hoisted body of lstm_core.cuh, the core that the two
//   fused float kernels share: mma.sync products on the tensor cores, W_hh
//   split over a thread-block cluster in shared memory, bf(h) pushed to the
//   peers through distributed shared memory, rows a cluster picked from B
//   and the card's cluster occupancy.  Its xw is the caller's bf16, read as
//   one bfloat162 for a thread's two adjacent units and widened to f32, so
//   a step streams half the bytes of the fused decoder's f32 xw.  The core
//   takes every H this launcher takes (a multiple of 32 up to 256).
// * float32 runs lstm_core.cuh's float32 core over the caller's float32 xw:
//   3xTF32 products on the tensor cores, W_hh split over a cluster of H/32
//   CTAs (8 at H=256, 128 KB of float32 W_hh each), f32 h exchanged
//   through distributed shared memory.  Its bound is 70.9 GFLOP, three
//   times that on the TF32 tensor cores, against xw's 553 MB in float32.
//
// Binding: a plain C launcher (no PyTorch headers) loaded with ctypes; it
// launches on the caller's stream and returns the first CUDA error.  The
// library also exports the core's launch plan (lstm_recurrence_plan).

#include "lstm_core.cuh"

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; reverse: run t = T-1..0.  xw must
// start on two of its elements and W_hh on 16 bytes.  Returns a
// cudaError_t value (0 on success).
int lstm_recurrence_launch(int dtype, const void* xw, const void* w_hh,
                           void* out, int steps, int B, int H, int reverse,
                           void* stream) {
  if (!lstm::valid_steps(steps, B, H)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const float* xwf = static_cast<const float*>(xw);
    return static_cast<int>(lstm::launch_recurrence_f32(
        &xwf, &w_hh, &out, &reverse, 1, steps, B, H, s));
  }
  if (dtype == 1) {
    const lstm::bf16* xws = static_cast<const lstm::bf16*>(xw);
    return static_cast<int>(lstm::launch_recurrence(
        &xws, &w_hh, &out, &reverse, 1, steps, B, H, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The core's launch plan for dtype (0 = float32, 1 = bfloat16) and B rows
// at width H, as lstm_direction_fused_plan_launch reports it (out[4]: rows
// and CTAs a cluster, clusters, clusters that run at once); launches
// nothing.
int lstm_recurrence_plan_launch(int dtype, int B, int H, int* out,
                                void* /*stream*/) {
  if (!lstm::valid_steps(1, B, H) || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(
      dtype == 0 ? lstm::f32_plan(B, H, 1, out)
                 : lstm::core_plan<lstm::bf16>(B, H, 1, false, out));
}

const char* lstm_recurrence_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
