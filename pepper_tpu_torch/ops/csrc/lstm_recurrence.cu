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
// * float32 keeps the first design, the layout of lstm_cell.cuh: a block
//   owns kRows batch rows for all T steps, thread j owns hidden unit j and
//   its four gate columns, h is staged in shared memory, c stays in
//   registers, and the recurrent product is scalar f32 FMAs over W_hh
//   streamed from L2 (tensor-core float32, 3xTF32, is later work).
//
// Binding: a plain C launcher (no PyTorch headers) loaded with ctypes; it
// launches on the caller's stream and returns the first CUDA error.  The
// library also exports the core's launch plan (lstm_recurrence_plan).

#include "lstm_core.cuh"

namespace {

using lstm::kMaxHidden;
using lstm::kRows;

template <typename T>
__global__ void __launch_bounds__(kMaxHidden)
    lstm_recurrence_kernel(const T* __restrict__ xw,
                           const T* __restrict__ w_hh, T* __restrict__ out,
                           int steps, int B, int H, int reverse) {
  extern __shared__ __align__(16) float hs[];  // [H][kRows]
  const int j = threadIdx.x;
  const int b0 = static_cast<int>(blockIdx.x) * kRows;
  const int G = 4 * H;

  float c[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    c[r] = 0.0f;
    hs[j * kRows + r] = 0.0f;
  }

  for (int s = 0; s < steps; ++s) {
    const int t = reverse ? steps - 1 - s : s;
    const size_t base = static_cast<size_t>(t) * B;
    float acc[kRows][4];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = b0 + r;
      const T* xr = xw + (base + (row < B ? row : 0)) * G + j;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        acc[r][q] = row < B ? lstm::to_f32(xr[q * H]) : 0.0f;
      }
    }
    __syncthreads();  // last step's h visible
    lstm::accumulate(acc, hs, w_hh, H, H, j);
    __syncthreads();  // every thread is done reading hs

#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float ig = lstm::sigmoid(acc[r][0]);
      const float fg = lstm::sigmoid(acc[r][1]);
      const float gg = tanhf(acc[r][2]);
      const float og = lstm::sigmoid(acc[r][3]);
      c[r] = fg * c[r] + ig * gg;
      const float h = og * tanhf(c[r]);
      const T h_out = lstm::from_f32<T>(h);
      hs[j * kRows + r] = lstm::to_f32(h_out);
      const int row = b0 + r;
      if (row < B) out[(base + row) * H + j] = h_out;
    }
  }
}

int launch_f32(const float* xw, const float* w_hh, float* out, int steps,
               int B, int H, int reverse, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(H) * kRows * sizeof(float);
  auto kernel = lstm_recurrence_kernel<float>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((B + kRows - 1) / kRows);
  kernel<<<grid, H, smem, stream>>>(xw, w_hh, out, steps, B, H, reverse);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; reverse: run t = T-1..0.  In bfloat16
// xw must start on 4 bytes and W_hh on 16.  Returns a cudaError_t value (0
// on success).
int lstm_recurrence_launch(int dtype, const void* xw, const void* w_hh,
                           void* out, int steps, int B, int H, int reverse,
                           void* stream) {
  if (!lstm::valid_steps(steps, B, H)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_f32(static_cast<const float*>(xw),
                      static_cast<const float*>(w_hh),
                      static_cast<float*>(out), steps, B, H, reverse, s);
  }
  if (dtype == 1) {
    const lstm::bf16* xws = static_cast<const lstm::bf16*>(xw);
    return static_cast<int>(lstm::launch_recurrence(
        &xws, &w_hh, &out, &reverse, 1, steps, B, H, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The bfloat16 core's launch plan for B rows at width H, as
// lstm_direction_fused_plan_launch reports it (out[4]: rows and CTAs a
// cluster, clusters, clusters that run at once); launches nothing.
int lstm_recurrence_plan_launch(int B, int H, int* out, void* /*stream*/) {
  if (!lstm::valid_steps(1, B, H)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(
      lstm::core_plan<lstm::bf16>(B, H, 1, false, out));
}

const char* lstm_recurrence_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
