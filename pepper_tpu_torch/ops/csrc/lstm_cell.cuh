// Device code shared by the port's LSTM kernels for Hopper (sm_90a): dtype
// conversions, the gate nonlinearity, the staged-row products and the
// float32 body of one fused LSTM direction (bfloat16 runs lstm_core.cuh).
// Included by lstm_core.cuh, lstm_direction_fused_static.cu and
// lstm_recurrence.cu; each kernel builds into a library of its own.
//
// Layout every kernel shares: a block owns kRows batch rows for all T steps
// and has H threads; thread j owns hidden unit j and accumulates the four
// gate columns j, H+j, 2H+j, 3H+j of its rows in f32 registers, so the cell
// update needs no exchange and c never leaves registers.  Shared memory
// holds the step's staged inputs laid out [feature][row], so one 16-byte
// broadcast read feeds four rows.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace lstm {

constexpr int kRows = 16;          // batch rows per block
constexpr int kMaxHidden = 256;    // threads per block = H

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);  // round to nearest even, as astype does
}
// the int8 code of a value in (-1, 1): round(v * 127), ties to even
// (__float2int_rn, as jnp.round and torch.round), the product rounded
// apart so it is not contracted into anything
template <>
__device__ __forceinline__ int8_t from_f32<int8_t>(float v) {
  return static_cast<int8_t>(__float2int_rn(__fmul_rn(v, 127.0f)));
}

__device__ __forceinline__ float sigmoid(float v) {
  return 1.0f / (1.0f + expf(-v));
}

// acc[r][q] += sum_k s[k][r] * w[k][q*H + j] over K features.
template <typename T>
__device__ __forceinline__ void accumulate(float (&acc)[kRows][4],
                                           const float* __restrict__ s,
                                           const T* __restrict__ w, int K,
                                           int H, int j) {
  const int G = 4 * H;
#pragma unroll 2
  for (int k = 0; k < K; ++k) {
    const T* wk = w + static_cast<size_t>(k) * G + j;
    const float wq[4] = {to_f32(wk[0]), to_f32(wk[H]), to_f32(wk[2 * H]),
                         to_f32(wk[3 * H])};
    const float4* sk = reinterpret_cast<const float4*>(s + k * kRows);
#pragma unroll
    for (int v = 0; v < kRows / 4; ++v) {
      const float4 x = sk[v];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        acc[4 * v + 0][q] += x.x * wq[q];
        acc[4 * v + 1][q] += x.y * wq[q];
        acc[4 * v + 2][q] += x.z * wq[q];
        acc[4 * v + 3][q] += x.w * wq[q];
      }
    }
  }
}

// Stage rows [b0, b0+kRows) of x[t] (F_part features) into s[k][r], with
// zeros for rows past the batch.
template <typename T>
__device__ __forceinline__ void stage(float* __restrict__ s,
                                      const T* __restrict__ x, int F_part,
                                      int t, int B, int b0) {
  const size_t base = static_cast<size_t>(t) * B;
  for (int idx = threadIdx.x; idx < kRows * F_part; idx += blockDim.x) {
    const int r = idx / F_part;
    const int k = idx - r * F_part;
    const int row = b0 + r;
    s[k * kRows + r] =
        row < B ? to_f32(x[(base + row) * F_part + k]) : 0.0f;
  }
}

// One fused LSTM direction for the block that owns rows [b0, b0+kRows):
//
//   gates = f32(b) + sum_i x_i[t] @ W_ih_i + bf(h) @ W_hh      (f32 sums)
//   i, f, g, o = sigmoid, sigmoid, tanh, sigmoid of the four H-wide slices
//   c = f * c + i * g ;  h = o * tanh(c)                        (f32 state)
//   out[t] = h rounded to T
//
// where bf(h) is h rounded to T before the recurrent product and t runs
// T-1..0 when `reverse`.  smem holds (F0 + F1 + H) * kRows floats.
template <typename T>
__device__ __forceinline__ void direction_body(
    float* __restrict__ smem, const T* __restrict__ x0,
    const T* __restrict__ x1, const T* __restrict__ w0,
    const T* __restrict__ w1, int F0, int F1, const T* __restrict__ bias,
    const T* __restrict__ w_hh, T* __restrict__ out, int steps, int B, int H,
    int reverse, int b0) {
  float* xs = smem;                          // [F0 + F1][kRows]
  float* hs = smem + (F0 + F1) * kRows;      // [H][kRows]
  const int j = threadIdx.x;

  const float b_q[4] = {to_f32(bias[j]), to_f32(bias[H + j]),
                        to_f32(bias[2 * H + j]), to_f32(bias[3 * H + j])};
  float c[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    c[r] = 0.0f;
    hs[j * kRows + r] = 0.0f;
  }

  for (int step = 0; step < steps; ++step) {
    const int t = reverse ? steps - 1 - step : step;
    stage(xs, x0, F0, t, B, b0);
    if (F1 > 0) stage(xs + F0 * kRows, x1, F1, t, B, b0);
    __syncthreads();  // x staged; last step's h visible

    float acc[kRows][4];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r][q] = b_q[q];
    }
    accumulate(acc, xs, w0, F0, H, j);
    if (F1 > 0) accumulate(acc, xs + F0 * kRows, w1, F1, H, j);
    accumulate(acc, hs, w_hh, H, H, j);
    __syncthreads();  // every thread is done reading xs and hs

    const size_t base = static_cast<size_t>(t) * B;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float ig = sigmoid(acc[r][0]);
      const float fg = sigmoid(acc[r][1]);
      const float gg = tanhf(acc[r][2]);
      const float og = sigmoid(acc[r][3]);
      c[r] = fg * c[r] + ig * gg;
      const float h = og * tanhf(c[r]);
      const T h_out = from_f32<T>(h);
      // the recurrent product reads h rounded to the weight dtype
      hs[j * kRows + r] = to_f32(h_out);
      const int row = b0 + r;
      if (row < B) out[(base + row) * H + j] = h_out;
    }
  }
}

}  // namespace lstm
