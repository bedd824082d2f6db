// Device code shared by the port's LSTM and GRU kernels for Hopper
// (sm_90a): dtype conversions, the gate nonlinearity and the staged-row
// products of the first static LSTM body (lstm_direction_fused_static.cu,
// body (b)) and the GRU's (gru_cell.cuh).  The float LSTM kernels run
// lstm_core.cuh in both dtypes.  Each kernel builds into a library of its
// own.
//
// Layout of the staged-row bodies: a block owns kRows batch rows for all T
// steps and has H threads; thread j owns hidden unit j and accumulates the
// four gate columns j, H+j, 2H+j, 3H+j of its rows in f32 registers, so the
// cell update needs no exchange and c never leaves registers.  Shared
// memory holds the step's staged inputs laid out [feature][row], so one
// 16-byte broadcast read feeds four rows.

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

}  // namespace lstm
