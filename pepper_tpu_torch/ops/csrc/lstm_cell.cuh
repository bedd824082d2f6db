// Device code shared by the port's LSTM and GRU kernels for Hopper
// (sm_90a): dtype conversions, the int8 code of a value and the plain
// sigmoid, and the staged-row layout constants of the GRU's first bodies
// (gru_cell.cuh).  The LSTM kernels run lstm_core.cuh.  Each kernel builds
// into a library of its own.
//
// Staged-row layout: a block owns kRows batch rows for all T steps and has
// H threads; thread j owns hidden unit j and accumulates its gate columns
// of its rows in f32 registers, so the cell update needs no exchange.
// Shared memory holds the step's staged inputs laid out [feature][row], so
// one 16-byte broadcast read feeds four rows.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace lstm {

constexpr int kRows = 16;          // batch rows per block
constexpr int kMaxHidden = 256;    // the widest H the kernels take

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

}  // namespace lstm
