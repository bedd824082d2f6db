// Device code shared by the port's GRU kernels for Hopper (sm_90a): the
// three-gate staged-row products and the GRU cell, which gru_core.cuh's
// L2-streaming body runs.  Included by gru_core.cuh, and so by
// gru_direction_fused.cu, gru_direction_fused_static.cu and
// gru_recurrence.cu; each builds into a library of its own.  The dtype
// conversions, the sigmoid and kRows come from lstm_cell.cuh.
//
// The cell is torch.nn.GRU's, with gates ordered (r, z, n) along 3H:
//
//   r = sigmoid(xw_r + hw_r) ;  z = sigmoid(xw_z + hw_z)
//   n = tanh(xw_n + r * hw_n) ;  h' = (1 - z) * n + z * h
//
// where xw = x @ W_ih + b_ih and hw = bf(h) @ W_hh + b_hh.  b_hh sits inside
// r * (...), so it cannot be folded into the input bias as the LSTM's is.
// The products r * hw_n, (1 - z) * n and z * h and their sums are rounded
// one by one (__fmul_rn/__fadd_rn): no multiply-add is contracted, so the
// update rounds as the plain version's separate operations do.
//
// Layout of that body (that of lstm_cell.cuh): a block owns kRows
// batch rows for all T steps and has H threads; thread j owns hidden unit j
// and accumulates the three gate columns j, H+j, 2H+j of its rows in f32
// registers, for xw and hw apart, and keeps its rows' f32 h in registers.
// Shared memory holds the step's staged inputs laid out [feature][row], so
// one 16-byte broadcast read feeds four rows.

#pragma once

#include "lstm_cell.cuh"

namespace gru {

using lstm::kRows;
constexpr int kMaxHidden = 256;    // threads per block = H

// acc[r][q] += sum_k s[k][r] * w[k][q*H + j] over K features, q = r, z, n.
template <typename T>
__device__ __forceinline__ void accumulate(float (&acc)[kRows][3],
                                           const float* __restrict__ s,
                                           const T* __restrict__ w, int K,
                                           int H, int j) {
  const int G = 3 * H;
#pragma unroll 2
  for (int k = 0; k < K; ++k) {
    const T* wk = w + static_cast<size_t>(k) * G + j;
    const float wq[3] = {lstm::to_f32(wk[0]), lstm::to_f32(wk[H]),
                         lstm::to_f32(wk[2 * H])};
    const float4* sk = reinterpret_cast<const float4*>(s + k * kRows);
#pragma unroll
    for (int v = 0; v < kRows / 4; ++v) {
      const float4 x = sk[v];
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        acc[4 * v + 0][q] += x.x * wq[q];
        acc[4 * v + 1][q] += x.y * wq[q];
        acc[4 * v + 2][q] += x.z * wq[q];
        acc[4 * v + 3][q] += x.w * wq[q];
      }
    }
  }
}

template <typename T>
__device__ __forceinline__ void zero(T (&acc)[kRows][3]) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int q = 0; q < 3; ++q) acc[r][q] = T(0);
  }
}

// acc[r][q] += b[q] for every row: the bias goes onto the finished
// product, as in the plain version's x @ W + b.
__device__ __forceinline__ void add_bias(float (&acc)[kRows][3],
                                         const float (&b)[3]) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int q = 0; q < 3; ++q) acc[r][q] = __fadd_rn(acc[r][q], b[q]);
  }
}

// The three gate values of unit j from a (3H,) float32 vector.
__device__ __forceinline__ void load3(float (&out)[3],
                                      const float* __restrict__ v, int H,
                                      int j) {
  out[0] = v[j];
  out[1] = v[H + j];
  out[2] = v[2 * H + j];
}

// One GRU cell update of h from the row's xw and hw gate sums.
__device__ __forceinline__ float cell(const float (&xw)[3],
                                      const float (&hw)[3], float h) {
  const float r = lstm::sigmoid(__fadd_rn(xw[0], hw[0]));
  const float z = lstm::sigmoid(__fadd_rn(xw[1], hw[1]));
  const float n = tanhf(__fadd_rn(xw[2], __fmul_rn(r, hw[2])));
  return __fadd_rn(__fmul_rn(__fsub_rn(1.0f, z), n), __fmul_rn(z, h));
}

// Load this thread's rows of h0 (B, H) float32 into h (zeros past the
// batch) and stage them, rounded to TW, into hs[j][r].
template <typename TW>
__device__ __forceinline__ void load_h0(float (&h)[kRows],
                                        float* __restrict__ hs,
                                        const float* __restrict__ h0, int B,
                                        int H, int j, int b0) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = b0 + r;
    h[r] = row < B ? h0[static_cast<size_t>(row) * H + j] : 0.0f;
    hs[j * kRows + r] = lstm::to_f32(lstm::from_f32<TW>(h[r]));
  }
}

}  // namespace gru
