// The float input projection of the GRU kernels, for Hopper (sm_90a):
//
//   xw[m][n] = sum_k [x_0 x_1][m][k] * [W_0; W_1][k][n] + b_ih[n]   (f32)
//
// for all M = T*B rows at once, into a float32 scratch (T, B, 3H) that the
// caller allocates (19.7 MB at B=128, H=128: it stays in the 50 MB L2).
// x is float32 or bfloat16, W float32 or bfloat16 (widened exactly), the
// bias float32 and added to the finished sum, as in the plain x @ W + b.
// The TPU kernels fused this product into each step to save xw's round
// trip to HBM; here the round trip stays in L2 and the product runs at the
// width of the whole card instead of inside each serial step.
//
// A tiled f32 product on the CUDA cores: 64 x 128 output tiles, 256
// threads of 4 x 8 outputs, k-tiles of 16 staged in shared memory (x
// transposed, so each k reads the rows as 16-byte broadcasts) and the next
// k-tile loaded into registers while the current one computes.
//
// Included by gru_direction_fused.cu and gru_direction_fused_static.cu,
// each a library of its own: internal linkage, as gru_core.cuh's.

#pragma once

#include "lstm_cell.cuh"

namespace gru_proj {

namespace {

constexpr int kBM = 64;             // output rows (of T*B) a block
constexpr int kBN = 128;            // output columns (of 3H) a block
constexpr int kBK = 16;             // k a tile
constexpr int kThreads = 256;       // 16 x 16, 4 x 8 outputs each
constexpr int kALoads = kBM * kBK / kThreads;        // 4 x values a thread
constexpr int kBLoads = kBK * kBN / 4 / kThreads;    // 2 float4 of W

// a[m][k] of the concatenated parts as float; zero past M or K
template <typename TX>
__device__ __forceinline__ float x_at(const TX* __restrict__ x0,
                                      const TX* __restrict__ x1, int F0,
                                      int F1, int M, int m, int k) {
  if (m >= M) return 0.0f;
  if (k < F0) return lstm::to_f32(x0[static_cast<size_t>(m) * F0 + k]);
  if (k < F0 + F1) {
    return lstm::to_f32(x1[static_cast<size_t>(m) * F1 + (k - F0)]);
  }
  return 0.0f;
}

__device__ __forceinline__ float4 four(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 four(const __nv_bfloat16* p) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// w[k][n..n+3] of the stacked parts as float; zero past K or N (N % 4 == 0)
template <typename TW>
__device__ __forceinline__ float4 w_at(const TW* __restrict__ w0,
                                       const TW* __restrict__ w1, int F0,
                                       int F1, int N, int k, int n) {
  if (n >= N || k >= F0 + F1) return make_float4(0.f, 0.f, 0.f, 0.f);
  const TW* row = k < F0 ? w0 + static_cast<size_t>(k) * N
                         : w1 + static_cast<size_t>(k - F0) * N;
  return four(row + n);
}

template <typename TX, typename TW>
__global__ void __launch_bounds__(kThreads)
    projection_kernel(const TX* __restrict__ x0, const TX* __restrict__ x1,
                      const TW* __restrict__ w0, const TW* __restrict__ w1,
                      int F0, int F1, const float* __restrict__ b_ih,
                      float* __restrict__ xw, int M, int N) {
  __shared__ __align__(16) float as[kBK][kBM + 4];  // x tile, [k][m]
  __shared__ __align__(16) float bs[kBK][kBN];      // W_ih tile, [k][n]
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = static_cast<int>(blockIdx.x) * kBM;
  const int n0 = static_cast<int>(blockIdx.y) * kBN;
  const int K = F0 + F1;

  float a_next[kALoads];
  float4 b_next[kBLoads];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kALoads; ++i) {
      const int e = tid + i * kThreads;  // neighbouring threads, same row
      a_next[i] = x_at(x0, x1, F0, F1, M, m0 + e / kBK, k0 + e % kBK);
    }
#pragma unroll
    for (int i = 0; i < kBLoads; ++i) {
      const int e = tid + i * kThreads;
      b_next[i] = w_at(w0, w1, F0, F1, N, k0 + e / (kBN / 4),
                       n0 + 4 * (e % (kBN / 4)));
    }
  };

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) acc[i][jj] = 0.0f;
  }
  load(0);
  for (int k0 = 0; k0 < K; k0 += kBK) {
#pragma unroll
    for (int i = 0; i < kALoads; ++i) {
      const int e = tid + i * kThreads;
      as[e % kBK][e / kBK] = a_next[i];
    }
#pragma unroll
    for (int i = 0; i < kBLoads; ++i) {
      const int e = tid + i * kThreads;
      *reinterpret_cast<float4*>(&bs[e / (kBN / 4)][4 * (e % (kBN / 4))]) =
          b_next[i];
    }
    __syncthreads();  // the tile is in place
    if (k0 + kBK < K) load(k0 + kBK);
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a4 = *reinterpret_cast<const float4*>(&as[kk][ty * 4]);
      const float4 b_lo = *reinterpret_cast<const float4*>(&bs[kk][tx * 4]);
      const float4 b_hi =
          *reinterpret_cast<const float4*>(&bs[kk][64 + tx * 4]);
      const float a[4] = {a4.x, a4.y, a4.z, a4.w};
      const float b[8] = {b_lo.x, b_lo.y, b_lo.z, b_lo.w,
                          b_hi.x, b_hi.y, b_hi.z, b_hi.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          acc[i][jj] = fmaf(a[i], b[jj], acc[i][jj]);
        }
      }
    }
    __syncthreads();  // every thread is done reading the tile
  }

  // the bias goes onto the finished sum, as in the plain x @ W + b
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int n = n0 + half * 64 + tx * 4;
      if (n >= N) continue;
      const int o = 4 * half;
      *reinterpret_cast<float4*>(xw + static_cast<size_t>(m) * N + n) =
          make_float4(__fadd_rn(acc[i][o], b_ih[n]),
                      __fadd_rn(acc[i][o + 1], b_ih[n + 1]),
                      __fadd_rn(acc[i][o + 2], b_ih[n + 2]),
                      __fadd_rn(acc[i][o + 3], b_ih[n + 3]));
    }
  }
}

// xw = [x0 x1] @ [w0; w1] + b_ih for M = steps * B rows and N = 3H
// columns; W's rows must start on 16 bytes (float32) or 8 (bfloat16).
template <typename TX, typename TW>
cudaError_t project(const TX* x0, const TX* x1, const TW* w0, const TW* w1,
                    int F0, int F1, const float* b_ih, float* xw, int M,
                    int N, cudaStream_t stream) {
  const dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN);
  projection_kernel<TX, TW><<<grid, kThreads, 0, stream>>>(
      x0, x1, w0, w1, F0, F1, b_ih, xw, M, N);
  return cudaGetLastError();
}

}  // namespace

}  // namespace gru_proj
