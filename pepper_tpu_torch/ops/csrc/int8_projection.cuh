// The int8 input projection of the static kernels, for Hopper (sm_90a):
//
//   xw[m][n] = f32(sum_k [x_0 x_1][m][k] * W[k][n]) * scale[n] + bias[n]
//
// for all M = T*B rows at once, into a float32 xw (M, N) that the caller
// allocates, with the int32 sum taken over both feature parts before the
// one rescale (__fmul_rn, then __fadd_rn: JAX's acc * scale + b, and its
// b + acc * scale, round alike).  The int32 sums are exact in any order,
// so xw equals the plain version's bit for bit.  It is the int8 half of
// the TPU kernels gru_direction_fused_static and
// lstm_direction_fused_static (pepper_tpu/ops/gru_kernel.py,
// lstm_kernel.py), taken out of their serial loops: the product does not
// depend on h.  Included by gru_direction_fused_static.cu and
// lstm_direction_fused_static.cu, each a library of its own, so the kernel
// and its launcher (which keeps a static flag) have internal linkage.
//
// W arrives k-major, (N, K) int8: row n holds output column n's K codes
// (ops/cuda_build.py:int8_kmajor, relaid once per weight tree on the served
// paths), so every 4 bytes of a row are one mma B register (mma_ptx.cuh).
//
// Design: mma.sync m16n8k32 s8 -> s32 on the tensor cores rather than dp4a
// on the CUDA cores: the classifier's decoder projects 141.7 GOP a
// direction at B=4096, which dp4a (about 4% of the card's int8 tensor rate)
// would take milliseconds over.  128 x 128 output tiles a block, 8 warps of
// 64 x 32, k-tiles of 64 codes in a ring of kStages in shared memory
// (rows padded to 80 bytes, so ldmatrix reads them without bank
// conflicts), filled with cp.async kStages - 1 tiles ahead of the product;
// byte by byte where x's or W's rows do not start on 16 bytes.  The column
// tiles of a row tile are neighbouring blocks, so x's rows come from DRAM
// once and from L2 after that; W (512 KB at most) stays in L2.
//
// Bound: the f32 xw it writes.  At the classifier's decoder (M = 33*4096,
// K = 512, N = 1024) that is 553 MB, 0.165 ms at 3.35 TB/s, against 141.7
// GOP, 0.072 ms at 1,979 TOP/s; at polish's (M = 100*128, K = 256,
// N = 384) 19.7 MB, 5.9 us.

#pragma once

#include <stdint.h>

#include <atomic>

#include "mma_ptx.cuh"

namespace i8 {

namespace {

constexpr int kBM = 128, kBN = 128;  // output tile of a block
constexpr int kBK = 64;              // codes of k a tile
constexpr int kRowBytes = kBK + 16;  // a padded shared row
constexpr int kThreads = 256;        // 2 x 4 warps of 64 x 32
constexpr int kStages = 4;
constexpr int kMaxDevices = 64;

struct Stage {
  uint8_t a[kBM][kRowBytes];  // x rows
  uint8_t b[kBN][kRowBytes];  // W's k-major rows (output columns)
};

struct Args {
  const int8_t* x0;     // (M, F0)
  const int8_t* x1;     // (M, F1) or null
  const int8_t* w_t;    // (N, F0 + F1), k-major
  const float* scale;   // (N,)
  const float* bias;    // (N,)
  float* xw;            // (M, N)
  int F0, F1, M, N;
};

// 16 codes of row m of [x0 x1] from k, zeros past M or K
__device__ __forceinline__ uint4 x_bytes(const Args& a, int m, int k) {
  uint4 v = make_uint4(0, 0, 0, 0);
  uint8_t* e = reinterpret_cast<uint8_t*>(&v);
  const int K = a.F0 + a.F1;
  if (m >= a.M) return v;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int kk = k + i;
    if (kk < a.F0) {
      e[i] = a.x0[static_cast<size_t>(m) * a.F0 + kk];
    } else if (kk < K) {
      e[i] = a.x1[static_cast<size_t>(m) * a.F1 + kk - a.F0];
    }
  }
  return v;
}

// 16 codes of W's column n from k, zeros past N or K
__device__ __forceinline__ uint4 w_bytes(const Args& a, int n, int k) {
  uint4 v = make_uint4(0, 0, 0, 0);
  uint8_t* e = reinterpret_cast<uint8_t*>(&v);
  const int K = a.F0 + a.F1;
  if (n >= a.N) return v;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    if (k + i < K) e[i] = a.w_t[static_cast<size_t>(n) * K + k + i];
  }
  return v;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, 2) projection_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char i8_smem[];
  Stage* stage = reinterpret_cast<Stage*>(i8_smem);
  const int K = a.F0 + a.F1;
  const int k_tiles = (K + kBK - 1) / kBK;
  const int n0 = static_cast<int>(blockIdx.x) * kBN;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 4, wn = warp % 4;
  for (int m0 = static_cast<int>(blockIdx.y) * kBM; m0 < a.M;
       m0 += static_cast<int>(gridDim.y) * kBM) {
    // k-tile kt into stage st: a 128 x 64 tile of x and one of W, 512
    // 16-byte chunks each, two of each a thread
    auto load = [&](int st, int kt) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int c = tid + i * kThreads;
        const int r = c / 4, k = kt * kBK + (c % 4) * 16;
        uint8_t* a_dst = &stage[st].a[r][(c % 4) * 16];
        uint8_t* b_dst = &stage[st].b[r][(c % 4) * 16];
        const int m = m0 + r, n = n0 + r;
        if constexpr (kVec) {
          const bool a_ok = m < a.M && k < K;
          const int8_t* a_src =
              !a_ok ? a.x0
              : k < a.F0 ? a.x0 + static_cast<size_t>(m) * a.F0 + k
                         : a.x1 + static_cast<size_t>(m) * a.F1 + k - a.F0;
          ptx::cp_async16_zfill(a_dst, a_src, a_ok);
          const bool b_ok = n < a.N && k < K;
          ptx::cp_async16_zfill(
              b_dst, b_ok ? a.w_t + static_cast<size_t>(n) * K + k : a.w_t,
              b_ok);
        } else {
          *reinterpret_cast<uint4*>(a_dst) = x_bytes(a, m, k);
          *reinterpret_cast<uint4*>(b_dst) = w_bytes(a, n, k);
        }
      }
    };
    int acc[4][4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[i][j][v] = 0;
      }
    }
#pragma unroll
    for (int st = 0; st < kStages - 1; ++st) {
      if (st < k_tiles) load(st, st);
      ptx::cp_async_commit();
    }
    for (int kt = 0; kt < k_tiles; ++kt) {
      ptx::cp_async_wait<kStages - 2>();
      __syncthreads();  // k-tile kt is in place; stage (kt-1) % S is free
      if (kt + kStages - 1 < k_tiles) {
        load((kt + kStages - 1) % kStages, kt + kStages - 1);
      }
      ptx::cp_async_commit();
      const Stage& sm = stage[kt % kStages];
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 32) {
        // bf[p]: b0, b1 of n8 tile 2p, then of tile 2p + 1
        unsigned bf[2][4];
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          ptx::ldmatrix_x4(
              bf[p], &sm.b[wn * 32 + p * 16 + (lane & 7) + (lane >> 4) * 8]
                          [kk + ((lane >> 3) & 1) * 16]);
        }
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          unsigned af[4];
          ptx::ldmatrix_x4(af, &sm.a[wm * 64 + mt * 16 + (lane & 15)]
                                    [kk + (lane >> 4) * 16]);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            ptx::mma_s8(acc[mt][nt], af, bf[nt / 2][2 * (nt % 2)],
                        bf[nt / 2][2 * (nt % 2) + 1]);
          }
        }
      }
    }
    // one rescale of the whole sum, then the bias
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int n = n0 + wn * 32 + nt * 8 + 2 * (lane % 4);
      if (n >= a.N) continue;
      const float s_lo = a.scale[n], s_hi = a.scale[n + 1];
      const float b_lo = a.bias[n], b_hi = a.bias[n + 1];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int m = m0 + wm * 64 + mt * 16 + lane / 4 + 8 * e;
          if (m < a.M) {
            *reinterpret_cast<float2*>(a.xw + static_cast<size_t>(m) * a.N +
                                       n) = make_float2(
                __fadd_rn(__fmul_rn(static_cast<float>(acc[mt][nt][2 * e]),
                                    s_lo),
                          b_lo),
                __fadd_rn(__fmul_rn(static_cast<float>(acc[mt][nt][2 * e + 1]),
                                    s_hi),
                          b_hi));
          }
        }
      }
    }
    ptx::cp_async_wait<0>();
    __syncthreads();  // every stage is read before the next rows' loads
  }
}

// Raise the kernel's dynamic shared-memory limit once per device.
template <bool kVec>
cudaError_t raise_limit(int device) {
  static std::atomic<bool> raised[kMaxDevices];
  const bool cached = device >= 0 && device < kMaxDevices;
  if (cached && raised[device].load(std::memory_order_acquire)) {
    return cudaSuccess;
  }
  const cudaError_t err = cudaFuncSetAttribute(
      projection_kernel<kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kStages * sizeof(Stage)));
  if (err != cudaSuccess) return err;
  if (cached) raised[device].store(true, std::memory_order_release);
  return cudaSuccess;
}

// xw = f32([x0 x1] @ W) * scale + bias for M rows and N columns (N even);
// w_t is W k-major, (N, F0 + F1).  xw must start on 8 bytes.
inline cudaError_t launch_projection(const int8_t* x0, const int8_t* x1,
                                     int F0, int F1, const int8_t* w_t,
                                     const float* scale, const float* bias,
                                     float* xw, int M, int N,
                                     cudaStream_t stream) {
  if (F0 <= 0 || F1 < 0 || M <= 0 || N <= 0 || N % 2 != 0 ||
      (F1 > 0 && x1 == nullptr) || scale == nullptr || bias == nullptr ||
      reinterpret_cast<uintptr_t>(xw) % 8 != 0) {
    return cudaErrorInvalidValue;
  }
  auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  // cp.async where every row of x and W starts on 16 bytes
  const bool vec = F0 % 16 == 0 && F1 % 16 == 0 && aligned(x0) &&
                   aligned(x1) && aligned(w_t);
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = vec ? raise_limit<true>(device) : raise_limit<false>(device);
  if (err != cudaSuccess) return err;
  Args a{x0, x1, w_t, scale, bias, xw, F0, F1, M, N};
  const int m_tiles = (M + kBM - 1) / kBM;
  const dim3 grid((N + kBN - 1) / kBN, m_tiles < 65535 ? m_tiles : 65535);
  const size_t smem = kStages * sizeof(Stage);
  if (vec) {
    projection_kernel<true><<<grid, kThreads, smem, stream>>>(a);
  } else {
    projection_kernel<false><<<grid, kThreads, smem, stream>>>(a);
  }
  return cudaGetLastError();
}

}  // namespace

}  // namespace i8
