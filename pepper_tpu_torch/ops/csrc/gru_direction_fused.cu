// One GRU direction with the input projection, for Hopper (sm_90a).
// Replaces the TPU kernel pepper_tpu/ops/gru_kernel.py::gru_direction_fused
// (body _make_fused_gru_kernel), the polish consensus model's recurrence.
// Per step, with t running T-1..0 when `reverse`:
//
//   xw = sum_i x_i[t] @ W_ih_i + b_ih ;  hw = h @ W_hh + b_hh   (f32 sums)
//   r, z = sigmoid(xw + hw) of the first two H-wide slices
//   n = tanh(xw_n + r * hw_n) ;  h = (1 - z) * n + z * h       (f32 state)
//   out[t] = h rounded to x's dtype
//
// h starts from h0, the hidden state carried from the previous sliding
// window, and up to two feature parts x_0, x_1 stand for their
// concatenation (the decoder reads the encoder's forward and backward
// streams without a concat).  x and out are float32 or bfloat16; W_ih, W_hh,
// b_ih, b_hh and h0 are float32, as the polish consensus hands them over
// in both compute dtypes, so the recurrent product reads h unrounded.  The
// caller takes the carried state from out's last step (its first when
// reversed), in out's dtype, as the TPU kernel's caller does.
//
// Design: two launches on the caller's stream, from one launcher; the
// projection alone is exported too, so that it can be timed apart.
// (1) The input projection, which does not depend on h, leaves the serial
// loop: xw = [x_0 x_1] @ [W_ih_0; W_ih_1] + b_ih for all T*B rows at once,
// into a float32 scratch (T, B, 3H) that the caller allocates (19.7 MB at
// B=128, H=128: it stays in the 50 MB L2).  A tiled f32 product on the CUDA
// cores: 64 x 128 output tiles, 256 threads of 4 x 8 outputs, k-tiles of
// 16 staged in shared memory (x transposed, so each k reads the rows as
// 16-byte broadcasts) and the next k-tile loaded into registers while the
// current one computes.  The TPU kernel fused the projection into the step
// to save xw's round trip to HBM; here the round trip stays in L2 and the
// product runs at the width of the whole card instead of inside each step.
// (2) The recurrence over xw: gru_core.cuh, h unrounded (TH = float).
//
// Bound.  2*T*B*(F+H)*3H operations (1.36 GFLOP for the encoder and 3.77
// GFLOP for the decoder at T=100, B=128, H=128) against x in and h out:
// operations bound it.  The projection (2/3 of the decoder's operations)
// runs at a share of the f32 rate on the CUDA cores, 103 registers a thread
// leaving two blocks an SM; the recurrence is held back by the latency of
// its serial steps (gru_core.cuh, gru_recurrence.cu).
//
// Binding: a plain C launcher (no PyTorch headers) loaded with ctypes; it
// launches on the caller's stream and returns cudaGetLastError().

#include <climits>

#include "gru_core.cuh"

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

// w[k][n..n+3] of the stacked parts; zero past K or N (N % 4 == 0)
__device__ __forceinline__ float4 w_at(const float* __restrict__ w0,
                                       const float* __restrict__ w1, int F0,
                                       int F1, int N, int k, int n) {
  if (n >= N || k >= F0 + F1) return make_float4(0.f, 0.f, 0.f, 0.f);
  const float* row = k < F0 ? w0 + static_cast<size_t>(k) * N
                            : w1 + static_cast<size_t>(k - F0) * N;
  return *reinterpret_cast<const float4*>(row + n);
}

template <typename TX>
__global__ void __launch_bounds__(kThreads)
    projection_kernel(const TX* __restrict__ x0, const TX* __restrict__ x1,
                      const float* __restrict__ w0,
                      const float* __restrict__ w1, int F0, int F1,
                      const float* __restrict__ b_ih, float* __restrict__ xw,
                      int M, int N) {
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

bool valid(int x_dtype, const float* w0, const float* w1, int F0, int F1,
           int steps, int B, int H) {
  return (x_dtype == 0 || x_dtype == 1) && H > 0 && H <= gru::kMaxHidden &&
         H % 32 == 0 && F0 > 0 && F1 >= 0 && steps > 0 && B > 0 &&
         static_cast<long long>(steps) * B <= INT_MAX &&
         reinterpret_cast<uintptr_t>(w0) % 16 == 0 &&
         (F1 == 0 || reinterpret_cast<uintptr_t>(w1) % 16 == 0);
}

// xw = [x0 x1] @ [w0; w1] + b_ih for all steps * B rows
cudaError_t project(int x_dtype, const void* x0, const void* x1,
                    const float* w0, const float* w1, int F0, int F1,
                    const float* b_ih, float* xw, int steps, int B, int H,
                    cudaStream_t stream) {
  const int M = steps * B;
  const int N = 3 * H;
  const dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN);
  if (x_dtype == 0) {
    projection_kernel<float><<<grid, kThreads, 0, stream>>>(
        static_cast<const float*>(x0), static_cast<const float*>(x1), w0, w1,
        F0, F1, b_ih, xw, M, N);
  } else {
    using bf16 = __nv_bfloat16;
    projection_kernel<bf16><<<grid, kThreads, 0, stream>>>(
        static_cast<const bf16*>(x0), static_cast<const bf16*>(x1), w0, w1,
        F0, F1, b_ih, xw, M, N);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x_dtype: 0 = float32, 1 = bfloat16 (x0, x1 and out); the weights, biases
// and h0 are float32, W_ih and W_hh 16-byte aligned.  x1/w1 may be null
// with F1 == 0.  xw: a float32 scratch of steps * B * 3H values.  Runs the
// projection into xw, then the recurrence over it.  Returns a cudaError_t
// value (0 on success).
int gru_direction_fused_launch(int x_dtype, const void* x0, const void* x1,
                               const float* w0, const float* w1, int F0,
                               int F1, const float* b_ih, const float* w_hh,
                               const float* b_hh, const float* h0, float* xw,
                               void* out, int steps, int B, int H,
                               int reverse, void* stream) {
  if (!valid(x_dtype, w0, w1, F0, F1, steps, B, H)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      project(x_dtype, x0, x1, w0, w1, F0, F1, b_ih, xw, steps, B, H, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (x_dtype == 0) {
    return static_cast<int>(gru::launch_core<float, float, float>(
        xw, w_hh, b_hh, h0, static_cast<float*>(out), steps, B, H, reverse,
        s));
  }
  return static_cast<int>(gru::launch_core<float, __nv_bfloat16, float>(
      xw, w_hh, b_hh, h0, static_cast<__nv_bfloat16*>(out), steps, B, H,
      reverse, s));
}

// The projection alone (the first of the two launches), with the same
// arguments: xw = [x0 x1] @ [w0; w1] + b_ih for all steps * B rows.
int gru_direction_fused_projection_launch(int x_dtype, const void* x0,
                                          const void* x1, const float* w0,
                                          const float* w1, int F0, int F1,
                                          const float* b_ih, float* xw,
                                          int steps, int B, int H,
                                          void* stream) {
  if (!valid(x_dtype, w0, w1, F0, F1, steps, B, H)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(project(x_dtype, x0, x1, w0, w1, F0, F1, b_ih, xw,
                                  steps, B, H,
                                  static_cast<cudaStream_t>(stream)));
}

const char* gru_direction_fused_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
