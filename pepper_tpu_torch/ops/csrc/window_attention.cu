// One encoder layer's self-attention of the transformer window classifier
// (models/alternates.py, PEPPER's simple_model_transformers.py), for
// Hopper (sm_90a).  It replaces no TPU kernel: the JAX package runs this
// attention as plain XLA ops, and the port ran it as eager PyTorch ops
// (attention_kernel.window_attention_reference, its twin), which write the
// (B*8, 33, 33) scores to device memory and read them back several times.
//
//   out[b, i, h*13:(h+1)*13] = sum_j p[b, h, i, j] v[b, j, h]
//   p[b, h, i, :] = softmax_j(q[b, i, h] . k[b, j, h] / sqrt(13))
//
// from the packed qkv (B, 33, 312) = [q | k | v], the in-projection's bias
// already added, to the heads' concatenated output (B, 33, 104) before
// out_proj: T = 33 positions, 8 heads of width 13 (d_model 104), the
// variant mode's shapes, fixed at compile time.  float32 or bfloat16 in,
// the same dtype out; every sum and the softmax in float32.
//
// Design.  A CTA takes kWindows consecutive windows: it copies their qkv
// (contiguous in device memory) into shared memory as float32 with 16-byte
// loads, then one thread a (window, position, head) computes that query's
// output: its 13 q values in registers, a first pass over the 33 keys for
// the largest score, a second for the exponentials' sum and the weighted
// sum of v, in float32.  A warp's threads hold 8 heads of 4 positions:
// its reads of k and v broadcast one row, the 8 heads 13 words apart on
// distinct banks (two rows where a warp spans two windows).  Each thread
// writes its 13 outputs over its own q in shared memory, and the CTA
// stores the windows' outputs with coalesced writes.  No score leaves the
// SM.
//
// Bound.  It must read the qkv and write the output once: 33 x 416 values
// a window, 112.5 MB at 4,096 bfloat16 windows, 33.6 us at 3.35 TB/s; its
// 453,024 FLOP a window (1.86 GFLOP) take 1.9 us at the bfloat16 peak, but
// width 13 fits no tensor-core shape, so they run as float32 FMAs (28 us at
// 67 TFLOP/s): the two are of one size.
//
// Binding: a plain C launcher (no PyTorch headers) loaded with ctypes; it
// launches on the caller's stream and returns the first CUDA error.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <atomic>

namespace {

constexpr int kT = 33;                 // positions a window
constexpr int kHeads = 8;
constexpr int kWidth = 13;             // a head's width
constexpr int kD = kHeads * kWidth;    // 104
constexpr int kRow = 3 * kD;           // 312: one position's q, k, v
constexpr int kWindows = 2;            // windows a CTA
constexpr int kTasks = kWindows * kT * kHeads;   // 528 queries a CTA
constexpr int kThreads = 544;          // 17 warps: one query a thread
constexpr int kSmemBytes = kWindows * kT * kRow * 4;
constexpr int kMaxDevices = 64;
std::atomic<int> smem_set[2][kMaxDevices];

static_assert(kThreads >= kTasks && kThreads % 32 == 0, "one query a thread");
static_assert((kT * kRow) % 8 == 0, "a window's qkv is whole 16-byte vectors");
static_assert(kD % 2 == 0, "output rows are whole pairs");

__device__ __forceinline__ void load_vector(const float* src, float* dst) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
}

__device__ __forceinline__ void load_vector(const __nv_bfloat16* src,
                                            float* dst) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* pairs = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(pairs[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store_pair(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}

__device__ __forceinline__ void store_pair(__nv_bfloat16* dst, float a,
                                           float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    window_attention_kernel(const T* __restrict__ qkv, T* __restrict__ out,
                            int batch) {
  extern __shared__ float4 smem_vectors[];
  float* rows = reinterpret_cast<float*>(smem_vectors);
  constexpr int kVector = 16 / sizeof(T);
  const int first = blockIdx.x * kWindows;
  const int windows = min(kWindows, batch - first);
  const int tid = static_cast<int>(threadIdx.x);

  const T* src = qkv + static_cast<long long>(first) * kT * kRow;
  const int vectors = windows * kT * kRow / kVector;
  for (int v = tid; v < vectors; v += kThreads) {
    load_vector(src + v * kVector, rows + v * kVector);
  }
  __syncthreads();

  const int w = tid / (kT * kHeads);
  const int i = (tid / kHeads) % kT;
  const int h = tid % kHeads;
  const bool live = tid < kTasks && w < windows;
  // log2(e) / sqrt(13): the scores in base 2, scaled
  const float scale = 1.4426950408889634f * 0.2773500981126146f;
  float* query = rows + (w * kT + i) * kRow + h * kWidth;
  float acc[kWidth];
  if (live) {
    const float* keys = rows + w * kT * kRow + kD + h * kWidth;
    float q[kWidth];
#pragma unroll
    for (int d = 0; d < kWidth; ++d) q[d] = query[d] * scale;
    float top = -CUDART_INF_F;
    for (int j = 0; j < kT; ++j) {
      const float* k = keys + j * kRow;
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < kWidth; ++d) s = fmaf(q[d], k[d], s);
      top = fmaxf(top, s);
    }
    float sum = 0.f;
#pragma unroll
    for (int d = 0; d < kWidth; ++d) acc[d] = 0.f;
    for (int j = 0; j < kT; ++j) {
      const float* k = keys + j * kRow;
      const float* v = k + kD;
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < kWidth; ++d) s = fmaf(q[d], k[d], s);
      const float p = exp2f(s - top);
      sum += p;
#pragma unroll
      for (int d = 0; d < kWidth; ++d) acc[d] = fmaf(p, v[d], acc[d]);
    }
    const float norm = 1.f / sum;
#pragma unroll
    for (int d = 0; d < kWidth; ++d) acc[d] *= norm;
  }
  // every thread has read what it needs of the rows before any q is
  // overwritten by an output
  __syncthreads();
  if (live) {
#pragma unroll
    for (int d = 0; d < kWidth; ++d) query[d] = acc[d];
  }
  __syncthreads();

  T* dst = out + static_cast<long long>(first) * kT * kD;
  const int pairs = windows * kT * kD / 2;
  for (int p = tid; p < pairs; p += kThreads) {
    const int e = 2 * p;
    const float* o = rows + (e / kD) * kRow + e % kD;
    store_pair(dst + e, o[0], o[1]);
  }
}

template <typename T>
cudaError_t launch(const void* qkv, void* out, int batch,
                   cudaStream_t stream, int kind) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const bool cached = device >= 0 && device < kMaxDevices;
  if (!cached || !smem_set[kind][device].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(window_attention_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
    if (err != cudaSuccess) return err;
    if (cached) smem_set[kind][device].store(1, std::memory_order_release);
  }
  const int blocks = (batch + kWindows - 1) / kWindows;
  window_attention_kernel<T><<<blocks, kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(qkv), static_cast<T*>(out), batch);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16.  qkv: (batch, 33, 312) contiguous, 16-byte
// aligned; out: (batch, 33, 104) contiguous, 4-byte aligned.  Launches
// nothing for an empty batch.  Returns a cudaError_t value (0 on success).
int window_attention_launch(int dtype, const void* qkv, void* out, int batch,
                            void* stream) {
  if (batch < 0 || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dtype == 0 ? launch<float>(qkv, out, batch, s, 0)
                                     : launch<__nv_bfloat16>(qkv, out, batch,
                                                             s, 1));
}

const char* window_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
