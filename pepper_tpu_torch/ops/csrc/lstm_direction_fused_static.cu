// One LSTM direction with static int8 streams, for Hopper (sm_90a).
// Replaces the TPU kernel
// pepper_tpu/ops/lstm_kernel.py::lstm_direction_fused_static (body
// _make_fused_kernel_static), the kernel of the static int8 serving modes.
// Per step, with t running T-1..0 when `reverse`:
//
//   gates = b                                                   (f32)
//   float x:  gates += sum_i x_i[t] @ W_ih_i                    (f32 sums)
//   int8 x:   gates += f32(sum_i x_i[t] @ W_ih_i) * acc_scale   (int32 sums)
//   float W_hh: gates += bf(h) @ W_hh                           (f32 sums)
//   int8 W_hh:  gates += f32(round(h*127) @ W_hh) * rec_scale   (int32 sums)
//   i, f, g, o = sigmoid, sigmoid, tanh, sigmoid ; c = f*c + i*g ;
//   h = o * tanh(c)                                             (f32 state)
//   out[t] = round(h*127) as int8, or h in float32 / bfloat16
//
// bf(h) is h rounded to W_hh's dtype.  Float x parts and W_ih share one
// dtype (float32 or bfloat16), and a float W_hh has that dtype too; int8 x
// (codes of tanh-bounded streams, scale exactly 1/127) takes a float32 or
// bfloat16 W_hh, or an int8 one.  round() is round-half-to-even
// (__float2int_rn), as jnp.round and torch.round are: the int8 recurrence
// feeds its own codes back, so a different tie rule would drift.  The int32
// sums of both parts are taken before the single rescale, and the rescales
// use __fmul_rn/__fadd_rn, so no multiply-add is contracted: those steps
// round exactly as the plain version's separate multiply and add.  In the
// same way every float product is summed apart from zero and joined with
// a rounded add in the plain version's order, gates = (b + x-part) +
// recurrent part, and the cell update's products and sum round apart:
// codes move with a gate's last bit.
//
// Design.  Two bodies, by combination.
// (a) lstm_core.cuh, for every combination with int8 codes out (the static
// and static_rec serving modes in bfloat16 and in float32): the
// tensor-core recurrence with W_hh split over a cluster, with int8 codes
// out and a float32 bias.  bf16 x of at most kXMax (32) features (the
// bfloat16 encoder's 26) joins the step's product as the float kernel's
// does; int8 x (the decoder's 2 x 256 codes) is first projected for all
// T*B rows by int8_projection.cuh (mma.sync m16n8k32 s8 on the tensor
// cores) into a float32 xw scratch the caller allocates, xw = b + f32(acc)
// * acc_scale (f32, as the TPU kernel's gates: bf16 would change the
// math), and the core's hoisted body runs over it.  bf16 x of more than
// kXMax features (the HP classifier's 48-feature encoder) is projected the
// same way by the core's bf16 projection, xw = b + x @ W_ih with the codes
// kinds' sums (each k16 step's product from zero, joined by rounded adds;
// the float32 bias added last, as the plain version adds it); float32 x
// (the float32 encoders' 26 or 48) by the core's float32 projection
// (float32 FMAs in k order, then b).  A bf16 or int8 W_hh runs the bf16
// core: an int8 one (static_rec) is held k-major in the cluster's shared
// memory and multiplied by the codes of h on the s8 tensor cores.  A
// float32 W_hh (the float32 static mode) runs the float32 core's codes
// kind: W_hh over a cluster of H/32 CTAs, 3xTF32 products on mma.sync
// m16n8k8, the recurrent part summed apart and added to xw[t] after it.
// int8 weights arrive k-major ((N, K), relaid once per weight tree:
// ops/cuda_build.py:int8_kmajor), W_ih as one (4H, F0 + F1) matrix for
// both parts.
// (b) The first body, for the float epilogue (out_int8=False) alone,
// which no served mode runs (the JAX package's callers pass out_int8=True
// too).  The layout of lstm_cell.cuh:
// a block owns kRows batch rows for all T steps, thread j owns hidden unit
// j and its four gate columns, c stays in registers; while a float part
// is summed from zero, the gates' first sum waits in shared memory, so the
// sums take no more registers than the gates (a second array of them
// halved the blocks an SM holds).  Float streams take
// the float path of lstm_cell.cuh.  The int8 products run on __dp4a, four
// k at a time: the int8 x rows are staged in shared memory as 32-bit words
// of four consecutive features ([k/4][row]), the h codes likewise, and the
// wrapper hands int8 weights over packed into k-quads ([k/4][4H] words,
// byte i = row 4*(k/4)+i), so thread j reads one word per gate column and
// k-quad, coalesced across the warp.
//
// Bound.  At B=4096, T=33, H=256 the work is far above the card's ridge
// point for the products: the static decoder does 141.7 GOP of int8 (0.072
// ms at 1,979 TOP/s) and 70.9 GFLOP of bf16 products (0.072 ms at 989
// TFLOP/s).  Its projection is bound by the f32 xw it writes instead (553
// MB, 0.165 ms); the recurrence, as the float kernel's, by its serial chain
// of 33 steps, each ending in an exchange of h across the cluster.  In
// float32 the same 70.9 GFLOP of the recurrence take 0.430 ms as 3xTF32
// (1.058 as float32 FMAs), and the encoder's 78.1 GFLOP 0.473 ms.
//
// Binding: a plain C launcher (no PyTorch headers) loaded with ctypes; it
// launches on the caller's stream and returns cudaGetLastError().

#include <type_traits>

#include "int8_projection.cuh"
#include "lstm_core.cuh"

namespace {

using lstm::kMaxHidden;
using lstm::kRows;

// Stage rows [b0, b0+kRows) of the int8 x[t] (F_part features, a multiple
// of 4) into s[k/4][r] as words of four features; zeros past the batch.
__device__ __forceinline__ void stage_quads(int* __restrict__ s,
                                            const int8_t* __restrict__ x,
                                            int F_part, int t, int B,
                                            int b0) {
  const int FQ = F_part / 4;
  const int* xq = reinterpret_cast<const int*>(x);
  const size_t base = static_cast<size_t>(t) * B;
  for (int idx = threadIdx.x; idx < kRows * FQ; idx += blockDim.x) {
    const int r = idx / FQ;
    const int kq = idx - r * FQ;
    const int row = b0 + r;
    s[kq * kRows + r] = row < B ? xq[(base + row) * FQ + kq] : 0;
  }
}

// acc[r][q] += sum over k-quads of dp4a(s[kq][r], w[kq][q*H + j]).
__device__ __forceinline__ void accumulate_quads(int (&acc)[kRows][4],
                                                 const int* __restrict__ s,
                                                 const int* __restrict__ w,
                                                 int KQ, int H, int j) {
  const int G = 4 * H;
#pragma unroll 2
  for (int kq = 0; kq < KQ; ++kq) {
    const int* wk = w + static_cast<size_t>(kq) * G + j;
    const int wq[4] = {wk[0], wk[H], wk[2 * H], wk[3 * H]};
    const int4* sk = reinterpret_cast<const int4*>(s + kq * kRows);
#pragma unroll
    for (int v = 0; v < kRows / 4; ++v) {
      const int4 x = sk[v];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        acc[4 * v + 0][q] = __dp4a(x.x, wq[q], acc[4 * v + 0][q]);
        acc[4 * v + 1][q] = __dp4a(x.y, wq[q], acc[4 * v + 1][q]);
        acc[4 * v + 2][q] = __dp4a(x.z, wq[q], acc[4 * v + 2][q]);
        acc[4 * v + 3][q] = __dp4a(x.w, wq[q], acc[4 * v + 3][q]);
      }
    }
  }
}

__device__ __forceinline__ void fill(float (&gates)[kRows][4],
                                     const float (&v)[4]) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int q = 0; q < 4; ++q) gates[r][q] = v[q];
  }
}

// gates[r][q] = v[q] + gates[r][q], rounded to nearest.
__device__ __forceinline__ void add_first(float (&gates)[kRows][4],
                                          const float (&v)[4]) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int q = 0; q < 4; ++q) gates[r][q] = __fadd_rn(v[q], gates[r][q]);
  }
}

// The sum so far of thread j's gates, parked in shared memory
// ([r * 4 + q][kMaxHidden] floats: a constant stride keeps the 64
// addresses immediate offsets, not registers) while the next part is
// summed from zero in the same registers.  The empty asm statements with
// a memory clobber keep the compiler from sinking the stores below, or
// hoisting add_parked's loads above, the next part's loop: either would
// hold 64 more values in registers across it.
__device__ __forceinline__ void park(float* __restrict__ parked,
                                     const float (&gates)[kRows][4], int j) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      parked[(r * 4 + q) * kMaxHidden + j] = gates[r][q];
    }
  }
  asm volatile("" ::: "memory");
}

// gates[r][q] = parked + gates[r][q], rounded to nearest.
__device__ __forceinline__ void add_parked(float (&gates)[kRows][4],
                                           const float* __restrict__ parked,
                                           int j) {
  asm volatile("" ::: "memory");
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      gates[r][q] =
          __fadd_rn(parked[(r * 4 + q) * kMaxHidden + j], gates[r][q]);
    }
  }
}

// gates[r][q] = gates[r][q] + f32(acc[r][q]) * scale[q], rounded as two
// separate operations.
__device__ __forceinline__ void add_rescaled(float (&gates)[kRows][4],
                                             const int (&acc)[kRows][4],
                                             const float (&scale)[4]) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      gates[r][q] = __fadd_rn(
          gates[r][q], __fmul_rn(static_cast<float>(acc[r][q]), scale[q]));
    }
  }
}

constexpr int kOutF32 = 0;
constexpr int kOutBf16 = 1;
constexpr int kOutInt8 = 2;

// TX: the dtype of x (float, __nv_bfloat16 or int8_t); TW: that of W_hh.
// w0/w1 are TX for float x and k-quad words for int8 x; w_hh is TW for a
// float W_hh and k-quad words for an int8 one.
template <typename TX, typename TW>
__global__ void __launch_bounds__(kMaxHidden)
    lstm_static_kernel(const TX* __restrict__ x0, const TX* __restrict__ x1,
                       const void* __restrict__ w0,
                       const void* __restrict__ w1, int F0, int F1,
                       const float* __restrict__ acc_scale,
                       const float* __restrict__ rec_scale,
                       const float* __restrict__ bias,
                       const void* __restrict__ w_hh, void* __restrict__ out,
                       int out_kind, int steps, int B, int H, int reverse) {
  constexpr bool kIntX = std::is_same<TX, int8_t>::value;
  constexpr bool kIntRec = std::is_same<TW, int8_t>::value;
  extern __shared__ __align__(16) float smem[];
  // x rows: floats [F][kRows], or words [F/4][kRows] for int8 x
  const int x_words = (kIntX ? (F0 + F1) / 4 : F0 + F1) * kRows;
  float* xs = smem;
  int* xq = reinterpret_cast<int*>(smem);
  // h: floats [H][kRows], or code words [H/4][kRows] for an int8 W_hh
  float* hs = smem + x_words;
  int* hq = reinterpret_cast<int*>(hs);
  int8_t* hq_bytes = reinterpret_cast<int8_t*>(hs);
  // the gates' first sum, parked while a float part is summed from zero
  float* parked = hs + (kIntRec ? H * kRows / 4 : H * kRows);
  const float zeros[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  const int j = threadIdx.x;
  const int b0 = static_cast<int>(blockIdx.x) * kRows;

  const float b_q[4] = {bias[j], bias[H + j], bias[2 * H + j],
                        bias[3 * H + j]};
  float a_q[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float r_q[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (kIntX) {
#pragma unroll
    for (int q = 0; q < 4; ++q) a_q[q] = acc_scale[q * H + j];
  }
  if (kIntRec) {
#pragma unroll
    for (int q = 0; q < 4; ++q) r_q[q] = rec_scale[q * H + j];
  }

  float c[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) c[r] = 0.0f;
  if (kIntRec) {
    for (int idx = j; idx < (H / 4) * kRows; idx += blockDim.x) hq[idx] = 0;
  } else {
#pragma unroll
    for (int r = 0; r < kRows; ++r) hs[j * kRows + r] = 0.0f;
  }

  for (int step = 0; step < steps; ++step) {
    const int t = reverse ? steps - 1 - step : step;
    if constexpr (kIntX) {
      stage_quads(xq, reinterpret_cast<const int8_t*>(x0), F0, t, B, b0);
      if (F1 > 0) {
        stage_quads(xq + (F0 / 4) * kRows,
                    reinterpret_cast<const int8_t*>(x1), F1, t, B, b0);
      }
    } else {
      lstm::stage(xs, x0, F0, t, B, b0);
      if (F1 > 0) lstm::stage(xs + F0 * kRows, x1, F1, t, B, b0);
    }
    __syncthreads();  // x staged; last step's h visible

    // gates = (b + x-part) + recurrent part, each float part summed from
    // zero and joined with a rounded add, as the plain version sums them
    float gates[kRows][4];
    if constexpr (kIntX) {
      int acc[kRows][4];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = 0;
      }
      accumulate_quads(acc, xq, static_cast<const int*>(w0), F0 / 4, H, j);
      if (F1 > 0) {
        accumulate_quads(acc, xq + (F0 / 4) * kRows,
                         static_cast<const int*>(w1), F1 / 4, H, j);
      }
      fill(gates, b_q);
      add_rescaled(gates, acc, a_q);
    } else {
      fill(gates, zeros);
      lstm::accumulate(gates, xs, static_cast<const TX*>(w0), F0, H, j);
      add_first(gates, b_q);
      if (F1 > 0) {
        park(parked, gates, j);
        fill(gates, zeros);
        lstm::accumulate(gates, xs + F0 * kRows, static_cast<const TX*>(w1),
                         F1, H, j);
        add_parked(gates, parked, j);
      }
    }
    if constexpr (kIntRec) {
      int acc[kRows][4];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = 0;
      }
      accumulate_quads(acc, hq, static_cast<const int*>(w_hh), H / 4, H, j);
      add_rescaled(gates, acc, r_q);
    } else {
      park(parked, gates, j);
      fill(gates, zeros);
      lstm::accumulate(gates, hs, static_cast<const TW*>(w_hh), H, H, j);
      add_parked(gates, parked, j);
    }
    __syncthreads();  // every thread is done reading the staged x and h

    const size_t base = static_cast<size_t>(t) * B;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float ig = lstm::sigmoid(gates[r][0]);
      const float fg = lstm::sigmoid(gates[r][1]);
      const float gg = tanhf(gates[r][2]);
      const float og = lstm::sigmoid(gates[r][3]);
      c[r] = __fadd_rn(__fmul_rn(fg, c[r]), __fmul_rn(ig, gg));
      const float h = __fmul_rn(og, tanhf(c[r]));
      if constexpr (kIntRec) {
        // unit j is byte j%4 of word [j/4][r]
        hq_bytes[((j >> 2) * kRows + r) * 4 + (j & 3)] =
            lstm::from_f32<int8_t>(h);
      } else {
        hs[j * kRows + r] = lstm::to_f32(lstm::from_f32<TW>(h));
      }
      const int row = b0 + r;
      if (row < B) {
        const size_t o = (base + row) * H + j;
        if (out_kind == kOutInt8) {
          static_cast<int8_t*>(out)[o] = lstm::from_f32<int8_t>(h);
        } else if (out_kind == kOutBf16) {
          static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(h);
        } else {
          static_cast<float*>(out)[o] = h;
        }
      }
    }
  }
}

template <typename TX, typename TW>
int launch(const void* x0, const void* x1, const void* w0, const void* w1,
           int F0, int F1, const float* acc_scale, const float* rec_scale,
           const float* bias, const void* w_hh, void* out, int out_kind,
           int steps, int B, int H, int reverse, cudaStream_t stream) {
  constexpr bool kIntX = std::is_same<TX, int8_t>::value;
  constexpr bool kIntRec = std::is_same<TW, int8_t>::value;
  const size_t x_bytes =
      static_cast<size_t>(F0 + F1) * kRows * (kIntX ? 1 : sizeof(float));
  const size_t h_bytes =
      static_cast<size_t>(H) * kRows * (kIntRec ? 1 : sizeof(float));
  // the parked sums, 4 gates x kRows floats a thread (int8 x and W_hh
  // sum no float part)
  const size_t park_bytes =
      kIntX && kIntRec ? 0 : kMaxHidden * kRows * 4 * sizeof(float);
  const size_t smem = x_bytes + h_bytes + park_bytes;
  auto kernel = lstm_static_kernel<TX, TW>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((B + kRows - 1) / kRows);
  kernel<<<grid, H, smem, stream>>>(
      static_cast<const TX*>(x0), static_cast<const TX*>(x1), w0, w1, F0, F1,
      acc_scale, rec_scale, bias, w_hh, out, out_kind, steps, B, H, reverse);
  return static_cast<int>(cudaGetLastError());
}

constexpr int kF32 = 0;
constexpr int kBf16 = 1;
constexpr int kInt8 = 2;

using bf16 = __nv_bfloat16;

bool valid_args(int x_dtype, int whh_dtype, int out_kind, int F0, int F1,
                const float* acc_scale, const float* rec_scale, int steps,
                int B, int H) {
  const bool int_x = x_dtype == kInt8;
  return lstm::valid_shape(F0, F1, steps, B, H) && out_kind >= kOutF32 &&
         out_kind <= kOutInt8 && x_dtype >= kF32 && x_dtype <= kInt8 &&
         whh_dtype >= kF32 && whh_dtype <= kInt8 &&
         (!int_x || (F0 % 4 == 0 && F1 % 4 == 0 && acc_scale != nullptr)) &&
         (whh_dtype != kInt8 || rec_scale != nullptr) &&
         // a float W_hh beside float x has x's dtype
         (int_x || whh_dtype == kInt8 || whh_dtype == x_dtype);
}

// Whether a combination runs on lstm_core.cuh (body (a)): every one with
// int8 codes out.  The wrapper (ops/lstm_kernel.py:static_on_core) applies
// the same rule to pick the weights' layout.
bool on_core(int out_kind) { return out_kind == kOutInt8; }

// xw = b + f32([x0 x1] @ W) * acc_scale for all steps * B rows; w_t is W
// k-major, (4H, F0 + F1)
cudaError_t project(const void* x0, const void* x1, int F0, int F1,
                    const void* w_t, const float* acc_scale,
                    const float* bias, float* xw, int steps, int B, int H,
                    cudaStream_t stream) {
  return i8::launch_projection(
      static_cast<const int8_t*>(x0), static_cast<const int8_t*>(x1), F0, F1,
      static_cast<const int8_t*>(w_t), acc_scale, bias, xw, steps * B,
      4 * H, stream);
}

// xw = b + [x0 x1] @ [w0; w1] in float32 for all steps * B rows with the
// codes kinds' sums and a float32 bias: the static kernels' bf16 x of more
// than kXMax features (the HP classifier's 48), which the core then runs
// over as over the int8 projection's xw.
cudaError_t project_bf16(const bf16* x0, const bf16* x1, int F0, int F1,
                         const bf16* w0, const bf16* w1, const float* bias,
                         float* xw, int steps, int B, int H,
                         cudaStream_t stream) {
  lstm::ProjArgs p{};
  p.x0 = x0;
  p.x1 = x1;
  p.F0 = F0;
  p.F1 = F1;
  p.M = steps * B;
  p.N = 4 * H;
  p.dir[0] = {w0, w1, bias, xw};
  return lstm::launch_projection<true>(p, 1, stream);
}

// The projection of any x into the float32 xw the core runs over: int8 x
// by the int8 projection (w0 k-major, (4H, F0 + F1), with acc_scale),
// bf16 x by project_bf16 and float32 x by the core's float32 projection
// (float32 FMAs in k order at the encoders' widths; then b is added, as
// the plain version adds it), w0 and w1 each part's (F_i, 4H).
cudaError_t project_any(int x_dtype, const void* x0, const void* x1, int F0,
                        int F1, const void* w0, const void* w1,
                        const float* acc_scale, const float* bias, float* xw,
                        int steps, int B, int H, cudaStream_t stream) {
  if (x_dtype == kInt8) {
    return project(x0, x1, F0, F1, w0, acc_scale, bias, xw, steps, B, H,
                   stream);
  }
  if (x_dtype == kBf16) {
    return project_bf16(static_cast<const bf16*>(x0),
                        static_cast<const bf16*>(x1), F0, F1,
                        static_cast<const bf16*>(w0),
                        static_cast<const bf16*>(w1), bias, xw, steps, B, H,
                        stream);
  }
  const void* b = bias;
  return lstm::launch_projections_f32(x0, x1, F0, F1, &w0, &w1, &b, &xw, 1,
                                      steps, B, H, stream);
}

// The core's recurrence over a float32 xw with int8 codes out: a float32
// W_hh (H, 4H) on the float32 core's codes kind, a bf16 one (H, 4H) or an
// int8 one (k-major (4H, H), with rec_scale) on the bf16 core's.
cudaError_t recur(int whh_dtype, const float* xw, const void* w_hh,
                  const float* rec_scale, int8_t* out, int reverse, int steps,
                  int B, int H, cudaStream_t stream) {
  if (whh_dtype == kF32) {
    return lstm::launch_static_f32(xw, w_hh, out, reverse, steps, B, H,
                                   stream);
  }
  return lstm::launch_static(nullptr, nullptr, 0, 0, nullptr, nullptr,
                             nullptr, xw, w_hh, whh_dtype == kInt8,
                             rec_scale, out, reverse, steps, B, H, stream);
}

}  // namespace

extern "C" {

// x_dtype, whh_dtype: 0 = float32, 1 = bfloat16, 2 = int8; out_kind:
// 0 = float32, 1 = bfloat16, 2 = int8 codes.  acc_scale is read for int8
// x, rec_scale for an int8 W_hh; bias is float32.  x1/w1 may be null with
// F1 == 0.  On the core (on_core: int8 codes out): an int8 W_ih is w0,
// k-major (4H, F0 + F1), w1 unused; an int8 W_hh is k-major (4H, H); int8
// x, float32 x, and bf16 x of more than 32 features, are projected into
// xw, a float32 scratch of steps * B * 4H values.  Otherwise (the float
// epilogue) int8 weights are in k-quad words (w0, w1 a part each) and xw
// is unused.  Returns a cudaError_t value (0 on success).
int lstm_direction_fused_static_launch(
    int x_dtype, int whh_dtype, int out_kind, const void* x0, const void* x1,
    const void* w0, const void* w1, int F0, int F1, const float* acc_scale,
    const float* rec_scale, const float* bias, const void* w_hh, float* xw,
    void* out, int steps, int B, int H, int reverse, void* stream) {
  if (!valid_args(x_dtype, whh_dtype, out_kind, F0, F1, acc_scale, rec_scale,
                  steps, B, H)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (on_core(out_kind)) {
    int8_t* codes = static_cast<int8_t*>(out);
    if (x_dtype == kBf16 && F0 + F1 <= lstm::kXMax) {
      return static_cast<int>(lstm::launch_static(
          static_cast<const bf16*>(x0), static_cast<const bf16*>(x1), F0,
          F1, static_cast<const bf16*>(w0), static_cast<const bf16*>(w1),
          bias, nullptr, w_hh, whh_dtype == kInt8, rec_scale, codes,
          reverse, steps, B, H, s));
    }
    const cudaError_t err = project_any(x_dtype, x0, x1, F0, F1, w0, w1,
                                        acc_scale, bias, xw, steps, B, H, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(recur(whh_dtype, xw, w_hh, rec_scale, codes,
                                  reverse, steps, B, H, s));
  }
#define PEPPER_STATIC_LAUNCH(TX, TW)                                       \
  launch<TX, TW>(x0, x1, w0, w1, F0, F1, acc_scale, rec_scale, bias, w_hh, \
                 out, out_kind, steps, B, H, reverse, s)
  if (x_dtype == kF32 && whh_dtype == kF32) {
    return PEPPER_STATIC_LAUNCH(float, float);
  }
  if (x_dtype == kF32 && whh_dtype == kInt8) {
    return PEPPER_STATIC_LAUNCH(float, int8_t);
  }
  if (x_dtype == kBf16 && whh_dtype == kBf16) {
    return PEPPER_STATIC_LAUNCH(bf16, bf16);
  }
  if (x_dtype == kBf16 && whh_dtype == kInt8) {
    return PEPPER_STATIC_LAUNCH(bf16, int8_t);
  }
  if (x_dtype == kInt8 && whh_dtype == kF32) {
    return PEPPER_STATIC_LAUNCH(int8_t, float);
  }
  if (x_dtype == kInt8 && whh_dtype == kBf16) {
    return PEPPER_STATIC_LAUNCH(int8_t, bf16);
  }
  if (x_dtype == kInt8 && whh_dtype == kInt8) {
    return PEPPER_STATIC_LAUNCH(int8_t, int8_t);
  }
#undef PEPPER_STATIC_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

// The projection of the core's path alone (its first launch where x does
// not join the step): xw = b + [x0 x1] @ W in float32 for all steps * B
// rows, x_dtype as above.  int8 x: W k-major (4H, F0 + F1), rescaled by
// acc_scale; float x: W the (F0 + F1, 4H) rows of both parts in x's dtype.
int lstm_direction_fused_static_projection_launch(
    int x_dtype, const void* x0, const void* x1, int F0, int F1,
    const void* w, const float* acc_scale, const float* bias, float* xw,
    int steps, int B, int H, void* stream) {
  if (!lstm::valid_shape(F0, F1, steps, B, H) || x_dtype < kF32 ||
      x_dtype > kInt8 || (x_dtype == kInt8 && acc_scale == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t item = x_dtype == kF32 ? sizeof(float) : sizeof(bf16);
  const void* w1 =
      x_dtype == kInt8 || F1 == 0
          ? nullptr
          : static_cast<const char*>(w) + static_cast<size_t>(F0) * 4 * H *
                                              item;
  return static_cast<int>(project_any(x_dtype, x0, x1, F0, F1, w, w1,
                                      acc_scale, bias, xw, steps, B, H,
                                      static_cast<cudaStream_t>(stream)));
}

// The core's recurrence over a float32 xw alone (its second launch):
// whh_dtype 0 = float32 (H, 4H), 1 = bfloat16 (H, 4H), 2 = int8 k-major
// (4H, H) with rec_scale; int8 codes out.
int lstm_direction_fused_static_recurrence_launch(
    int whh_dtype, const float* xw, const void* w_hh, const float* rec_scale,
    void* out, int steps, int B, int H, int reverse, void* stream) {
  if (!lstm::valid_steps(steps, B, H) || whh_dtype < kF32 ||
      whh_dtype > kInt8 || (whh_dtype == kInt8 && rec_scale == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(recur(whh_dtype, xw, w_hh, rec_scale,
                                static_cast<int8_t*>(out), reverse, steps, B,
                                H, static_cast<cudaStream_t>(stream)));
}

// The core's plan for one direction of B rows with a W_hh of whh_dtype (0
// float32: the float32 core's codes kind; 1 bfloat16, 2 int8: the bf16
// core's codes kinds), fused (bf16 x joins the step) or over xw: out[0]
// rows a cluster, out[1] CTAs a cluster, out[2] clusters, out[3] clusters
// that run at once.  Launches nothing.
int lstm_direction_fused_static_plan_launch(int whh_dtype, int B, int H,
                                            int fused, int* out,
                                            void* stream) {
  (void)stream;
  if (!lstm::valid_steps(1, B, H) || whh_dtype < kF32 || whh_dtype > kInt8 ||
      (whh_dtype == kF32 && fused)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(
      whh_dtype == kF32
          ? lstm::f32_plan(B, H, 1, out, true)
          : lstm::static_plan(B, H, fused != 0, whh_dtype == kInt8, out));
}

const char* lstm_direction_fused_static_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
