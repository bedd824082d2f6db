// The LSTM core that lstm_direction_fused.cu, bilstm_dual_fused.cu,
// lstm_recurrence.cu and lstm_direction_fused_static.cu share, for Hopper
// (sm_90a): the bfloat16 core below and, at the end of this file, its
// float32 kind (3xTF32 products; the float kernels' float32 path, and with
// int8 codes out the static kernel's float32 W_hh).  Together with the
// input projection below it replaces the bf16 path of the TPU kernels
// pepper_tpu/ops/lstm_kernel.py::lstm_direction_fused (body
// _make_fused_kernel) and ::bilstm_dual_fused (body _make_dual_kernel), and
// alone the bf16 path of ::lstm_recurrence_pallas (body _lstm_kernel), whose
// xw the caller computed: per step, with t running T-1..0 for a reversed
// direction,
//
//   gates = f32(b) + sum_i x_i[t] @ W_ih_i + bf(h) @ W_hh      (f32 sums)
//         = f32(xw[t]) + bf(h) @ W_hh                (over a precomputed xw)
//   i, f, g, o = sigmoid, sigmoid, tanh, sigmoid of the four H-wide slices
//   c = f * c + i * g ;  h = o * tanh(c)                        (f32 state)
//   out[t] = h rounded to bfloat16
//
// where bf(h) is h rounded to bfloat16 before the recurrent product.
//
// Bound.  2*T*B*(F+H)*4H operations, far above the card's ridge point at
// the serving shapes (B=4096, T=33, H=256): 0.079 ms for the encoder
// (F=26) and 0.215 ms for the decoder (F=512) on the bf16 tensor cores.
// What holds a step back is the serial chain instead: a step's product
// needs the whole of the last step's h, so every step ends in an exchange
// of h; the 4H x H recurrent weight (512 KB in bf16 at H=256) is more than
// one SM's shared memory; and the gates' nonlinearities (five a cell) load
// the special-function unit as much as the product loads the tensor cores.
//
// Design.
// * The recurrent product runs on the tensor cores, mma.sync m16n8k16
//   bf16 -> f32, with ldmatrix fragments from shared memory; c and h stay
//   f32 in registers.
// * W_hh is split over a thread-block cluster of n CTAs (n = 1, 2 or 4:
//   the smallest power of two with H/n <= 64).  CTA `rank` holds the four
//   gate columns of units [rank*U, rank*U + U), U = H/n, so each thread's
//   accumulator fragments hold all four gates of its cells and the cell
//   update needs no exchange.  Its slice (H x 4U bf16, 128 KB at H=256) is
//   copied into shared memory once, with cp.async, and never leaves it.
// * One warp per group of 8 units: the warp's four n8 tiles are the
//   i, f, g, o columns of those units.
// * A cluster owns R batch rows for all T steps, in chunks of kMT m16
//   tiles: a warp runs one chunk's product, then its cell, then the next
//   chunk's product, so one warp's cell (special-function and FMA pipes)
//   runs beside another's product, and only one chunk's accumulators are
//   live.  After the last cell each CTA writes its slice of bf(h) into its
//   own A tile and pushes it into every peer's through distributed shared
//   memory (st.shared::cluster); two cluster barriers a step (split
//   arrive/wait, so the last cell runs while the slowest CTA finishes its
//   product) order the exchange.
// * Rows a cluster (pick_rows): the fewest of 16, 32, 48, 96 and 144 whose
//   clusters all run in one wave by cudaOccupancyMaxActiveClusters.  An
//   H100 SXM runs 30 clusters of 4 such CTAs at once (120 SMs), so B=4096
//   takes 144 rows: 29 clusters.
// * Input features, by where W_ih fits.  At most kXMax of them (the
//   encoder's 26 window values): x[t] joins bf(h) in the A tile as 32 more
//   columns of K, W_ih's slice stays in registers as each warp's B
//   fragments, and the step's one product takes both, so no xw is written.
//   More (the decoder's 2 x 256 encoder streams): W_ih does not fit beside
//   W_hh's slice, so the product leaves the loop: `projection_kernel`, a
//   tiled bf16 tensor-core product of its own, writes xw = [x_0 x_1] @
//   [W_ih_0; W_ih_1] + b in float32 for all T*B rows (xw is not rounded to
//   bf16, which would change the math), and each chunk's accumulators start
//   from xw[t], loaded one chunk ahead.  lstm_recurrence runs the same
//   hoisted body over the bf16 xw its caller computed: xw's element type
//   is a template parameter (XW, float by default), and a thread loads its
//   two adjacent units' xw as one float2 or one bfloat162, widened to f32;
//   a bf16 xw halves the bytes a step streams.
// * The nonlinearities: sigmoid(v) = 1/(1 + e^-v), tanh(v) = 1 - 2/(1 +
//   e^2v), e^v by ex2 on the special-function unit and the reciprocal by
//   Newton steps on the FMA pipe, within 2e-7 of the library functions.
//
// * The static kernel (lstm_direction_fused_static.cu) runs the same core
//   with a float32 bias and out as it asks (Direction::out_kind): int8
//   codes (TO = int8_t marks these kinds: round(h * 127), ties to even),
//   or h in float32 or bfloat16, the value the codes are rounded from.
//   static keeps the bf16 W_hh above (in float32 its float32 W_hh runs the
//   float32 core's codes kind, at the end of this file, in the same order
//   of sums).  static_rec's int8 W_hh arrives k-major (4H, H); each CTA
//   holds its slice (4U x H codes, 64 KB at H=256) in shared memory, the A
//   tile holds the codes of h, exchanged as bf(h) is (in 8-byte pieces),
//   the product is mma.sync m16n8k32 s8 -> s32 into accumulators of its
//   own, and once the sum is whole gates = (bias + the bf16 x-part, or xw)
//   + f32(sum) * rec_scale, JAX's order.  Fused x then takes a bf16 tile
//   of its own.  Codes move with a gate's last bit, so these kinds also
//   sum every bf16 product apart from zero, each k16 step's tensor-core
//   sum added with a rounded add (the tensor cores' running sum does not
//   round to nearest), and take the library's expf and tanhf, as the
//   plain version does.  With the fast forms, or with the tensor cores'
//   running sums, one near-tied site of chip_smoke.py phase 9's static
//   call set differed from the CPU run's; with both, all but about one
//   code in 1e5 equal the plain version's.
//
// The kernels and launchers have internal linkage, as in gru_core.cuh: the
// four libraries that include this header instantiate the same templates,
// and a launcher's static with external linkage would be one object for
// all.

#pragma once

#include <cooperative_groups.h>

#include <atomic>
#include <climits>
#include <cstdint>
#include <map>
#include <mutex>
#include <tuple>
#include <type_traits>

#include "lstm_cell.cuh"
#include "mma_ptx.cuh"

namespace lstm {

namespace {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;
using ptx::cp_async16;
using ptx::cp_async16_zfill;
using ptx::cp_async_commit;
using ptx::cp_async_wait;
using ptx::cp_async_wait_all;
using ptx::ldmatrix_x4;
using ptx::ldmatrix_x4_trans;
using ptx::mma_bf16;
using ptx::mma_s8;
using ptx::mma_tf32;
using ptx::split_tf32;

constexpr int kXMax = 32;          // input features that join the step's K
constexpr int kPad = 8;            // bf16 elements past each shared row
constexpr int kCodePad = 16;       // bytes past each int8 shared row
constexpr int kMaxCluster = 4;
constexpr int kCoreMaxThreads = 256;  // 8 warps: U = 64 units
constexpr int kCoreDevices = 64;

// What the static kernel writes (out_kind): h as float32 or bfloat16 (the
// float epilogue), or its int8 codes round(h * 127)
constexpr int kOutF32 = 0;
constexpr int kOutBf16 = 1;
constexpr int kOutInt8 = 2;

// What a core instance reads and writes.  XW: the hoisted body's xw element
// type (float or bf16).  TO: out's, bf16 (the float kernels, whose bias is
// bf16) or int8_t, the codes round(h * 127) of the static kernels, whose
// bias is float32.  kIntRec: an int8 W_hh, k-major (4H, H), fed the codes
// of h and rescaled by rec_scale (static_rec).  kFloatOut: a code-emitting
// kind (TO = int8_t, its sums and nonlinearities) that writes h instead,
// in float32 or bfloat16 as CoreArgs::out_kind says (the static kernel's
// float epilogue); an int8 W_hh is still fed the codes.
template <typename XW_ = float, typename TO_ = bf16, bool kIntRec_ = false,
          bool kFloatOut_ = false>
struct Kind {
  using XW = XW_;
  using TO = TO_;
  static constexpr bool kCodes = std::is_same<TO_, int8_t>::value;
  static constexpr bool kIntRec = kIntRec_;
  static constexpr bool kFloatOut = kFloatOut_;
  using Bias = typename std::conditional<kCodes, float, bf16>::type;
  using Out = typename std::conditional<kFloatOut_, void, TO_>::type;
  static_assert(kCodes || !kIntRec_, "an int8 W_hh emits int8 codes");
  static_assert(kCodes || !kFloatOut_, "the float epilogue is a codes kind's");
};

using FloatKind = Kind<>;

// One direction's operands.  Fused x: w_x0/w_x1 and bias; hoisted: xw.
template <typename K = FloatKind>
struct Direction {
  const void* w_hh;              // (H, 4H) bf16, or (4H, H) int8 k-major
  const bf16* w_x0;              // (F0, 4H)
  const bf16* w_x1;              // (F1, 4H) or null
  const typename K::Bias* bias;  // (4H,)
  const typename K::XW* xw;      // (T, B, 4H)
  typename K::Out* out;          // (T, B, H)
  const float* rec_scale;        // (4H,), an int8 W_hh's
  int reverse;
};

template <typename K = FloatKind>
struct CoreArgs {
  const bf16* x0;     // (T, B, F0), read by the fused-x body
  const bf16* x1;     // (T, B, F1) or null
  int F0, F1, steps, B, H;
  Direction<K> dir[2];  // blockIdx.y picks one
  int out_kind;         // kFloatOut: kOutF32 or kOutBf16
};

// xw[0..1] of one thread's two adjacent units, widened to f32
__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ float2 load_pair(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the shared::cluster address of `smem` (this CTA's) in CTA `rank`
__device__ __forceinline__ unsigned map_rank(const void* smem, int rank) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(s), "r"(rank));
  return r;
}

__device__ __forceinline__ void st_cluster_v4(unsigned addr, uint4 v) {
  asm volatile("st.shared::cluster.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                   addr),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

__device__ __forceinline__ void st_cluster_v2(unsigned addr, uint2 v) {
  asm volatile("st.shared::cluster.v2.u32 [%0], {%1, %2};\n" ::"r"(addr),
               "r"(v.x), "r"(v.y)
               : "memory");
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// the int8 codes of two adjacent units, the first in the low byte
__device__ __forceinline__ unsigned pack_codes(float lo, float hi) {
  return static_cast<uint8_t>(from_f32<int8_t>(lo)) |
         (static_cast<unsigned>(static_cast<uint8_t>(from_f32<int8_t>(hi)))
          << 8);
}

// out[o], out[o + 1] = h of two adjacent units in float32 (out_kind
// kOutF32) or bfloat16: the float epilogue's store
__device__ __forceinline__ void store_h(void* out, int out_kind, size_t o,
                                        float lo, float hi) {
  if (out_kind == kOutF32) {
    *reinterpret_cast<float2*>(static_cast<float*>(out) + o) =
        make_float2(lo, hi);
  } else {
    *reinterpret_cast<unsigned*>(static_cast<bf16*>(out) + o) =
        pack_bf16(lo, hi);
  }
}

__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// 1/d for d in [1, 2^126) within 2e-7: a guess from the bits (5% off) and
// three Newton steps on the FMA pipe, which leaves the special-function
// unit to ex2
__device__ __forceinline__ float rcp_newton(float d) {
  float y = __int_as_float(0x7EF311C7 - __float_as_int(d));
#pragma unroll
  for (int i = 0; i < 3; ++i) y = __fmul_rn(y, __fmaf_rn(-d, y, 2.0f));
  return y;
}

constexpr float kLog2e = 1.4426950408889634f;

// sigmoid(v) = 1 / (1 + e^-v); v >= -80 keeps e^-v finite
__device__ __forceinline__ float sigmoid_fast(float v) {
  return rcp_newton(__fadd_rn(1.0f, ex2(-kLog2e * fmaxf(v, -80.0f))));
}

// tanh(v) = 1 - 2 / (1 + e^2v); v <= 40 keeps e^2v finite
__device__ __forceinline__ float tanh_fast(float v) {
  return __fmaf_rn(
      -2.0f, rcp_newton(__fadd_rn(1.0f, ex2(2.0f * kLog2e * fminf(v, 40.0f)))),
      1.0f);
}

// The cell's nonlinearities: the fast forms above for bf16 out; for int8
// codes out, where a gate's last bit moves a code wherever h * 127 lies
// near a half, and a code that rounds the other way feeds the next step
// (static_rec) and the next layer, the plain versions' own: 1 / (1 + expf(-v))
// (its reciprocal rounded to nearest, as the division rounds it) and tanhf.
template <typename Kd>
__device__ __forceinline__ float gate_sigmoid(float v) {
  return Kd::kCodes ? __frcp_rn(__fadd_rn(1.0f, expf(-v)))
                    : sigmoid_fast(v);
}

template <typename Kd>
__device__ __forceinline__ float gate_tanh(float v) {
  return Kd::kCodes ? tanhf(v) : tanh_fast(v);
}

inline int cluster_size(int H) { return H <= 64 ? 1 : H <= 128 ? 2 : 4; }

// Shared memory of the core.  A bf16 W_hh: its slice [H][4U + kPad] and
// the A tile [R][K + kPad] (bf(h), then x[t] when fused), K = H (+ kXMax
// when fused), bf16.  An int8 W_hh: its slice k-major [4U][H + kCodePad]
// and the codes of h [R][H + kCodePad], bytes, then for fused x a tile of
// its own, [R][kXMax + kPad] bf16.
inline size_t core_smem_bytes(int H, int rows, bool fused_x, bool int_rec) {
  const int U = H / cluster_size(H);
  if (int_rec) {
    return static_cast<size_t>(4 * U + rows) * (H + kCodePad) +
           (fused_x ? static_cast<size_t>(rows) * (kXMax + kPad) *
                          sizeof(bf16)
                    : 0);
  }
  const int K = H + (fused_x ? kXMax : 0);
  return (static_cast<size_t>(H) * (4 * U + kPad) +
          static_cast<size_t>(rows) * (K + kPad)) *
         sizeof(bf16);
}

// A cluster's R = 16 * kMT * kChunks rows, in kChunks chunks of kMT m16
// tiles (see the design above).
template <int kMT, int kChunks, bool kFusedX, typename Kd>
__global__ void __launch_bounds__(kCoreMaxThreads, 1)
    core_kernel(const CoreArgs<Kd> a) {
  using XW = typename Kd::XW;
  using TO = typename Kd::TO;
  constexpr bool kIntRec = Kd::kIntRec;
  constexpr int R = 16 * kMT * kChunks;
  cg::cluster_group cluster = cg::this_cluster();
  const int n = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  // the parameters as locals: lambdas below capture these, not `a`
  const Direction<Kd> d = blockIdx.y ? a.dir[1] : a.dir[0];
  const bf16* x0 = a.x0;
  const bf16* x1 = a.x1;
  const int F0 = a.F0, F1 = a.F1, B = a.B, steps = a.steps, H = a.H;
  const int out_kind = a.out_kind;
  const int U = H / n, G = 4 * H;
  const int b0 = static_cast<int>(blockIdx.x) / n * R;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid / 32, lane = tid % 32;
  const int quad = lane / 4, pair = 2 * (lane % 4);
  // this thread's two units of each gate's n8 tile
  const int unit = rank * U + warp * 8 + pair;
  const bool early = warp < 4;  // see the xw prefetch below

  // The shared tiles (core_smem_bytes).  A bf16 W_hh: ws [H][ldw] and the
  // A tile hs [R][ldh], whose columns H.. hold x[t] when fused.  An int8
  // W_hh: wq [4U][ldq] and the codes hq [R][ldq], bytes, and x[t] in a tile
  // of its own.  xs/ldx: x[t]'s columns, wherever they are.
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ldw = 4 * U + kPad;
  const int ldh = H + (kFusedX ? kXMax : 0) + kPad;
  const int ldq = H + kCodePad;
  bf16* ws = reinterpret_cast<bf16*>(smem_raw);
  bf16* hs = ws + H * ldw;
  uint8_t* wq = smem_raw;
  uint8_t* hq = wq + 4 * U * ldq;
  bf16* xs = kIntRec ? reinterpret_cast<bf16*>(hq + R * ldq) : hs + H;
  const int ldx = kIntRec ? kXMax + kPad : ldh;

  // W_hh's slice: local column warp'*32 + q*8 + j is gate q of unit
  // rank*U + warp'*8 + j (a row of wq, a column of ws)
  if constexpr (kIntRec) {
    const uint8_t* w = static_cast<const uint8_t*>(d.w_hh);
    const int row_chunks = H / 16;
    for (int i = tid; i < 4 * U * row_chunks; i += nthreads) {
      const int lc = i / row_chunks, c = i - lc * row_chunks;
      const int col = (lc % 32) / 8 * H + rank * U + lc / 32 * 8 + lc % 8;
      cp_async16(wq + lc * ldq + c * 16,
                 w + static_cast<size_t>(col) * H + c * 16);
    }
    // h0 = 0, and zeros in every pad and in the x columns past F
    const int zero_chunks =
        (R * ldq + (kFusedX ? R * ldx * 2 : 0)) / 16;
    for (int i = tid; i < zero_chunks; i += nthreads) {
      reinterpret_cast<uint4*>(hq)[i] = make_uint4(0, 0, 0, 0);
    }
  } else {
    const bf16* w = static_cast<const bf16*>(d.w_hh);
    const int row_chunks = 4 * U / 8;
    for (int i = tid; i < H * row_chunks; i += nthreads) {
      const int k = i / row_chunks, c = i - k * row_chunks;
      cp_async16(ws + k * ldw + c * 8,
                 w + static_cast<size_t>(k) * G + (c % 4) * H + rank * U +
                     (c / 4) * 8);
    }
    for (int i = tid; i < R * ldh / 8; i += nthreads) {
      reinterpret_cast<uint4*>(hs)[i] = make_uint4(0, 0, 0, 0);
    }
  }

  // The fused W_ih slice stays in registers as this warp's B fragments:
  // wx[kx][q] = (b0, b1) of k16 step kx of gate q, zeros past F
  const int F = F0 + F1;
  unsigned wx[2][4][2];
  if constexpr (kFusedX) {
    auto w_at = [&](int k, int col) -> unsigned {
      if (k >= F) return 0;
      const bf16* w = k < F0 ? d.w_x0 + static_cast<size_t>(k) * G
                             : d.w_x1 + static_cast<size_t>(k - F0) * G;
      return *reinterpret_cast<const unsigned short*>(w + col);
    };
#pragma unroll
    for (int kx = 0; kx < 2; ++kx) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int col = q * H + rank * U + warp * 8 + quad;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int k = 16 * kx + 8 * r + pair;
          wx[kx][q][r] = w_at(k, col) | (w_at(k + 1, col) << 16);
        }
      }
    }
  }
  // an int8 W_hh's rescale of the thread's gate columns
  float rs[4][2];
  if constexpr (kIntRec) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
      for (int j = 0; j < 2; ++j) rs[q][j] = d.rec_scale[q * H + unit + j];
    }
  }

  // x[t] of the cluster's rows into the x columns: element idx is row
  // idx / kXMax, feature idx % kXMax.  A thread loads kXRegs of them (all
  // of them at 8 warps) into registers after the step's last product and
  // stores them after the step's exchange; with fewer warps it loads the
  // rest at the store.
  constexpr int kXRegs = R * kXMax / kCoreMaxThreads;
  auto x_at = [&](int t, int idx) -> unsigned short {
    const int r = idx / kXMax, k = idx % kXMax, row = b0 + r;
    if (k >= F || row >= B) return 0;
    const size_t base = static_cast<size_t>(t) * B + row;
    const bf16* src = k < F0 ? x0 + base * F0 + k : x1 + base * F1 + k - F0;
    return *reinterpret_cast<const unsigned short*>(src);
  };
  unsigned short xv[kXRegs];
  // (the empty asm keeps each element's offsets from being computed once
  // and held in registers through the step loop)
  auto load_x = [&](int t) {
#pragma unroll
    for (int i = 0; i < kXRegs; ++i) {
      int idx = tid + i * nthreads;
      asm volatile("" : "+r"(idx));
      xv[i] = x_at(t, idx);
    }
  };
  auto store_x = [&](int t) {
    unsigned short* xd = reinterpret_cast<unsigned short*>(xs);
#pragma unroll
    for (int i = 0; i < kXRegs; ++i) {
      int idx = tid + i * nthreads;
      asm volatile("" : "+r"(idx));
      if (idx % kXMax < F) xd[idx / kXMax * ldx + idx % kXMax] = xv[i];
    }
    for (int idx = kXRegs * nthreads + tid; idx < R * kXMax;
         idx += nthreads) {
      if (idx % kXMax < F) xd[idx / kXMax * ldx + idx % kXMax] = x_at(t, idx);
    }
  };

  // A chunk's accumulators, acc[mt][q][2e+j]: gate q of unit `unit + j`,
  // row (ch*kMT + mt)*16 + quad + 8e of the cluster.  They start from the
  // bias (fused) or from xw[t] (hoisted: loaded into `nxt` one chunk ahead);
  // the code-emitting kinds sum the recurrent part apart, in racc (same
  // layout), and join the parts once each is whole.
  float acc[kMT][4][4];
  float nxt[kMT][4][4];
  auto load_xw = [&](int t, int ch) {
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = b0 + (ch * kMT + mt) * 16 + quad + 8 * e;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float2 v = make_float2(0.0f, 0.0f);
          if (row < B) {
            v = load_pair(d.xw + (static_cast<size_t>(t) * B + row) * G +
                          q * H + unit);
          }
          nxt[mt][q][2 * e] = v.x;
          nxt[mt][q][2 * e + 1] = v.y;
        }
      }
    }
  };

  const int t_first = d.reverse ? steps - 1 : 0;
  __syncthreads();  // the A tile is zero
  if (kFusedX) {
    load_x(t_first);
    store_x(t_first);
  } else {
    load_xw(t_first, 0);
  }
  cp_async_wait_all();
  __syncthreads();  // W_hh's slice, h0 and x[t] in place

  float c[kChunks][kMT][4];
  // the thread's two units of h by row, as the A tile holds them: bf(h)
  // (two bf16) or, for an int8 W_hh, the two codes
  unsigned hw[kChunks][kMT][2];
#pragma unroll
  for (int ch = 0; ch < kChunks; ++ch) {
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) c[ch][mt][i] = 0.0f;
    }
  }

  // ldmatrix addresses: A rows by lane, B rows k (bf16 W_hh) or columns
  // (int8 W_hh) by lane
  const bf16* a_base = hs + (lane & 15) * ldh + (lane >> 4) * 8;
  const bf16* b_base =
      ws + ((lane & 7) + ((lane >> 3) & 1) * 8) * ldw + warp * 32 +
      (lane >> 4) * 8;
  const uint8_t* qa_base = hq + (lane & 15) * ldq + (lane >> 4) * 16;
  const uint8_t* qb_base =
      wq + (warp * 32 + (lane & 7) + (lane >> 4) * 8) * ldq +
      ((lane >> 3) & 1) * 16;
  // the fused x columns' A rows: their own tile beside an int8 W_hh, else
  // the A tile's columns H.. (a_base + H, no pointer of their own)
  const bf16* qx_base = xs + (lane & 15) * ldx + (lane >> 4) * 8;

  for (int s = 0; s < steps; ++s) {
    const int t = d.reverse ? steps - 1 - s : s;
    const bool more = s + 1 < steps;
    const int t_next = d.reverse ? t - 1 : t + 1;
    const size_t base = static_cast<size_t>(t) * B;
#pragma unroll
    for (int ch = 0; ch < kChunks; ++ch) {
      // The float kinds sum bias (or xw) and every product into acc on
      // the tensor cores.  The code-emitting kinds keep each part apart,
      // from zero, and join them with rounded adds in the plain version's
      // order, gates = (b + x-part, or xw) + recurrent part: the tensor
      // cores do not round their running sum to nearest, and a code moves
      // with a gate's last bit.  A bf16 W_hh's part is then the
      // round-to-nearest sum of each k16 step's product (tsum); an int8
      // W_hh's is exact (s32).
      using RecSum = typename std::conditional<kIntRec, int, float>::type;
      RecSum racc[kMT][4][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            if (Kd::kCodes) {
              acc[mt][q][v] = 0.0f;
              racc[mt][q][v] = 0;
            } else if (kFusedX) {  // the bias, from L1
              acc[mt][q][v] = to_f32(d.bias[q * H + unit + (v & 1)]);
            } else {
              acc[mt][q][v] = nxt[mt][q][v];
            }
          }
        }
      }
      // the next chunk's xw, this step's or the next's.  Issuing them
      // stalls a warp until the memory system takes them, so the warps of
      // one scheduler take turns: the lower half issues them before its
      // product, the upper half after it.  (The code-emitting kinds issue
      // them after their product, whose sums then join the current xw
      // still in `nxt`.)
      auto prefetch = [&]() {
        if (ch + 1 < kChunks) {
          load_xw(t, ch + 1);
        } else if (more) {
          load_xw(t_next, 0);
        }
      };
      // d += a @ b over one k16 step: onto d on the tensor cores, or as a
      // sum of its own added to d with a rounded add
      auto mma_into = [&](float (&dst)[4], const unsigned (&af)[4],
                          unsigned b0, unsigned b1) {
        if constexpr (Kd::kCodes) {
          float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          mma_bf16(part, af, b0, b1);
#pragma unroll
          for (int v = 0; v < 4; ++v) dst[v] = __fadd_rn(dst[v], part[v]);
        } else {
          mma_bf16(dst, af, b0, b1);
        }
      };
      if (!kFusedX && !Kd::kCodes && early) prefetch();
      if constexpr (kIntRec) {
        const uint8_t* a_chunk = qa_base + ch * kMT * 16 * ldq;
        for (int kk = 0; kk < H; kk += 32) {
          unsigned bq[2][4];  // gates (0, 1) and (2, 3): b0, b1 of each
          ldmatrix_x4(bq[0], qb_base + kk);
          ldmatrix_x4(bq[1], qb_base + 16 * ldq + kk);
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt) {
            unsigned af[4];
            ldmatrix_x4(af, a_chunk + mt * 16 * ldq + kk);
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              mma_s8(racc[mt][q], af, bq[q / 2][2 * (q % 2)],
                     bq[q / 2][2 * (q % 2) + 1]);
            }
          }
        }
      } else {
        const bf16* a_chunk = a_base + ch * kMT * 16 * ldh;
        for (int kk = 0; kk < H; kk += 16) {
          unsigned bf[2][4];  // gates (0, 1) and (2, 3): b0, b1 of each
          ldmatrix_x4_trans(bf[0], b_base + kk * ldw);
          ldmatrix_x4_trans(bf[1], b_base + kk * ldw + 16);
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt) {
            unsigned af[4];
            ldmatrix_x4(af, a_chunk + mt * 16 * ldh + kk);
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              if constexpr (Kd::kCodes) {
                mma_into(racc[mt][q], af, bf[q / 2][2 * (q % 2)],
                         bf[q / 2][2 * (q % 2) + 1]);
              } else {
                mma_into(acc[mt][q], af, bf[q / 2][2 * (q % 2)],
                         bf[q / 2][2 * (q % 2) + 1]);
              }
            }
          }
        }
      }
      if constexpr (kFusedX) {
        const bf16* x_chunk = kIntRec ? qx_base + ch * kMT * 16 * ldx
                                      : a_base + ch * kMT * 16 * ldh + H;
#pragma unroll
        for (int kx = 0; kx < 2; ++kx) {
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt) {
            unsigned af[4];
            ldmatrix_x4(af, x_chunk + mt * 16 * ldx + 16 * kx);
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              mma_into(acc[mt][q], af, wx[kx][q][0], wx[kx][q][1]);
            }
          }
        }
      }
      if constexpr (Kd::kCodes) {
        // gates = (b + x-part, or xw) + the recurrent part (an int8 W_hh's
        // rescaled once), JAX's order
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
#pragma unroll
            for (int v = 0; v < 4; ++v) {
              const float rec =
                  kIntRec ? __fmul_rn(static_cast<float>(racc[mt][q][v]),
                                      rs[q][v & 1])
                          : static_cast<float>(racc[mt][q][v]);
              const float first =
                  kFusedX ? __fadd_rn(to_f32(d.bias[q * H + unit + (v & 1)]),
                                      acc[mt][q][v])
                          : nxt[mt][q][v];
              acc[mt][q][v] = __fadd_rn(first, rec);
            }
          }
        }
      }
      if (!kFusedX && (Kd::kCodes || !early)) prefetch();
      if (ch + 1 == kChunks) {
        cluster_arrive();  // done reading the A tile
        // the next x[t] lands during the last cell and the barrier
        if (kFusedX && more) load_x(t_next);
      }

#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float h[2];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int v = 2 * e + j;
            const float ig = gate_sigmoid<Kd>(acc[mt][0][v]);
            const float fg = gate_sigmoid<Kd>(acc[mt][1][v]);
            const float gg = gate_tanh<Kd>(acc[mt][2][v]);
            const float og = gate_sigmoid<Kd>(acc[mt][3][v]);
            float& cv = c[ch][mt][v];
            cv = __fadd_rn(__fmul_rn(fg, cv), __fmul_rn(ig, gg));
            h[j] = __fmul_rn(og, gate_tanh<Kd>(cv));
          }
          const unsigned codes =
              Kd::kCodes ? pack_codes(h[0], h[1]) : 0u;
          hw[ch][mt][e] = kIntRec ? codes : pack_bf16(h[0], h[1]);
          const int row = b0 + (ch * kMT + mt) * 16 + quad + 8 * e;
          if (row < B) {
            if constexpr (Kd::kFloatOut) {
              store_h(d.out, out_kind, (base + row) * H + unit, h[0], h[1]);
            } else {
              TO* dst = d.out + (base + row) * H + unit;
              if constexpr (Kd::kCodes) {
                *reinterpret_cast<unsigned short*>(dst) =
                    static_cast<unsigned short>(codes);
              } else {
                *reinterpret_cast<unsigned*>(dst) = hw[ch][mt][e];
              }
            }
          }
        }
      }
    }
    if (!more) break;
    cluster_wait();  // every CTA of the cluster is done with its A tile

    // this CTA's slice of h into its own tile, then into the peers'
#pragma unroll
    for (int ch = 0; ch < kChunks; ++ch) {
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = (ch * kMT + mt) * 16 + quad + 8 * e;
          if constexpr (kIntRec) {
            *reinterpret_cast<unsigned short*>(hq + r * ldq + unit) =
                static_cast<unsigned short>(hw[ch][mt][e]);
          } else {
            *reinterpret_cast<unsigned*>(hs + r * ldh + unit) =
                hw[ch][mt][e];
          }
        }
      }
    }
    if (kFusedX) store_x(t_next);
    __syncthreads();  // the slice is whole
    if constexpr (kIntRec) {
      // U codes a row, in 8-byte pieces (U is a multiple of 8)
      const int slice_chunks = U / 8;
      for (int i = tid; i < R * slice_chunks; i += nthreads) {
        const int r = i / slice_chunks;
        const int off = r * ldq + rank * U + (i - r * slice_chunks) * 8;
        const uint2 v = *reinterpret_cast<const uint2*>(hq + off);
#pragma unroll
        for (int p = 0; p < kMaxCluster; ++p) {
          if (p < n && p != rank) st_cluster_v2(map_rank(hq + off, p), v);
        }
      }
    } else {
      const int slice_chunks = U / 8;
      for (int i = tid; i < R * slice_chunks; i += nthreads) {
        const int r = i / slice_chunks;
        const int off = r * ldh + rank * U + (i - r * slice_chunks) * 8;
        const uint4 v = *reinterpret_cast<const uint4*>(hs + off);
#pragma unroll
        for (int p = 0; p < kMaxCluster; ++p) {
          if (p < n && p != rank) st_cluster_v4(map_rank(hs + off, p), v);
        }
      }
    }
    cluster_arrive();
    cluster_wait();  // every slice of h and x[t+1] in place
  }
  cluster_wait();  // pairs the last step's arrive
}

// Raise a kernel's dynamic shared-memory limit to the device's opt-in
// maximum, the first time a launch on that device asks (Tag: one flag set
// per kernel).
template <typename Tag>
cudaError_t ensure_smem_limit(const void* kernel, int device) {
  static std::atomic<bool> raised[kCoreDevices];
  const bool cached = device >= 0 && device < kCoreDevices;
  if (cached && raised[device].load(std::memory_order_acquire)) {
    return cudaSuccess;
  }
  int optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin);
  if (err != cudaSuccess) return err;
  if (cached) raised[device].store(true, std::memory_order_release);
  return cudaSuccess;
}

template <int kMT, int kChunks, bool kFusedX, typename Kd>
struct CoreTag {};

template <int kMT, int kChunks, bool kFusedX, typename Kd>
void fill_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr, int H,
                 int clusters, int dirs, cudaStream_t stream) {
  const int n = cluster_size(H);
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(clusters * n, dirs, 1);
  cfg.blockDim = dim3(32 * (H / n / 8), 1, 1);
  cfg.dynamicSmemBytes =
      core_smem_bytes(H, 16 * kMT * kChunks, kFusedX, Kd::kIntRec);
  cfg.stream = stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = n;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
}

// How many clusters of a core kernel at width H run at once on `device`
// (cudaOccupancyMaxActiveClusters, asked once per device and H; 30 of 4
// CTAs on an H100 SXM at H=256, so 120 of its 132 SMs).
template <int kMT, int kChunks, bool kFusedX, typename Kd>
cudaError_t max_clusters(int device, int H, int* count) {
  static std::mutex mu;
  static std::map<std::tuple<int, int>, int> memo;
  std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_tuple(device, H);
  const auto found = memo.find(key);
  if (found != memo.end()) {
    *count = found->second;
    return cudaSuccess;
  }
  auto kernel = core_kernel<kMT, kChunks, kFusedX, Kd>;
  cudaError_t err = ensure_smem_limit<CoreTag<kMT, kChunks, kFusedX, Kd>>(
      reinterpret_cast<const void*>(kernel), device);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  fill_config<kMT, kChunks, kFusedX, Kd>(cfg, attr, H, 1, 1, nullptr);
  err = cudaOccupancyMaxActiveClusters(count, kernel, &cfg);
  if (err != cudaSuccess) return err;
  memo[key] = *count;
  return cudaSuccess;
}

template <int kMT, int kChunks, bool kFusedX, typename Kd>
cudaError_t launch_rows(const CoreArgs<Kd>& a, int dirs, int device,
                        cudaStream_t stream) {
  auto kernel = core_kernel<kMT, kChunks, kFusedX, Kd>;
  cudaError_t err = ensure_smem_limit<CoreTag<kMT, kChunks, kFusedX, Kd>>(
      reinterpret_cast<const void*>(kernel), device);
  if (err != cudaSuccess) return err;
  const int rows = 16 * kMT * kChunks;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  fill_config<kMT, kChunks, kFusedX, Kd>(cfg, attr, a.H,
                                         (a.B + rows - 1) / rows, dirs,
                                         stream);
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The rows a cluster that launch_core takes for dirs directions of B rows:
// the fewest of 16, 32, 48, 96 and 144 whose clusters all run in one wave,
// else 144 (in more waves where B asks for them).  *count: how many
// clusters of that plan run at once.
template <bool kFusedX, typename Kd>
cudaError_t pick_rows(int B, int H, int dirs, int device, int* rows,
                      int* count) {
  cudaError_t err;
#define LSTM_TRY(MT, CH)                                                    \
  err = max_clusters<MT, CH, kFusedX, Kd>(device, H, count);              \
  if (err != cudaSuccess) return err;                                     \
  *rows = 16 * (MT) * (CH);                                               \
  if (static_cast<long long>(dirs) * ((B + *rows - 1) / *rows) <= *count) { \
    return cudaSuccess;                                                   \
  }
  LSTM_TRY(1, 1)
  LSTM_TRY(2, 1)
  LSTM_TRY(3, 1)
  LSTM_TRY(3, 2)
#undef LSTM_TRY
  *rows = 144;
  return max_clusters<3, 3, kFusedX, Kd>(device, H, count);
}

template <bool kFusedX, typename Kd>
cudaError_t launch_plan(const CoreArgs<Kd>& a, int dirs, int device,
                        cudaStream_t stream) {
  // the float epilogue, which no served mode runs, takes the widest plan
  // alone (a row's sums do not depend on the plan)
  if constexpr (Kd::kFloatOut) {
    return launch_rows<3, 3, kFusedX>(a, dirs, device, stream);
  } else {
    int rows = 0, count = 0;
    const cudaError_t err =
        pick_rows<kFusedX, Kd>(a.B, a.H, dirs, device, &rows, &count);
    if (err != cudaSuccess) return err;
    switch (rows) {
      case 16:
        return launch_rows<1, 1, kFusedX>(a, dirs, device, stream);
      case 32:
        return launch_rows<2, 1, kFusedX>(a, dirs, device, stream);
      case 48:
        return launch_rows<3, 1, kFusedX>(a, dirs, device, stream);
      case 96:
        return launch_rows<3, 2, kFusedX>(a, dirs, device, stream);
      default:
        return launch_rows<3, 3, kFusedX>(a, dirs, device, stream);
    }
  }
}

// The fused-x body exists for a float xw only (it reads no xw), so a
// library that runs the core over a bf16 xw builds the hoisted body alone.
template <typename Kd>
constexpr bool kHasFused = std::is_same<typename Kd::XW, float>::value;

// The recurrence of dirs directions (a.dir[0..dirs-1]): with fused_x
// (F0 + F1 <= kXMax) x[t] joins the step's product, else it runs over each
// direction's xw, whose rows must start on two elements.  W_hh must be
// 16-byte aligned.
template <typename Kd>
cudaError_t launch_core(const CoreArgs<Kd>& a, int dirs, bool fused_x,
                        cudaStream_t stream) {
  if (fused_x && !kHasFused<Kd>) return cudaErrorInvalidValue;
  for (int i = 0; i < dirs; ++i) {
    if (reinterpret_cast<uintptr_t>(a.dir[i].w_hh) % 16 != 0) {
      return cudaErrorMisalignedAddress;
    }
    if (Kd::kIntRec && a.dir[i].rec_scale == nullptr) {
      return cudaErrorInvalidValue;
    }
    if (!fused_x && a.dir[i].xw == nullptr) return cudaErrorInvalidValue;
    if (!fused_x && reinterpret_cast<uintptr_t>(a.dir[i].xw) %
                            (2 * sizeof(typename Kd::XW)) !=
                        0) {
      return cudaErrorMisalignedAddress;
    }
  }
  int device = 0;
  const cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if constexpr (kHasFused<Kd>) {
    if (fused_x) return launch_plan<true>(a, dirs, device, stream);
  }
  return launch_plan<false>(a, dirs, device, stream);
}

// ---------------------------------------------------------------------------
// The input projection of the hoisted path: for each direction,
//
//   xw[m][n] = b[n] + sum_k [x_0 x_1][m][k] * [W_ih_0; W_ih_1][k][n]
//
// for all M = T*B rows (f32 sums on the tensor cores).  128 x 128 output
// tiles of one direction a block, 8 warps of 64 x 32, k-tiles of 32 in a
// ring of kPStages in shared memory, filled with cp.async kPStages - 1
// k-tiles ahead of the product (element by element where x's or W's rows
// are not 16-byte aligned).  Directions side by side in blockIdx.x read x once
// from L2 for both (N = 8H).  Bound: x in and xw out (553 MB of f32 xw at
// B=4096 for one decoder direction) against 2*M*F*4H operations.

constexpr int kPM = 128, kPN = 128, kPK = 32, kPThreads = 256;
constexpr int kPStages = 4;  // k-tiles in flight

struct ProjDir {
  const bf16* w0;     // (F0, N)
  const bf16* w1;     // (F1, N) or null
  const void* bias;   // (N,): bf16, or float32 for the codes kinds
  float* xw;          // (M, N)
};

struct ProjArgs {
  const bf16* x0;     // (M, F0)
  const bf16* x1;     // (M, F1) or null
  int F0, F1, M, N;
  ProjDir dir[2];
};

// The element-wise loads of the projection where a row is not 16-byte
// aligned: 8 consecutive bf16 of row m of the concatenated parts from k,
// zeros past M or F0 + F1
__device__ __forceinline__ uint4 x_chunk(const bf16* x0, const bf16* x1,
                                         int F0, int F1, int M, int m,
                                         int k) {
  const int F = F0 + F1;
  if (m >= M || k >= F) return make_uint4(0, 0, 0, 0);
  uint4 v;
  unsigned short* e = reinterpret_cast<unsigned short*>(&v);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int kk = k + i;
    const unsigned short* src = nullptr;
    if (kk < F0) {
      src = reinterpret_cast<const unsigned short*>(
          x0 + static_cast<size_t>(m) * F0 + kk);
    } else if (kk < F) {
      src = reinterpret_cast<const unsigned short*>(
          x1 + static_cast<size_t>(m) * F1 + kk - F0);
    }
    e[i] = src != nullptr ? *src : 0;
  }
  return v;
}

// W[k][n..n+7] of the stacked parts; zeros past F0 + F1
__device__ __forceinline__ uint4 w_chunk(const bf16* w0, const bf16* w1,
                                         int F0, int F1, int N, int k,
                                         int n) {
  if (k >= F0 + F1) return make_uint4(0, 0, 0, 0);
  const bf16* row = k < F0 ? w0 + static_cast<size_t>(k) * N
                           : w1 + static_cast<size_t>(k - F0) * N;
  uint4 v;
  unsigned short* e = reinterpret_cast<unsigned short*>(&v);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    e[i] = reinterpret_cast<const unsigned short*>(row)[n + i];
  }
  return v;
}

// one pipeline stage: the x tile [kPM][kPK + kPad] and the W tile
// [kPK][kPN + kPad], bf16 kept as their 16-bit patterns
struct ProjStage {
  unsigned short a[kPM][kPK + kPad];
  unsigned short b[kPK][kPN + kPad];
};

// kCodes: the static kernels' projection (their codes kinds' sums): a
// float32 bias, and each k16 step's product summed from zero and added
// with a rounded add, as the core's fused x part of those kinds is.
template <bool kVec, bool kCodes = false>
__global__ void __launch_bounds__(kPThreads, 2)
    projection_kernel(const ProjArgs a) {
  extern __shared__ __align__(16) unsigned char proj_smem[];
  ProjStage* stage = reinterpret_cast<ProjStage*>(proj_smem);
  const int tiles_n = a.N / kPN;
  const int dir = static_cast<int>(blockIdx.x) / tiles_n;
  const ProjDir d = dir ? a.dir[1] : a.dir[0];
  const bf16* x0 = a.x0;
  const bf16* x1 = a.x1;
  const int F0 = a.F0, F1 = a.F1, M = a.M, N = a.N;
  const int n0 = (static_cast<int>(blockIdx.x) % tiles_n) * kPN;
  const int K = F0 + F1;
  const int k_tiles = (K + kPK - 1) / kPK;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 4, wn = warp % 4;  // a 64 x 32 warp tile

  for (int m0 = static_cast<int>(blockIdx.y) * kPM; m0 < M;
       m0 += static_cast<int>(gridDim.y) * kPM) {
    // k-tile kt into stage st: cp.async with zeros past M and K where
    // every chunk is 16-byte aligned, else element by element
    auto load = [&](int st, int kt) {
      const int k0 = kt * kPK;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int c = tid + i * kPThreads;
        const int m = m0 + c / 4, k = k0 + (c % 4) * 8;  // A: 128 x 4 chunks
        unsigned short* a_dst = &stage[st].a[c / 4][(c % 4) * 8];
        const int kb = k0 + c / 16, n = n0 + (c % 16) * 8;  // B: 32 x 16
        unsigned short* b_dst = &stage[st].b[c / 16][(c % 16) * 8];
        if constexpr (kVec) {
          const bool a_ok = m < M && k < K;
          const bf16* a_src =
              !a_ok ? x0
              : k < F0 ? x0 + static_cast<size_t>(m) * F0 + k
                       : x1 + static_cast<size_t>(m) * F1 + k - F0;
          cp_async16_zfill(a_dst, a_src, a_ok);
          const bool b_ok = kb < K;
          const bf16* b_src =
              !b_ok ? d.w0
              : kb < F0 ? d.w0 + static_cast<size_t>(kb) * N + n
                        : d.w1 + static_cast<size_t>(kb - F0) * N + n;
          cp_async16_zfill(b_dst, b_src, b_ok);
        } else {
          *reinterpret_cast<uint4*>(a_dst) =
              x_chunk(x0, x1, F0, F1, M, m, k);
          *reinterpret_cast<uint4*>(b_dst) =
              w_chunk(d.w0, d.w1, F0, F1, N, kb, n);
        }
      }
    };
    float acc[4][4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.0f;
      }
    }
#pragma unroll
    for (int st = 0; st < kPStages - 1; ++st) {
      if (st < k_tiles) load(st, st);
      cp_async_commit();
    }
    for (int kt = 0; kt < k_tiles; ++kt) {
      cp_async_wait<kPStages - 2>();
      __syncthreads();  // k-tile kt is in place; stage (kt-1) % S is free
      if (kt + kPStages - 1 < k_tiles) {
        load((kt + kPStages - 1) % kPStages, kt + kPStages - 1);
      }
      cp_async_commit();
      const ProjStage& sm = stage[kt % kPStages];
#pragma unroll
      for (int kk = 0; kk < kPK; kk += 16) {
        unsigned bf[2][4];
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          ldmatrix_x4_trans(bf[p],
                            &sm.b[kk + (lane & 7) + ((lane >> 3) & 1) * 8]
                                 [wn * 32 + p * 16 + (lane >> 4) * 8]);
        }
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          unsigned af[4];
          ldmatrix_x4(af, &sm.a[wm * 64 + mt * 16 + (lane & 15)]
                               [kk + (lane >> 4) * 8]);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            if constexpr (kCodes) {
              float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
              mma_bf16(part, af, bf[nt / 2][2 * (nt % 2)],
                       bf[nt / 2][2 * (nt % 2) + 1]);
#pragma unroll
              for (int v = 0; v < 4; ++v) {
                acc[mt][nt][v] = __fadd_rn(acc[mt][nt][v], part[v]);
              }
            } else {
              mma_bf16(acc[mt][nt], af, bf[nt / 2][2 * (nt % 2)],
                       bf[nt / 2][2 * (nt % 2) + 1]);
            }
          }
        }
      }
    }
    // the bias goes onto the finished sum
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int n = n0 + wn * 32 + nt * 8 + 2 * (lane % 4);
      float b_lo, b_hi;
      if constexpr (kCodes) {
        b_lo = static_cast<const float*>(d.bias)[n];
        b_hi = static_cast<const float*>(d.bias)[n + 1];
      } else {
        b_lo = __bfloat162float(static_cast<const bf16*>(d.bias)[n]);
        b_hi = __bfloat162float(static_cast<const bf16*>(d.bias)[n + 1]);
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int m = m0 + wm * 64 + mt * 16 + lane / 4 + 8 * e;
          if (m < M) {
            *reinterpret_cast<float2*>(d.xw + static_cast<size_t>(m) * N +
                                       n) =
                make_float2(__fadd_rn(acc[mt][nt][2 * e], b_lo),
                            __fadd_rn(acc[mt][nt][2 * e + 1], b_hi));
          }
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // every stage is read before the next rows' loads
  }
}

template <bool kVec, bool kCodes>
struct ProjTag {};

// xw of dirs directions from one read of x: M = steps * B rows, N = 4H
// columns a direction (a multiple of kPN since H % 32 == 0).
template <bool kCodes = false>
cudaError_t launch_projection(ProjArgs a, int dirs, cudaStream_t stream) {
  auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  // cp.async where every row of x and W starts on 16 bytes
  bool vec = a.F0 % 8 == 0 && a.F1 % 8 == 0 && aligned(a.x0) &&
             aligned(a.x1);
  for (int i = 0; i < dirs; ++i) {
    vec = vec && aligned(a.dir[i].w0) && aligned(a.dir[i].w1);
    if (a.dir[i].xw == nullptr || reinterpret_cast<uintptr_t>(a.dir[i].xw)
                                          % 8 != 0) {
      return cudaErrorInvalidValue;
    }
  }
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  auto kernel = vec ? projection_kernel<true, kCodes>
                    : projection_kernel<false, kCodes>;
  err = vec ? ensure_smem_limit<ProjTag<true, kCodes>>(
                    reinterpret_cast<const void*>(kernel), device)
            : ensure_smem_limit<ProjTag<false, kCodes>>(
                    reinterpret_cast<const void*>(kernel), device);
  if (err != cudaSuccess) return err;
  const int m_tiles = (a.M + kPM - 1) / kPM;
  const dim3 grid(dirs * (a.N / kPN), m_tiles < 65535 ? m_tiles : 65535);
  kernel<<<grid, kPThreads, kPStages * sizeof(ProjStage), stream>>>(a);
  return cudaGetLastError();
}

// The argument checks every launcher shares.
inline bool valid_steps(int steps, int B, int H) {
  return H > 0 && H <= kMaxHidden && H % 32 == 0 && steps > 0 && B > 0 &&
         static_cast<long long>(steps) * B <= INT_MAX;
}

inline bool valid_shape(int F0, int F1, int steps, int B, int H) {
  return F0 > 0 && F1 >= 0 && valid_steps(steps, B, H);
}

// The plan launch_core takes for dirs directions of B rows at width H:
// out[0] rows a cluster, out[1] CTAs a cluster, out[2] clusters a
// direction, out[3] clusters that run at once.
template <typename Kd>
cudaError_t plan_of(int B, int H, int dirs, bool fused_x, int* out) {
  if (fused_x && !kHasFused<Kd>) return cudaErrorInvalidValue;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  int rows = 0, count = 0;
  if constexpr (kHasFused<Kd>) {
    err = fused_x ? pick_rows<true, Kd>(B, H, dirs, device, &rows, &count)
                  : pick_rows<false, Kd>(B, H, dirs, device, &rows, &count);
  } else {
    err = pick_rows<false, Kd>(B, H, dirs, device, &rows, &count);
  }
  if (err != cudaSuccess) return err;
  out[0] = rows;
  out[1] = cluster_size(H);
  out[2] = (B + rows - 1) / rows;
  out[3] = count;
  return cudaSuccess;
}

// The float kernels' plan over a bf16 recurrence with an xw of type XW.
template <typename XW = float>
cudaError_t core_plan(int B, int H, int dirs, bool fused_x, int* out) {
  return plan_of<Kind<XW>>(B, H, dirs, fused_x, out);
}

// The bfloat16 recurrence of dirs directions over their xw (float32 from
// the fused kernels' projection, or bfloat16 from lstm_recurrence's
// caller), which holds the input projection and the bias; direction i runs
// reversed where reverse[i].
template <typename XW>
cudaError_t launch_recurrence(const XW* const* xw, const void* const* w_hh,
                              void* const* out, const int* reverse, int dirs,
                              int steps, int B, int H, cudaStream_t stream) {
  CoreArgs<Kind<XW>> a{};
  a.steps = steps;
  a.B = B;
  a.H = H;
  for (int i = 0; i < dirs; ++i) {
    a.dir[i].w_hh = w_hh[i];
    a.dir[i].xw = xw[i];
    a.dir[i].out = static_cast<bf16*>(out[i]);
    a.dir[i].reverse = reverse[i];
  }
  return launch_core(a, dirs, false, stream);
}

// xw_i = [x0 x1] @ [w0_i; w1_i] + bias_i in float32 for dirs directions,
// from one read of x.
inline cudaError_t launch_projections(const void* x0, const void* x1,
                                      int F0, int F1, const void* const* w0,
                                      const void* const* w1,
                                      const void* const* bias,
                                      float* const* xw, int dirs, int steps,
                                      int B, int H, cudaStream_t stream) {
  ProjArgs p{};
  p.x0 = static_cast<const bf16*>(x0);
  p.x1 = static_cast<const bf16*>(x1);
  p.F0 = F0;
  p.F1 = F1;
  p.M = steps * B;
  p.N = 4 * H;
  for (int i = 0; i < dirs; ++i) {
    p.dir[i] = {static_cast<const bf16*>(w0[i]),
                static_cast<const bf16*>(w1[i]), bias[i], xw[i]};
  }
  return launch_projection(p, dirs, stream);
}

// dirs bfloat16 LSTM directions over the feature parts x0, x1: at most
// kXMax features join the step's product; more are projected into each
// direction's xw first.  Direction i's operands are the [i] of each array.
inline cudaError_t launch_directions(
    const void* x0, const void* x1, int F0, int F1, const void* const* w0,
    const void* const* w1, const void* const* bias, const void* const* w_hh,
    float* const* xw, void* const* out, const int* reverse, int dirs,
    int steps, int B, int H, cudaStream_t stream) {
  if (F0 + F1 > kXMax) {
    const cudaError_t err = launch_projections(
        x0, x1, F0, F1, w0, w1, bias, xw, dirs, steps, B, H, stream);
    if (err != cudaSuccess) return err;
    const float* xws[2] = {xw[0], dirs > 1 ? xw[1] : nullptr};
    return launch_recurrence(xws, w_hh, out, reverse, dirs, steps, B, H,
                             stream);
  }
  CoreArgs<FloatKind> a{};
  a.x0 = static_cast<const bf16*>(x0);
  a.x1 = static_cast<const bf16*>(x1);
  a.F0 = F0;
  a.F1 = F1;
  a.steps = steps;
  a.B = B;
  a.H = H;
  for (int i = 0; i < dirs; ++i) {
    a.dir[i] = {w_hh[i],
                static_cast<const bf16*>(w0[i]),
                static_cast<const bf16*>(w1[i]),
                static_cast<const bf16*>(bias[i]),
                nullptr,
                static_cast<bf16*>(out[i]),
                nullptr,
                reverse[i]};
  }
  return launch_core(a, dirs, true, stream);
}

// ---------------------------------------------------------------------------
// The static kernel's recurrence (lstm_direction_fused_static.cu) on the
// bf16 core: one direction with a float32 bias over bf16 x of at most
// kXMax features (fused: bias, w0, w1 read) or over a float32 xw (xw
// read); W_hh bf16 (H, 4H), or with int_rec int8 k-major (4H, H) and its
// rescale rec_scale (4H,); out as out_kind (kOut*).

template <bool kIntRec, bool kFloatOut>
cudaError_t launch_static_kind(const bf16* x0, const bf16* x1, int F0,
                               int F1, const bf16* w0, const bf16* w1,
                               const float* bias, const float* xw,
                               const void* w_hh, const float* rec_scale,
                               void* out, int out_kind, int reverse,
                               int steps, int B, int H,
                               cudaStream_t stream) {
  using Kd = Kind<float, int8_t, kIntRec, kFloatOut>;
  CoreArgs<Kd> a{};
  a.x0 = x0;
  a.x1 = x1;
  a.F0 = F0;
  a.F1 = F1;
  a.steps = steps;
  a.B = B;
  a.H = H;
  a.dir[0] = {w_hh, w0, w1, bias, xw,
              static_cast<typename Kd::Out*>(out), rec_scale, reverse};
  a.out_kind = out_kind;
  return launch_core(a, 1, xw == nullptr, stream);
}

inline cudaError_t launch_static(const bf16* x0, const bf16* x1, int F0,
                                 int F1, const bf16* w0, const bf16* w1,
                                 const float* bias, const float* xw,
                                 const void* w_hh, bool int_rec,
                                 const float* rec_scale, void* out,
                                 int out_kind, int reverse, int steps, int B,
                                 int H, cudaStream_t stream) {
  if ((xw == nullptr && F0 + F1 > kXMax) || out_kind < kOutF32 ||
      out_kind > kOutInt8) {
    return cudaErrorInvalidValue;
  }
#define LSTM_STATIC_KIND(REC, FLOAT_OUT)                                    \
  launch_static_kind<REC, FLOAT_OUT>(x0, x1, F0, F1, w0, w1, bias, xw, w_hh, \
                                     rec_scale, out, out_kind, reverse,      \
                                     steps, B, H, stream)
  if (out_kind == kOutInt8) {
    return int_rec ? LSTM_STATIC_KIND(true, false)
                   : LSTM_STATIC_KIND(false, false);
  }
  return int_rec ? LSTM_STATIC_KIND(true, true) : LSTM_STATIC_KIND(false, true);
#undef LSTM_STATIC_KIND
}

// The static recurrence's plan (see plan_of), fused or over xw.
inline cudaError_t static_plan(int B, int H, bool fused_x, bool int_rec,
                               int* out) {
  return int_rec ? plan_of<Kind<float, int8_t, true>>(B, H, 1, fused_x, out)
                 : plan_of<Kind<float, int8_t, false>>(B, H, 1, fused_x,
                                                       out);
}

// ---------------------------------------------------------------------------
// The float32 core: the recurrence of the float kernels in float32 (rows 1,
// 3 and 4), per step
//
//   gates = xw[t] + h @ W_hh      (f32 products and sums, f32 h)
//
// over the xw that the float32 projection below (or lstm_recurrence's
// caller) wrote; the cell and out[t] = h as the bf16 core's, in float32,
// with the library's expf and tanhf (the plain version's functions).
//
// Its codes kind (kCodes; the static kernel's float32 W_hh: the float32
// static mode's encoder over the float32 projection's xw, and its decoder
// over the int8 projection's) emits out[t] = round(h * 127), ties to even
// (or, kFloatOut, the float epilogue's h in float32 or bfloat16), and sums
// as the bf16 core's codes kinds do: the recurrent part apart, from zero,
// each k16 step's sum joined with a rounded add, then gates = xw[t] + that
// part (xw = b + x-part, already summed by the projection), the cell's
// products and sums rounded apart, sigmoid(v) = 1 / (1 + e^-v) with its
// reciprocal rounded to nearest.  xw[t] joins after the product, so it is
// loaded during the product's last k16 step (held through the whole
// product, as the float kind holds it, the 96-row plan would run out of
// registers), from L2, where a prefetch issued during the last step's cell
// has put it.
//
// Products.  3xTF32 on mma.sync m16n8k8: each float32 operand splits into
// hi = tf32(v) and lo = v - hi when its fragment is loaded
// (mma_ptx.cuh:split_tf32), and a k16 step sums a_lo b_hi + a_hi b_lo +
// a_hi b_hi from zero on the tensor cores and adds that to the gates with
// a rounded add.  Plain TF32 keeps 11 bits and fails the twin's 1e-5; the
// split keeps about 21, and the rounded adds keep the tensor cores'
// truncating running sum out of a sum over 16 k16 steps.  Each of the
// three products is issued over all the warp's tiles before the next, so
// that no mma waits on the one before it.
//
// Layout.  A float32 W_hh is 1 MB at H=256, so its split is wider than the
// bf16 core's: every CTA holds kF32Units = 32 units, so a cluster has H/32
// CTAs (8 at H=256, the portable maximum) and each holds its slice's 128
// gate columns k-major, [4U][H] floats (128 KB at H=256), transposed from
// W_hh's (H, 4H) once per launch.  k-major, so that a B fragment is an
// ldmatrix matrix as it stands (ldmatrix moves 16-bit elements: its
// transposing form cannot turn 32-bit ones).  The A tile holds f32 h,
// [R][H + 4].  The A tile's pad, and the slice's swizzle of its 16-byte
// chunks (f32_w_at), put the 8 rows of an ldmatrix matrix on 8 distinct
// bank groups.
// * 4 x kGroups warps: warp w runs the 8 units w % 4 of the CTA's four
//   groups for the kMT m16 tiles of row group w / 4, so kGroups warps of
//   each scheduler take turns between product and cell.
// * R = 16 * kMT * kGroups rows a cluster is 32, 64 or 96 (pick_f32_rows,
//   as pick_rows; 96 fills 226 KB of the 227): an H100 runs 15 clusters of
//   8 at once, so B=4096 takes 3 waves of 96 rows where 64 would take 5.
//   The plan is printed by lstm_direction_fused_plan and
//   lstm_recurrence_plan with dtype 0.
// * Each row's sums run in one order whatever the plan (the k16 steps of
//   the CTA's own 32 units first, then the others in order; k8 steps and
//   the three products in order, one rounded add a k16 step), so a row's
//   result does not depend on B or on the rows beside it.  The own units'
//   h is in the CTA's A tile before its peers' slices arrive, so the next
//   step's own part runs inside the exchange, between its cluster arrive
//   and wait.
// * h is exchanged as the bf16 core's is: each CTA writes its 32 units of
//   its R rows into its own A tile and pushes them into its peers' tiles
//   (st.shared::cluster, 16 bytes a store), between split cluster
//   barriers.
//
// Bound.  2*T*B*H*4H operations of the recurrence (70.9 GFLOP at B=4096,
// T=33, H=256), three times that on the TF32 tensor cores: 0.43 ms at 495
// TFLOP/s against 1.06 ms at the 67 TFLOP/s of float32 FMAs; xw in (553
// MB, 0.17 ms) is below both.

constexpr int kF32Units = 32;
constexpr int kF32Pad = 4;         // floats past each shared row
constexpr int kF32MaxCluster = kMaxHidden / kF32Units;

inline int f32_cluster_size(int H) { return H / kF32Units; }

// W_hh's slice [4U][H] (swizzled, no pad) and the A tile [R][H + 4]
inline size_t f32_smem_bytes(int H, int rows) {
  return (static_cast<size_t>(4 * kF32Units) * H +
          static_cast<size_t>(rows) * (H + kF32Pad)) *
         sizeof(float);
}

// Where W_hh's slice keeps element k of local column lc: the 16-byte chunk
// k / 4 of the row moves to chunk (k / 4) ^ (lc % 8), so that the 8 rows
// of an ldmatrix matrix (8 consecutive columns) fall on 8 distinct bank
// groups without a pad (a pad of 4 floats a row would leave no room for a
// 96-row A tile).
__device__ __forceinline__ int f32_w_at(int lc, int k, int H) {
  return lc * H + ((((k >> 2) ^ (lc & 7))) << 2) + (k & 3);
}

struct F32Direction {
  const float* w_hh;  // (H, 4H)
  const float* xw;    // (T, B, 4H)
  void* out;          // (T, B, H): float, or int8 codes (kCodes)
  int reverse;
};

struct F32Args {
  int steps, B, H;
  F32Direction dir[2];  // blockIdx.y picks one
  int out_kind;         // kFloatOut: kOutF32 or kOutBf16
};

template <int kGroups, int kMT, bool kCodes, bool kFloatOut>
__global__ void __launch_bounds__(128 * kGroups, 1)
    f32_core_kernel(const F32Args a) {
  static_assert(kCodes || !kFloatOut,
                "the float epilogue is the codes kind's");
  using CodesKind = Kind<float, int8_t>;
  constexpr int R = 16 * kMT * kGroups;
  constexpr int kThreads = 128 * kGroups;
  constexpr int U = kF32Units;
  cg::cluster_group cluster = cg::this_cluster();
  const int n = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const F32Direction d = blockIdx.y ? a.dir[1] : a.dir[0];
  const int B = a.B, steps = a.steps, H = a.H;
  const int out_kind = a.out_kind;
  const int G = 4 * H;
  const int b0 = static_cast<int>(blockIdx.x) / n * R;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int quad = lane / 4, pair = 2 * (lane % 4);
  const int group = warp % 4;
  const int row0 = warp / 4 * 16 * kMT;  // the warp's first row
  const int unit = rank * U + group * 8 + pair;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = H + kF32Pad;
  float* ws = reinterpret_cast<float*>(smem_raw);  // [4U][H], k-major
  float* hs = ws + 4 * U * H;                       // [R][ld]

  // W_hh's slice, transposed: local column g'*32 + q*8 + j is gate q of
  // unit rank*U + g'*8 + j.  Thread i reads 4 columns of row k = i % H (a
  // warp writes 32 consecutive k of a column: no bank conflict).
  for (int i = tid; i < H * (4 * U / 4); i += kThreads) {
    const int k = i % H, lc = i / H * 4;
    const float4 v = *reinterpret_cast<const float4*>(
        d.w_hh + static_cast<size_t>(k) * G + (lc % 32) / 8 * H + rank * U +
        lc / 32 * 8 + lc % 8);
    ws[f32_w_at(lc + 0, k, H)] = v.x;
    ws[f32_w_at(lc + 1, k, H)] = v.y;
    ws[f32_w_at(lc + 2, k, H)] = v.z;
    ws[f32_w_at(lc + 3, k, H)] = v.w;
  }
  for (int i = tid; i < R * ld / 4; i += kThreads) {
    reinterpret_cast<float4*>(hs)[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }

  // acc[mt][q][2e+j]: gate q of unit `unit + j`, row row0 + mt*16 + quad +
  // 8e of the cluster, from xw[t] (loaded into nxt a step ahead; the codes
  // kind from zero, xw[t] loaded into nxt during the last k16 step)
  float nxt[kMT][4][4];
  auto load_xw = [&](int t) {
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = b0 + row0 + mt * 16 + quad + 8 * e;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float2 v = make_float2(0.0f, 0.0f);
          if (row < B) {
            v = load_pair(d.xw + (static_cast<size_t>(t) * B + row) * G +
                          q * H + unit);
          }
          nxt[mt][q][2 * e] = v.x;
          nxt[mt][q][2 * e + 1] = v.y;
        }
      }
    }
  };
  // the codes kind's xw[t] into L2 a step ahead of its load
  auto prefetch_xw = [&](int t) {
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = b0 + row0 + mt * 16 + quad + 8 * e;
        if (row < B) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            asm volatile("prefetch.global.L2 [%0];\n" ::"l"(
                d.xw + (static_cast<size_t>(t) * B + row) * G + q * H +
                unit));
          }
        }
      }
    }
  };
  if constexpr (kCodes) {
    prefetch_xw(d.reverse ? steps - 1 : 0);
  } else {
    load_xw(d.reverse ? steps - 1 : 0);
  }
  __syncthreads();  // W_hh's slice and h0 in place

  float c[kMT][4];
  float2 hw[kMT][2];  // the thread's two units of h by row
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) c[mt][i] = 0.0f;
  }

  // ldmatrix addresses: A rows by lane (matrices: rows 0-7 and 8-15 of k
  // 0-3, then of k 4-7); B columns by lane (gate q's b0 and b1, then gate
  // q+1's, 16 columns further for gates 2 and 3), each lane's chunk of k8
  // step kk being (kk / 4 + b_half) ^ (lane % 8) (f32_w_at)
  const float* a_base = hs + (row0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld +
                        (lane >> 4) * 4;
  const float* b_row = ws + (group * 32 + (lane >> 4) * 8 + (lane & 7)) * H;
  const int b_half = (lane >> 3) & 1, b_swz = lane & 7;

  float acc[kMT][4][4];
  // a step's sums start from xw[t] (the codes kind's from zero)
  auto start_sums = [&]() {
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          acc[mt][q][v] = kCodes ? 0.0f : nxt[mt][q][v];
        }
      }
    }
  };
  // the product over the k16 step kk: from zero into part, then one
  // rounded add
  auto product_k16 = [&](int kk) {
    float part[kMT][4][4] = {};
#pragma unroll
    for (int k8 = kk; k8 < kk + 16; k8 += 8) {
      unsigned bw[2][4], b_hi[2][4], b_lo[2][4];
      const float* b_at = b_row + ((((k8 >> 2) + b_half) ^ b_swz) << 2);
      ldmatrix_x4(bw[0], b_at);
      ldmatrix_x4(bw[1], b_at + 16 * H);
      split_tf32(bw[0], b_hi[0], b_lo[0]);
      split_tf32(bw[1], b_hi[1], b_lo[1]);
      unsigned a_hi[kMT][4], a_lo[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        unsigned af[4];
        ldmatrix_x4(af, a_base + mt * 16 * ld + k8);
        split_tf32(af, a_hi[mt], a_lo[mt]);
      }
      // a_lo b_hi, then a_hi b_lo, then a_hi b_hi, each over every tile
#pragma unroll
      for (int pass = 0; pass < 3; ++pass) {
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int p = q / 2, r = 2 * (q % 2);
            const unsigned(&af)[4] = pass == 0 ? a_lo[mt] : a_hi[mt];
            const unsigned(&bf)[4] = pass == 1 ? b_lo[p] : b_hi[p];
            mma_tf32(part[mt][q], af, bf[r], bf[r + 1]);
          }
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          acc[mt][q][v] = __fadd_rn(acc[mt][q][v], part[mt][q][v]);
        }
      }
    }
  };
  // Each step sums the k16 steps of this CTA's own units first (their h is
  // in its A tile before the peers' slices arrive: the next step's own part
  // runs between the exchange's arrive and wait), then the rest in order;
  // a row's order of sums depends on its columns alone, not on B.
  const int own = rank * U;
  start_sums();
  for (int kk = own; kk < own + U; kk += 16) product_k16(kk);

  for (int s = 0; s < steps; ++s) {
    const int t = d.reverse ? steps - 1 - s : s;
    const bool more = s + 1 < steps;
    // the other units' k16 steps in order, the last of them (-16: none)
    // apart: the codes kind loads xw[t] before it, so that the loads are in
    // flight during its products (held through all of them, xw would take
    // registers the 96-row plan does not have)
    const int last = own + U < H ? H - 16 : own - 16;
    for (int kk = 0; kk < own && kk != last; kk += 16) product_k16(kk);
    for (int kk = own + U; kk < last; kk += 16) product_k16(kk);
    if constexpr (kCodes) {
      asm volatile("" ::: "memory");  // the loads stay below the product
      load_xw(t);
    }
    if (last >= 0) product_k16(last);
    if constexpr (kCodes) {
      // gates = xw[t] + the recurrent part, the plain version's order
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            acc[mt][q][v] = __fadd_rn(nxt[mt][q][v], acc[mt][q][v]);
          }
        }
      }
    }
    cluster_arrive();  // done reading the A tile
    if (more) {
      if constexpr (kCodes) {
        prefetch_xw(d.reverse ? t - 1 : t + 1);
      } else {
        load_xw(d.reverse ? t - 1 : t + 1);
      }
    }

    const size_t base = static_cast<size_t>(t) * B;
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float h[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int v = 2 * e + j;
          float& cv = c[mt][v];
          if constexpr (kCodes) {
            const float ig = gate_sigmoid<CodesKind>(acc[mt][0][v]);
            const float fg = gate_sigmoid<CodesKind>(acc[mt][1][v]);
            const float gg = tanhf(acc[mt][2][v]);
            const float og = gate_sigmoid<CodesKind>(acc[mt][3][v]);
            cv = __fadd_rn(__fmul_rn(fg, cv), __fmul_rn(ig, gg));
            h[j] = __fmul_rn(og, tanhf(cv));
          } else {
            const float ig = sigmoid(acc[mt][0][v]);
            const float fg = sigmoid(acc[mt][1][v]);
            const float gg = tanhf(acc[mt][2][v]);
            const float og = sigmoid(acc[mt][3][v]);
            cv = fg * cv + ig * gg;
            h[j] = og * tanhf(cv);
          }
        }
        hw[mt][e] = make_float2(h[0], h[1]);
        const int row = b0 + row0 + mt * 16 + quad + 8 * e;
        if (row < B) {
          const size_t o = (base + row) * H + unit;
          if constexpr (kFloatOut) {
            store_h(d.out, out_kind, o, h[0], h[1]);
          } else if constexpr (kCodes) {
            *reinterpret_cast<unsigned short*>(static_cast<int8_t*>(d.out) +
                                               o) =
                static_cast<unsigned short>(pack_codes(h[0], h[1]));
          } else {
            *reinterpret_cast<float2*>(static_cast<float*>(d.out) + o) =
                hw[mt][e];
          }
        }
      }
    }
    if (!more) break;
    cluster_wait();  // every CTA of the cluster is done with its A tile

#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        *reinterpret_cast<float2*>(
            hs + (row0 + mt * 16 + quad + 8 * e) * ld + unit) = hw[mt][e];
      }
    }
    __syncthreads();  // the slice is whole
    // U floats a row, in 16-byte pieces
    constexpr int kSliceChunks = U / 4;
    for (int i = tid; i < R * kSliceChunks; i += kThreads) {
      const int r = i / kSliceChunks;
      const int off = r * ld + rank * U + (i - r * kSliceChunks) * 4;
      const uint4 v = *reinterpret_cast<const uint4*>(hs + off);
#pragma unroll
      for (int p = 0; p < kF32MaxCluster; ++p) {
        if (p < n && p != rank) st_cluster_v4(map_rank(hs + off, p), v);
      }
    }
    cluster_arrive();
    start_sums();
    for (int kk = own; kk < own + U; kk += 16) product_k16(kk);
    cluster_wait();  // every slice of h in place
  }
  cluster_wait();  // pairs the last step's arrive
}

template <int kGroups, int kMT, bool kCodes, bool kFloatOut>
struct F32Tag {};

template <int kGroups, int kMT>
void fill_f32_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr,
                     int H, int clusters, int dirs, cudaStream_t stream) {
  const int n = f32_cluster_size(H);
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(clusters * n, dirs, 1);
  cfg.blockDim = dim3(128 * kGroups, 1, 1);
  cfg.dynamicSmemBytes = f32_smem_bytes(H, 16 * kMT * kGroups);
  cfg.stream = stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = n;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
}

// How many clusters of the float32 core run at once on `device` at width H
// (asked once per device and H).
template <int kGroups, int kMT, bool kCodes>
cudaError_t max_f32_clusters(int device, int H, int* count) {
  static std::mutex mu;
  static std::map<std::tuple<int, int>, int> memo;
  std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_tuple(device, H);
  const auto found = memo.find(key);
  if (found != memo.end()) {
    *count = found->second;
    return cudaSuccess;
  }
  auto kernel = f32_core_kernel<kGroups, kMT, kCodes, false>;
  cudaError_t err = ensure_smem_limit<F32Tag<kGroups, kMT, kCodes, false>>(
      reinterpret_cast<const void*>(kernel), device);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  fill_f32_config<kGroups, kMT>(cfg, attr, H, 1, 1, nullptr);
  err = cudaOccupancyMaxActiveClusters(count, kernel, &cfg);
  if (err != cudaSuccess) return err;
  memo[key] = *count;
  return cudaSuccess;
}

// The plans of the float32 core, (kGroups, kMT): 32 rows a cluster (two
// row groups of one m16 tile), 64 (two of two) and 96 (three of two).
#define LSTM_F32_32 2, 1
#define LSTM_F32_64 2, 2
#define LSTM_F32_96 3, 2

// The rows a cluster of the float32 core for dirs directions of B rows:
// the fewest of 32, 64 and 96 whose clusters all run in one wave, else 96.
template <bool kCodes>
cudaError_t pick_f32_rows(int B, int H, int dirs, int device, int* rows,
                          int* count) {
  cudaError_t err;
#define LSTM_F32_TRY(ROWS, PLAN)                                            \
  err = max_f32_clusters<PLAN, kCodes>(device, H, count);                 \
  if (err != cudaSuccess) return err;                                     \
  *rows = ROWS;                                                           \
  if (static_cast<long long>(dirs) * ((B + ROWS - 1) / ROWS) <= *count) {  \
    return cudaSuccess;                                                   \
  }
  LSTM_F32_TRY(32, LSTM_F32_32)
  LSTM_F32_TRY(64, LSTM_F32_64)
#undef LSTM_F32_TRY
  *rows = 96;
  return max_f32_clusters<LSTM_F32_96, kCodes>(device, H, count);
}

template <int kGroups, int kMT, bool kCodes, bool kFloatOut>
cudaError_t launch_f32_rows(const F32Args& a, int dirs, int device,
                            cudaStream_t stream) {
  auto kernel = f32_core_kernel<kGroups, kMT, kCodes, kFloatOut>;
  cudaError_t err = ensure_smem_limit<F32Tag<kGroups, kMT, kCodes, kFloatOut>>(
      reinterpret_cast<const void*>(kernel), device);
  if (err != cudaSuccess) return err;
  constexpr int rows = 16 * kMT * kGroups;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  fill_f32_config<kGroups, kMT>(cfg, attr, a.H, (a.B + rows - 1) / rows,
                                dirs, stream);
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The float32 core over dirs directions of a (kCodes: the codes kind;
// kFloatOut: its float epilogue, which no served mode runs and which takes
// the widest plan alone: a row's sums do not depend on the plan).  Each xw
// must start on 8 bytes and each W_hh on 16.
template <bool kCodes, bool kFloatOut = false>
cudaError_t launch_f32_core(const F32Args& a, int dirs,
                            cudaStream_t stream) {
  for (int i = 0; i < dirs; ++i) {
    if (reinterpret_cast<uintptr_t>(a.dir[i].w_hh) % 16 != 0 ||
        a.dir[i].xw == nullptr ||
        reinterpret_cast<uintptr_t>(a.dir[i].xw) % 8 != 0) {
      return cudaErrorMisalignedAddress;
    }
  }
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if constexpr (kFloatOut) {
    return launch_f32_rows<LSTM_F32_96, kCodes, true>(a, dirs, device,
                                                      stream);
  } else {
    int rows = 0, count = 0;
    err = pick_f32_rows<kCodes>(a.B, a.H, dirs, device, &rows, &count);
    if (err != cudaSuccess) return err;
    switch (rows) {
      case 32:
        return launch_f32_rows<LSTM_F32_32, kCodes, false>(a, dirs, device,
                                                           stream);
      case 64:
        return launch_f32_rows<LSTM_F32_64, kCodes, false>(a, dirs, device,
                                                           stream);
      default:
        return launch_f32_rows<LSTM_F32_96, kCodes, false>(a, dirs, device,
                                                           stream);
    }
  }
}

#undef LSTM_F32_32
#undef LSTM_F32_64
#undef LSTM_F32_96

// The float32 recurrence of dirs directions over their xw (which holds the
// input projection and the bias); direction i runs reversed where
// reverse[i].  xw must start on 8 bytes and W_hh on 16.
inline cudaError_t launch_recurrence_f32(const float* const* xw,
                                         const void* const* w_hh,
                                         void* const* out, const int* reverse,
                                         int dirs, int steps, int B, int H,
                                         cudaStream_t stream) {
  F32Args a{};
  a.steps = steps;
  a.B = B;
  a.H = H;
  for (int i = 0; i < dirs; ++i) {
    a.dir[i] = {static_cast<const float*>(w_hh[i]), xw[i], out[i],
                reverse[i]};
  }
  return launch_f32_core<false>(a, dirs, stream);
}

// The static kernel's float32 W_hh (H, 4H): one direction over its float32
// xw (b + x-part, from the float32 or the int8 projection) on the float32
// core's codes kind, out as out_kind (kOut*).
inline cudaError_t launch_static_f32(const float* xw, const void* w_hh,
                                     void* out, int out_kind, int reverse,
                                     int steps, int B, int H,
                                     cudaStream_t stream) {
  if (out_kind < kOutF32 || out_kind > kOutInt8) return cudaErrorInvalidValue;
  F32Args a{};
  a.steps = steps;
  a.B = B;
  a.H = H;
  a.dir[0] = {static_cast<const float*>(w_hh), xw, out, reverse};
  a.out_kind = out_kind;
  return out_kind == kOutInt8 ? launch_f32_core<true>(a, 1, stream)
                              : launch_f32_core<true, true>(a, 1, stream);
}

// The float32 core's plan (as plan_of reports the bf16 core's), for its
// float kind or (codes) its codes kind.
inline cudaError_t f32_plan(int B, int H, int dirs, int* out,
                            bool codes = false) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  int rows = 0, count = 0;
  err = codes ? pick_f32_rows<true>(B, H, dirs, device, &rows, &count)
              : pick_f32_rows<false>(B, H, dirs, device, &rows, &count);
  if (err != cudaSuccess) return err;
  out[0] = rows;
  out[1] = f32_cluster_size(H);
  out[2] = (B + rows - 1) / rows;
  out[3] = count;
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// The float32 input projection (rows 1 and 3 in float32, every F): for each
// direction xw[m][n] = sum_k [x_0 x_1][m][k] * [W_ih_0; W_ih_1][k][n] + b[n],
// the bias added to the finished sum.  Two kernels, by F.
// * More than kNarrowMax features (the decoder's 512): 3xTF32 on the tensor
//   cores, with the bf16 projection's tiling: 128 x 128 tiles of one
//   direction a block, 8 warps of 64 x 32, k-tiles of 16 floats in a ring
//   of kPStages, cp.async where every row of x and W starts on 16 bytes.
//   The A tile [128][16 + 4] loads by ldmatrix; the B tile [16][128 + 8]
//   by 32-bit loads (b0 is row i, column g: the pad of 8 puts a warp's 32
//   on 32 banks).  A k8 step's three products go into a sum from zero a
//   column tile and join the tile's sum with a rounded add (a k16 step's
//   sums of all 16 tiles would not fit in the registers of two blocks an
//   SM).  Bound: 2*M*F*4H operations, three times that on the TF32 tensor
//   cores (the decoder's 425 GFLOP-equivalent at B=4096: 0.86 ms at 495
//   TFLOP/s), above x in and xw out.
// * At most kNarrowMax (the encoders' 26 or, at HP, 48 window values,
//   integers up to 127): float32 FMAs, k in order from zero
//   (projection_narrow_kernel).  3xTF32 keeps ~21 bits of each product,
//   and with such inputs the HP encoder's h strayed 1.2e-5 from the
//   twin's; FMAs keep float32's 24.  Its products are 5-8% of the
//   encoder's; its bound is the xw it writes (553 MB at B=4096: 0.165 ms).

constexpr int kQK = 16;
constexpr int kNarrowMax = 64;      // features the FMA projection takes
constexpr int kNarrowRows = 64;     // rows a block of it, a tile
constexpr int kNarrowThreads = 128;  // threads a block, two columns each
constexpr int kNarrowBlocks = 256;  // row tiles walked at once

struct ProjF32Dir {
  const float* w0;    // (F0, N)
  const float* w1;    // (F1, N) or null
  const float* bias;  // (N,)
  float* xw;          // (M, N)
};

struct ProjF32Args {
  const float* x0;    // (M, F0)
  const float* x1;    // (M, F1) or null
  int F0, F1, M, N;
  ProjF32Dir dir[2];
};

struct ProjF32Stage {
  float a[kPM][kQK + kF32Pad];
  float b[kQK][kPN + 8];
};

// 4 consecutive floats of row m of [x0 x1] (or of W's row k) from k (from
// n), element by element, zeros past the ends
__device__ __forceinline__ float4 x_chunk_f32(const float* x0,
                                              const float* x1, int F0,
                                              int F1, int M, int m, int k) {
  float v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kk = k + i;
    v[i] = m >= M || kk >= F0 + F1 ? 0.0f
           : kk < F0               ? x0[static_cast<size_t>(m) * F0 + kk]
                     : x1[static_cast<size_t>(m) * F1 + kk - F0];
  }
  return make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ float4 w_chunk_f32(const float* w0,
                                              const float* w1, int F0,
                                              int F1, int N, int k, int n) {
  if (k >= F0 + F1) return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const float* row = k < F0 ? w0 + static_cast<size_t>(k) * N
                            : w1 + static_cast<size_t>(k - F0) * N;
  return make_float4(row[n], row[n + 1], row[n + 2], row[n + 3]);
}

template <bool kVec>
__global__ void __launch_bounds__(kPThreads, 2)
    projection_f32_kernel(const ProjF32Args a) {
  extern __shared__ __align__(16) unsigned char proj_smem[];
  ProjF32Stage* stage = reinterpret_cast<ProjF32Stage*>(proj_smem);
  const int tiles_n = a.N / kPN;
  const int dir = static_cast<int>(blockIdx.x) / tiles_n;
  const ProjF32Dir d = dir ? a.dir[1] : a.dir[0];
  const float* x0 = a.x0;
  const float* x1 = a.x1;
  const int F0 = a.F0, F1 = a.F1, M = a.M, N = a.N;
  const int n0 = (static_cast<int>(blockIdx.x) % tiles_n) * kPN;
  const int K = F0 + F1;
  const int k_tiles = (K + kQK - 1) / kQK;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int quad = lane / 4, col = lane % 4;
  const int wm = warp / 4, wn = warp % 4;  // a 64 x 32 warp tile

  for (int m0 = static_cast<int>(blockIdx.y) * kPM; m0 < M;
       m0 += static_cast<int>(gridDim.y) * kPM) {
    auto load = [&](int st, int kt) {
      const int k0 = kt * kQK;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int c = tid + i * kPThreads;
        const int m = m0 + c / 4, k = k0 + (c % 4) * 4;  // A: 128 x 4 chunks
        float* a_dst = &stage[st].a[c / 4][(c % 4) * 4];
        const int kb = k0 + c / 32, n = n0 + (c % 32) * 4;  // B: 16 x 32
        float* b_dst = &stage[st].b[c / 32][(c % 32) * 4];
        if constexpr (kVec) {
          const bool a_ok = m < M && k < K;
          const float* a_src =
              !a_ok ? x0
              : k < F0 ? x0 + static_cast<size_t>(m) * F0 + k
                       : x1 + static_cast<size_t>(m) * F1 + k - F0;
          cp_async16_zfill(a_dst, a_src, a_ok);
          const bool b_ok = kb < K;
          const float* b_src =
              !b_ok ? d.w0
              : kb < F0 ? d.w0 + static_cast<size_t>(kb) * N + n
                        : d.w1 + static_cast<size_t>(kb - F0) * N + n;
          cp_async16_zfill(b_dst, b_src, b_ok);
        } else {
          *reinterpret_cast<float4*>(a_dst) =
              x_chunk_f32(x0, x1, F0, F1, M, m, k);
          *reinterpret_cast<float4*>(b_dst) =
              w_chunk_f32(d.w0, d.w1, F0, F1, N, kb, n);
        }
      }
    };
    float acc[4][4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.0f;
      }
    }
#pragma unroll
    for (int st = 0; st < kPStages - 1; ++st) {
      if (st < k_tiles) load(st, st);
      cp_async_commit();
    }
    for (int kt = 0; kt < k_tiles; ++kt) {
      cp_async_wait<kPStages - 2>();
      __syncthreads();  // k-tile kt is in place; stage (kt-1) % S is free
      if (kt + kPStages - 1 < k_tiles) {
        load((kt + kPStages - 1) % kPStages, kt + kPStages - 1);
      }
      cp_async_commit();
      const ProjF32Stage& sm = stage[kt % kPStages];
#pragma unroll
      for (int kk = 0; kk < kQK; kk += 8) {
        unsigned b_hi[4][2], b_lo[4][2];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int n = wn * 32 + nt * 8 + quad;
          const unsigned bw[2] = {__float_as_uint(sm.b[kk + col][n]),
                                  __float_as_uint(sm.b[kk + col + 4][n])};
          split_tf32(bw, b_hi[nt], b_lo[nt]);
        }
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          unsigned af[4], a_hi[4], a_lo[4];
          ldmatrix_x4(af, &sm.a[wm * 64 + mt * 16 + (lane & 7) +
                                ((lane >> 3) & 1) * 8][kk + (lane >> 4) * 4]);
          split_tf32(af, a_hi, a_lo);
          // a_lo b_hi, then a_hi b_lo, then a_hi b_hi, each over the four
          // column tiles
          float part[4][4] = {};
#pragma unroll
          for (int pass = 0; pass < 3; ++pass) {
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
              const unsigned(&ap)[4] = pass == 0 ? a_lo : a_hi;
              const unsigned(&bp)[2] = pass == 1 ? b_lo[nt] : b_hi[nt];
              mma_tf32(part[nt], ap, bp[0], bp[1]);
            }
          }
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
            for (int v = 0; v < 4; ++v) {
              acc[mt][nt][v] = __fadd_rn(acc[mt][nt][v], part[nt][v]);
            }
          }
        }
      }
    }
    // the bias goes onto the finished sum
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int n = n0 + wn * 32 + nt * 8 + 2 * col;
      const float b_lo = d.bias[n], b_hi = d.bias[n + 1];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int m = m0 + wm * 64 + mt * 16 + quad + 8 * e;
          if (m < M) {
            *reinterpret_cast<float2*>(d.xw + static_cast<size_t>(m) * N +
                                       n) =
                make_float2(__fadd_rn(acc[mt][nt][2 * e], b_lo),
                            __fadd_rn(acc[mt][nt][2 * e + 1], b_hi));
          }
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // every stage is read before the next rows' loads
  }
}

// The narrow float32 projection: a block owns 2 * kNarrowThreads columns
// of one direction (two adjacent ones a thread, their columns of W in
// registers, kF rows each: the features rounded up to 28, 48 or 64) and
// steps over rows kNarrowRows at a time, staged in shared memory and read
// as 16-byte broadcasts, four rows at once (eight FMA chains a thread);
// xw[m][n] = (sum_k x[m][k] * W[k][n], FMAs from zero, k in order) + b[n],
// stored two columns at a time.  A block walks many row tiles
// (kNarrowBlocks of them cover the rows), so W is read once a block.
template <int kF>
__global__ void __launch_bounds__(kNarrowThreads)
    projection_narrow_kernel(const ProjF32Args a) {
  constexpr int kCols = 2 * kNarrowThreads;
  constexpr int kAtOnce = 4;  // rows a thread sums at once
  __shared__ __align__(16) float xs[kNarrowRows][kF];
  const int tiles_n = (a.N + kCols - 1) / kCols;
  const ProjF32Dir d =
      static_cast<int>(blockIdx.x) / tiles_n ? a.dir[1] : a.dir[0];
  const float* x0 = a.x0;
  const float* x1 = a.x1;
  const int F0 = a.F0, F1 = a.F1, F = F0 + F1, M = a.M, N = a.N;
  // the block's last columns lie past N where N is not a multiple of kCols
  const int n = min((static_cast<int>(blockIdx.x) % tiles_n) * kCols +
                        2 * static_cast<int>(threadIdx.x),
                    N - 2);
  const bool live = (static_cast<int>(blockIdx.x) % tiles_n) * kCols +
                        2 * static_cast<int>(threadIdx.x) <
                    N;
  float w[kF][2];
  if (F1 == 0) {
#pragma unroll
    for (int k = 0; k < kF; ++k) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        w[k][c] = k < F ? d.w0[static_cast<size_t>(k) * N + n + c] : 0.0f;
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < kF; ++k) {
      const float* row = k < F0 ? d.w0 + static_cast<size_t>(k) * N
                                : d.w1 + static_cast<size_t>(k - F0) * N;
#pragma unroll
      for (int c = 0; c < 2; ++c) w[k][c] = k < F ? row[n + c] : 0.0f;
    }
  }
  const float b0 = d.bias[n], b1 = d.bias[n + 1];
  for (int m0 = static_cast<int>(blockIdx.y) * kNarrowRows; m0 < M;
       m0 += static_cast<int>(gridDim.y) * kNarrowRows) {
    __syncthreads();  // the last rows are read
    // (one part, the encoders' case, in a loop of its own: with both
    // parts' selects in one loop this kernel took 0.40-0.42 ms for the
    // 33x26 encoder's xw at B=4096 on an H100; PERF.md section 7)
    if (F1 == 0) {
      for (int i = threadIdx.x; i < kNarrowRows * kF; i += kNarrowThreads) {
        const int r = i / kF, k = i % kF, m = m0 + r;
        xs[r][k] =
            m >= M || k >= F ? 0.0f : x0[static_cast<size_t>(m) * F0 + k];
      }
    } else {
      for (int i = threadIdx.x; i < kNarrowRows * kF; i += kNarrowThreads) {
        const int r = i / kF, k = i % kF, m = m0 + r;
        xs[r][k] = m >= M || k >= F ? 0.0f
                   : k < F0 ? x0[static_cast<size_t>(m) * F0 + k]
                            : x1[static_cast<size_t>(m) * F1 + k - F0];
      }
    }
    __syncthreads();
    // rows past M are zeros in the tile: summed, never stored
    for (int r = 0; r < kNarrowRows; r += kAtOnce) {
      float acc[kAtOnce][2] = {};
#pragma unroll
      for (int k4 = 0; k4 < kF / 4; ++k4) {
#pragma unroll
        for (int i = 0; i < kAtOnce; ++i) {
          const float4 x =
              *reinterpret_cast<const float4*>(&xs[r + i][4 * k4]);
          const float xv[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              acc[i][c] = __fmaf_rn(xv[j], w[4 * k4 + j][c], acc[i][c]);
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kAtOnce; ++i) {
        if (live && m0 + r + i < M) {
          *reinterpret_cast<float2*>(
              d.xw + static_cast<size_t>(m0 + r + i) * N + n) =
              make_float2(__fadd_rn(acc[i][0], b0), __fadd_rn(acc[i][1], b1));
        }
      }
    }
  }
}

template <bool kVec>
struct ProjF32Tag {};

// The float32 xw_i = [x0 x1] @ [w0_i; w1_i] + bias_i for dirs directions,
// from one read of x.
inline cudaError_t launch_projections_f32(
    const void* x0, const void* x1, int F0, int F1, const void* const* w0,
    const void* const* w1, const void* const* bias, float* const* xw,
    int dirs, int steps, int B, int H, cudaStream_t stream) {
  ProjF32Args p{};
  p.x0 = static_cast<const float*>(x0);
  p.x1 = static_cast<const float*>(x1);
  p.F0 = F0;
  p.F1 = F1;
  p.M = steps * B;
  p.N = 4 * H;
  auto aligned = [](const void* q) {
    return reinterpret_cast<uintptr_t>(q) % 16 == 0;
  };
  bool vec = F0 % 4 == 0 && F1 % 4 == 0 && aligned(x0) && aligned(x1);
  for (int i = 0; i < dirs; ++i) {
    if (xw[i] == nullptr || reinterpret_cast<uintptr_t>(xw[i]) % 8 != 0) {
      return cudaErrorInvalidValue;
    }
    vec = vec && aligned(w0[i]) && aligned(w1[i]);
    p.dir[i] = {static_cast<const float*>(w0[i]),
                static_cast<const float*>(w1[i]),
                static_cast<const float*>(bias[i]), xw[i]};
  }
  if (F0 + F1 <= kNarrowMax) {
    const int m_tiles = (p.M + kNarrowRows - 1) / kNarrowRows;
    constexpr int kCols = 2 * kNarrowThreads;
    const dim3 grid(dirs * ((p.N + kCols - 1) / kCols),
                    m_tiles < kNarrowBlocks ? m_tiles : kNarrowBlocks);
    if (F0 + F1 <= 28) {
      projection_narrow_kernel<28><<<grid, kNarrowThreads, 0, stream>>>(p);
    } else if (F0 + F1 <= 48) {
      projection_narrow_kernel<48><<<grid, kNarrowThreads, 0, stream>>>(p);
    } else {
      projection_narrow_kernel<kNarrowMax>
          <<<grid, kNarrowThreads, 0, stream>>>(p);
    }
    return cudaGetLastError();
  }
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  auto kernel = vec ? projection_f32_kernel<true> : projection_f32_kernel<false>;
  err = vec ? ensure_smem_limit<ProjF32Tag<true>>(
                  reinterpret_cast<const void*>(kernel), device)
            : ensure_smem_limit<ProjF32Tag<false>>(
                  reinterpret_cast<const void*>(kernel), device);
  if (err != cudaSuccess) return err;
  const int m_tiles = (p.M + kPM - 1) / kPM;
  const dim3 grid(dirs * (p.N / kPN), m_tiles < 65535 ? m_tiles : 65535);
  kernel<<<grid, kPThreads, kPStages * sizeof(ProjF32Stage), stream>>>(p);
  return cudaGetLastError();
}

// dirs float32 LSTM directions over the feature parts x0, x1: every F is
// projected into each direction's float32 xw first, then the float32 core
// runs over it.
inline cudaError_t launch_directions_f32(
    const void* x0, const void* x1, int F0, int F1, const void* const* w0,
    const void* const* w1, const void* const* bias, const void* const* w_hh,
    float* const* xw, void* const* out, const int* reverse, int dirs,
    int steps, int B, int H, cudaStream_t stream) {
  cudaError_t err = launch_projections_f32(x0, x1, F0, F1, w0, w1, bias, xw,
                                           dirs, steps, B, H, stream);
  if (err != cudaSuccess) return err;
  const float* xws[2] = {xw[0], dirs > 1 ? xw[1] : nullptr};
  return launch_recurrence_f32(xws, w_hh, out, reverse, dirs, steps, B, H,
                               stream);
}

}  // namespace

}  // namespace lstm
