// The bfloat16 LSTM core that lstm_direction_fused.cu, bilstm_dual_fused.cu
// and lstm_recurrence.cu share, for Hopper (sm_90a).  Together with the
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
// The kernels and launchers have internal linkage, as in gru_core.cuh: both
// libraries instantiate the same templates, and a launcher's static with
// external linkage would be one object for both.

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

namespace lstm {

namespace {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

constexpr int kXMax = 32;          // input features that join the step's K
constexpr int kPad = 8;            // bf16 elements past each shared row
constexpr int kMaxCluster = 4;
constexpr int kCoreMaxThreads = 256;  // 8 warps: U = 64 units
constexpr int kCoreDevices = 64;

// One direction's operands.  Fused x: w_x0/w_x1 and bias; hoisted: xw, of
// element type XW (float or bf16).
template <typename XW = float>
struct Direction {
  const bf16* w_hh;   // (H, 4H)
  const bf16* w_x0;   // (F0, 4H)
  const bf16* w_x1;   // (F1, 4H) or null
  const bf16* bias;   // (4H,)
  const XW* xw;       // (T, B, 4H)
  bf16* out;          // (T, B, H)
  int reverse;
};

template <typename XW = float>
struct CoreArgs {
  const bf16* x0;     // (T, B, F0), read by the fused-x body
  const bf16* x1;     // (T, B, F1) or null
  int F0, F1, steps, B, H;
  Direction<XW> dir[2];  // blockIdx.y picks one
};

// xw[0..1] of one thread's two adjacent units, widened to f32
__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ float2 load_pair(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
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

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4],
                                            const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// d += a (16x16, row) @ b (16x8, col), bf16 in, f32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
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

inline int cluster_size(int H) { return H <= 64 ? 1 : H <= 128 ? 2 : 4; }

// shared memory of the core: W_hh's slice [H][4U + kPad] and the A tile
// [R][K + kPad] (bf(h), then x[t] when fused), K = H (+ kXMax when fused)
inline size_t core_smem_bytes(int H, int rows, bool fused_x) {
  const int K = H + (fused_x ? kXMax : 0);
  const int U = H / cluster_size(H);
  return (static_cast<size_t>(H) * (4 * U + kPad) +
          static_cast<size_t>(rows) * (K + kPad)) *
         sizeof(bf16);
}

// A cluster's R = 16 * kMT * kChunks rows, in kChunks chunks of kMT m16
// tiles (see the design above); XW, the hoisted body's xw element type.
template <int kMT, int kChunks, bool kFusedX, typename XW>
__global__ void __launch_bounds__(kCoreMaxThreads, 1)
    core_kernel(const CoreArgs<XW> a) {
  constexpr int R = 16 * kMT * kChunks;
  cg::cluster_group cluster = cg::this_cluster();
  const int n = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  // the parameters as locals: lambdas below capture these, not `a`
  const Direction<XW> d = blockIdx.y ? a.dir[1] : a.dir[0];
  const bf16* x0 = a.x0;
  const bf16* x1 = a.x1;
  const int F0 = a.F0, F1 = a.F1, B = a.B, steps = a.steps, H = a.H;
  const int U = H / n, G = 4 * H;
  const int K = H + (kFusedX ? kXMax : 0);
  const int ldw = 4 * U + kPad, ldh = K + kPad;
  const int b0 = static_cast<int>(blockIdx.x) / n * R;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid / 32, lane = tid % 32;
  const int quad = lane / 4, pair = 2 * (lane % 4);
  // this thread's two units of each gate's n8 tile
  const int unit = rank * U + warp * 8 + pair;
  const bool early = warp < 4;  // see the xw prefetch below

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ws = reinterpret_cast<bf16*>(smem_raw);  // [H][ldw]
  bf16* hs = ws + H * ldw;                        // [R][ldh]

  // W_hh's slice: local column warp'*32 + q*8 + j is gate q of unit
  // rank*U + warp'*8 + j
  const int row_chunks = 4 * U / 8;
  for (int i = tid; i < H * row_chunks; i += nthreads) {
    const int k = i / row_chunks, c = i - k * row_chunks;
    cp_async16(ws + k * ldw + c * 8,
               d.w_hh + static_cast<size_t>(k) * G + (c % 4) * H + rank * U +
                   (c / 4) * 8);
  }
  // h0 = 0, and zeros in every pad and in the x columns past F
  for (int i = tid; i < R * ldh / 8; i += nthreads) {
    reinterpret_cast<uint4*>(hs)[i] = make_uint4(0, 0, 0, 0);
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

  // x[t] of the cluster's rows into the A tile's columns H..H+F-1: element
  // idx is row idx / kXMax, feature idx % kXMax.  A thread loads kXRegs of
  // them (all of them at 8 warps) into registers after the step's last
  // product and stores them after the step's exchange; with fewer warps it
  // loads the rest at the store.
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
    unsigned short* xs = reinterpret_cast<unsigned short*>(hs) + H;
#pragma unroll
    for (int i = 0; i < kXRegs; ++i) {
      int idx = tid + i * nthreads;
      asm volatile("" : "+r"(idx));
      if (idx % kXMax < F) xs[idx / kXMax * ldh + idx % kXMax] = xv[i];
    }
    for (int idx = kXRegs * nthreads + tid; idx < R * kXMax;
         idx += nthreads) {
      if (idx % kXMax < F) xs[idx / kXMax * ldh + idx % kXMax] = x_at(t, idx);
    }
  };

  // A chunk's accumulators, acc[mt][q][2e+j]: gate q of unit `unit + j`,
  // row (ch*kMT + mt)*16 + quad + 8e of the cluster.  They start from the
  // bias (fused) or from xw[t] (hoisted: loaded into `nxt` one chunk ahead)
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
  unsigned hw[kChunks][kMT][2];  // bf(h) of the thread's two units, by row
#pragma unroll
  for (int ch = 0; ch < kChunks; ++ch) {
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) c[ch][mt][i] = 0.0f;
    }
  }

  // ldmatrix addresses: A rows by lane, B rows k by lane
  const bf16* a_base = hs + (lane & 15) * ldh + (lane >> 4) * 8;
  const bf16* b_base =
      ws + ((lane & 7) + ((lane >> 3) & 1) * 8) * ldw + warp * 32 +
      (lane >> 4) * 8;

  for (int s = 0; s < steps; ++s) {
    const int t = d.reverse ? steps - 1 - s : s;
    const bool more = s + 1 < steps;
    const int t_next = d.reverse ? t - 1 : t + 1;
    const size_t base = static_cast<size_t>(t) * B;
#pragma unroll
    for (int ch = 0; ch < kChunks; ++ch) {
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            if (kFusedX) {  // the bias, from L1
              acc[mt][q][v] =
                  __bfloat162float(d.bias[q * H + unit + (v & 1)]);
            } else {
              acc[mt][q][v] = nxt[mt][q][v];
            }
          }
        }
      }
      // the next chunk's xw, this step's or the next's.  Issuing them
      // stalls a warp until the memory system takes them, so the warps of
      // one scheduler take turns: the lower half issues them before its
      // product, the upper half after it.
      auto prefetch = [&]() {
        if (ch + 1 < kChunks) {
          load_xw(t, ch + 1);
        } else if (more) {
          load_xw(t_next, 0);
        }
      };
      if (!kFusedX && early) prefetch();
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
            mma_bf16(acc[mt][q], af, bf[q / 2][2 * (q % 2)],
                     bf[q / 2][2 * (q % 2) + 1]);
          }
        }
      }
      if constexpr (kFusedX) {
#pragma unroll
        for (int kx = 0; kx < 2; ++kx) {
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt) {
            unsigned af[4];
            ldmatrix_x4(af, a_chunk + mt * 16 * ldh + H + 16 * kx);
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              mma_bf16(acc[mt][q], af, wx[kx][q][0], wx[kx][q][1]);
            }
          }
        }
      }
      if (!kFusedX && !early) prefetch();
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
            const float ig = sigmoid_fast(acc[mt][0][v]);
            const float fg = sigmoid_fast(acc[mt][1][v]);
            const float gg = tanh_fast(acc[mt][2][v]);
            const float og = sigmoid_fast(acc[mt][3][v]);
            float& cv = c[ch][mt][v];
            cv = __fadd_rn(__fmul_rn(fg, cv), __fmul_rn(ig, gg));
            h[j] = __fmul_rn(og, tanh_fast(cv));
          }
          hw[ch][mt][e] = pack_bf16(h[0], h[1]);
          const int row = b0 + (ch * kMT + mt) * 16 + quad + 8 * e;
          if (row < B) {
            *reinterpret_cast<unsigned*>(d.out + (base + row) * H + unit) =
                hw[ch][mt][e];
          }
        }
      }
    }
    if (!more) break;
    cluster_wait();  // every CTA of the cluster is done with its A tile

    // this CTA's slice of bf(h) into its own tile, then into the peers'
#pragma unroll
    for (int ch = 0; ch < kChunks; ++ch) {
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          *reinterpret_cast<unsigned*>(
              hs + ((ch * kMT + mt) * 16 + quad + 8 * e) * ldh + unit) =
              hw[ch][mt][e];
        }
      }
    }
    if (kFusedX) store_x(t_next);
    __syncthreads();  // the slice is whole
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
    cluster_arrive();
    cluster_wait();  // every slice of bf(h) and x[t+1] in place
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

template <int kMT, int kChunks, bool kFusedX, typename XW>
struct CoreTag {};

template <int kMT, int kChunks, bool kFusedX>
void fill_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr, int H,
                 int clusters, int dirs, cudaStream_t stream) {
  const int n = cluster_size(H);
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(clusters * n, dirs, 1);
  cfg.blockDim = dim3(32 * (H / n / 8), 1, 1);
  cfg.dynamicSmemBytes = core_smem_bytes(H, 16 * kMT * kChunks, kFusedX);
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
template <int kMT, int kChunks, bool kFusedX, typename XW>
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
  auto kernel = core_kernel<kMT, kChunks, kFusedX, XW>;
  cudaError_t err = ensure_smem_limit<CoreTag<kMT, kChunks, kFusedX, XW>>(
      reinterpret_cast<const void*>(kernel), device);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  fill_config<kMT, kChunks, kFusedX>(cfg, attr, H, 1, 1, nullptr);
  err = cudaOccupancyMaxActiveClusters(count, kernel, &cfg);
  if (err != cudaSuccess) return err;
  memo[key] = *count;
  return cudaSuccess;
}

template <int kMT, int kChunks, bool kFusedX, typename XW>
cudaError_t launch_rows(const CoreArgs<XW>& a, int dirs, int device,
                        cudaStream_t stream) {
  auto kernel = core_kernel<kMT, kChunks, kFusedX, XW>;
  cudaError_t err = ensure_smem_limit<CoreTag<kMT, kChunks, kFusedX, XW>>(
      reinterpret_cast<const void*>(kernel), device);
  if (err != cudaSuccess) return err;
  const int rows = 16 * kMT * kChunks;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  fill_config<kMT, kChunks, kFusedX>(cfg, attr, a.H,
                                     (a.B + rows - 1) / rows, dirs, stream);
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The rows a cluster that launch_core takes for dirs directions of B rows:
// the fewest of 16, 32, 48, 96 and 144 whose clusters all run in one wave,
// else 144 (in more waves where B asks for them).  *count: how many
// clusters of that plan run at once.
template <bool kFusedX, typename XW>
cudaError_t pick_rows(int B, int H, int dirs, int device, int* rows,
                      int* count) {
  cudaError_t err;
#define LSTM_TRY(MT, CH)                                                    \
  err = max_clusters<MT, CH, kFusedX, XW>(device, H, count);              \
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
  return max_clusters<3, 3, kFusedX, XW>(device, H, count);
}

template <bool kFusedX, typename XW>
cudaError_t launch_plan(const CoreArgs<XW>& a, int dirs, int device,
                        cudaStream_t stream) {
  int rows = 0, count = 0;
  const cudaError_t err =
      pick_rows<kFusedX, XW>(a.B, a.H, dirs, device, &rows, &count);
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

// The fused-x body exists for a float xw only (it reads no xw), so a
// library that runs the core over a bf16 xw builds the hoisted body alone.
template <typename XW>
constexpr bool kHasFused = std::is_same<XW, float>::value;

// The recurrence of dirs directions (a.dir[0..dirs-1]): with fused_x
// (F0 + F1 <= kXMax) x[t] joins the step's product, else it runs over each
// direction's xw, whose rows must start on two elements.  W_hh must be
// 16-byte aligned.
template <typename XW>
cudaError_t launch_core(const CoreArgs<XW>& a, int dirs, bool fused_x,
                        cudaStream_t stream) {
  if (fused_x && !kHasFused<XW>) return cudaErrorInvalidValue;
  for (int i = 0; i < dirs; ++i) {
    if (reinterpret_cast<uintptr_t>(a.dir[i].w_hh) % 16 != 0) {
      return cudaErrorMisalignedAddress;
    }
    if (!fused_x && a.dir[i].xw == nullptr) return cudaErrorInvalidValue;
    if (!fused_x &&
        reinterpret_cast<uintptr_t>(a.dir[i].xw) % (2 * sizeof(XW)) != 0) {
      return cudaErrorMisalignedAddress;
    }
  }
  int device = 0;
  const cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if constexpr (kHasFused<XW>) {
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
  const bf16* bias;   // (N,)
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

__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem,
                                                 bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// one pipeline stage: the x tile [kPM][kPK + kPad] and the W tile
// [kPK][kPN + kPad], bf16 kept as their 16-bit patterns
struct ProjStage {
  unsigned short a[kPM][kPK + kPad];
  unsigned short b[kPK][kPN + kPad];
};

template <bool kVec>
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
            mma_bf16(acc[mt][nt], af, bf[nt / 2][2 * (nt % 2)],
                     bf[nt / 2][2 * (nt % 2) + 1]);
          }
        }
      }
    }
    // the bias goes onto the finished sum
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int n = n0 + wn * 32 + nt * 8 + 2 * (lane % 4);
      const float b_lo = __bfloat162float(d.bias[n]);
      const float b_hi = __bfloat162float(d.bias[n + 1]);
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

template <bool kVec>
struct ProjTag {};

// xw of dirs directions from one read of x: M = steps * B rows, N = 4H
// columns a direction (a multiple of kPN since H % 32 == 0).
inline cudaError_t launch_projection(ProjArgs a, int dirs,
                                     cudaStream_t stream) {
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
  auto kernel = vec ? projection_kernel<true> : projection_kernel<false>;
  err = vec ? ensure_smem_limit<ProjTag<true>>(
                    reinterpret_cast<const void*>(kernel), device)
            : ensure_smem_limit<ProjTag<false>>(
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
template <typename XW = float>
cudaError_t core_plan(int B, int H, int dirs, bool fused_x, int* out) {
  if (fused_x && !kHasFused<XW>) return cudaErrorInvalidValue;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  int rows = 0, count = 0;
  if constexpr (kHasFused<XW>) {
    err = fused_x ? pick_rows<true, XW>(B, H, dirs, device, &rows, &count)
                  : pick_rows<false, XW>(B, H, dirs, device, &rows, &count);
  } else {
    err = pick_rows<false, XW>(B, H, dirs, device, &rows, &count);
  }
  if (err != cudaSuccess) return err;
  out[0] = rows;
  out[1] = cluster_size(H);
  out[2] = (B + rows - 1) / rows;
  out[3] = count;
  return cudaSuccess;
}

// The bfloat16 recurrence of dirs directions over their xw (float32 from
// the fused kernels' projection, or bfloat16 from lstm_recurrence's
// caller), which holds the input projection and the bias; direction i runs
// reversed where reverse[i].
template <typename XW>
cudaError_t launch_recurrence(const XW* const* xw, const void* const* w_hh,
                              void* const* out, const int* reverse, int dirs,
                              int steps, int B, int H, cudaStream_t stream) {
  CoreArgs<XW> a{};
  a.steps = steps;
  a.B = B;
  a.H = H;
  for (int i = 0; i < dirs; ++i) {
    a.dir[i].w_hh = static_cast<const bf16*>(w_hh[i]);
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
                static_cast<const bf16*>(w1[i]),
                static_cast<const bf16*>(bias[i]), xw[i]};
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
  CoreArgs<> a{};
  a.x0 = static_cast<const bf16*>(x0);
  a.x1 = static_cast<const bf16*>(x1);
  a.F0 = F0;
  a.F1 = F1;
  a.steps = steps;
  a.B = B;
  a.H = H;
  for (int i = 0; i < dirs; ++i) {
    a.dir[i] = {static_cast<const bf16*>(w_hh[i]),
                static_cast<const bf16*>(w0[i]),
                static_cast<const bf16*>(w1[i]),
                static_cast<const bf16*>(bias[i]), nullptr,
                static_cast<bf16*>(out[i]), reverse[i]};
  }
  return launch_core(a, dirs, true, stream);
}

}  // namespace

}  // namespace lstm
