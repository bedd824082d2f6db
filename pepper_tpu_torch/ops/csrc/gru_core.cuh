// The GRU recurrence core that gru_direction_fused.cu and gru_recurrence.cu
// share, for Hopper (sm_90a): T steps of
//
//   hw = bf(h) @ W_hh + b_hh                                    (f32 sums)
//   r = sigmoid(xw_r + hw_r) ;  z = sigmoid(xw_z + hw_z)
//   n = tanh(xw_n + r * hw_n) ;  h = (1 - z) * n + z * h       (f32 state)
//   out[t] = h rounded to TO ;  h_out = h after the last step (f32)
//
// over a precomputed xw (T, B, 3H) of type TW, with t running T-1..0 when
// `reverse`.  bf(h) is h rounded to TH before the recurrent product (TH =
// float leaves it unrounded).  h starts from the float32 h0 (B, H).  The
// cell is gru_cell.cuh's: b_hh inside r * (...), the bias added after the
// whole sum, the update's products and sums rounded one by one.  TO is
// float, bfloat16 or int8_t (the static kernel's codes round(h * 127), ties
// to even); h_out, where not null, takes the f32 state after the last step
// (the static kernel's carry, which must stay exact).
//
// Two bodies, chosen by H:
//
// smem (H <= kSmemMaxHidden = 128).  W_hh (H x 3H f32, 192 KB at H=128) is
// copied once per block into dynamic shared memory with cp.async and read
// from there on every step; where few rows leave registers free (one or
// two rows a block), each thread keeps its column's first 96 or 64 rows of
// W_hh in registers instead.  A block owns kR batch rows (kR in 1..16, a
// power of two that launch_core picks from B and the device's SM count so
// that the grid covers the SMs: one row a block at B=128) and has 3H
// threads; thread c owns gate column c,
// reads W_hh[k][c] (neighbouring threads, neighbouring banks) and h[r][k]
// as a 16-byte broadcast, and sums its column in f32 (two chains a row
// below 4 rows, so the FMAs are not all in one dependent line; one chain,
// in k order, where TO is int8: a code rounds the other way wherever h*127
// lies within a sum's last bit of a half, and the codes of one chain in k
// order equal those of the plain version's float32 product on the card,
// at no cost in time at one row a block).  The r and
// z threads apply their sigmoid and leave the gate in shared memory; after
// one barrier the n thread of unit j runs the cell for its rows, keeps h
// in registers and stages bf(h); a second barrier ends the step.  Each
// thread loads its next step's xw into registers before the product, so
// the load hides behind it.
//   Bound: the product reads W_hh's rows in shared memory once a step
//   (12 H^2 bytes, 1,536 cycles at 128 B a cycle at H=128; a quarter of
//   that with 96 rows in registers) and h as broadcasts, whatever kR;
//   above kR of about 4 the FMAs (kR * 3H^2 a step) take over.
//
// stream (128 < H <= 256, where W_hh does not fit).  The layout of
// gru_cell.cuh: a block owns 16 rows and has H threads, thread j the three
// gate columns of unit j for all 16 rows, W_hh read from L2 on every step.
//
// Included by gru_direction_fused.cu, gru_direction_fused_static.cu and
// gru_recurrence.cu; the dtype conversions and the cell come from
// gru_cell.cuh and lstm_cell.cuh.

#pragma once

#include <atomic>
#include <type_traits>

#include "gru_cell.cuh"

namespace gru {

constexpr int kSmemMaxHidden = 128;  // W_hh fits a block's shared memory
constexpr int kSmemMaxRows = 16;     // the most batch rows a smem block owns
constexpr int kMaxDevices = 64;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// xw[t][b0 + r][c] for the block's rows as float, zeros past the batch.
template <typename TW, int kR>
__device__ __forceinline__ void load_xw(float (&x)[kR],
                                        const TW* __restrict__ xw, int t,
                                        int B, int G, int b0, int c) {
  const size_t base = static_cast<size_t>(t) * B;
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int row = b0 + r;
    x[r] = row < B ? lstm::to_f32(xw[(base + row) * G + c]) : 0.0f;
  }
}

// The kernels and their launchers have internal linkage: the three libraries
// that include this header instantiate the same templates, and a launcher's
// static "limit raised" flag with external linkage would be one object for
// all (the loader unifies such statics across shared objects), so a
// second library would launch without raising its kernel's limit.
namespace {

// kRegK: rows k < kRegK of W_hh stay in each thread's registers (its own
// column), the rest in shared memory.
template <typename TW, typename TO, typename TH, int kR, int kRegK>
__global__ void __launch_bounds__(3 * kSmemMaxHidden, 1)
    core_smem_kernel(const TW* __restrict__ xw,
                     const float* __restrict__ w_hh,
                     const float* __restrict__ b_hh,
                     const float* __restrict__ h0, TO* __restrict__ out,
                     float* __restrict__ h_out, int steps, int B, int H,
                     int reverse) {
  extern __shared__ __align__(16) float smem[];
  const int G = 3 * H;
  float* ws = smem;                  // [H - kRegK][G] W_hh rows kRegK..
  float* hs = ws + (H - kRegK) * G;  // [kR][H] bf(h)
  float* gs = hs + kR * H;           // [kR][2H] the r and z gates
  const int c = threadIdx.x;
  const int q = c / H;         // gate of column c; H % 32 == 0: warp-uniform
  const int j = c - q * H;     // its unit
  const int b0 = static_cast<int>(blockIdx.x) * kR;

  const float* w_rest = w_hh + kRegK * G;
  for (int i = c; i < (H - kRegK) * G / 4; i += blockDim.x) {
    cp_async16(ws + 4 * i, w_rest + 4 * i);
  }
  float wr[kRegK > 0 ? kRegK : 1];
#pragma unroll
  for (int k = 0; k < kRegK; ++k) wr[k] = w_hh[k * G + c];
  const float bh = b_hh[c];
  float h[kR];
  if (q == 2) {
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int row = b0 + r;
      h[r] = row < B ? h0[static_cast<size_t>(row) * H + j] : 0.0f;
      hs[r * H + j] = lstm::to_f32(lstm::from_f32<TH>(h[r]));
    }
  }
  float x[kR];
  load_xw<TW, kR>(x, xw, reverse ? steps - 1 : 0, B, G, b0, c);
  cp_async_wait_all();
  __syncthreads();  // W_hh and bf(h0) in place

  for (int s = 0; s < steps; ++s) {
    const int t = reverse ? steps - 1 - s : s;
    float x_next[kR];
    if (s + 1 < steps) {
      load_xw<TW, kR>(x_next, xw, reverse ? t - 1 : t + 1, B, G, b0, c);
    }

    // two FMA chains a row where few rows leave the FMAs dependent, but
    // for int8 codes out (see the design above)
    constexpr int kC = kR < 4 && !std::is_same<TO, int8_t>::value ? 2 : 1;
    float acc[kC][kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
#pragma unroll
      for (int i = 0; i < kC; ++i) acc[i][r] = 0.0f;
    }
    auto quad = [&](int k, float w0, float w1, float w2, float w3) {
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const float4 hv = *reinterpret_cast<const float4*>(hs + r * H + k);
        acc[0][r] = fmaf(hv.x, w0, acc[0][r]);
        acc[kC - 1][r] = fmaf(hv.y, w1, acc[kC - 1][r]);
        acc[0][r] = fmaf(hv.z, w2, acc[0][r]);
        acc[kC - 1][r] = fmaf(hv.w, w3, acc[kC - 1][r]);
      }
    };
#pragma unroll
    for (int k = 0; k < kRegK; k += 4) {
      quad(k, wr[k], wr[k + 1], wr[k + 2], wr[k + 3]);
    }
#pragma unroll (kR < 8 ? 4 : 2)
    for (int k = kRegK; k < H; k += 4) {
      const float* wk = ws + (k - kRegK) * G + c;
      quad(k, wk[0], wk[G], wk[2 * G], wk[3 * G]);
    }
    float hw[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const float sum = kC == 2 ? __fadd_rn(acc[0][r], acc[kC - 1][r])
                                : acc[0][r];
      hw[r] = __fadd_rn(sum, bh);
      if (q < 2) gs[r * 2 * H + c] = lstm::sigmoid(__fadd_rn(x[r], hw[r]));
    }
    __syncthreads();  // r and z gates in place; every read of hs done

    if (q == 2) {
      const size_t base = static_cast<size_t>(t) * B;
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const float rg = gs[r * 2 * H + j];
        const float zg = gs[r * 2 * H + H + j];
        const float n = tanhf(__fadd_rn(x[r], __fmul_rn(rg, hw[r])));
        h[r] = __fadd_rn(__fmul_rn(__fsub_rn(1.0f, zg), n),
                         __fmul_rn(zg, h[r]));
        hs[r * H + j] = lstm::to_f32(lstm::from_f32<TH>(h[r]));
        const int row = b0 + r;
        if (row < B) out[(base + row) * H + j] = lstm::from_f32<TO>(h[r]);
      }
    }
    __syncthreads();  // bf(h) of this step in place; gates read
#pragma unroll
    for (int r = 0; r < kR; ++r) x[r] = x_next[r];
  }
  if (q == 2 && h_out != nullptr) {
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int row = b0 + r;
      if (row < B) h_out[static_cast<size_t>(row) * H + j] = h[r];
    }
  }
}

template <typename TW, typename TO, typename TH>
__global__ void __launch_bounds__(kMaxHidden)
    core_stream_kernel(const TW* __restrict__ xw,
                       const float* __restrict__ w_hh,
                       const float* __restrict__ b_hh,
                       const float* __restrict__ h0, TO* __restrict__ out,
                       float* __restrict__ h_out, int steps, int B, int H,
                       int reverse) {
  extern __shared__ __align__(16) float hs[];  // [H][kRows]
  const int j = threadIdx.x;
  const int b0 = static_cast<int>(blockIdx.x) * kRows;
  const int G = 3 * H;

  float bh[3];
  load3(bh, b_hh, H, j);
  float h[kRows];
  load_h0<TH>(h, hs, h0, B, H, j, b0);

  for (int s = 0; s < steps; ++s) {
    const int t = reverse ? steps - 1 - s : s;
    const size_t base = static_cast<size_t>(t) * B;
    float x[kRows][3];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = b0 + r;
      const TW* xr = xw + (base + (row < B ? row : 0)) * G + j;
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        x[r][q] = row < B ? lstm::to_f32(xr[q * H]) : 0.0f;
      }
    }
    __syncthreads();  // last step's h visible
    float hw[kRows][3];
    zero(hw);
    accumulate(hw, hs, w_hh, H, H, j);
    add_bias(hw, bh);
    __syncthreads();  // every thread is done reading hs

#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      h[r] = cell(x[r], hw[r], h[r]);
      hs[j * kRows + r] = lstm::to_f32(lstm::from_f32<TH>(h[r]));
      const int row = b0 + r;
      if (row < B) out[(base + row) * H + j] = lstm::from_f32<TO>(h[r]);
    }
  }
  if (h_out != nullptr) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = b0 + r;
      if (row < B) h_out[static_cast<size_t>(row) * H + j] = h[r];
    }
  }
}

// Dynamic shared memory of the smem body: W_hh's rows past reg_k, bf(h)
// and the r, z gates.
inline size_t core_smem_bytes(int H, int rows, int reg_k) {
  return static_cast<size_t>(H - reg_k + rows) * 3 * H * sizeof(float);
}

template <typename TW, typename TO, typename TH, int kR, int kRegK>
cudaError_t launch_smem(const TW* xw, const float* w_hh, const float* b_hh,
                        const float* h0, TO* out, float* h_out, int steps,
                        int B, int H, int reverse, cudaStream_t stream) {
  auto kernel = core_smem_kernel<TW, TO, TH, kR, kRegK>;
  // raise the kernel's dynamic shared-memory limit to the device's opt-in
  // maximum, the first time a launch on that device asks
  static std::atomic<bool> raised[kMaxDevices];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const bool cached = device >= 0 && device < kMaxDevices;
  if (!cached || !raised[device].load(std::memory_order_acquire)) {
    int optin = 0;
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err != cudaSuccess) return err;
    if (cached) raised[device].store(true, std::memory_order_release);
  }
  const dim3 grid((B + kR - 1) / kR);
  kernel<<<grid, 3 * H, core_smem_bytes(H, kR, kRegK), stream>>>(
      xw, w_hh, b_hh, h0, out, h_out, steps, B, H, reverse);
  return cudaGetLastError();
}

// Batch rows a block of the smem body: the fewest, a power of two up to
// kSmemMaxRows, whose blocks cover B in one wave of `sms` SMs; past that the
// batch takes more blocks and more waves.
inline int smem_rows(int B, int sms) {
  int rows = 1;
  while (rows < kSmemMaxRows && (B + rows - 1) / rows > sms) rows *= 2;
  return rows;
}

// The recurrence over xw with the body H calls for: the smem body for
// H <= kSmemMaxHidden with smem_rows rows a block, else the stream body with
// kRows.  w_hh must be 16-byte aligned; h_out may be null.
template <typename TW, typename TO, typename TH>
cudaError_t launch_core(const TW* xw, const float* w_hh, const float* b_hh,
                        const float* h0, TO* out, float* h_out, int steps,
                        int B, int H, int reverse, cudaStream_t stream) {
  if (H > kSmemMaxHidden) {
    core_stream_kernel<TW, TO, TH>
        <<<(B + kRows - 1) / kRows, H, H * kRows * sizeof(float), stream>>>(
            xw, w_hh, b_hh, h0, out, h_out, steps, B, H, reverse);
    return cudaGetLastError();
  }
  if (reinterpret_cast<uintptr_t>(w_hh) % 16 != 0) {
    return cudaErrorMisalignedAddress;
  }
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  // rows of W_hh in registers: as many as the thread's 168 registers
  // leave room for (96 at one row a block, 64 at two), at most H
#define GRU_LAUNCH(R, K)                                                   \
  return launch_smem<TW, TO, TH, R, K>(xw, w_hh, b_hh, h0, out, h_out,   \
                                       steps, B, H, reverse, stream)
  switch (smem_rows(B, sms)) {
    case 1:
      if (H >= 96) GRU_LAUNCH(1, 96);
      if (H >= 64) GRU_LAUNCH(1, 64);
      GRU_LAUNCH(1, 0);
    case 2:
      if (H >= 64) GRU_LAUNCH(2, 64);
      GRU_LAUNCH(2, 0);
    case 4:
      GRU_LAUNCH(4, 0);
    case 8:
      GRU_LAUNCH(8, 0);
    default:
      GRU_LAUNCH(kSmemMaxRows, 0);
  }
#undef GRU_LAUNCH
}

}  // namespace

}  // namespace gru
