// The pileup histogram, for Hopper (sm_90a).  Replaces the TPU kernel body
// pepper_tpu/ops/pileup_kernel.py::_histogram_kernel, which the JAX package
// reaches through accumulate_pallas and through
// ops/device_windows.py::_fused_events_classify:
//
//   out[tile * 256 + rel[s], col[s]] += delta[s]
//       for every slot s of the tile with 0 <= rel[s] < 256, 0 <= col[s] < 64
//
// The input is the host binning of ops/pileup_kernel.py::_bin_events:
// events sorted by row, cut into 256-row tiles, each tile padded with the
// sentinel rel = -1 to n_chunks chunks of 2048 slots; three int32 slabs
// (rel, col, delta) of n_tiles * n_chunks * 2048 slots, tile-major.  The
// output is the int32 (n_tiles * 256, 64) image.
//
// Design.  The TPU kernel turns the scatter into one-hot matrix products
// because a scatter serialises there; on Hopper the scatter is the natural
// form.  A block takes one chunk of one tile (grid n_tiles x n_chunks, 256
// threads, 8 slots a thread read as two coalesced 16-byte loads per slab),
// finds the rows its events touch, zeroes those rows of a 256 x 64 int32
// tile in shared memory (64 KB, so the launcher raises the dynamic
// shared-memory limit, once a device), adds each event with a shared-memory atomicAdd, and
// adds each non-zero entry of the touched rows into the output with one
// global atomicAdd.  The launcher zeroes the output first, since the
// chunks of a tile meet there in no fixed order.  A chunk of padding only
// leaves at once.  Integer atomics are exact, so the result does not depend
// on that order.  Sorted input keeps a chunk's rows few (about 2048 / (events
// a row)), so the zeroing and the epilogue stay small; unsorted input is
// still summed right, at the cost of touching the whole tile.
//
// Bound.  Per launch it must read 12 bytes an event (padding slots are a
// layout choice, not work) and write the image's 26 feature columns, 4
// bytes each, and it does one integer add an event: bytes bound it.  This
// first version also reads the padding and writes the 64-column padded
// image; a CSR tile layout, unbinned input and the reference channel and
// clamp fused into the epilogue are later work.
//
// Binding: a plain C launcher (no PyTorch headers) loaded with ctypes; it
// launches on the caller's stream and returns the first CUDA error.

#include <cuda_runtime.h>

#include <atomic>

namespace {

constexpr int kTileR = 256;
constexpr int kColPad = 64;
constexpr int kChunkE = 2048;
constexpr int kThreads = 256;
constexpr int kQuads = kChunkE / 4 / kThreads;  // 16-byte loads a thread: 2
constexpr int kSlots = 4 * kQuads;              // slots a thread: 8
constexpr int kSmemBytes = kTileR * kColPad * static_cast<int>(sizeof(int));

__global__ void __launch_bounds__(kThreads)
    pileup_histogram_kernel(const int4* __restrict__ rel,
                            const int4* __restrict__ cols,
                            const int4* __restrict__ deltas,
                            int* __restrict__ out, int n_chunks) {
  extern __shared__ int tile[];  // [kTileR][kColPad]
  __shared__ int row_lo, row_hi;
  const int t = static_cast<int>(blockIdx.x);
  const size_t chunk =
      (static_cast<size_t>(t) * n_chunks + blockIdx.y) * (kChunkE / 4);

  // slot q*1024 + 4*threadIdx.x + i; a warp's loads are contiguous
  int r[kSlots], c[kSlots], d[kSlots];
#pragma unroll
  for (int q = 0; q < kQuads; ++q) {
    const size_t at = chunk + q * kThreads + threadIdx.x;
    const int4 rr = rel[at], cc = cols[at], dd = deltas[at];
    r[4 * q] = rr.x, r[4 * q + 1] = rr.y, r[4 * q + 2] = rr.z,
    r[4 * q + 3] = rr.w;
    c[4 * q] = cc.x, c[4 * q + 1] = cc.y, c[4 * q + 2] = cc.z,
    c[4 * q + 3] = cc.w;
    d[4 * q] = dd.x, d[4 * q + 1] = dd.y, d[4 * q + 2] = dd.z,
    d[4 * q + 3] = dd.w;
  }

  // the rows this chunk touches; out-of-range slots (the -1 sentinel)
  // become -1 and add nothing
  int lo = kTileR, hi = -1;
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    if (static_cast<unsigned>(r[i]) < kTileR &&
        static_cast<unsigned>(c[i]) < kColPad) {
      lo = min(lo, r[i]);
      hi = max(hi, r[i]);
    } else {
      r[i] = -1;
    }
  }
  if (threadIdx.x == 0) {
    row_lo = kTileR;
    row_hi = -1;
  }
  __syncthreads();
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  if ((threadIdx.x & 31) == 0) {
    atomicMin(&row_lo, lo);
    atomicMax(&row_hi, hi);
  }
  __syncthreads();
  const int first = row_lo;
  const int last = row_hi;
  if (last < first) return;  // padding only; the whole block leaves

  int* rows = tile + first * kColPad;
  const int span = (last - first + 1) * kColPad;
  for (int i = threadIdx.x; i < span; i += kThreads) rows[i] = 0;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    if (r[i] >= 0) atomicAdd(&tile[r[i] * kColPad + c[i]], d[i]);
  }
  __syncthreads();
  int* dst = out + (static_cast<size_t>(t) * kTileR + first) * kColPad;
  for (int i = threadIdx.x; i < span; i += kThreads) {
    const int v = rows[i];
    if (v != 0) atomicAdd(dst + i, v);
  }
}

constexpr int kMaxDevices = 64;
std::atomic<bool> smem_raised[kMaxDevices];

// Raises the kernel's dynamic shared-memory limit to kSmemBytes on the
// current device, the first time a launch there asks.
cudaError_t raise_smem_limit() {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const bool cached = device >= 0 && device < kMaxDevices;
  if (cached && smem_raised[device].load(std::memory_order_acquire)) {
    return cudaSuccess;
  }
  err = cudaFuncSetAttribute(pileup_histogram_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
  if (err == cudaSuccess && cached) {
    smem_raised[device].store(true, std::memory_order_release);
  }
  return err;
}

}  // namespace

extern "C" {

// rel, cols, deltas: int32 slabs of n_tiles * n_chunks * 2048 slots, each
// 16-byte aligned; out: int32 (n_tiles * 256, 64).  Returns a cudaError_t
// value (0 on success).
int pileup_histogram_launch(const void* rel, const void* cols,
                            const void* deltas, void* out, int n_tiles,
                            int n_chunks, void* stream) {
  if (n_tiles <= 0 || n_chunks <= 0 || n_chunks > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = raise_smem_limit();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemsetAsync(
      out, 0, static_cast<size_t>(n_tiles) * kTileR * kColPad * sizeof(int),
      s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(n_tiles, n_chunks);
  pileup_histogram_kernel<<<grid, kThreads, kSmemBytes, s>>>(
      static_cast<const int4*>(rel), static_cast<const int4*>(cols),
      static_cast<const int4*>(deltas), static_cast<int*>(out), n_chunks);
  return static_cast<int>(cudaGetLastError());
}

const char* pileup_histogram_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
