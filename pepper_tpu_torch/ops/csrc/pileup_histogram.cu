// The pileup histogram, for Hopper (sm_90a).  Replaces the TPU kernel body
// pepper_tpu/ops/pileup_kernel.py::_histogram_kernel, which the JAX package
// reaches through accumulate_pallas and through
// ops/device_windows.py::_fused_events_classify:
//
//   out[row[e], col[e]] += delta[e]
//       for every event e with 0 <= row[e] < n_rows, 0 <= col[e] < n_cols
//
// The input is a flat list of N events, three int32 arrays (rows, cols,
// deltas) in any order: the order the pileup walk emits them, with no
// host sort or binning.  The output is the int32 (n_rows, n_cols) image,
// which the caller zeroes (or seeds) before the launch; an event outside
// the image adds nothing.
//
// Design.  The TPU kernel turns the scatter into one-hot matrix products on
// events sorted into padded 256-row tiles, because a scatter serialises
// there; on Hopper the scatter is the natural form, and needs no sort.
// One launch, a grid-stride loop over the events: a warp takes 32
// consecutive events a pass, one a lane, with coalesced 128-byte loads of
// each array (any alignment, any N: no padding and no tail).  Each event
// goes straight to L2 as a `red.global.add.s32` (atomicAdd with its result
// unused): the whole image (1 MB a 10 kb region, 8.5 MB an 8-region
// dispatch) stays in the 50 MB L2, and integer adds are exact in any
// order.  Where lanes of a warp hold the same key row * n_cols + col,
// __match_any_sync groups them and __reduce_add_sync sums each group, so
// one leader adds the sum.  That grouping pays on row-sorted input (the
// slab wrapper's, the TPU layout), where a warp's events fall on a few
// rows; in the order the walker emits them, a warp's events are one
// read's consecutive bases, every key distinct, and the grouping costs
// more than it saves.  So a warp groups only where a lane's key equals
// that of the lane one or two before it (a shuffle and a vote), which
// sorted runs show and emission order does not.  No shared memory and no
// per-block merge: a block's events in emission order have no reuse to
// keep on chip.  Blocks: enough for one event a thread, at most a full
// wave of the SMs (cudaDevAttrMultiProcessorCount).
//
// Bound.  It must read 12 bytes an event and write the image once (4 bytes
// an entry), and does one integer add an event: by bytes, at a region
// (582,255 events, 10,102 x 26) 8.0 MB, 0.0024 ms at 3.35 TB/s.  What
// holds it back is the rate at which L2 takes atomic adds on distinct
// addresses, which index_add_ meets as well; only input whose keys repeat
// within a warp lets the grouping cut the adds.
//
// Binding: a plain C launcher (no PyTorch headers) loaded with ctypes; it
// launches on the caller's stream and returns the first CUDA error.

#include <cuda_runtime.h>

#include <atomic>
#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 2048 / kThreads;  // a full SM of threads
constexpr int kMaxDevices = 64;
std::atomic<int> sm_counts[kMaxDevices];

// Adds delta at (row, col) where that lies in the image.  Every lane of
// the warp calls it together: where neighbouring lanes share a key, lanes
// with one key add their sum once.
__device__ __forceinline__ void add_event(int* __restrict__ out, int row,
                                          int col, int delta, int n_rows,
                                          int n_cols) {
  const bool inside =
      static_cast<unsigned>(row) < static_cast<unsigned>(n_rows) &&
      static_cast<unsigned>(col) < static_cast<unsigned>(n_cols);
  const int key = inside ? row * n_cols + col : -1;
  const int lane = static_cast<int>(threadIdx.x) & 31;
  const int one = __shfl_up_sync(0xffffffffu, key, 1);
  const int two = __shfl_up_sync(0xffffffffu, key, 2);
  const bool runs = inside && ((lane >= 1 && one == key) ||
                               (lane >= 2 && two == key));
  if (!__any_sync(0xffffffffu, runs)) {
    if (inside) atomicAdd(out + key, delta);
    return;
  }
  const unsigned peers = __match_any_sync(0xffffffffu, key);
  const int sum = __reduce_add_sync(peers, delta);
  if (inside && lane == __ffs(peers) - 1) atomicAdd(out + key, sum);
}

// The loop bound is the warp's, so that every lane of a warp reaches each
// add_event; lanes past the end add nothing.
__global__ void __launch_bounds__(kThreads)
    pileup_histogram_kernel(const int* __restrict__ rows,
                            const int* __restrict__ cols,
                            const int* __restrict__ deltas, long long n,
                            int* __restrict__ out, int n_rows, int n_cols) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const int lane = static_cast<int>(threadIdx.x) & 31;
  for (long long w = static_cast<long long>(blockIdx.x) * kThreads +
                     (threadIdx.x & ~31);
       w < n; w += stride) {
    const long long e = w + lane;
    const bool live = e < n;
    add_event(out, live ? rows[e] : -1, live ? cols[e] : 0,
              live ? deltas[e] : 0, n_rows, n_cols);
  }
}

cudaError_t sm_count(int* count) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const bool cached = device >= 0 && device < kMaxDevices;
  if (cached) {
    *count = sm_counts[device].load(std::memory_order_acquire);
    if (*count > 0) return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(count, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  if (cached) sm_counts[device].store(*count, std::memory_order_release);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// rows, cols, deltas: int32 arrays of n_events; out: int32 (n_rows,
// n_cols), zeroed or seeded by the caller.  Launches nothing for no
// events.  Returns a cudaError_t value (0 on success).
int pileup_histogram_launch(const void* rows, const void* cols,
                            const void* deltas, long long n_events, void* out,
                            int n_rows, int n_cols, void* stream) {
  if (n_events < 0 || n_rows <= 0 || n_cols <= 0 ||
      static_cast<long long>(n_rows) * n_cols > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_events == 0) return static_cast<int>(cudaSuccess);
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long wanted = (n_events + kThreads - 1) / kThreads;
  const long long wave = static_cast<long long>(sms) * kBlocksPerSm;
  const int blocks = static_cast<int>(wanted < wave ? wanted : wave);
  pileup_histogram_kernel<<<blocks, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(rows), static_cast<const int*>(cols),
      static_cast<const int*>(deltas), n_events, static_cast<int*>(out),
      n_rows, n_cols);
  return static_cast<int>(cudaGetLastError());
}

const char* pileup_histogram_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
