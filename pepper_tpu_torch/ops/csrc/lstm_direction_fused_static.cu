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
// (__float2int_rn, as jnp.round and torch.round are): the int8 recurrence
// feeds its own codes back, so a different tie rule would drift.  The int32
// sums of both parts are taken before the single rescale, and the rescales
// use __fmul_rn/__fadd_rn, so no multiply-add is contracted: those steps
// round exactly as the plain version's separate multiply and add.  In the
// same way every float product is summed apart from zero and joined with
// a rounded add in the plain version's order, gates = (b + x-part) +
// recurrent part, and the cell update's products and sum round apart:
// codes move with a gate's last bit.
//
// Design.  One body for every combination: lstm_core.cuh's code-emitting
// kinds, the tensor-core recurrence with W_hh split over a thread-block
// cluster, a float32 bias, and out as the caller asks (int8 codes, or h in
// float32 or bfloat16: the value the codes are rounded from, an int8 W_hh
// still fed its codes).  A bf16 or int8 W_hh runs the bf16 core (an int8
// one, static_rec, held k-major in the cluster's shared memory and
// multiplied by the codes of h on the s8 tensor cores); a float32 W_hh
// (the float32 static mode) runs the float32 core's codes kind: W_hh over
// a cluster of H/32 CTAs, 3xTF32 products on mma.sync m16n8k8, the
// recurrent part summed apart.  By x:
// * bf16 x of at most kXMax (32) features (the bfloat16 encoder's 26)
//   joins the bf16 core's step as the float kernel's does: no xw is
//   written.
// * Anything else is first projected for all T*B rows into a float32 xw
//   scratch the caller allocates, and the core runs over it: int8 x (the
//   decoder's 2 x 256 codes) by int8_projection.cuh (mma.sync m16n8k32 s8)
//   into xw = b + f32(acc) * acc_scale (f32, as the TPU kernel's gates:
//   bf16 would change the math); wider bf16 x (the HP classifier's
//   48-feature encoder) by the core's bf16 projection with the codes
//   kinds' sums (each k16 step's product from zero, joined by rounded
//   adds; the float32 bias added last); float32 x (the float32 encoders'
//   26 and HP 48, by float32 FMAs from zero in k order, then + b; wider
//   x by 3xTF32) by the core's float32 projection.  float32 x joining
//   the float32 core's step was built and measured slower than these two
//   launches (PERF.md section 6).
// int8 weights arrive k-major ((N, K), relaid once per weight tree:
// ops/cuda_build.py:int8_kmajor), W_ih as one (4H, F0 + F1) matrix for
// both parts.
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

#include "int8_projection.cuh"
#include "lstm_core.cuh"

namespace {

constexpr int kF32 = 0;
constexpr int kBf16 = 1;
constexpr int kInt8 = 2;

using bf16 = __nv_bfloat16;

bool valid_args(int x_dtype, int whh_dtype, int out_kind, int F0, int F1,
                const float* acc_scale, const float* rec_scale, int steps,
                int B, int H) {
  const bool int_x = x_dtype == kInt8;
  return lstm::valid_shape(F0, F1, steps, B, H) &&
         out_kind >= lstm::kOutF32 && out_kind <= lstm::kOutInt8 &&
         x_dtype >= kF32 && x_dtype <= kInt8 && whh_dtype >= kF32 &&
         whh_dtype <= kInt8 && (!int_x || acc_scale != nullptr) &&
         (whh_dtype != kInt8 || rec_scale != nullptr) &&
         // a float W_hh beside float x has x's dtype
         (int_x || whh_dtype == kInt8 || whh_dtype == x_dtype);
}

// Whether x joins the recurrence's step (no xw): bf16 x of at most kXMax
// features.  ops/lstm_kernel.py:static_x_joins applies the same rule.
bool joins_step(int x_dtype, int F0, int F1) {
  return x_dtype == kBf16 && F0 + F1 <= lstm::kXMax;
}

// xw = b + [x0 x1] @ [w0; w1] in float32 for all steps * B rows with the
// codes kinds' sums and a float32 bias: bf16 x of more than kXMax
// features (the HP classifier's 48), which the core then runs over as over
// the int8 projection's xw.
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
// (float32 FMAs in k order at widths up to kNarrowMax; then b is added, as
// the plain version adds it), w0 and w1 each part's (F_i, 4H).
cudaError_t project_any(int x_dtype, const void* x0, const void* x1, int F0,
                        int F1, const void* w0, const void* w1,
                        const float* acc_scale, const float* bias, float* xw,
                        int steps, int B, int H, cudaStream_t stream) {
  if (x_dtype == kInt8) {
    return i8::launch_projection(
        static_cast<const int8_t*>(x0), static_cast<const int8_t*>(x1), F0,
        F1, static_cast<const int8_t*>(w0), acc_scale, bias, xw, steps * B,
        4 * H, stream);
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

// The core's recurrence over a float32 xw, out as out_kind: a float32
// W_hh (H, 4H) on the float32 core's codes kind, a bf16 one (H, 4H) or an
// int8 one (k-major (4H, H), with rec_scale) on the bf16 core's.
cudaError_t recur(int whh_dtype, const float* xw, const void* w_hh,
                  const float* rec_scale, void* out, int out_kind,
                  int reverse, int steps, int B, int H,
                  cudaStream_t stream) {
  if (whh_dtype == kF32) {
    return lstm::launch_static_f32(xw, w_hh, out, out_kind, reverse, steps,
                                   B, H, stream);
  }
  return lstm::launch_static(nullptr, nullptr, 0, 0, nullptr, nullptr,
                             nullptr, xw, w_hh, whh_dtype == kInt8,
                             rec_scale, out, out_kind, reverse, steps, B, H,
                             stream);
}

}  // namespace

extern "C" {

// x_dtype, whh_dtype: 0 = float32, 1 = bfloat16, 2 = int8; out_kind:
// 0 = float32, 1 = bfloat16, 2 = int8 codes.  acc_scale is read for int8
// x, rec_scale for an int8 W_hh; bias is float32.  x1/w1 may be null with
// F1 == 0.  An int8 W_ih is w0, k-major (4H, F0 + F1), w1 unused; an int8
// W_hh is k-major (4H, H).  Where x does not join the step (joins_step),
// it is projected into xw, a float32 scratch of steps * B * 4H values;
// else xw is unused.  Returns a cudaError_t value (0 on success).
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
  if (joins_step(x_dtype, F0, F1)) {
    return static_cast<int>(lstm::launch_static(
        static_cast<const bf16*>(x0), static_cast<const bf16*>(x1), F0, F1,
        static_cast<const bf16*>(w0), static_cast<const bf16*>(w1), bias,
        nullptr, w_hh, whh_dtype == kInt8, rec_scale, out, out_kind,
        reverse, steps, B, H, s));
  }
  const cudaError_t err = project_any(x_dtype, x0, x1, F0, F1, w0, w1,
                                      acc_scale, bias, xw, steps, B, H, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(recur(whh_dtype, xw, w_hh, rec_scale, out,
                                out_kind, reverse, steps, B, H, s));
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
  return static_cast<int>(recur(whh_dtype, xw, w_hh, rec_scale, out,
                                lstm::kOutInt8, reverse, steps, B, H,
                                static_cast<cudaStream_t>(stream)));
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
