#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (pepper_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each printing one JSON line:
  1 device     the card's name and `nvidia-smi` name/power limit
  2 build      the native host libraries and the four sm_90a CUDA kernels,
               built from the checkout's sources in parallel (one nvcc per
               kernel), with ptxas's register and spill lines
  3 kernel     lstm_direction_fused against its plain twin on the card, at
               the transducer's full width (encoder F=26, decoder 2x256,
               H=256), B=4096 and B=37, both directions, float32 (atol
               1e-5) and bfloat16 (atol 2e-2); per-launch times of kernel,
               twin and cuDNN (torch.nn.LSTM) beside the bound
  4 transducer transducer_infer on 4096 int8 windows through the kernel
               against the twin path on the card (probabilities atol 2e-4
               float32, 1e-2 bfloat16), and windows/s
  5 kernel_static
               lstm_direction_fused_static against its twin: encoder (F=26,
               bfloat16 and float32) and decoder (the encoder's int8 codes,
               2x256), static and static_rec, B=4096 and B=37, both
               directions; codes within 1 and at least 99.9% (static) /
               99.5% (static_rec) equal; per-launch times beside the bound
  6 kernel_recurrence
               lstm_recurrence against its twin, xw (33, B, 1024) in
               bfloat16 (atol 2e-2) and float32 (atol 1e-5), B=4096 and 37
  7 kernel_dual
               bilstm_dual_fused against its twin (two twins of phase 3's
               kernel), as phase 3, with the time of cuDNN's bidirectional
               torch.nn.LSTM
  8 transducer_quantized
               4096 int8 windows through the static, static_rec and
               dynamic int8 modes on the kernels against the twin path on
               the card (atol 5e-3, 1e-2, 1e-2), windows/s, and the largest
               difference from the float transducer
  9 call       call_variant through the CLI on a synthetic 30x scene with
               seeded random full-width weights: cuda bfloat16 (the float
               main path), cuda float32 and cpu float32 must give the same
               (pos, REF, ALT, GT) set; so must cuda bfloat16 with
               PEPPER_LSTM_DUAL=1; --quantized static, static_rec and
               dynamic on cuda must each give the set of a cpu run of the
               same mode, up to the order of the ALT alleles within a
               site (near-tied candidates; the count is printed).  Every
               kernel's launch count is set to 0 before each cuda run and
               read after it.

Then the kernel summary line, the nvidia-smi line and, last, the result
line.  Any failed check raises, and the script exits non-zero without the
result line; so it does without a CUDA device or outside a checkout.
"""

from __future__ import annotations

import contextlib
import gzip
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from unittest import mock

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
B_SERVE = 4096
H = 256
T = 33
PEAK_BF16_FLOPS = 989e12       # H100 SXM dense bf16 tensor-core peak
PEAK_F32_FLOPS = 67e12         # H100 SXM float32 outside the tensor cores
PEAK_INT8_OPS = 1979e12        # H100 SXM dense int8 tensor-core peak
PEAK_BYTES = 3.35e12           # H100 SXM HBM3
KERNEL_BARS = {"float32": 1e-5, "bfloat16": 2e-2}
TRANSDUCER_BARS = {"float32": 2e-4, "bfloat16": 1e-2}
# int8 codes: the share equal to the twin's, by mode (an int8 recurrence
# feeds its codes back, so a code that rounds the other way spreads)
CODE_BARS = {"static": 0.999, "static_rec": 0.995}
QUANTIZED_BARS = {"static": 5e-3, "static_rec": 1e-2, "dynamic": 1e-2}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(ok: bool, message: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {message}")


def nvidia_smi_line() -> str:
    result = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return result.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=10, warmup=2) -> float:
    """Mean device time of fn() over iters runs, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------- phase 2


def phase_build():
    from pepper_tpu_torch.io import native
    from pepper_tpu_torch.ops import lstm_kernel

    times, errors = {}, {}

    def run(name, fn):
        t0 = time.time()
        try:
            fn()
        except BaseException as exc:  # re-raised below, in this thread
            errors[name] = exc
        times[name] = round(time.time() - t0, 3)

    jobs = [("native", native.build_native)] + [
        (name, lambda name=name: lstm_kernel.build_kernel(name=name))
        for name in lstm_kernel.KERNELS]
    threads = [threading.Thread(target=run, args=job) for job in jobs]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join()
    for exc in errors.values():
        raise exc
    ptxas = {name: [line.strip() for line in
                    lstm_kernel.ptxas_report(name=name).splitlines()
                    if "registers" in line or "spill" in line]
             for name in lstm_kernel.KERNELS}
    emit({"phase": "build", "seconds": times, "ptxas": ptxas})


# ---------------------------------------------------------------- phase 3


def lstm_inputs(gen, shape, B, dtype, device):
    """One direction's inputs at the serving widths: the encoder reads int8
    window values, the decoder the encoder's (-1, 1) outputs."""
    import torch

    scale = 1.0 / H ** 0.5

    def u(*size, s=scale):
        return ((torch.rand(size, generator=gen, device=device) * 2 - 1)
                * s).to(dtype)

    if shape == "encoder":
        xs = (torch.randint(-125, 126, (T, B, 26), generator=gen,
                            device=device).to(dtype),)
        ws = (u(26, 4 * H),)
    else:
        xs = (u(T, B, H, s=1.0), u(T, B, H, s=1.0))
        ws = (u(H, 4 * H), u(H, 4 * H))
    return xs, ws, u(4 * H, s=2 * scale), u(H, 4 * H)


def launch_work(shape, B, itemsize):
    """Operations and bytes one launch must do: 2*T*B*(F+H)*4H, and x in,
    weights in, h out, each once."""
    F = 26 if shape == "encoder" else 2 * H
    flops = 2 * T * B * (F + H) * 4 * H
    nbytes = itemsize * (T * B * F + (F + H + 1) * 4 * H + T * B * H)
    return flops, nbytes


def bound_ms(flops, nbytes, peak_flops):
    return max(flops / peak_flops, nbytes / PEAK_BYTES) * 1e3


def cudnn_ms(lstm, x):
    """Time of one torch.nn.LSTM call (cuDNN), the library yardstick that
    the port never uses."""
    import torch

    with torch.no_grad():
        return cuda_ms(lambda: lstm(x))


def cudnn_lstm(directions, dtype, device):
    """torch.nn.LSTM holding the same weights: one layer, concatenated
    input, one direction or, given two (w_ih_parts, b, w_hh), both."""
    import torch

    w_ih = torch.cat(directions[0][0], dim=0)
    lstm = torch.nn.LSTM(w_ih.shape[0], H,
                         bidirectional=len(directions) == 2).to(
        device=device, dtype=dtype)
    with torch.no_grad():
        for suffix, (w_ih_parts, b, w_hh) in zip(("", "_reverse"),
                                                 directions):
            getattr(lstm, f"weight_ih_l0{suffix}").copy_(
                torch.cat(w_ih_parts, dim=0).t())
            getattr(lstm, f"weight_hh_l0{suffix}").copy_(w_hh.t())
            getattr(lstm, f"bias_ih_l0{suffix}").copy_(b)
            getattr(lstm, f"bias_hh_l0{suffix}").zero_()
    return lstm


def phase_kernel(device, card):
    import torch
    from pepper_tpu_torch.ops import lstm_kernel

    kernel = lstm_kernel.lstm_direction_fused
    twin = lstm_kernel.lstm_direction_fused_reference
    gen = torch.Generator(device=device).manual_seed(1234)
    max_err = {}
    for dtype_name, dtype in (("float32", torch.float32),
                              ("bfloat16", torch.bfloat16)):
        worst = 0.0
        for shape in ("encoder", "decoder"):
            for B in (B_SERVE, 37):
                xs, ws, b, w_hh = lstm_inputs(gen, shape, B, dtype, device)
                for reverse in (False, True):
                    out = kernel(xs, ws, b, w_hh, reverse=reverse)
                    ref = twin(xs, ws, b, w_hh, reverse=reverse)
                    torch.cuda.synchronize()
                    check(out.shape == (T, B, H) and out.dtype == dtype,
                          f"kernel output {tuple(out.shape)} {out.dtype}")
                    check(bool(torch.isfinite(out.float()).all()),
                          "kernel output not finite")
                    err = (out.float() - ref.float()).abs().max().item()
                    check(err <= KERNEL_BARS[dtype_name],
                          f"{dtype_name} {shape} B={B} reverse={reverse}: "
                          f"max abs diff {err} > {KERNEL_BARS[dtype_name]}")
                    worst = max(worst, err)
        max_err[dtype_name] = worst

    timings = {}
    for dtype_name, dtype in (("bfloat16", torch.bfloat16),
                              ("float32", torch.float32)):
        peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
        for shape in ("encoder", "decoder"):
            xs, ws, b, w_hh = lstm_inputs(gen, shape, B_SERVE, dtype, device)
            flops, nbytes = launch_work(shape, B_SERVE, xs[0].element_size())
            x_cat = torch.cat(xs, dim=-1)
            lstm = cudnn_lstm([(ws, b, w_hh)], dtype, device)
            with torch.no_grad():
                lib_out, _ = lstm(x_cat)
            lib_diff = (lib_out.float() - kernel(xs, ws, b, w_hh).float()
                        ).abs().max().item()
            timings[f"{shape}_{dtype_name}"] = {
                "kernel_ms": cuda_ms(lambda: kernel(xs, ws, b, w_hh)),
                "plain_ms": cuda_ms(lambda: twin(xs, ws, b, w_hh)),
                "cudnn_ms": cudnn_ms(lstm, x_cat),
                "cudnn_max_abs_diff": lib_diff,
                "bound_ms": bound_ms(flops, nbytes, peak),
                "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
            }
    emit({"phase": "kernel", "kernel_names": ["lstm_direction_fused"],
          "card": card, "max_abs_err": max_err,
          "B": B_SERVE, "per_launch": timings})
    return max_err, timings


# ---------------------------------------------------------------- phase 4


@contextlib.contextmanager
def twin_path():
    """Run every LSTM kernel wrapper as its plain twin, for comparison
    only."""
    from pepper_tpu_torch.ops import lstm_kernel

    with contextlib.ExitStack() as stack:
        for name in lstm_kernel.KERNELS:
            stack.enter_context(mock.patch.object(
                lstm_kernel, name, getattr(lstm_kernel, f"{name}_reference")))
        yield


def phase_transducer(device, card):
    import torch
    from pepper_tpu_torch.models.transducer import (init_transducer_params,
                                                    params_from_jax,
                                                    transducer_infer,
                                                    map_params)

    params = init_transducer_params(torch.Generator().manual_seed(7),
                                    device=device)
    gen = torch.Generator(device=device).manual_seed(8)
    windows = torch.randint(-125, 126, (B_SERVE, T, 26), generator=gen,
                            device=device).to(torch.int8)
    result = {}
    for dtype_name, dtype in (("float32", torch.float32),
                              ("bfloat16", torch.bfloat16)):
        cast = map_params(lambda p: p.to(dtype), params_from_jax(params,
                                                                 device))
        probs = transducer_infer(cast, windows, dtype)
        with twin_path():
            ref = transducer_infer(cast, windows, dtype)
        torch.cuda.synchronize()
        check(probs.shape == (B_SERVE, 3) and probs.dtype == torch.float32,
              f"probabilities {tuple(probs.shape)} {probs.dtype}")
        check(bool(torch.isfinite(probs).all()), "probabilities not finite")
        sums = probs.sum(dim=1)
        check(bool(torch.allclose(sums, torch.ones_like(sums), atol=1e-5)),
              "probabilities do not sum to 1")
        err = (probs - ref).abs().max().item()
        check(err <= TRANSDUCER_BARS[dtype_name],
              f"transducer {dtype_name}: max abs diff {err}")
        ms = cuda_ms(lambda: transducer_infer(cast, windows, dtype), iters=5)
        with twin_path():
            twin_ms = cuda_ms(lambda: transducer_infer(cast, windows, dtype),
                              iters=5)
        result[dtype_name] = {
            "max_abs_err": err,
            "argmax_agree": (probs.argmax(1) == ref.argmax(1)).float()
            .mean().item(),
            "batch_ms": ms, "windows_per_s": B_SERVE / ms * 1e3,
            "twin_batch_ms": twin_ms,
        }
    emit({"phase": "transducer", "card": card, "B": B_SERVE, **result})
    return result


# ---------------------------------------------------------------- phase 5


def quantize_cols(w):
    """Per-output-column int8 codes of a float (K, N) weight and their
    (N,) float32 scales, absmax/127 (models/quantize.py's _quantize_cols)."""
    import torch

    scale = w.abs().amax(dim=0).clamp_min(1e-8) / 127.0
    return torch.round(w / scale).clamp(-127, 127).to(torch.int8), scale


def static_weights(gen, layer, dtype, rec_int8, device):
    """One direction's weights in a static int8 mode at the serving widths:
    the encoder's W_ih in dtype, the decoder's int8 with acc_scale
    (w_scale/127), W_hh in dtype or int8 with rec_scale; a float32 bias."""
    import torch

    scale = 1.0 / H ** 0.5

    def u(*size, s=scale):
        return (torch.rand(size, generator=gen, device=device) * 2 - 1) * s

    weights = {"b": u(4 * H, s=2 * scale), "acc_scale": None,
               "rec_scale": None}
    if layer == "encoder":
        weights["w_ih"] = (u(26, 4 * H).to(dtype),)
    else:
        q, w_scale = quantize_cols(u(2 * H, 4 * H))
        weights["w_ih"] = (q[:H].contiguous(), q[H:].contiguous())
        weights["acc_scale"] = w_scale / 127.0
    if rec_int8:
        weights["w_hh"], r_scale = quantize_cols(u(H, 4 * H))
        weights["rec_scale"] = r_scale / 127.0
    else:
        weights["w_hh"] = u(H, 4 * H).to(dtype)
    return weights


def static_bound_ms(layer, B, dtype, rec_int8):
    """Least time of one static launch: its products at the tensor-core
    peak of their type (int8 for int8 operands, else the float dtype's),
    against the bytes of x in, weights in and int8 codes out."""
    import torch

    F = 26 if layer == "encoder" else 2 * H
    float_peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 \
        else PEAK_F32_FLOPS
    item = 2 if dtype == torch.bfloat16 else 4
    proj, rec = 2 * T * B * F * 4 * H, 2 * T * B * H * 4 * H
    seconds = (proj / (float_peak if layer == "encoder" else PEAK_INT8_OPS)
               + rec / (PEAK_INT8_OPS if rec_int8 else float_peak))
    x_item = item if layer == "encoder" else 1
    nbytes = (T * B * F * x_item + F * 4 * H * x_item
              + H * 4 * H * (1 if rec_int8 else item) + 3 * 4 * H * 4
              + T * B * H)
    return max(seconds, nbytes / PEAK_BYTES) * 1e3


def phase_kernel_static(device, card):
    import torch
    from pepper_tpu_torch.ops import lstm_kernel

    kernel = lstm_kernel.lstm_direction_fused_static
    twin = lstm_kernel.lstm_direction_fused_static_reference
    gen = torch.Generator(device=device).manual_seed(4321)

    def run(fn, xs, w, reverse=False, **kw):
        return fn(xs, w["w_ih"], w["b"], w["w_hh"], acc_scale=w["acc_scale"],
                  rec_scale=w["rec_scale"], reverse=reverse, **kw)

    codes, max_code_diff, float_err = {}, 0, {}
    for dtype_name, dtype in (("bfloat16", torch.bfloat16),
                              ("float32", torch.float32)):
        for mode in ("static", "static_rec"):
            rec_int8 = mode == "static_rec"
            tally = {"encoder": [0, 0], "decoder": [0, 0]}
            for B in (B_SERVE, 37):
                x = torch.randint(-125, 126, (T, B, 26), generator=gen,
                                  device=device).to(dtype)
                streams = []
                for layer in ("encoder", "decoder"):
                    xs = (x,) if layer == "encoder" else tuple(streams)
                    streams = []
                    for reverse in (False, True):
                        w = static_weights(gen, layer, dtype, rec_int8,
                                           device)
                        out = run(kernel, xs, w, reverse, out_int8=True)
                        ref = run(twin, xs, w, reverse, out_int8=True)
                        torch.cuda.synchronize()
                        check(out.shape == (T, B, H)
                              and out.dtype == torch.int8,
                              f"static output {tuple(out.shape)} "
                              f"{out.dtype}")
                        diff = (out.int() - ref.int()).abs()
                        worst = diff.max().item()
                        check(worst <= 1, f"{dtype_name} {mode} {layer} "
                              f"B={B} reverse={reverse}: codes differ by "
                              f"{worst}")
                        max_code_diff = max(max_code_diff, worst)
                        tally[layer][0] += (diff == 0).sum().item()
                        tally[layer][1] += diff.numel()
                        streams.append(out)
            for layer, (equal, total) in tally.items():
                share = equal / total
                check(share >= CODE_BARS[mode],
                      f"{dtype_name} {mode} {layer}: {share} of the codes "
                      f"equal the twin's, bar {CODE_BARS[mode]}")
                codes[f"{mode}_{layer}_{dtype_name}"] = share
        # the float epilogue (out_int8=False)
        x = torch.randint(-125, 126, (T, 37, 26), generator=gen,
                          device=device).to(dtype)
        w = static_weights(gen, "encoder", dtype, False, device)
        out = run(kernel, (x,), w, out_dtype=dtype)
        ref = run(twin, (x,), w, out_dtype=dtype)
        float_err[dtype_name] = (out.float() - ref.float()).abs().max().item()
        check(out.dtype == dtype and float_err[dtype_name]
              <= KERNEL_BARS[dtype_name],
              f"static float output {dtype_name}: {float_err[dtype_name]}")

    timings = {}
    dtype = torch.bfloat16
    for mode in ("static", "static_rec"):
        rec_int8 = mode == "static_rec"
        x = torch.randint(-125, 126, (T, B_SERVE, 26), generator=gen,
                          device=device).to(dtype)
        enc = static_weights(gen, "encoder", dtype, rec_int8, device)
        streams = (run(kernel, (x,), enc, out_int8=True),
                   run(kernel, (x,), enc, True, out_int8=True))
        dec = static_weights(gen, "decoder", dtype, rec_int8, device)
        for layer, xs, w in (("encoder", (x,), enc),
                             ("decoder", streams, dec)):
            timings[f"{layer}_{mode}_bfloat16"] = {
                "kernel_ms": cuda_ms(lambda: run(kernel, xs, w,
                                                 out_int8=True)),
                "plain_ms": cuda_ms(lambda: run(twin, xs, w, out_int8=True),
                                    iters=5),
                "bound_ms": static_bound_ms(layer, B_SERVE, dtype, rec_int8),
            }
    emit({"phase": "kernel_static",
          "kernel_names": ["lstm_direction_fused_static"], "card": card,
          "max_code_diff": max_code_diff, "equal_share": codes,
          "float_output_max_abs_err": float_err, "B": B_SERVE,
          "per_launch": timings})
    return max_code_diff, codes, timings


# ---------------------------------------------------------------- phase 6


def phase_kernel_recurrence(device, card):
    import torch
    from pepper_tpu_torch.ops import lstm_kernel

    kernel = lstm_kernel.lstm_recurrence
    twin = lstm_kernel.lstm_recurrence_reference
    gen = torch.Generator(device=device).manual_seed(99)

    def inputs(B, dtype):
        xw = ((torch.rand((T, B, 4 * H), generator=gen, device=device) * 4
               - 2).to(dtype))
        w_hh = ((torch.rand((H, 4 * H), generator=gen, device=device) * 2
                 - 1) / H ** 0.5).to(dtype)
        return xw, w_hh

    max_err = {}
    for dtype_name, dtype in (("float32", torch.float32),
                              ("bfloat16", torch.bfloat16)):
        worst = 0.0
        for B in (B_SERVE, 37):
            xw, w_hh = inputs(B, dtype)
            out = kernel(xw, w_hh)
            ref = twin(xw, w_hh)
            torch.cuda.synchronize()
            check(out.shape == (T, B, H) and out.dtype == dtype,
                  f"recurrence output {tuple(out.shape)} {out.dtype}")
            check(bool(torch.isfinite(out.float()).all()),
                  "recurrence output not finite")
            err = (out.float() - ref.float()).abs().max().item()
            check(err <= KERNEL_BARS[dtype_name],
                  f"recurrence {dtype_name} B={B}: max abs diff {err}")
            worst = max(worst, err)
        max_err[dtype_name] = worst

    xw, w_hh = inputs(B_SERVE, torch.bfloat16)
    nbytes = 2 * (xw.numel() + w_hh.numel() + T * B_SERVE * H)
    flops = 2 * T * B_SERVE * H * 4 * H
    timing = {"kernel_ms": cuda_ms(lambda: kernel(xw, w_hh)),
              "plain_ms": cuda_ms(lambda: twin(xw, w_hh), iters=5),
              "bound_ms": bound_ms(flops, nbytes, PEAK_BF16_FLOPS),
              "bound_by": ("bytes" if nbytes / PEAK_BYTES
                           > flops / PEAK_BF16_FLOPS else "operations"),
              "mbytes": nbytes / 1e6, "gflop": flops / 1e9}
    emit({"phase": "kernel_recurrence", "kernel_names": ["lstm_recurrence"],
          "card": card, "max_abs_err": max_err, "B": B_SERVE,
          "per_launch_bfloat16": timing})
    return max_err, timing


# ---------------------------------------------------------------- phase 7


def phase_kernel_dual(device, card):
    import torch
    from pepper_tpu_torch.ops import lstm_kernel

    kernel = lstm_kernel.bilstm_dual_fused
    twin = lstm_kernel.bilstm_dual_fused_reference
    single = lstm_kernel.lstm_direction_fused
    gen = torch.Generator(device=device).manual_seed(5678)

    def inputs(shape, B, dtype):
        xs, wf, b_f, w_hh_f = lstm_inputs(gen, shape, B, dtype, device)
        _, wb, b_b, w_hh_b = lstm_inputs(gen, shape, 1, dtype, device)
        return xs, wf, wb, b_f, b_b, w_hh_f, w_hh_b

    max_err, max_vs_single = {}, 0.0
    for dtype_name, dtype in (("float32", torch.float32),
                              ("bfloat16", torch.bfloat16)):
        worst = 0.0
        for shape in ("encoder", "decoder"):
            for B in (B_SERVE, 37):
                args = inputs(shape, B, dtype)
                xs, wf, wb, b_f, b_b, w_hh_f, w_hh_b = args
                outs = kernel(*args)
                refs = twin(*args)
                singles = (single(xs, wf, b_f, w_hh_f),
                           single(xs, wb, b_b, w_hh_b, reverse=True))
                torch.cuda.synchronize()
                for out, ref, one in zip(outs, refs, singles):
                    check(out.shape == (T, B, H) and out.dtype == dtype,
                          f"dual output {tuple(out.shape)} {out.dtype}")
                    err = (out.float() - ref.float()).abs().max().item()
                    check(err <= KERNEL_BARS[dtype_name],
                          f"dual {dtype_name} {shape} B={B}: max abs diff "
                          f"{err}")
                    worst = max(worst, err)
                    max_vs_single = max(max_vs_single, (
                        out.float() - one.float()).abs().max().item())
        max_err[dtype_name] = worst

    timings = {}
    dtype = torch.bfloat16
    for shape in ("encoder", "decoder"):
        args = inputs(shape, B_SERVE, dtype)
        xs, wf, wb, b_f, b_b, w_hh_f, w_hh_b = args
        flops, nbytes = launch_work(shape, B_SERVE, 2)
        x_cat = torch.cat(xs, dim=-1)
        lstm = cudnn_lstm([(wf, b_f, w_hh_f), (wb, b_b, w_hh_b)], dtype,
                          device)
        timings[f"{shape}_bfloat16"] = {
            "kernel_ms": cuda_ms(lambda: kernel(*args)),
            "two_single_launches_ms": cuda_ms(lambda: (
                single(xs, wf, b_f, w_hh_f),
                single(xs, wb, b_b, w_hh_b, reverse=True))),
            "plain_ms": cuda_ms(lambda: twin(*args), iters=5),
            "cudnn_bidirectional_ms": cudnn_ms(lstm, x_cat),
            "bound_ms": 2 * bound_ms(flops, nbytes, PEAK_BF16_FLOPS),
        }
    emit({"phase": "kernel_dual", "kernel_names": ["bilstm_dual_fused"],
          "card": card, "max_abs_err": max_err,
          "max_abs_diff_from_single_launches": max_vs_single, "B": B_SERVE,
          "per_launch": timings})
    return max_err, timings


# ---------------------------------------------------------------- phase 8


def phase_transducer_quantized(device, card):
    import torch
    from pepper_tpu_torch.models import quantize
    from pepper_tpu_torch.models.transducer import (init_transducer_params,
                                                    map_params,
                                                    params_from_jax,
                                                    transducer_infer)
    from pepper_tpu_torch.ops import lstm_kernel

    params = init_transducer_params(torch.Generator().manual_seed(7))
    host = {name: {k: v.numpy() for k, v in group.items()}
            for name, group in params.items()}
    gen = torch.Generator(device=device).manual_seed(8)
    windows = torch.randint(-125, 126, (B_SERVE, T, 26), generator=gen,
                            device=device).to(torch.int8)
    floats = {}
    for dtype_name, dtype in (("float32", torch.float32),
                              ("bfloat16", torch.bfloat16)):
        cast = map_params(lambda p: p.to(dtype),
                          params_from_jax(params, device))
        floats[dtype_name] = transducer_infer(cast, windows, dtype)

    result = {}
    for mode in ("static", "static_rec", "dynamic"):
        if mode == "dynamic":
            q, s = (params_from_jax(tree, device)
                    for tree in quantize.quantize_params(host))
            counter = lstm_kernel.lstm_recurrence

            def forward():
                return quantize.transducer_infer_quantized(q, s, windows)
        else:
            tree = quantize.prepare_static(
                quantize.quantize_params_static(
                    host, rec_int8=mode == "static_rec"),
                torch.bfloat16, device)
            counter = lstm_kernel.lstm_direction_fused_static

            def forward():
                return quantize.transducer_infer_static(tree, windows,
                                                        torch.bfloat16)
        counter.launches = 0
        probs = forward()
        check(counter.launches == 4,
              f"{mode}: {counter.launches} kernel launches, not 4")
        with twin_path():
            ref = forward()
        torch.cuda.synchronize()
        check(probs.shape == (B_SERVE, 3) and probs.dtype == torch.float32,
              f"{mode} probabilities {tuple(probs.shape)} {probs.dtype}")
        check(bool(torch.isfinite(probs).all()),
              f"{mode} probabilities not finite")
        sums = probs.sum(dim=1)
        check(bool(torch.allclose(sums, torch.ones_like(sums), atol=1e-5)),
              f"{mode} probabilities do not sum to 1")
        err = (probs - ref).abs().max().item()
        check(err <= QUANTIZED_BARS[mode],
              f"transducer {mode}: max abs diff {err} from the twin path")
        ms = cuda_ms(forward, iters=5)
        with twin_path():
            twin_ms = cuda_ms(forward, iters=3, warmup=1)
        result[mode] = {
            "max_abs_err": err,
            "argmax_agree": (probs.argmax(1) == ref.argmax(1)).float()
            .mean().item(),
            "batch_ms": ms, "windows_per_s": B_SERVE / ms * 1e3,
            "twin_batch_ms": twin_ms,
            "max_abs_diff_from_float": {
                name: (probs - p).abs().max().item()
                for name, p in floats.items()},
        }
    emit({"phase": "transducer_quantized", "card": card, "B": B_SERVE,
          "compute_dtype": "bfloat16", **result})
    return result


# ---------------------------------------------------------------- phase 9


def _cigar_read(ref, variants, start, span):
    """(seq, cigar) of a read covering ref[start:start+span) on a haplotype
    carrying `variants` [(pos, ref_allele, alt_allele)], none of which may
    straddle the read's ends."""
    seq, ops = [], []

    def op(kind, n):
        if n <= 0:
            return
        if ops and ops[-1][0] == kind:
            ops[-1][1] += n
        else:
            ops.append([kind, n])

    cursor = start
    for pos, ref_allele, alt in variants:
        if pos < start or pos + len(ref_allele) >= start + span:
            continue
        seq.append(ref[cursor:pos])
        op("M", pos - cursor)
        if len(ref_allele) == len(alt):          # SNP
            seq.append(alt)
            op("M", 1)
        elif len(alt) > len(ref_allele):         # insertion after the anchor
            seq.append(alt)
            op("M", 1)
            op("I", len(alt) - 1)
        else:                                    # deletion after the anchor
            seq.append(alt)
            op("M", 1)
            op("D", len(ref_allele) - 1)
        cursor = pos + len(ref_allele)
    seq.append(ref[cursor:start + span])
    op("M", start + span - cursor)
    return "".join(seq), "".join(f"{n}{kind}" for kind, n in ops)


def write_scene(directory, length=60_000, read_len=1000, coverage=30,
                error_rate=0.03, seed=5):
    """A reference, two haplotypes with SNPs and indels every ~150 bp, and
    ~30x of reads with substitution errors, written with the port's own
    BAM/FASTA writers."""
    from pepper_tpu_torch.io.bam_writer import (BamRecord, write_bam,
                                                write_fasta)

    rng = np.random.RandomState(seed)
    ref = "".join("ACGT"[i] for i in rng.randint(0, 4, length))
    hap1, hap2 = [], []
    for i, pos in enumerate(range(300, length - 300, 150)):
        kind = i % 4
        if kind in (0, 1):
            alt = "ACGT"[("ACGT".index(ref[pos]) + 1 + rng.randint(3)) % 4]
            variant = (pos, ref[pos], alt)
        elif kind == 2:
            variant = (pos, ref[pos], ref[pos] + "".join(
                "ACGT"[j] for j in rng.randint(0, 4, 1 + rng.randint(4))))
        else:
            variant = (pos, ref[pos:pos + 2 + rng.randint(4)], ref[pos])
        hap1.append(variant)
        if kind == 1:                             # homozygous
            hap2.append(variant)
    stride = read_len * 2 // coverage
    records = []
    for hap_index, variants in enumerate((hap1, hap2)):
        for n, start in enumerate(range(hap_index * stride // 2,
                                        length - read_len, stride)):
            seq, cigar = _cigar_read(ref, variants, start, read_len)
            codes = np.frombuffer(seq.encode(), np.uint8).copy()
            errors = rng.rand(len(codes)) < error_rate
            shift = rng.randint(1, 4, len(codes))
            base_ix = np.searchsorted(np.frombuffer(b"ACGT", np.uint8), codes)
            codes[errors] = np.frombuffer(b"ACGT", np.uint8)[
                (base_ix[errors] + shift[errors]) % 4]
            qual = np.where(errors, 7, 30).tolist()
            records.append(BamRecord(
                name=f"read_{hap_index}_{n}", ref_id=0, pos=start, mapq=60,
                cigar=cigar, seq=codes.tobytes().decode(), qual=qual,
                flag=0x10 if n % 2 else 0))
    records.sort(key=lambda r: r.pos)
    bam, fasta = (os.path.join(directory, "scene.bam"),
                  os.path.join(directory, "scene.fa"))
    write_bam(bam, [("chr1", length)], records)
    write_fasta(fasta, {"chr1": ref})
    return bam, fasta, len(hap1)


def canonical_calls(calls):
    """The call set with each site's ALT alleles and genotype as sorted
    allele strings: the ALT order within a multi-allelic site follows the
    candidates' genotype probabilities and can swap on a near tie."""
    out = set()
    for pos, ref, alt, gt in calls:
        alleles = [ref, *alt.split(",")]
        called = sorted(alleles[int(i)] if i != "." else "."
                        for i in gt.replace("|", "/").split("/"))
        out.add((pos, ref, tuple(sorted(alleles[1:])), tuple(called)))
    return out


def call_set(out_dir):
    calls = set()
    path = os.path.join(out_dir, "PEPPER_VARIANT_FULL.vcf.gz")
    with gzip.open(path, "rt") as f:
        for line in f:
            if not line.startswith("#"):
                fields = line.split("\t")
                gt = fields[9].split(":")[fields[8].split(":").index("GT")]
                calls.add((int(fields[1]), fields[3], fields[4], gt))
    return calls


# (name, device, compute dtype, extra CLI arguments, PEPPER_LSTM_DUAL,
#  the kernel the run must launch and its launches per batch, the run whose
#  call set it must equal); cpu runs launch nothing
CALL_RUNS = (
    ("cuda_bfloat16", "cuda", "bfloat16", (), False,
     "lstm_direction_fused", 4, "cpu_float32"),
    ("cuda_float32", "cuda", "float32", (), False,
     "lstm_direction_fused", 4, "cpu_float32"),
    ("cpu_float32", "cpu", "float32", (), False, None, 0, None),
    ("cuda_dual_bfloat16", "cuda", "bfloat16", (), True,
     "bilstm_dual_fused", 2, "cpu_float32"),
    ("cuda_static_bfloat16", "cuda", "bfloat16", ("--quantized",), False,
     "lstm_direction_fused_static", 4, "cpu_static_bfloat16"),
    ("cpu_static_bfloat16", "cpu", "bfloat16", ("--quantized",), False,
     None, 0, None),
    ("cuda_static_rec_bfloat16", "cuda", "bfloat16",
     ("--quantized", "--quantize_mode", "static_rec"), False,
     "lstm_direction_fused_static", 4, "cpu_static_rec_bfloat16"),
    ("cpu_static_rec_bfloat16", "cpu", "bfloat16",
     ("--quantized", "--quantize_mode", "static_rec"), False, None, 0, None),
    ("cuda_dynamic", "cuda", "bfloat16",
     ("--quantized", "--quantize_mode", "dynamic"), False,
     "lstm_recurrence", 4, "cpu_dynamic"),
    ("cpu_dynamic", "cpu", "bfloat16",
     ("--quantized", "--quantize_mode", "dynamic"), False, None, 0, None),
)


def phase_call(device, workdir, threads=4):
    """call_variant through the CLI in every run of CALL_RUNS; returns each
    cuda run's launches by kernel, read around that run alone."""
    import torch
    from pepper_tpu_torch.cli import main as cli
    from pepper_tpu_torch.models.checkpoint import save_params
    from pepper_tpu_torch.models.transducer import init_transducer_params
    from pepper_tpu_torch.ops import lstm_kernel

    bam, fasta, n_variants = write_scene(workdir)
    model = os.path.join(workdir, "model.npz")
    params = init_transducer_params(torch.Generator().manual_seed(11))
    save_params(model, {name: {k: v.numpy() for k, v in group.items()}
                        for name, group in params.items()},
                {"model_type": "lstm"})
    wrappers = {name: getattr(lstm_kernel, name)
                for name in lstm_kernel.KERNELS}
    runs, launches = {}, {}
    for name, dev, dtype, extra, dual, _, _, _ in CALL_RUNS:
        out = os.path.join(workdir, name)
        argv = ["call_variant", "-b", bam, "-f", fasta, "-m", model,
                "-o", out, "-t", str(threads), "--region_size", "10000",
                "--ont_r9_guppy5_sup", "--compute_dtype", dtype,
                "--device", str(device) if dev == "cuda" else dev, *extra]
        for wrapper in wrappers.values():
            wrapper.launches = 0
        env = {"PEPPER_LSTM_DUAL": "1" if dual else "0"}
        t0 = time.time()
        with mock.patch.dict(os.environ, env):
            check(cli.main(argv) == 0, f"call_variant {name} failed")
        if dev == "cuda":
            torch.cuda.synchronize()
        seconds = time.time() - t0
        launches[name] = {k: w.launches for k, w in wrappers.items()}
        runs[name] = {"seconds": round(seconds, 3), "calls": call_set(out)}
    check(len(runs["cpu_float32"]["calls"]) > 0, "no calls on the CPU")
    alt_order_only = {}
    for name, dev, _, extra, _, kernel, per_batch, reference in CALL_RUNS:
        counts = launches[name]
        if dev == "cpu":
            check(not any(counts.values()), f"{name} launched {counts}")
            continue
        calls, expected = runs[name]["calls"], runs[reference]["calls"]
        if "--quantized" in extra:
            # int8 codes on the card and the CPU differ at the 1e-4 share,
            # so near-tied candidates of one site may list in either order
            alt_order_only[name] = len(calls - expected)
            calls, expected = canonical_calls(calls), canonical_calls(
                expected)
        check(calls == expected, f"{name} calls differ from {reference}: "
              f"{sorted(calls ^ expected)[:10]}")
        n = counts[kernel]
        check(n >= per_batch and n % per_batch == 0,
              f"{kernel} launched {n} times in {name}")
        others = {k: v for k, v in counts.items() if k != kernel and v}
        check(not others, f"{name} also launched {others}")
    emit({"phase": "call", "variants_simulated": n_variants,
          "calls": {k: len(v["calls"]) for k, v in runs.items()},
          "alt_order_only_differences": alt_order_only,
          "launches": {k: v for k, v in launches.items()
                       if k.startswith("cuda")},
          "seconds": {k: v["seconds"] for k, v in runs.items()}})
    return launches


# ---------------------------------------------------------------- main


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import pepper_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: run from a checkout of the repository ({exc})",
              file=sys.stderr)
        return 2
    # float32 products on the card in full float32 (the twins' reference)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "kind": kind, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda})
    t0 = time.time()
    phase_build()
    max_err, per_launch = phase_kernel(device, smi)
    phase_transducer(device, smi)
    code_diff, code_share, static_launch = phase_kernel_static(device, smi)
    rec_err, rec_launch = phase_kernel_recurrence(device, smi)
    dual_err, dual_launch = phase_kernel_dual(device, smi)
    phase_transducer_quantized(device, smi)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        launches = phase_call(device, workdir)
    emit({"phase": "done", "seconds_total": round(time.time() - t0, 3)})

    # each kernel's work on its path for one batch of B_SERVE windows in
    # bfloat16: encoder and decoder, forward and backward
    def batch(per_layer, keys, runs=2):
        return {key: runs * sum(layer[key] for layer in per_layer)
                for key in keys}

    float_batch = batch(
        [per_launch["encoder_bfloat16"], per_launch["decoder_bfloat16"]],
        ("kernel_ms", "plain_ms", "bound_ms", "cudnn_ms"))
    static_batch = {mode: batch(
        [static_launch[f"encoder_{mode}_bfloat16"],
         static_launch[f"decoder_{mode}_bfloat16"]],
        ("kernel_ms", "plain_ms", "bound_ms"))
        for mode in ("static", "static_rec")}
    rec_batch = {key: 4 * rec_launch[key]
                 for key in ("kernel_ms", "plain_ms", "bound_ms")}
    dual_batch = batch(
        [dual_launch["encoder_bfloat16"], dual_launch["decoder_bfloat16"]],
        ("kernel_ms", "plain_ms", "bound_ms", "cudnn_bidirectional_ms",
         "two_single_launches_ms"), runs=1)
    emit({"kernels": [{
        "name": "lstm_direction_fused", "route": "cuda",
        "source": "pepper_tpu_torch/ops/csrc/lstm_direction_fused.cu",
        "replaces": "pepper_tpu/ops/lstm_kernel.py:146",
        "launches": launches["cuda_bfloat16"]["lstm_direction_fused"],
        "max_abs_err": max_err["bfloat16"],
        "max_abs_err_f32": max_err["float32"],
        "ms": float_batch["kernel_ms"], "plain_ms": float_batch["plain_ms"],
        "bound_ms": float_batch["bound_ms"], "bound_by": "operations",
        "library_ms": float_batch["cudnn_ms"],
        "work": f"one batch of {B_SERVE} windows, bfloat16: encoder and "
                "decoder, forward and backward (4 launches)",
    }, {
        "name": "lstm_direction_fused_static", "route": "cuda",
        "source": "pepper_tpu_torch/ops/csrc/lstm_direction_fused_static.cu",
        "replaces": "pepper_tpu/ops/lstm_kernel.py:283",
        "launches": launches["cuda_static_bfloat16"][
            "lstm_direction_fused_static"],
        "launches_static_rec": launches["cuda_static_rec_bfloat16"][
            "lstm_direction_fused_static"],
        "max_abs_err": code_diff, "max_abs_err_unit": "int8 code",
        "equal_share": code_share,
        "ms": static_batch["static"]["kernel_ms"],
        "plain_ms": static_batch["static"]["plain_ms"],
        "bound_ms": static_batch["static"]["bound_ms"],
        "bound_by": "operations", "library_ms": None,
        "library_note": "no PyTorch call runs an LSTM on int8 input codes "
                        "with int8 weights and emits int8 codes",
        "static_rec": static_batch["static_rec"],
        "work": f"one batch of {B_SERVE} windows in the static mode, "
                "bfloat16: encoder and decoder, forward and backward (4 "
                "launches)",
    }, {
        "name": "lstm_recurrence", "route": "cuda",
        "source": "pepper_tpu_torch/ops/csrc/lstm_recurrence.cu",
        "replaces": "pepper_tpu/ops/lstm_kernel.py:65",
        "launches": launches["cuda_dynamic"]["lstm_recurrence"],
        "max_abs_err": rec_err["bfloat16"],
        "max_abs_err_f32": rec_err["float32"],
        "ms": rec_batch["kernel_ms"], "plain_ms": rec_batch["plain_ms"],
        "bound_ms": rec_batch["bound_ms"],
        "bound_by": rec_launch["bound_by"], "library_ms": None,
        "library_note": "torch.nn.LSTM (cuDNN) takes x and W_ih, not "
                        "precomputed projections; no PyTorch call runs the "
                        "recurrence alone",
        "work": f"one batch of {B_SERVE} windows in the dynamic mode: four "
                "bfloat16 recurrences (4 launches)",
    }, {
        "name": "bilstm_dual_fused", "route": "cuda",
        "source": "pepper_tpu_torch/ops/csrc/bilstm_dual_fused.cu",
        "replaces": "pepper_tpu/ops/lstm_kernel.py:451",
        "launches": launches["cuda_dual_bfloat16"]["bilstm_dual_fused"],
        "max_abs_err": dual_err["bfloat16"],
        "max_abs_err_f32": dual_err["float32"],
        "ms": dual_batch["kernel_ms"], "plain_ms": dual_batch["plain_ms"],
        "bound_ms": dual_batch["bound_ms"], "bound_by": "operations",
        "library_ms": dual_batch["cudnn_bidirectional_ms"],
        "two_single_launches_ms": dual_batch["two_single_launches_ms"],
        "work": f"one batch of {B_SERVE} windows, bfloat16, "
                "PEPPER_LSTM_DUAL=1: encoder and decoder (2 launches)",
    }]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
