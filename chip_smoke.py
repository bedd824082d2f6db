#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (pepper_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each printing one JSON line:
  1 device     the card's name and `nvidia-smi` name/power limit
  2 build      the native host libraries and the eight sm_90a CUDA kernels,
               built from the checkout's sources in parallel (one nvcc per
               kernel), with ptxas's register and spill lines
  3 kernel     lstm_direction_fused against its plain twin on the card, at
               the transducer's full width (encoder F=26, decoder 2x256,
               H=256), B=4096, 37, 128 and 512, both directions, float32
               (atol 1e-5) and bfloat16 (atol 2e-2); per-launch times of
               kernel and cuDNN (torch.nn.LSTM) beside the bound, queued
               behind a device sleep, in bfloat16 at B=32, 128, 512 and
               4096 (the decoder's input projection and recurrence also
               apart, through the library's entries, whose outputs must
               equal the kernel's), in float32 at 4096 (both widths'
               projection and recurrence apart; cuDNN with
               torch.backends.cudnn.allow_tf32 False, checked; both
               bounds, 3xTF32 on the TF32 tensor cores and float32 FMAs),
               the twin at 4096, with the core's launch plan in each dtype
               (rows and CTAs a cluster, clusters, and how many run at
               once); ptxas's registers, shared memory and spills of both
               float LSTM kernels
  4 transducer transducer_infer on 4096 int8 windows through the kernel
               against the twin path on the card (probabilities atol 2e-4
               float32, 1e-2 bfloat16), and windows/s
  5 kernel_static
               lstm_direction_fused_static against its twin: encoder (F=26,
               bfloat16 and float32) and decoder (the encoder's int8 codes,
               2x256), static and static_rec, B=4096 and B=37, both
               directions; codes within 1 and at least 99.9% (static) /
               99.5% (static_rec) equal; the float epilogue (h out in
               float32 and bfloat16) of every (x, W_hh) dtype pair at
               KERNEL_BARS, B=37 and 4096; per-launch times in bfloat16
               and float32 at B=4096 (queued, and unqueued beside them)
               beside the bound (float32: both, 3xTF32 and float32 FMAs)
               and the twin, every launch that projects x first (the
               decoder; in float32 the encoder too) as its
               projection and recurrence apart through the library's
               entries (int8 x's xw equal to the exact int32 product,
               float x's within 1e-4 of b + x @ W_ih, the two launches'
               codes equal to the kernel's bit for bit), the cores'
               launch plan for the recurrence, in float32 the PR 2
               scalar body's time, measured by --static_float32_times on
               commit 97c4798 (a constant, labelled), the float
               epilogue's launch (33x26, B=4096, bfloat16 and float32)
               beside its bound, row 1's bfloat16 kernel at the same
               shapes, and ptxas's registers and spills of the library's
               entries
  6 kernel_recurrence
               lstm_recurrence against its twin, xw (33, B, 1024) in
               bfloat16 (atol 2e-2) and float32 (atol 1e-5), phase 3's
               batches, both directions; times queued behind a device
               sleep (unqueued beside them) of the kernel at B=4096, 37 and
               512 in bfloat16 and at 4096 in float32, and of cuDNN's
               torch.nn.LSTM with W_ih = I on xw in both dtypes, checked
               against the twin in float32; the core's launch plan in both
               dtypes and ptxas's registers and spills of the library's
               entries
  7 kernel_dual
               bilstm_dual_fused against its twin (two twins of phase 3's
               kernel) at phase 3's batches, and its largest difference
               from two single launches; times at B=4096 in bfloat16 and
               float32 as phase 3's (projection and recurrence apart where
               x is projected first), with cuDNN's bidirectional
               torch.nn.LSTM
  8 transducer_quantized
               4096 int8 windows through the static, static_rec and
               dynamic int8 modes (and the static ones again in float32,
               4 launches a batch) on the kernels against the twin path on
               the card (atol 5e-3, 1e-2, 1e-2), windows/s, and the largest
               difference from the float transducer; one dynamic batch
               under torch.profiler: its ten operations and ten kernels
               with the most device time
  9 call       call_variant through the CLI on a synthetic 30x scene with
               seeded random full-width weights: cuda bfloat16 (the float
               main path), cuda float32 and cpu float32 must give the same
               (pos, REF, ALT, GT) set, the bfloat16 run up to the order
               of the ALT alleles within a site (near-tied candidates; the
               count is printed); so must cuda bfloat16 with
               PEPPER_LSTM_DUAL=1; --quantized static, static_rec and
               dynamic on cuda must each give the set of a cpu run of the
               same mode, up to the ALT order, and so must --quantized
               static and static_rec with --compute_dtype float32 (on the
               scene's first 20 kb, F32_STATIC_REGION);
               --device_pileup on cuda in float32 must give the set of a
               cpu --device_pileup run and of the cuda host flow, in
               bfloat16 the cpu --device_pileup bfloat16 set up to the ALT
               order (counted); cuda float32 with PEPPER_LSTM_DUAL=1 must
               give the cpu float32 set.  Every kernel's launch count is
               set to 0 before each cuda run and read after it;
               --device_pileup runs the images flow, which launches no
               histogram.
 10 kernel_gru the three GRU kernels of polish against their twins at the
               consensus model's width (encoder F=10, decoder 2x128, H=128,
               T=100; encoder inputs 0..40), B=128, 4096 and 37, both
               directions, a non-zero h0:
               gru_direction_fused and gru_recurrence in float32 (atol 1e-5)
               and bfloat16 (2e-2), also at B=32 and 512 (the other
               consensus buckets) and, at B=37, H=32 and 256 (the core's
               narrowest smem width and its L2-streaming body);
               gru_direction_fused_static with codes within 1 and at least
               99.9% equal and hT within 1e-5 (float32 mode) or 2e-2
               (bfloat16 W_hh); per-launch times at B=32, 128, 512 and 4096
               (the static kernel at 128, 4096 and 37) beside the bound, and
               cuDNN's torch.nn.GRU (for the recurrence: with W_ih = I on
               xw, checked against the twin); both fused kernels' input
               projection and recurrence timed apart (the static one's
               int8 projection equal to the exact int32 product, its two
               launches' codes and hT equal to the kernel's); ptxas's
               registers, static shared memory and spills of each entry of
               the three kernels on gru_core.cuh
 11 consensus  512 chunks through the consensus scan at the CLI's batch of
               128 in the float, static and recurrence modes, kernels
               against the twin path on the card (votes within the stated
               bar, labels equal wherever the twin's top-two vote margin
               exceeds 0.05), twice: the phase-12 scene's own images
               (repeated to 512; timed, chunks/s) and seeded counts of
               0..40; each set with the share of saturated outputs
 12 polish     the polish CLI on a synthetic 24 kb draft with seeded SNP,
               insertion and deletion errors and ~30x of reads of the truth:
               cuda float32, cuda --quantized and cuda with
               PEPPER_GRU_FUSED=0 PEPPER_GRU_KERNEL=1 against cpu runs
               (the same FASTA bytes; --quantized: or else only near-tied
               positions, counted), each cuda run launching only its own
               kernel, a multiple of 76 times (19 windows x 4 directions);
               a --dry run must move the draft toward the truth (fewer of
               the truth's 21-mers missing)
 13 kernel_histogram
               pileup_histogram_events against its twin on the card, exact
               integer equality, on flat events in the order the walker
               emitted them: one region of phase 9's scene (its real events
               from the Python walker), the event flow's 8-region dispatch
               (the scene's 6 regions and its first 2 again), that
               dispatch's events 4 times over (~20 M, the depth of ~120x),
               a skewed dispatch with one 256-row tile at 10x the mean, and
               the dispatch sorted by row; the slab wrapper
               pileup_histogram on the region's binned slabs; and
               accumulate_cuda against accumulate_torch on
               tests/test_pileup_kernel.py's cases and on no events (no
               launch); per launch, queued behind a device sleep (unqueued
               beside them), the kernel, the twin and the library call (one
               index_add_ into a zeroed image), the bound, the host time of
               the flat int32 events beside that of the TPU layout's
               binning (which no path runs any more), the bytes of each
               layout and the flat events' pinned host-to-device copy
 14 device_flows
               on phase 9's scene, bfloat16 and float32: (a)
               classify_regions_images at --device_region_batch 32 against
               the host windows through transducer_infer, launching no
               histogram; (b) classify_regions_events over the 8-region
               dispatch against the same flow on the twins and against (a),
               one histogram and 4 lstm_direction_fused launches a
               dispatch, with its host half (pack_events), the bytes it
               uploads and a whole call's wall time; (c) the summarizer's
               Python walker with accumulate_cuda as its RegionalSummary
               matrix backend:
               windows equal to the in-place walker's and the native
               pass's, byte for byte, one launch a region; windows/s of
               each flow's device half and the events per window (phases
               13 and 14 run right after phase 9, on its scene)
 15 kernel_hp  rows 1-4 at the HP classifier's shapes (T=21, encoder F=48,
               decoder 2x256, H=256), B=4096 and 37, both directions:
               lstm_direction_fused, bilstm_dual_fused (equal to two single
               launches) and lstm_recurrence against their twins in float32
               (atol 1e-5) and bfloat16 (2e-2); lstm_direction_fused_static
               in static and static_rec, bfloat16 and float32, codes within
               1 and phase 5's equal shares (every served combination on
               lstm_core.cuh, the encoder's 48 features projected first;
               a trace, in a process of its own, of each static encoder's
               kernels in both dtypes);
               per-launch times at B=4096 in bfloat16 queued beside the
               bound, the twin and cuDNN's torch.nn.LSTM, with the route
               (fused, or projection first) and the launch plan, the static
               launches in both dtypes as phase 5 times them (projection
               and recurrence apart); models/rnn.py's bilstm on
               the card
               (bilstm_pallas, two lstm_recurrence launches) over each HP
               layer against the twin path at the same bars
 16 transducer_hp
               4096 HP windows through transducer_infer on the fused
               and dual routes in float32 and bfloat16, and through
               the static, static_rec and dynamic int8 modes (static and
               static_rec in float32 too), against the
               twin path on the card at phase 4's and 8's bars; each route's
               own kernel launched, 4 (2 for dual) a batch; windows/s
 17 call_hp    phase 9's HP case: call_variant --use_hp_info on an HP-tagged
               20 kb scene (reads tagged HP 1 or 2, every seventh
               untagged) in phase 9's host-flow modes, each cuda run against
               its cpu run as phase 9 holds them, except that the dynamic
               int8 run may flip a genotype where the cpu run's top two
               probabilities lie within HP_DYNAMIC_TIE_BAR; the int8 modes
               again on the twin path on the card, held the same way (the
               witness that the card's plain arithmetic flips such sites
               too, printed with every flip's margins); on phase 9's scene,
               --model_type no_cnn and transformer (from the checkpoint's
               metadata) cuda against cpu in float32, no_cnn launching no
               kernel and the transformer the attention kernel alone,
               and a reference .pkl of phase 9's weights, whose call set on
               cuda must equal the .npz run's
 18 hp_votes   the legacy HP sliding predictor: 128 image pairs of 1000
               columns through predict_hp on the polish GRU's widths, the
               fused route (row 5) and PEPPER_GRU_FUSED=0
               PEPPER_GRU_KERNEL=1 (row 7), each 76 launches a haplotype
               batch, every x10000 vote within 1 of the twin path's on the
               card and at least 99.9% equal, labels equal where the twin's
               top-two margin exceeds 50; pairs/s, and the route's kernel
               time a pair batch beside the bound, the twin and cuDNN
 19 multi_device
               the data-parallel paths over every local GPU (cuda:0 twice
               where there is one, so that the split, the per-device trees
               and the gather run with the kernels on the card), each
               against one device with its kernel launches counted around
               the run alone: InferenceRunner at B=4096 on the full-width
               33x26 transducer in bfloat16, float32, static, static_rec
               and dynamic at phase 4's and phase 8's bars; call_variant on
               phase 9's scene in phase 9's cuda bfloat16 run, through the
               CLI's --num_devices -1 and the library over the list (the
               same call set, up to the ALT order within a site);
               consensus_predict at B=128 and predict_hp on 128 pairs
               (labels, phred and votes equal); polish on phase 12's scene
               through --num_devices -1 and the library (the one-device
               FASTA bytes); windows/s, chunks/s and pairs/s of each beside
               one device's; call_variant's 1-deep dispatch/resolve loop
               over 8 distinct batches of 4096 on cuda and over the list,
               bfloat16 and float32, bitwise predict_images' probabilities
               when resolved and read again after the loop, with the share
               of resolves that found their batch done and the pinned
               blocks created after its first two batches.  Where h5py is
               installed, also the staged variant and polish flows and a
               two-process gloo --sharded run on cuda:0 against their
               one-process runs; where it is not, one {"phase": "staged",
               "skipped": ...} line first
 20 train      variant-side training at full width (H=256, linear 512):
               train steps/s and windows/s at B=128 and 4096 with the
               forward/backward/optimizer split, and the eval's windows/s
               (first, the host idle); three float64 Adam steps (lr 1e-4,
               weight decay 1e-4, dropout 0) of the 26x33 and HP 48x21
               transducers, no_cnn and the transformer on one seeded
               batch of 1024 windows on cuda against the same steps on
               the CPU (in two processes of their own while the card
               works; loss rtol 1e-5, each gradient leaf within 2e-4 of
               its largest magnitude, params atol 1e-5), launching no
               kernel (and, measured only, each leaf's gradient
               difference of one float32 step of the 26x33 transducer:
               a last bit that moves a SELU pre-activation across 0, where
               its slope jumps, and Adam's +-lr near g = 0 keep float32
               from those bars); train_on_arrays on the labeled windows
               of a 40 kb genome (tests/test_trained_e2e.py's recipe: 150
               SNPs, 250 noise sites, lr 3e-4, batch 32, holdout 0.15, 30
               epochs) to >= 90% held out, its eval through row 1 (4
               launches a batch) and no other kernel; call_variant with the
               best checkpoint on an unseen 6 kb genome (cuda bfloat16 and
               float32 against cpu float32, every variant recovered, no
               false positive); test_model's arrays entry on cuda against
               cpu; two gloo processes on cuda:0 against one process over
               [cuda:0, cuda:0] (params within 2e-4, rank 1 writes
               nothing)
 21 polish_train  polish-side training at full width (F=10, H=128, 5
               classes): TBPTT steps/s and chunks/s at B=16 and 128 with
               one window's forward/backward/Adam split and its device
               launches, and the eval's chunks/s through row 5 (4
               launches a batch; first, the host idle); row 5 at T=1000
               (the eval's whole chunk) against its twin at B=16 and 128
               (atol 1e-5); one float64 TBPTT step (19 window updates, lr
               1e-4, weight decay 1e-4) of 16 chunks on cuda against the
               same step on the CPU (in a process of its own while the
               card works; each window's loss rtol 1e-5, each gradient
               leaf within 2e-4 of its largest magnitude, params atol
               1e-5), launching no kernel (one float32 step's gradient
               differences measured only); train_polish_on_arrays on the
               labelled chunks of a 14 kb draft with a truth read
               (tests/test_polish_train_e2e.py's recipe: lr 1e-3, batch
               8, holdout 0.15, 6 epochs), its evals through row 5 and no
               other kernel; polish on an unseen 6 kb draft with the
               final .npz, float32 and --quantized on cuda against cpu
               (phase 12's rules, 76 launches of row 5 or row 6 a
               consensus batch), >= 0.995 identity to the truth and above
               the draft's; test_polish_on_arrays on cuda against cpu
               (loss rtol 1e-5, the confusion equal but at positions whose
               cpu top-two logits lie within 1e-4, counted); two gloo
               processes on cuda:0 against one process over [cuda:0,
               cuda:0] (params within 2e-4, rank 1 writes nothing)
 22 measure    the measurement half, through the port's own scripts: the
               bench (pepper_tpu_torch.bench) in its three modes at full
               width and B=4096, each JSON line printed, each marginal
               rate within 0.75-1.33x of 4096 over one event-timed batch
               of the same forward (the loop stays queued), 4 launches a
               batch of the mode's kernel (rows 2, 1, 4); utils.profiling's
               trace() around one bfloat16 call_variant on phase 9's scene
               (one worker, in a process of its own: PERF.md section 7),
               whose trace parses and holds as many events of row 1's
               recurrence core (ptxas's entry names) as the call's
               launches, with the call's StageTimer line in the JAX
               package's format on stderr; bench_pipeline's main stages
               (1 Mb) and one-core window generation (1 Mb, ONT errors)
               with the host's CPU (lscpu); a reduced acceptance run
               (examples/acceptance_run.run: train 0.2 Mb, call 0.5 Mb,
               uniform errors, 12 epochs) on cuda held to
               ACCEPTANCE_BARS per variant type
 23 tfm        the transformer window classifier at its published widths
               through InferenceRunner at B=4096, bfloat16 and float32, on
               cuda and over multi_devices(), with the benchmark cell's
               pyramid scale (the probabilities follow the window): the
               attention kernel's route (6 launches a block's batch)
               against the twin route (twin_path), the root mean square of
               the probabilities' gap within TFM_RMS_BARS and a route with
               two heads swapped beyond them, windows/s of each; the
               kernel alone at B=4096 against its twin (float32 1e-5, the
               bfloat16 output within 2e-2 of the twin's float32 math and of
               the bfloat16 twin), its time queued beside the bound, the
               twin's (the eager attention it replaces) and
               scaled_dot_product_attention's (the library column), which
               of SDPA's backends take heads of width 13; one bfloat16
               batch's costliest kernels and one encoder layer's parts
               timed apart

Then the kernel summary line (rows 1-4 with their HP figures, rows 1-4
with their float32 figures, row 1 with the training eval's
launches, rows 5 and 7 with their hp_votes_scan
figures, rows 5 and 6 with phase 21's launches, rows 1, 2 and 4 with
phase 22's), the nvidia-smi line and, last, the
result line; the `done` line gives each phase's wall seconds.  `--phases
6,13` runs phases 1 and 2 and the listed ones only, and prints neither the
summary nor the result line.  `--static_float32_times DIR` times row 2's
float32 static launches and batches, its bfloat16 static launches and its
float epilogue through the public entry points of DIR's package (any
checkout; static_float32_times) and prints one line.
Any failed check
raises, and the script exits non-zero without the result line; so it
does without a CUDA device or outside a checkout.
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
PEAK_TF32_FLOPS = 495e12       # H100 SXM dense TF32 tensor-core peak
PEAK_INT8_OPS = 1979e12        # H100 SXM dense int8 tensor-core peak
PEAK_BYTES = 3.35e12           # H100 SXM HBM3
KERNEL_BARS = {"float32": 1e-5, "bfloat16": 2e-2}
TRANSDUCER_BARS = {"float32": 2e-4, "bfloat16": 1e-2}
# int8 codes: the share equal to the twin's, by mode (an int8 recurrence
# feeds its codes back, so a code that rounds the other way spreads)
CODE_BARS = {"static": 0.999, "static_rec": 0.995}
QUANTIZED_BARS = {"static": 5e-3, "static_rec": 1e-2, "dynamic": 1e-2}
# every (x, W_hh) dtype pair lstm_direction_fused_static takes (as
# tests/test_torch_lstm.py lists them): float x with a W_hh of its dtype or
# int8, int8 x with a float32, bfloat16 or int8 W_hh
STATIC_PAIRS = (("float32", "float32"), ("float32", "int8"),
                ("bfloat16", "bfloat16"), ("bfloat16", "int8"),
                ("int8", "float32"), ("int8", "bfloat16"), ("int8", "int8"))


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


def cuda_ms(fn, iters=10, warmup=2, queued=False) -> float:
    """Mean device time of fn() over iters runs, by CUDA events.  With
    `queued`, the runs are enqueued behind a device sleep of ~10 ms, longer
    than a busy host takes to enqueue them, so that launches shorter than
    the host's launch overhead run back to back and their device time, not
    the host's launch rate, is what is timed."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------- phase 2


def phase_build():
    from pepper_tpu_torch.io import native
    from pepper_tpu_torch.ops import cuda_build

    times, errors = {}, {}

    def run(name, fn):
        t0 = time.time()
        try:
            fn()
        except BaseException as exc:  # re-raised below, in this thread
            errors[name] = exc
        times[name] = round(time.time() - t0, 3)

    jobs = [("native", native.build_native)] + [
        (name, lambda name=name: cuda_build.build_kernel(name=name))
        for name in cuda_build.KERNELS]
    threads = [threading.Thread(target=run, args=job) for job in jobs]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join()
    for exc in errors.values():
        raise exc
    ptxas = {name: [line.strip() for line in
                    cuda_build.ptxas_report(name=name).splitlines()
                    if "registers" in line or "spill" in line]
             for name in cuda_build.KERNELS}
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


def launch_work(shape, B, itemsize, steps=T, features=26):
    """Operations and bytes one launch must do: 2*T*B*(F+H)*4H, and x in,
    weights in, h out, each once (T steps, an encoder of `features`)."""
    F = features if shape == "encoder" else 2 * H
    flops = 2 * steps * B * (F + H) * 4 * H
    nbytes = itemsize * (steps * B * F + (F + H + 1) * 4 * H
                         + steps * B * H)
    return flops, nbytes


def split_work(B, features=2 * H, itemsize=2):
    """The two launches alone of a layer projected first (the bfloat16
    decoder; float32 at both widths), (operations, bytes) each: the
    projection reads x, W_ih and b and writes the float32 xw; the
    recurrence reads xw and W_hh and writes h."""
    F, G = features, 4 * H
    projection = (2 * T * B * F * G, itemsize * (T * B * F + F * G + G)
                  + 4 * T * B * G)
    recurrence = (2 * T * B * H * G, 4 * T * B * G + itemsize * H * G
                  + itemsize * T * B * H)
    return projection, recurrence


def bound_ms(flops, nbytes, peak_flops):
    return max(flops / peak_flops, nbytes / PEAK_BYTES) * 1e3


def float32_bounds(flops, nbytes):
    """A float32 launch's two bounds: its operations at the float32 FMA
    peak, and as three TF32 products each (3xTF32, the kernels' products)
    on the TF32 tensor cores; each against its bytes, and which binds."""
    tensor = bound_ms(3 * flops, nbytes, PEAK_TF32_FLOPS)
    return {"bound_ms": tensor,
            "bound_by": ("bytes" if nbytes / PEAK_BYTES
                         > 3 * flops / PEAK_TF32_FLOPS else "operations"),
            "bound_ms_f32_fma": bound_ms(flops, nbytes, PEAK_F32_FLOPS),
            "bound_note": "bound_ms: 3xTF32 (3 products an operation) at "
                          "495 TFLOP/s; bound_ms_f32_fma: float32 FMAs at "
                          "67 TFLOP/s"}


def device_ms(fn, iters=10):
    """cuda_ms of launches queued behind a device sleep: the bfloat16 LSTM
    launches are short enough for the host's launch rate to show."""
    return cuda_ms(fn, iters=iters, queued=True)


def cudnn_ms(lstm, x, queued=False):
    """Time of one torch.nn.LSTM call (cuDNN), the library yardstick that
    the port never uses; in float32 with TF32 off (main sets
    torch.backends.cudnn.allow_tf32 = False: cuDNN's default is TF32)."""
    import torch

    check(x.dtype != torch.float32 or not torch.backends.cudnn.allow_tf32,
          "cuDNN float32 would be timed with TF32 products")
    with torch.no_grad():
        return cuda_ms(lambda: lstm(x), queued=queued)


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


# phase 3's and 7's batches: the serving batch and the others of the
# bfloat16 core's rows-a-cluster plan (16 rows at 37, 128 and 512, 128 at
# 4096), and the batches phase 3 times
LSTM_CHECKED_BATCHES = (B_SERVE, 37, 128, 512)
LSTM_TIMED_BATCHES = (32, 128, 512, B_SERVE)


def decoder_launches(device, name, xs, weights, biases, w_hhs, B,
                     dtype_name="bfloat16"):
    """The two launches of a layer whose input is projected first (the
    bfloat16 decoder; float32 at both widths) through the library's entries
    (<name>_projection, <name>_recurrence) for one direction (the forward
    one with `reverse`=0 after it) or, for bilstm_dual_fused, both:
    (project, recur, outs)."""
    import torch
    from pepper_tpu_torch.ops import cuda_build

    code = {"float32": 0, "bfloat16": 1}[dtype_name]
    dual = name == "bilstm_dual_fused"
    xws = [torch.empty((T, B, 4 * H), device=device)
           for _ in range(2 if dual else 1)]
    outs = [torch.empty((T, B, H), dtype=xs[0].dtype, device=device)
            for _ in xws]

    def two(parts):
        return [t.data_ptr() for t in parts] + [None] * (2 - len(parts))

    features = [x.shape[2] for x in xs] + [0] * (2 - len(xs))

    def project():
        cuda_build.launch(f"{name}_projection", device, code, *two(xs),
                          *(p for parts in weights for p in two(parts)),
                          *features, *(b.data_ptr() for b in biases),
                          *(xw.data_ptr() for xw in xws), T, B, H)

    def recur():
        cuda_build.launch(f"{name}_recurrence", device, code,
                          *(xw.data_ptr() for xw in xws),
                          *(w.data_ptr() for w in w_hhs),
                          *(o.data_ptr() for o in outs), T, B, H,
                          *(() if dual else (0,)))

    return project, recur, outs


def core_plan(device, B, fused, dirs=1, dtype_name="bfloat16"):
    """The LSTM core's launch plan at width H (the bfloat16 core, or the
    float32 one), as its library reports it: rows and CTAs a cluster,
    clusters a direction, and how many clusters the card runs at once."""
    import ctypes

    from pepper_tpu_torch.ops import cuda_build

    out = (ctypes.c_int * 4)()
    cuda_build.launch("lstm_direction_fused_plan", device,
                      {"float32": 0, "bfloat16": 1}[dtype_name], B, H, dirs,
                      int(fused), ctypes.addressof(out))
    return dict(zip(("rows", "cluster_ctas", "clusters", "max_clusters"),
                    out))


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
            for B in LSTM_CHECKED_BATCHES:
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
        # bfloat16 at every timed batch, float32 at the serving batch
        batches = LSTM_TIMED_BATCHES if dtype == torch.bfloat16 else (
            B_SERVE,)
        for B in batches:
            for shape in ("encoder", "decoder"):
                xs, ws, b, w_hh = lstm_inputs(gen, shape, B, dtype, device)
                itemsize = xs[0].element_size()
                flops, nbytes = launch_work(shape, B, itemsize)
                x_cat = torch.cat(xs, dim=-1)
                lstm = cudnn_lstm([(ws, b, w_hh)], dtype, device)
                with torch.no_grad():
                    lib_out, _ = lstm(x_cat)
                out = kernel(xs, ws, b, w_hh)
                lib_diff = (lib_out.float() - out.float()).abs().max().item()
                entry = {
                    "kernel_ms": device_ms(lambda: kernel(xs, ws, b, w_hh)),
                    "cudnn_ms": cudnn_ms(lstm, x_cat, queued=True),
                    "cudnn_max_abs_diff": lib_diff,
                    "bound_ms": bound_ms(flops, nbytes, PEAK_BF16_FLOPS),
                    "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
                }
                if dtype == torch.float32:
                    entry.update(float32_bounds(flops, nbytes),
                                 cudnn_allow_tf32=(
                                     torch.backends.cudnn.allow_tf32))
                if B == B_SERVE:
                    entry["plain_ms"] = device_ms(
                        lambda: twin(xs, ws, b, w_hh), iters=3)
                    # back to back from Python, unqueued
                    entry["kernel_ms_unqueued"] = cuda_ms(
                        lambda: kernel(xs, ws, b, w_hh))
                # float32 projects every width first, bfloat16 the decoder
                projected = dtype == torch.float32 or shape == "decoder"
                if projected:
                    project, recur, (split,) = decoder_launches(
                        device, "lstm_direction_fused", xs, [ws], [b],
                        [w_hh], B, dtype_name)
                    project()
                    recur()
                    torch.cuda.synchronize()
                    check(torch.equal(split, out),
                          f"{dtype_name} {shape} B={B}: projection + "
                          "recurrence differ from the kernel")
                    (p_ops, p_bytes), (r_ops, r_bytes) = split_work(
                        B, x_cat.shape[2], itemsize)
                    if dtype == torch.float32:
                        p_bound = float32_bounds(p_ops, p_bytes)["bound_ms"]
                        r_bound = float32_bounds(r_ops, r_bytes)["bound_ms"]
                    else:
                        p_bound = bound_ms(p_ops, p_bytes, PEAK_BF16_FLOPS)
                        r_bound = bound_ms(r_ops, r_bytes, PEAK_BF16_FLOPS)
                    entry.update(
                        projection_ms=device_ms(project),
                        recurrence_ms=device_ms(recur),
                        projection_bound_ms=p_bound,
                        recurrence_bound_ms=r_bound)
                else:
                    # the encoder's features join the step: one launch, the
                    # recurrence
                    entry.update(projection_ms=0.0,
                                 recurrence_ms=entry["kernel_ms"])
                entry["plan"] = core_plan(device, B, not projected,
                                          dtype_name=dtype_name)
                timings[f"{shape}_{dtype_name}_B{B}"] = entry
    emit({"phase": "kernel", "kernel_names": ["lstm_direction_fused"],
          "card": card, "max_abs_err": max_err,
          "ptxas": {name: ptxas_entries(name)
                    for name in ("lstm_direction_fused",
                                 "bilstm_dual_fused")},
          "per_launch": timings})
    return max_err, timings


# ---------------------------------------------------------------- phase 4


def kernel_modules():
    from pepper_tpu_torch.ops import (attention_kernel, gru_kernel,
                                      lstm_kernel, pileup_kernel)

    return (lstm_kernel, gru_kernel, pileup_kernel, attention_kernel)


def kernel_wrappers():
    """Every kernel wrapper by name: each counts its launches."""
    return {name: getattr(module, name) for module in kernel_modules()
            for name in module.KERNELS}


@contextlib.contextmanager
def twin_path():
    """Run every kernel wrapper as its plain twin, for comparison only."""
    with contextlib.ExitStack() as stack:
        for module in kernel_modules():
            for name in module.KERNELS:
                stack.enter_context(mock.patch.object(
                    module, name, getattr(module, f"{name}_reference")))
        yield


def checked_probs(probs, ref, bar, what):
    """Probabilities of the right shape, finite and summing to 1, within
    `bar` of the twin path's; returns the difference and the argmax
    agreement."""
    import torch

    torch.cuda.synchronize()
    check(probs.shape == ref.shape and probs.dtype == torch.float32,
          f"{what}: probabilities {tuple(probs.shape)} {probs.dtype}")
    check(bool(torch.isfinite(probs).all()), f"{what}: not finite")
    sums = probs.sum(dim=1)
    check(bool(torch.allclose(sums, torch.ones_like(sums), atol=1e-5)),
          f"{what}: probabilities do not sum to 1")
    err = (probs - ref).abs().max().item()
    check(err <= bar, f"{what}: max abs diff {err} from the twin path")
    return err, (probs.argmax(1) == ref.argmax(1)).float().mean().item()


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
        err, agree = checked_probs(probs, ref, TRANSDUCER_BARS[dtype_name],
                                   f"transducer {dtype_name}")
        ms = cuda_ms(lambda: transducer_infer(cast, windows, dtype), iters=5)
        with twin_path():
            twin_ms = cuda_ms(lambda: transducer_infer(cast, windows, dtype),
                              iters=5)
        result[dtype_name] = {
            "max_abs_err": err, "argmax_agree": agree,
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


def static_weights(gen, layer, dtype, rec_int8, device, features=26):
    """One direction's weights in a static int8 mode at the serving widths:
    the encoder's W_ih (features x 4H) in dtype, the decoder's int8 with
    acc_scale (w_scale/127), W_hh in dtype or int8 with rec_scale; a
    float32 bias."""
    import torch

    scale = 1.0 / H ** 0.5

    def u(*size, s=scale):
        return (torch.rand(size, generator=gen, device=device) * 2 - 1) * s

    weights = {"b": u(4 * H, s=2 * scale), "acc_scale": None,
               "rec_scale": None}
    if layer == "encoder":
        weights["w_ih"] = (u(features, 4 * H).to(dtype),)
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


def static_bound_ms(layer, B, dtype, rec_int8, steps=T, features=26,
                    out_item=1):
    """Least time of one static launch: its products at the tensor-core
    peak of their type (int8 for int8 operands, else the float dtype's),
    against the bytes of x in, weights in and h out (int8 codes, or
    out_item bytes a value for the float epilogue)."""
    import torch

    T = steps
    F = features if layer == "encoder" else 2 * H
    float_peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 \
        else PEAK_F32_FLOPS
    item = 2 if dtype == torch.bfloat16 else 4
    proj, rec = 2 * T * B * F * 4 * H, 2 * T * B * H * 4 * H
    seconds = (proj / (float_peak if layer == "encoder" else PEAK_INT8_OPS)
               + rec / (PEAK_INT8_OPS if rec_int8 else float_peak))
    x_item = item if layer == "encoder" else 1
    nbytes = (T * B * F * x_item + F * 4 * H * x_item
              + H * 4 * H * (1 if rec_int8 else item) + 3 * 4 * H * 4
              + T * B * H * out_item)
    return max(seconds, nbytes / PEAK_BYTES) * 1e3


def static_bounds_f32(layer, B, rec_int8, steps=T, features=26,
                      out_item=1):
    """A float32 static launch's two bounds (float32_bounds' names): its
    float products (the encoder's projection, a float32 W_hh's recurrence)
    as three TF32 products each at the TF32 tensor-core peak, or as float32
    FMAs, plus its int8 products (the decoder's projection, an int8 W_hh's
    recurrence) at the int8 peak, against the bytes of x in, weights in and
    h out (int8 codes, or out_item bytes a value for the float
    epilogue)."""
    F = features if layer == "encoder" else 2 * H
    proj, rec = 2 * steps * B * F * 4 * H, 2 * steps * B * H * 4 * H
    floats = ((proj if layer == "encoder" else 0)
              + (0 if rec_int8 else rec))
    int8_s = ((0 if layer == "encoder" else proj)
              + (rec if rec_int8 else 0)) / PEAK_INT8_OPS
    x_item = 4 if layer == "encoder" else 1
    nbytes = (steps * B * F * x_item + F * 4 * H * x_item
              + H * 4 * H * (1 if rec_int8 else 4) + 3 * 4 * H * 4
              + steps * B * H * out_item)
    tensor = 3 * floats / PEAK_TF32_FLOPS + int8_s
    return {"bound_ms": max(tensor, nbytes / PEAK_BYTES) * 1e3,
            "bound_by": ("bytes" if nbytes / PEAK_BYTES > tensor
                         else "operations"),
            "bound_ms_f32_fma": max(floats / PEAK_F32_FLOPS + int8_s,
                                    nbytes / PEAK_BYTES) * 1e3,
            "bound_note": "bound_ms: the float products as 3xTF32 (3 "
                          "products an operation) at 495 TFLOP/s; "
                          "bound_ms_f32_fma: as float32 FMAs at 67 "
                          "TFLOP/s; int8 products at 1979 TOP/s in both"}


# lstm_direction_fused_static's float32 launches at B=4096 as commit
# 97c4798 ran them (float32 x or W_hh on the first, scalar body; the
# static_rec decoder, int8 x and W_hh, already on the core), queued: the
# mean of two runs of `--static_float32_times DIR` on an unpacked 97c4798
# (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md section 6, "float32, row 2")
SCALAR_BODY_FLOAT32_MS = {
    "source": "chip_smoke.py --static_float32_times <97c4798> (PERF.md "
              "section 6)",
    "encoder_static": 2.2783, "decoder_static": 3.3676,
    "encoder_static_rec": 1.6185, "decoder_static_rec": 1.1710,
    "encoder_static_hp": 1.5453, "decoder_static_hp": 2.1192,
    "encoder_static_rec_hp": 1.2103, "decoder_static_rec_hp": 0.7551}


def static_float32_times(device):
    """Row 2's float32 static launches and batches at B=4096 through the
    package's public entry points alone, so that the package of any
    checkout can be timed (`--static_float32_times DIR`; two versions on
    one card in one call: parent, change, change, parent).  At 33x26 and
    the HP 21x48, static and static_rec: each launch queued, its codes
    within 1 of the twin's, and one transducer_infer_static batch (4
    launches); beside them the same launches in bfloat16, and the float
    epilogue's launch (out_int8=False: the encoder at 33x26, W_hh and h
    out in float32 and in bfloat16)."""
    import torch
    from pepper_tpu_torch.models import quantize
    from pepper_tpu_torch.models.transducer import init_transducer_params
    from pepper_tpu_torch.ops import lstm_kernel

    kernel = lstm_kernel.lstm_direction_fused_static
    twin = lstm_kernel.lstm_direction_fused_static_reference
    gen = torch.Generator(device=device).manual_seed(1515)

    def run(fn, xs, w, reverse=False):
        return fn(xs, w["w_ih"], w["b"], w["w_hh"], acc_scale=w["acc_scale"],
                  rec_scale=w["rec_scale"], reverse=reverse, out_int8=True)

    shapes = {"33x26": (T, 26, init_transducer_params(
        torch.Generator().manual_seed(7))), "21x48": (HP_T, HP_F, hp_params())}
    per_launch, batches, epilogue = {}, {}, {}
    for shape, (steps, features, params) in shapes.items():
        host = {name: {k: v.numpy() for k, v in group.items()}
                for name, group in params.items()}
        windows = torch.randint(-125, 126, (B_SERVE, steps, features),
                                generator=gen, device=device).to(torch.int8)
        for mode, dtype in ((mode, dtype) for mode in ("static",
                                                       "static_rec")
                            for dtype in (torch.float32, torch.bfloat16)):
            rec_int8 = mode == "static_rec"
            suffix = "" if dtype == torch.float32 else "_bfloat16"
            x = torch.randint(-125, 126, (steps, B_SERVE, features),
                              generator=gen, device=device).to(dtype)
            enc = static_weights(gen, "encoder", dtype, rec_int8, device,
                                 features)
            streams = (run(kernel, (x,), enc), run(kernel, (x,), enc, True))
            dec = static_weights(gen, "decoder", dtype, rec_int8, device)
            for layer, xs, w in (("encoder", (x,), enc),
                                 ("decoder", streams, dec)):
                diff = (run(kernel, xs, w).int()
                        - run(twin, xs, w).int()).abs()
                check(diff.max().item() <= 1, f"{layer} {mode} {shape}"
                      f"{suffix}: codes differ by {diff.max().item()}")
                per_launch[f"{layer}_{mode}_{shape}{suffix}"] = {
                    "ms": device_ms(lambda: run(kernel, xs, w)),
                    "equal_share": (diff == 0).float().mean().item()}
            if dtype != torch.float32:
                continue
            tree = quantize.prepare_static(
                quantize.quantize_params_static(host, rec_int8=rec_int8),
                torch.float32, device)

            def forward():
                return quantize.transducer_infer_static(tree, windows,
                                                        torch.float32)

            kernel.launches = 0
            check(bool(torch.isfinite(forward()).all())
                  and kernel.launches == 4,
                  f"{mode} {shape}: {kernel.launches} launches a batch, "
                  "not 4, or probabilities that are not finite")
            batches[f"{mode}_{shape}"] = cuda_ms(forward, iters=5)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randint(-125, 126, (T, B_SERVE, 26), generator=gen,
                          device=device).to(dtype)
        w = static_weights(gen, "encoder", dtype, False, device)

        def float_out(fn):
            return fn((x,), w["w_ih"], w["b"], w["w_hh"], out_dtype=dtype)

        err = (float_out(kernel).float() - float_out(twin).float()).abs()
        check(err.max().item() <= KERNEL_BARS[str(dtype).split(".")[1]],
              f"float epilogue {dtype}: {err.max().item()} from the twin")
        epilogue[str(dtype).split(".")[1]] = {
            "ms": device_ms(lambda: float_out(kernel)),
            "max_abs_err": err.max().item()}
    return {"B": B_SERVE, "per_launch": per_launch, "batch_ms": batches,
            "float_epilogue_33x26": epilogue}


def static_launch_times(device, kernel, twin, gen, dtype, steps=T,
                        features=26):
    """Per-launch figures of the static and static_rec modes at B=4096 in
    dtype (encoder of `features`, then the decoder over its codes), queued
    beside the bound and the twin, with the route, the core's plan for the
    recurrence and, where x is projected first, the projection and the
    recurrence apart through the library's entries."""
    import torch
    from pepper_tpu_torch.ops import lstm_kernel

    def run(fn, xs, w, reverse=False):
        return fn(xs, w["w_ih"], w["b"], w["w_hh"], acc_scale=w["acc_scale"],
                  rec_scale=w["rec_scale"], reverse=reverse, out_int8=True)

    timings = {}
    for mode in ("static", "static_rec"):
        rec_int8 = mode == "static_rec"
        x = torch.randint(-125, 126, (steps, B_SERVE, features),
                          generator=gen, device=device).to(dtype)
        enc = static_weights(gen, "encoder", dtype, rec_int8, device,
                             features)
        streams = (run(kernel, (x,), enc), run(kernel, (x,), enc, True))
        dec = static_weights(gen, "decoder", dtype, rec_int8, device)
        for layer, xs, w in (("encoder", (x,), enc),
                             ("decoder", streams, dec)):
            joins = lstm_kernel.static_x_joins(
                xs[0].dtype, tuple(part.shape[2] for part in xs))
            entry = {
                "kernel_ms": device_ms(lambda: run(kernel, xs, w)),
                "kernel_ms_unqueued": cuda_ms(lambda: run(kernel, xs, w)),
                "plain_ms": cuda_ms(lambda: run(twin, xs, w), iters=5),
                "route": ("lstm_core.cuh, x joins each step" if joins
                          else "lstm_core.cuh, projection first into a "
                               "float32 xw"),
                "plan": static_plan(device, B_SERVE, joins,
                                    w["w_hh"].dtype)}
            if dtype == torch.float32:
                entry.update(static_bounds_f32(layer, B_SERVE, rec_int8,
                                               steps, features))
                hp = "_hp" if features != 26 else ""
                entry["scalar_body_ms"] = SCALAR_BODY_FLOAT32_MS[
                    f"{layer}_{mode}{hp}"]
                entry["scalar_body_source"] = SCALAR_BODY_FLOAT32_MS["source"]
            else:
                entry["bound_ms"] = static_bound_ms(
                    layer, B_SERVE, dtype, rec_int8, steps, features)
            if joins:
                # the encoder's features join the step: one launch
                entry.update(projection_ms=0.0,
                             recurrence_ms=entry["kernel_ms"])
            else:
                entry.update(static_split(device, xs, w, B_SERVE,
                                          run(kernel, xs, w), steps))
            timings[f"{layer}_{mode}"] = entry
    return timings


def phase_kernel_static(device, card):
    import torch
    from pepper_tpu_torch.ops import lstm_kernel

    kernel = lstm_kernel.lstm_direction_fused_static
    twin = lstm_kernel.lstm_direction_fused_static_reference
    gen = torch.Generator(device=device).manual_seed(4321)

    def run(fn, xs, w, reverse=False, **kw):
        return fn(xs, w["w_ih"], w["b"], w["w_hh"], acc_scale=w["acc_scale"],
                  rec_scale=w["rec_scale"], reverse=reverse, **kw)

    codes, max_code_diff = {}, 0
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
    float_err = static_float_epilogue(device, kernel, twin, gen)

    timings = {}
    for dtype_name, dtype in (("bfloat16", torch.bfloat16),
                              ("float32", torch.float32)):
        for key, entry in static_launch_times(device, kernel, twin, gen,
                                              dtype).items():
            timings[f"{key}_{dtype_name}"] = entry
    for dtype_name, dtype in (("bfloat16", torch.bfloat16),
                              ("float32", torch.float32)):
        timings[f"float_epilogue_{dtype_name}"] = float_epilogue_times(
            device, kernel, twin, gen, dtype)
    # row 1's bfloat16 kernel at the same shapes, in the same run
    dtype = torch.bfloat16
    for layer in ("encoder", "decoder"):
        xs, ws, b, w_hh = lstm_inputs(gen, layer, B_SERVE, dtype, device)
        timings[f"{layer}_float_bfloat16"] = {"kernel_ms": device_ms(
            lambda: lstm_kernel.lstm_direction_fused(xs, ws, b, w_hh))}
    emit({"phase": "kernel_static",
          "kernel_names": ["lstm_direction_fused_static"], "card": card,
          "max_code_diff": max_code_diff, "equal_share": codes,
          "float_output_max_abs_err": float_err, "B": B_SERVE,
          "ptxas": ptxas_entries("lstm_direction_fused_static"),
          "per_launch": timings})
    return max_code_diff, codes, timings


def static_float_epilogue(device, kernel, twin, gen):
    """The float epilogue (out_int8=False) of every STATIC_PAIRS combination,
    h out in float32 and in bfloat16, against the twin at B=37 (both
    directions) and B=4096 (reversed): float x as the encoder's 26 window
    values, int8 x as the decoder's 2 x 256 codes.  Bar KERNEL_BARS
    ["float32"] where W_hh and out are float32 (float32 or int8 x);
    KERNEL_BARS["bfloat16"] where anything rounds to bfloat16 or an int8
    W_hh feeds its codes back (a code that rounds the other way moves h by
    about 1e-4).  Returns the largest difference of each combination."""
    import torch

    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16,
              "int8": torch.int8}
    errors = {}
    for x_name, whh_name in STATIC_PAIRS:
        x_dtype, whh_dtype = dtypes[x_name], dtypes[whh_name]
        rec_int8 = whh_dtype == torch.int8
        for B, directions in ((37, (False, True)), (B_SERVE, (True,))):
            if x_dtype == torch.int8:
                xs = tuple(torch.randint(-127, 128, (T, B, H), generator=gen,
                                         device=device).to(torch.int8)
                           for _ in range(2))
                w = static_weights(gen, "decoder", torch.float32
                                   if rec_int8 else whh_dtype, rec_int8,
                                   device)
            else:
                xs = (torch.randint(-125, 126, (T, B, 26), generator=gen,
                                    device=device).to(x_dtype),)
                w = static_weights(gen, "encoder", x_dtype, rec_int8, device)
            for out_name in ("float32", "bfloat16"):
                out_dtype = dtypes[out_name]
                bar = KERNEL_BARS["float32" if whh_dtype == out_dtype
                                  == torch.float32 else "bfloat16"]
                key = f"{x_name}_x_{whh_name}_whh_{out_name}_out"
                for reverse in directions:
                    kw = dict(acc_scale=w["acc_scale"],
                              rec_scale=w["rec_scale"], reverse=reverse,
                              out_dtype=out_dtype)
                    out = kernel(xs, w["w_ih"], w["b"], w["w_hh"], **kw)
                    ref = twin(xs, w["w_ih"], w["b"], w["w_hh"], **kw)
                    torch.cuda.synchronize()
                    check(out.shape == (T, B, H) and out.dtype == out_dtype,
                          f"static float output {key}: {tuple(out.shape)} "
                          f"{out.dtype}")
                    err = (out.float() - ref.float()).abs().max().item()
                    check(err <= bar, f"static float output {key} B={B} "
                          f"reverse={reverse}: {err} > {bar}")
                    errors[key] = max(errors.get(key, 0.0), err)
    return errors


def float_epilogue_times(device, kernel, twin, gen, dtype):
    """The float epilogue's launch at the served encoder's shape (33x26,
    B=4096, W_hh and out in dtype), queued, beside its bound (h out in
    dtype instead of codes), the twin and the core's plan."""
    import torch
    from pepper_tpu_torch.ops import lstm_kernel

    x = torch.randint(-125, 126, (T, B_SERVE, 26), generator=gen,
                      device=device).to(dtype)
    w = static_weights(gen, "encoder", dtype, False, device)

    def run(fn):
        return fn((x,), w["w_ih"], w["b"], w["w_hh"], out_dtype=dtype)

    item = torch.empty((), dtype=dtype).element_size()
    joins = lstm_kernel.static_x_joins(dtype, (26,))
    entry = {"kernel_ms": device_ms(lambda: run(kernel)),
             "plain_ms": cuda_ms(lambda: run(twin), iters=3),
             "route": "lstm_core.cuh, x joins each step" if joins else
                      "lstm_core.cuh, projection first into a float32 xw",
             "plan": static_plan(device, B_SERVE, joins, dtype)}
    if dtype == torch.float32:
        entry.update(static_bounds_f32("encoder", B_SERVE, False,
                                       out_item=item))
    else:
        entry["bound_ms"] = static_bound_ms("encoder", B_SERVE, dtype, False,
                                            out_item=item)
        entry["bound_by"] = "operations"
    return entry


def static_plan(device, B, fused, whh_dtype):
    """The LSTM cores' plan for a static launch's recurrence with a W_hh of
    whh_dtype (float32: the float32 core's codes kind), fused or over xw,
    as the static library reports it (launches nothing)."""
    import ctypes

    from pepper_tpu_torch.ops import cuda_build

    out = (ctypes.c_int * 4)()
    cuda_build.launch("lstm_direction_fused_static_plan", device,
                      cuda_build.DTYPE_CODE[whh_dtype], B, H, int(fused),
                      ctypes.addressof(out))
    return dict(zip(("rows", "cluster_ctas", "clusters", "max_clusters"),
                    out))


def static_split(device, xs, w, B, codes, steps=T):
    """A static launch that projects x first, as its two launches through
    the library's entries: the projection into a float32 xw (int8 x: checked
    against the exact int32 product; float x: against b + x @ W_ih within
    float32's rounding) and the core's recurrence over it (its codes must
    equal the kernel's bit for bit), timed apart, with each launch's
    bound: the projection's against the f32 xw it writes, the recurrence's
    xw in and codes out against its products (float32 ones as 3xTF32)."""
    import torch
    from pepper_tpu_torch.ops import cuda_build
    from pepper_tpu_torch.ops.int8_matmul import int8_matmul

    T, G = steps, 4 * H
    F = sum(x.shape[2] for x in xs)
    x_dtype, whh_dtype = xs[0].dtype, w["w_hh"].dtype
    int_x = x_dtype == torch.int8
    w_ih = torch.cat(w["w_ih"])
    if int_x:
        w_ih = cuda_build.int8_kmajor(w_ih)
    w_rec = (cuda_build.int8_kmajor(w["w_hh"]) if whh_dtype == torch.int8
             else w["w_hh"])
    xw = torch.empty((T, B, G), device=device)
    out = torch.empty((T, B, H), dtype=torch.int8, device=device)
    x1 = xs[1] if len(xs) > 1 else None

    def project():
        cuda_build.launch("lstm_direction_fused_static_projection", device,
                          cuda_build.DTYPE_CODE[x_dtype], xs[0].data_ptr(),
                          None if x1 is None else x1.data_ptr(),
                          xs[0].shape[2], 0 if x1 is None else x1.shape[2],
                          w_ih.data_ptr(),
                          w["acc_scale"].data_ptr() if int_x else None,
                          w["b"].data_ptr(), xw.data_ptr(), T, B, H)

    def recur():
        cuda_build.launch("lstm_direction_fused_static_recurrence", device,
                          cuda_build.DTYPE_CODE[whh_dtype], xw.data_ptr(),
                          w_rec.data_ptr(),
                          w["rec_scale"].data_ptr()
                          if whh_dtype == torch.int8 else None,
                          out.data_ptr(), T, B, H, 0)

    project()
    recur()
    if int_x:
        acc = sum(int8_matmul(x.reshape(T * B, -1), part)
                  for x, part in zip(xs, w["w_ih"]))
        expected = w["b"] + acc.float() * w["acc_scale"]
        torch.cuda.synchronize()
        check(torch.equal(xw.reshape(T * B, G), expected),
              "static projection entry: xw differs from the exact product")
    else:
        expected = w["b"] + torch.cat(xs, -1).float() @ torch.cat(
            w["w_ih"]).float()
        torch.cuda.synchronize()
        worst = (xw - expected).abs().max().item()
        check(worst <= 1e-4, f"static {x_dtype} projection entry: xw "
              f"{worst} from b + x @ W_ih")
    check(torch.equal(out, codes),
          "static projection + recurrence differ from the kernel")
    x_item = x_dtype.itemsize
    rec_ops = 2 * T * B * H * G
    proj_ops = 2 * T * B * F * G
    proj_peak = {torch.int8: PEAK_INT8_OPS, torch.bfloat16: PEAK_BF16_FLOPS,
                 torch.float32: PEAK_F32_FLOPS}[x_dtype]
    rec_peak = {torch.int8: PEAK_INT8_OPS, torch.bfloat16: PEAK_BF16_FLOPS,
                torch.float32: PEAK_TF32_FLOPS / 3}[whh_dtype]
    return {
        "projection_ms": device_ms(project),
        "recurrence_ms": device_ms(recur),
        "projection_bound_ms": bound_ms(
            proj_ops, T * B * F * x_item + F * G * x_item + 4 * T * B * G,
            proj_peak),
        "recurrence_bound_ms": bound_ms(
            rec_ops, 4 * T * B * G + H * G * whh_dtype.itemsize + T * B * H,
            rec_peak)}


# ---------------------------------------------------------------- phase 6


def recurrence_plan(device, B, dtype_name="bfloat16"):
    """The core's launch plan as lstm_recurrence runs it (bfloat16 or
    float32): rows and CTAs a cluster, clusters, and how many clusters run
    at once."""
    import ctypes

    from pepper_tpu_torch.ops import cuda_build

    out = (ctypes.c_int * 4)()
    cuda_build.launch("lstm_recurrence_plan", device,
                      {"float32": 0, "bfloat16": 1}[dtype_name], B, H,
                      ctypes.addressof(out))
    return dict(zip(("rows", "cluster_ctas", "clusters", "max_clusters"),
                    out))


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
        for B in LSTM_CHECKED_BATCHES:
            xw, w_hh = inputs(B, dtype)
            for reverse in (False, True):
                out = kernel(xw, w_hh, reverse=reverse)
                ref = twin(xw, w_hh, reverse=reverse)
                torch.cuda.synchronize()
                check(out.shape == (T, B, H) and out.dtype == dtype,
                      f"recurrence output {tuple(out.shape)} {out.dtype}")
                check(bool(torch.isfinite(out.float()).all()),
                      "recurrence output not finite")
                err = (out.float() - ref.float()).abs().max().item()
                check(err <= KERNEL_BARS[dtype_name],
                      f"recurrence {dtype_name} B={B} reverse={reverse}: "
                      f"max abs diff {err}")
                worst = max(worst, err)
        max_err[dtype_name] = worst

    # torch.nn.LSTM(4H, H) with W_ih = I and zero biases computes the
    # recurrence over xw, at the cost of an extra (T*B, 4H) x (4H, 4H)
    # product: checked once against the twin in float32 (no TF32)
    xw, w_hh = inputs(B_SERVE, torch.float32)
    eye = torch.eye(4 * H, device=device)
    lstm = cudnn_lstm([((eye,), torch.zeros(4 * H, device=device), w_hh)],
                      torch.float32, device)
    with torch.no_grad():
        lib_diff = (lstm(xw)[0] - twin(xw, w_hh)).abs().max().item()
    check(lib_diff <= KERNEL_BARS["float32"],
          f"identity-W_ih torch.nn.LSTM: {lib_diff}")
    f32_ms = device_ms(lambda: kernel(xw, w_hh))
    nbytes = 4 * (xw.numel() + w_hh.numel() + T * B_SERVE * H)
    flops = 2 * T * B_SERVE * H * 4 * H
    float32 = {"kernel_ms": f32_ms,
               "kernel_ms_reverse": device_ms(
                   lambda: kernel(xw, w_hh, reverse=True)),
               "kernel_ms_unqueued": cuda_ms(lambda: kernel(xw, w_hh)),
               "plain_ms": cuda_ms(lambda: twin(xw, w_hh), iters=5),
               "cudnn_ms": cudnn_ms(lstm, xw, queued=True),
               "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
               **float32_bounds(flops, nbytes),
               "mbytes": nbytes / 1e6, "gflop": flops / 1e9,
               "plan": recurrence_plan(device, B_SERVE, "float32")}
    xw, w_hh = inputs(B_SERVE, torch.bfloat16)
    lstm = cudnn_lstm([((eye,), torch.zeros(4 * H, device=device), w_hh)],
                      torch.bfloat16, device)
    nbytes = 2 * (xw.numel() + w_hh.numel() + T * B_SERVE * H)
    flops = 2 * T * B_SERVE * H * 4 * H
    # kernel and library queued behind a device sleep; the figures timed
    # back to back from Python beside them
    timing = {"kernel_ms": device_ms(lambda: kernel(xw, w_hh)),
              "kernel_ms_unqueued": cuda_ms(lambda: kernel(xw, w_hh)),
              "kernel_ms_reverse": device_ms(
                  lambda: kernel(xw, w_hh, reverse=True)),
              "plain_ms": cuda_ms(lambda: twin(xw, w_hh), iters=5),
              "cudnn_ms": cudnn_ms(lstm, xw, queued=True),
              "cudnn_ms_unqueued": cudnn_ms(lstm, xw),
              "cudnn_max_abs_diff_f32": lib_diff,
              "bound_ms": bound_ms(flops, nbytes, PEAK_BF16_FLOPS),
              "bound_by": ("bytes" if nbytes / PEAK_BYTES
                           > flops / PEAK_BF16_FLOPS else "operations"),
              "mbytes": nbytes / 1e6, "gflop": flops / 1e9,
              "kernel_ms_float32": f32_ms, "float32": float32}
    for B in (37, 512):
        small = inputs(B, torch.bfloat16)
        timing[f"kernel_ms_B{B}"] = device_ms(lambda: kernel(*small))
    emit({"phase": "kernel_recurrence", "kernel_names": ["lstm_recurrence"],
          "card": card, "max_abs_err": max_err, "B": B_SERVE,
          "plan": {f"B{B}": recurrence_plan(device, B)
                   for B in (37, 512, B_SERVE)},
          # the library's own entries: the float32 core and the core's
          # bfloat16-xw instances (it also builds the fused ones it never
          # launches)
          "ptxas": [e for e in ptxas_entries("lstm_recurrence")
                    if "f32_core_kernel" in e["entry"]
                    or "nv_bfloat16" in e["entry"]],
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
            for B in LSTM_CHECKED_BATCHES:
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
    for dtype_name, dtype in (("bfloat16", torch.bfloat16),
                              ("float32", torch.float32)):
        for shape in ("encoder", "decoder"):
            args = inputs(shape, B_SERVE, dtype)
            xs, wf, wb, b_f, b_b, w_hh_f, w_hh_b = args
            flops, nbytes = launch_work(shape, B_SERVE,
                                        xs[0].element_size())
            x_cat = torch.cat(xs, dim=-1)
            lstm = cudnn_lstm([(wf, b_f, w_hh_f), (wb, b_b, w_hh_b)], dtype,
                              device)
            entry = {
                "kernel_ms": device_ms(lambda: kernel(*args)),
                "two_single_launches_ms": device_ms(lambda: (
                    single(xs, wf, b_f, w_hh_f),
                    single(xs, wb, b_b, w_hh_b, reverse=True))),
                "plain_ms": device_ms(lambda: twin(*args), iters=3),
                "cudnn_bidirectional_ms": cudnn_ms(lstm, x_cat, queued=True),
                "bound_ms": 2 * bound_ms(flops, nbytes, PEAK_BF16_FLOPS),
            }
            if dtype == torch.float32:
                bounds = float32_bounds(2 * flops, 2 * nbytes)
                entry.update(bounds, cudnn_allow_tf32=(
                    torch.backends.cudnn.allow_tf32))
            projected = dtype == torch.float32 or shape == "decoder"
            if projected:
                project, recur, split = decoder_launches(
                    device, "bilstm_dual_fused", xs, [wf, wb], [b_f, b_b],
                    [w_hh_f, w_hh_b], B_SERVE, dtype_name)
                project()
                recur()
                whole = kernel(*args)
                torch.cuda.synchronize()
                check(all(torch.equal(a, b) for a, b in zip(split, whole)),
                      f"dual {dtype_name} {shape}: projection + recurrence "
                      "differ from the kernel")
                entry.update(projection_ms=device_ms(project),
                             recurrence_ms=device_ms(recur))
            else:
                entry.update(projection_ms=0.0,
                             recurrence_ms=entry["kernel_ms"])
            entry["plan"] = core_plan(device, B_SERVE, not projected, 2,
                                      dtype_name)
            timings[f"{shape}_{dtype_name}"] = entry
    emit({"phase": "kernel_dual", "kernel_names": ["bilstm_dual_fused"],
          "card": card, "max_abs_err": max_err,
          "max_abs_diff_from_single_launches": max_vs_single, "B": B_SERVE,
          "per_launch": timings})
    return max_err, timings


# ---------------------------------------------------------------- phase 8


def profile_top(fn, n=10):
    """One run of fn() under torch.profiler: the n PyTorch operations with
    the most device time of their own, the n kernels (and copies) with the
    most device time, each as name, count and total ms, and the device
    time of every kernel of the run in all."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()

    def self_ms(event):
        return getattr(event, "self_device_time_total",
                       getattr(event, "self_cuda_time_total", 0.0)) / 1e3

    def top(events):
        events = sorted((e for e in events if self_ms(e) > 0), key=self_ms,
                        reverse=True)
        return [{"name": e.key[:160], "count": e.count,
                 "total_ms": self_ms(e)} for e in events[:n]]

    averages = prof.key_averages()
    kernels = [e for e in averages if e.device_type == DeviceType.CUDA]
    return {"device_ms": sum(self_ms(e) for e in kernels),
            "ops": top(e for e in averages
                       if e.device_type != DeviceType.CUDA),
            "kernels": top(kernels)}


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
    # (the result's key, the mode, the compute dtype): the dynamic mode's
    # recurrences run in bfloat16 whatever the runner's dtype
    for key, mode, dtype in (
            ("static", "static", torch.bfloat16),
            ("static_rec", "static_rec", torch.bfloat16),
            ("dynamic", "dynamic", torch.bfloat16),
            ("static_float32", "static", torch.float32),
            ("static_rec_float32", "static_rec", torch.float32)):
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
                dtype, device)
            counter = lstm_kernel.lstm_direction_fused_static

            def forward():
                return quantize.transducer_infer_static(tree, windows, dtype)
        counter.launches = 0
        probs = forward()
        check(counter.launches == 4,
              f"{key}: {counter.launches} kernel launches, not 4")
        with twin_path():
            ref = forward()
        err, agree = checked_probs(probs, ref, QUANTIZED_BARS[mode],
                                   f"transducer {key}")
        ms = cuda_ms(forward, iters=5)
        with twin_path():
            twin_ms = cuda_ms(forward, iters=3, warmup=1)
        result[key] = {
            "max_abs_err": err, "argmax_agree": agree,
            "batch_ms": ms, "windows_per_s": B_SERVE / ms * 1e3,
            "twin_batch_ms": twin_ms,
            "max_abs_diff_from_float": {
                name: (probs - p).abs().max().item()
                for name, p in floats.items()},
        }
        if mode == "dynamic":
            # where the dynamic batch's time goes, one JSON line
            emit({"phase": "transducer_quantized_profile", "mode": mode,
                  "B": B_SERVE, "card": card, **profile_top(forward)})
    emit({"phase": "transducer_quantized", "card": card, "B": B_SERVE,
          "compute_dtype": "bfloat16 (keys without _float32)", **result})
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
                error_rate=0.03, seed=5, hp=False):
    """A reference, two haplotypes with SNPs and indels every ~150 bp, and
    ~30x of reads with substitution errors, written with the port's own
    BAM/FASTA writers.  With `hp`, each read carries its haplotype's HP tag
    (1 or 2) as a haplotagger writes it, but every seventh is left
    untagged (HP 0, which counts into both haplotype blocks)."""
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
                flag=0x10 if n % 2 else 0,
                hp=(0 if n % 7 == 6 else hap_index + 1) if hp else None))
    records.sort(key=lambda r: r.pos)
    stem = "scene_hp" if hp else "scene"
    bam, fasta = (os.path.join(directory, f"{stem}.bam"),
                  os.path.join(directory, f"{stem}.fa"))
    write_bam(bam, [("chr1", length)], records)
    write_fasta(fasta, {"chr1": ref})
    return bam, fasta, len(hap1)


def write_hp_scene(directory):
    """Phase 17's HP-tagged scene: write_scene's, 20 kb (the CPU's int8
    runs it is held to take ~10 s each at full width)."""
    return write_scene(directory, length=20_000, seed=6, hp=True)


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


# The float32 static runs' region: a third of phase 9's scene (its cpu
# runs, int8 products at full width, take ~8 s where the whole scene's took
# ~25) and the whole of phase 17's HP scene
F32_STATIC_REGION = ("-r", "chr1:1-20000")

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
    ("cuda_dual_float32", "cuda", "float32", (), True,
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
    # the float32 static modes: what --sharded and the staged
    # run_inference serve with --quantized, and --compute_dtype float32;
    # on the scene's first 20 kb (F32_STATIC_REGION)
    ("cuda_static_float32", "cuda", "float32",
     ("--quantized", *F32_STATIC_REGION), False,
     "lstm_direction_fused_static", 4, "cpu_static_float32"),
    ("cpu_static_float32", "cpu", "float32",
     ("--quantized", *F32_STATIC_REGION), False, None, 0, None),
    ("cuda_static_rec_float32", "cuda", "float32",
     ("--quantized", "--quantize_mode", "static_rec", *F32_STATIC_REGION),
     False, "lstm_direction_fused_static", 4, "cpu_static_rec_float32"),
    ("cpu_static_rec_float32", "cpu", "float32",
     ("--quantized", "--quantize_mode", "static_rec", *F32_STATIC_REGION),
     False, None, 0, None),
    ("cuda_dynamic", "cuda", "bfloat16",
     ("--quantized", "--quantize_mode", "dynamic"), False,
     "lstm_recurrence", 4, "cpu_dynamic"),
    ("cpu_dynamic", "cpu", "bfloat16",
     ("--quantized", "--quantize_mode", "dynamic"), False, None, 0, None),
    ("cuda_pileup_bfloat16", "cuda", "bfloat16", ("--device_pileup",), False,
     "lstm_direction_fused", 4, "cpu_pileup_bfloat16"),
    ("cpu_pileup_bfloat16", "cpu", "bfloat16", ("--device_pileup",), False,
     None, 0, None),
    ("cuda_pileup_float32", "cuda", "float32", ("--device_pileup",), False,
     "lstm_direction_fused", 4, "cpu_pileup_float32"),
    ("cpu_pileup_float32", "cpu", "float32", ("--device_pileup",), False,
     None, 0, None),
)


def call_params():
    """The seeded full-width transducer of phases 9 and 14."""
    import torch
    from pepper_tpu_torch.models.transducer import init_transducer_params

    return init_transducer_params(torch.Generator().manual_seed(11))


def save_model(path, params, model_type="lstm"):
    """A seeded tree of tensors as the CLI's .npz checkpoint."""
    from pepper_tpu_torch.models.checkpoint import save_params

    def host(tree):
        return {k: host(v) if isinstance(v, dict) else v.cpu().numpy()
                for k, v in tree.items()}

    save_params(path, host(params), {"model_type": model_type})
    return path


def run_calls(device, workdir, scene, runs_table, threads=4):
    """call_variant through the CLI on `scene` for each run of
    `runs_table` (CALL_RUNS' layout, with the model path and any more CLI
    arguments of the run last); each kernel's launch count is set to 0
    just before a run and read just after it.  Returns (runs, launches):
    each run's call set and seconds, and its launches by kernel."""
    import torch
    from pepper_tpu_torch.cli import main as cli
    from pepper_tpu_torch.infer.runner import InferenceRunner

    bam, fasta = scene[:2]
    wrappers = kernel_wrappers()
    runs, launches = {}, {}
    resolve = InferenceRunner.resolve
    for name, dev, dtype, extra, dual, _, _, _, model, *more in runs_table:
        out = os.path.join(workdir, name)
        argv = ["call_variant", "-b", bam, "-f", fasta, "-m", model,
                "-o", out, "-t", str(threads), "--region_size", "10000",
                "--ont_r9_guppy5_sup", "--compute_dtype", dtype,
                "--device", str(device) if dev == "cuda" else dev, *extra,
                *more]
        for wrapper in wrappers.values():
            wrapper.launches = 0
        env = {"PEPPER_LSTM_DUAL": "1" if dual else "0"}
        probs = {}

        def recording(runner, handle):
            predictions = resolve(runner, handle)
            probs.update((p.position, p.prediction_base)
                         for p in predictions)
            return predictions

        t0 = time.time()
        with mock.patch.dict(os.environ, env), mock.patch.object(
                InferenceRunner, "resolve", recording):
            check(cli.main(argv) == 0, f"call_variant {name} failed")
        if dev == "cuda":
            torch.cuda.synchronize()
        seconds = time.time() - t0
        launches[name] = {k: w.launches for k, w in wrappers.items()}
        runs[name] = {"seconds": round(seconds, 3), "calls": call_set(out),
                      "probs": probs}
    return runs, launches


def margin(probs, pos):
    """The top-two genotype margin of a run's window at `pos` and at the
    position before it (an indel's anchor), the smaller, or None."""
    margins = [float(np.diff(np.sort(probs[p])[-2:])[0])
               for p in (pos - 1, pos) if p in probs]
    return min(margins) if margins else None


def max_prob_diff(probs, ref):
    """The largest difference of a run's window probabilities from the
    reference run's, over the windows both classified."""
    return max((float(np.abs(np.asarray(probs[p], np.float64)
                             - np.asarray(ref[p], np.float64)).max())
                for p in probs.keys() & ref.keys()), default=0.0)


def genotype_flips(calls, expected, probs, bar):
    """The sites where `calls` and `expected` (canonical_calls sets) hold
    one call each with the same REF and ALT alleles and differ in the
    genotype alone, and where the reference run's window (at the VCF
    position or the one before it, the anchor of an indel) has its top two
    genotype probabilities within `bar`.  Returns (those sites with their
    margins, every other differing call: a site that appears, vanishes or
    changes its alleles, or a flip without such a tie)."""
    by_site = {}
    for call in calls ^ expected:
        by_site.setdefault(call[0], []).append(call)
    tied, untied = {}, []
    for pos, differing in by_site.items():
        ours = [c for c in differing if c in calls]
        theirs = [c for c in differing if c in expected]
        tie = margin(probs, pos)
        flip = (len(ours) == len(theirs) == 1
                and ours[0][:3] == theirs[0][:3])
        if flip and tie is not None and tie <= bar:
            tied[pos] = tie
        else:
            untied.extend(differing)
    return tied, untied


def check_calls(runs, launches, runs_table, tie_bars=None):
    """Each cuda run of `runs_table` against its reference run: the same
    call set (bfloat16 and int8 runs up to the ALT order within a site;
    the count of such sites is returned), its own kernel launched a
    positive multiple of its launches per batch (none where it names no
    kernel), and no other kernel; cpu runs launch nothing.  A run named in
    `tie_bars` may differ in addition by genotype flips at sites whose
    reference window's top two genotype probabilities lie within the run's
    bar (genotype_flips).  Returns (the ALT-order counts, each such run's
    flipped sites with their margins)."""
    alt_order_only, tied_sites = {}, {}
    for name, dev, dtype, extra, _, kernel, per_batch, reference, \
            *_ in runs_table:
        counts = launches[name]
        if dev == "cpu" or kernel is None:
            check(not any(counts.values()), f"{name} launched {counts}")
        if dev == "cpu":
            continue
        calls, expected = runs[name]["calls"], runs[reference]["calls"]
        if name in (tie_bars or {}):
            tied, untied = genotype_flips(canonical_calls(calls),
                                          canonical_calls(expected),
                                          runs[reference]["probs"],
                                          tie_bars[name])
            tied_sites[name] = tied
            calls = {c for c in calls if c[0] not in tied}
            expected = {c for c in expected if c[0] not in tied}
            check(not untied, f"{name} calls differ from {reference} "
                  "other than by genotype flips at near ties: "
                  f"{sorted(untied)[:10]}")
        if "--quantized" in extra or dtype == "bfloat16":
            # int8 codes on the card and the CPU differ at the 1e-4 share,
            # and bfloat16 products on the tensor cores, or of windows
            # batched by region, round apart from the float32 and twin
            # paths' at a few ulps, so near-tied candidates of one site may
            # list in either order
            alt_order_only[name] = len(calls - expected)
            calls, expected = canonical_calls(calls), canonical_calls(
                expected)
        check(calls == expected, f"{name} calls differ from {reference}: "
              f"{sorted(calls ^ expected)[:10]}")
        if kernel is None:
            continue
        n = counts[kernel]
        check(n >= per_batch and n % per_batch == 0,
              f"{kernel} launched {n} times in {name}")
        others = {k: v for k, v in counts.items() if k != kernel and v}
        check(not others, f"{name} also launched {others}")
    return alt_order_only, tied_sites


def phase_call(device, workdir, scene, threads=4):
    """call_variant through the CLI on `scene` (write_scene's) in every run
    of CALL_RUNS; returns each cuda run's launches by kernel, read around
    that run alone."""
    n_variants = scene[2]
    model = save_model(os.path.join(workdir, "model.npz"), call_params())
    table = [(*run, model) for run in CALL_RUNS]
    runs, launches = run_calls(device, workdir, scene, table, threads)
    check(len(runs["cpu_float32"]["calls"]) > 0, "no calls on the CPU")
    alt_order_only, _ = check_calls(runs, launches, table)
    # the device-pileup flow calls what the host window flow calls
    host, fused = runs["cuda_float32"]["calls"], runs["cuda_pileup_float32"][
        "calls"]
    check(fused == host, "cuda --device_pileup float32 calls differ from "
          f"the cuda host flow's: {sorted(fused ^ host)[:10]}")
    emit({"phase": "call", "variants_simulated": n_variants,
          "calls": {k: len(v["calls"]) for k, v in runs.items()},
          "alt_order_only_differences": alt_order_only,
          "launches": {k: v for k, v in launches.items()
                       if k.startswith("cuda")},
          "seconds": {k: v["seconds"] for k, v in runs.items()}})
    return launches


# ---------------------------------------------------------------- phase 10

GRU_H = 128
GRU_T = 100
GRU_F = 10
B_POLISH = 128          # the polish CLI's consensus batch
WINDOWS = 19            # 100-column windows sliding by 50 over 1000
LAUNCHES_PER_BATCH = 4 * WINDOWS    # encoder and decoder, both directions
# hT of the static kernel: exact f32 state with a float32 W_hh; with a
# bfloat16 W_hh a rounding of h to bf16 may fall on either side
STATIC_HT_BARS = {"float32": 1e-5, "bfloat16": 2e-2}


# phase 10's batches: the consensus buckets 32, 128 and 512 and the
# serving batch; the widths besides GRU_H checked at B=37
GRU_TIMED_BATCHES = (32, B_POLISH, 512, B_SERVE)
GRU_CHECKED_BATCHES = (B_POLISH, B_SERVE, 37, 32, 512)
STATIC_BATCHES = (B_POLISH, B_SERVE, 37)
GRU_OTHER_WIDTHS = (32, 256)


def gru_inputs(gen, layer, B, x_dtype, device, H=GRU_H, T=GRU_T):
    """One GRU direction at the polish width (or H) over T steps: the
    encoder reads image values (F=10) of 0..40, where the random-weight
    gates are not all saturated, the decoder the encoder's two (-1, 1)
    streams; float32 weights and biases, and a non-zero float32 h0."""
    import torch

    scale = 1.0 / H ** 0.5

    def u(*size, s=scale):
        return (torch.rand(size, generator=gen, device=device) * 2 - 1) * s

    if layer == "encoder":
        xs = (torch.randint(0, 41, (T, B, GRU_F), generator=gen,
                            device=device).float(),)
    else:
        xs = (u(T, B, H, s=1.0), u(T, B, H, s=1.0))
    ws = tuple(u(x.shape[2], 3 * H) for x in xs)
    return (tuple(x.to(x_dtype) for x in xs), ws, u(3 * H), u(H, 3 * H),
            u(3 * H), u(B, H, s=0.9))


def recurrence_inputs(gen, B, dtype, device, H=GRU_H):
    """xw (T, B, 3H) in (-2, 2) and dtype, the encoder's W_hh and b_hh and
    an h0 in (-0.9, 0.9)."""
    import torch

    xw = ((torch.rand((GRU_T, B, 3 * H), generator=gen, device=device)
           * 4 - 2).to(dtype))
    _, _, _, w_hh, b_hh, _ = gru_inputs(gen, "encoder", 1, dtype, device, H)
    h0 = torch.rand((B, H), generator=gen, device=device) * 1.8 - 0.9
    return xw, w_hh, b_hh, h0


def ptxas_entries(name):
    """Each kernel entry of csrc/<name>.cu as ptxas reported it: registers,
    static shared memory and spill bytes (phase 2's build report)."""
    import re

    from pepper_tpu_torch.ops import cuda_build

    entries, entry = [], None
    for line in cuda_build.ptxas_report(name=name).splitlines():
        found = re.search(r"Compiling entry function '(\w+)'", line)
        if found:
            entry = {"entry": found.group(1)}
            entries.append(entry)
        elif entry is not None:
            spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                               r"loads", line)
            if spills:
                entry["spill_stores"] = int(spills.group(1))
                entry["spill_loads"] = int(spills.group(2))
            used = re.search(r"Used (\d+) registers", line)
            if used:
                entry["registers"] = int(used.group(1))
                smem = re.search(r"(\d+) bytes smem", line)
                entry["smem_static"] = int(smem.group(1)) if smem else 0
    return entries


def gru_work(layer, B, x_item, out_item, static=False, rec_item=4):
    """Operations and bytes of one direction launch: 2*T*B*(F+H)*3H
    (projection and recurrence apart), x in, weights, biases and h0 in, h
    out (int8 codes and an f32 hT for the static kernel), each once."""
    F = GRU_F if layer == "encoder" else 2 * GRU_H
    G = 3 * GRU_H
    proj = 2 * GRU_T * B * F * G
    rec = 2 * GRU_T * B * GRU_H * G
    w_item = 1 if static and layer == "decoder" else (
        x_item if static else 4)
    nbytes = (GRU_T * B * F * x_item + F * G * w_item + GRU_H * G * rec_item
              + 4 * G * 4 + B * GRU_H * 4 + GRU_T * B * GRU_H * out_item
              + (B * GRU_H * 4 if static else 0))
    return proj, rec, nbytes


def cudnn_gru(w_ih, b_ih, w_hh, b_hh, device):
    """torch.nn.GRU (cuDNN) holding one direction's weights: its gate
    placement is the kernel's."""
    import torch

    gru = torch.nn.GRU(w_ih.shape[0], GRU_H).to(device)
    with torch.no_grad():
        gru.weight_ih_l0.copy_(w_ih.t())
        gru.weight_hh_l0.copy_(w_hh.t())
        gru.bias_ih_l0.copy_(b_ih)
        gru.bias_hh_l0.copy_(b_hh)
    return gru


def phase_kernel_gru(device, card):
    import torch
    from pepper_tpu_torch.ops import cuda_build, gru_kernel

    gen = torch.Generator(device=device).manual_seed(2468)
    fused = gru_kernel.gru_direction_fused
    fused_twin = gru_kernel.gru_direction_fused_reference
    static = gru_kernel.gru_direction_fused_static
    static_twin = gru_kernel.gru_direction_fused_static_reference
    rec = gru_kernel.gru_recurrence
    rec_twin = gru_kernel.gru_recurrence_reference
    err = {"fused": {}, "recurrence": {}, "static_hT": {}}
    max_code_diff, code_share = 0, {}
    # the twin's float32 outputs at |h| > 0.99, by layer: where the gates
    # saturate, kernel and twin agree whatever their arithmetic
    saturated = {"encoder": [0, 0], "decoder": [0, 0]}

    def worst(a, b):
        return (a.float() - b.float()).abs().max().item()

    def device_ms(fn, iters=10):
        # a launch shorter than the host's call (the encoder's projection
        # alone) would time the host, so this phase times queued
        return cuda_ms(fn, iters=iters, queued=True)

    def check_fused(xs, ws, b_ih, w_hh, b_hh, h0, dtype, bar, label):
        """Both directions against the twin; the largest difference."""
        e_max = 0.0
        H = w_hh.shape[0]
        T, B = xs[0].shape[:2]
        for reverse in (False, True):
            ys, hT = fused(xs, ws, b_ih, w_hh, b_hh, h0.to(dtype),
                           reverse=reverse)
            ref, ref_hT = fused_twin(xs, ws, b_ih, w_hh, b_hh, h0.to(dtype),
                                     reverse=reverse)
            torch.cuda.synchronize()
            check(ys.shape == (T, B, H) and ys.dtype == dtype
                  and bool(torch.isfinite(ys.float()).all()),
                  f"gru_direction_fused output {tuple(ys.shape)} {ys.dtype}")
            e = max(worst(ys, ref), worst(hT, ref_hT))
            check(e <= bar,
                  f"gru_direction_fused {label} reverse={reverse}: {e}")
            e_max = max(e_max, e)
            if dtype == torch.float32 and H == GRU_H:
                layer = "encoder" if len(xs) == 1 else "decoder"
                saturated[layer][0] += (ref.abs() > 0.99).sum().item()
                saturated[layer][1] += ref.numel()
        return e_max

    def check_recurrence(B, dtype, bar, label, H=GRU_H):
        xw, w_hh, b_hh, h0 = recurrence_inputs(gen, B, dtype, device, H)
        out = rec(xw, w_hh, b_hh, h0)
        ref = rec_twin(xw, w_hh, b_hh, h0)
        torch.cuda.synchronize()
        e = worst(out, ref)
        check(out.dtype == dtype and out.shape == (GRU_T, B, H)
              and e <= bar,
              f"gru_recurrence {label}: {e}")
        return e

    for dtype_name, dtype in (("float32", torch.float32),
                              ("bfloat16", torch.bfloat16)):
        bar = KERNEL_BARS[dtype_name]
        e_fused = e_rec = e_ht = 0.0
        tally = [0, 0]
        for B in GRU_CHECKED_BATCHES:
            for layer in ("encoder", "decoder"):
                xs, ws, b_ih, w_hh, b_hh, h0 = gru_inputs(gen, layer, B,
                                                          dtype, device)
                e_fused = max(e_fused, check_fused(
                    xs, ws, b_ih, w_hh, b_hh, h0, dtype, bar,
                    f"{dtype_name} {layer} B={B}"))
                if B not in STATIC_BATCHES:
                    continue
                # the served static combinations of this compute dtype:
                # encoder float x with W_ih and W_hh of its dtype, decoder
                # the encoder's int8 codes with int8 W_ih and W_hh in it
                if layer == "encoder":
                    s_xs, s_ws, acc_scale = xs, tuple(
                        w.to(dtype) for w in ws), None
                else:
                    s_xs = tuple(torch.round(x.float() * 127).to(torch.int8)
                                 for x in xs)
                    q, w_scale = quantize_cols(torch.cat(ws))
                    s_ws = (q[:GRU_H].contiguous(), q[GRU_H:].contiguous())
                    acc_scale = w_scale / 127.0
                for reverse in (False, True):
                    args = (s_xs, s_ws, b_ih, w_hh.to(dtype), b_hh, h0)
                    out, hT = static(*args, acc_scale=acc_scale,
                                     reverse=reverse)
                    ref, ref_hT = static_twin(*args, acc_scale=acc_scale,
                                              reverse=reverse)
                    torch.cuda.synchronize()
                    diff = (out.int() - ref.int()).abs()
                    check(out.dtype == torch.int8 and diff.max().item() <= 1,
                          f"static {dtype_name} {layer} B={B}: codes differ "
                          f"by {diff.max().item()}")
                    max_code_diff = max(max_code_diff, diff.max().item())
                    tally[0] += (diff == 0).sum().item()
                    tally[1] += diff.numel()
                    e = worst(hT, ref_hT)
                    check(e <= STATIC_HT_BARS[dtype_name],
                          f"static {dtype_name} {layer} B={B}: hT {e}")
                    e_ht = max(e_ht, e)
            # the recurrence over xw of the encoder's shape
            e_rec = max(e_rec, check_recurrence(B, dtype, bar,
                                                f"{dtype_name} B={B}"))
        for H in GRU_OTHER_WIDTHS:
            for layer in ("encoder", "decoder"):
                e_fused = max(e_fused, check_fused(
                    *gru_inputs(gen, layer, 37, dtype, device, H), dtype,
                    bar, f"{dtype_name} {layer} H={H} B=37"))
            e_rec = max(e_rec, check_recurrence(
                37, dtype, bar, f"{dtype_name} H={H} B=37", H))
        share = tally[0] / tally[1]
        check(share >= CODE_BARS["static"],
              f"static {dtype_name}: {share} of the codes equal the twin's")
        err["fused"][dtype_name] = e_fused
        err["recurrence"][dtype_name] = e_rec
        err["static_hT"][dtype_name] = e_ht
        code_share[dtype_name] = share

    # per-launch times in float32, the CLI's consensus dtype
    timings = {}
    for B in GRU_TIMED_BATCHES:
        for layer in ("encoder", "decoder"):
            xs, ws, b_ih, w_hh, b_hh, h0 = gru_inputs(gen, layer, B,
                                                      torch.float32, device)
            proj, rec_ops, nbytes = gru_work(layer, B, 4, 4)
            gru = cudnn_gru(torch.cat(ws), b_ih, w_hh, b_hh, device)
            x_cat = torch.cat(xs, dim=-1)
            with torch.no_grad():
                lib_out, _ = gru(x_cat, h0[None])
            lib_diff = worst(lib_out, fused(xs, ws, b_ih, w_hh, b_hh, h0)[0])
            with torch.no_grad():
                lib_ms = device_ms(lambda: gru(x_cat, h0[None]))
            # the kernel's two launches apart: its library's projection
            # entry, then gru_recurrence over the projected float32 xw (the
            # same core as the fused kernel's second launch on float32 x)
            xw = torch.empty((GRU_T, B, 3 * GRU_H), device=device)
            two = len(xs) > 1

            def project():
                cuda_build.launch(
                    "gru_direction_fused_projection", device, 0,
                    xs[0].data_ptr(), xs[1].data_ptr() if two else None,
                    ws[0].data_ptr(), ws[1].data_ptr() if two else None,
                    xs[0].shape[2], xs[1].shape[2] if two else 0,
                    b_ih.data_ptr(), xw.data_ptr(), GRU_T, B, GRU_H)

            project()
            torch.cuda.synchronize()
            exact = (torch.cat(xs, dim=-1).double() @ torch.cat(ws).double()
                     + b_ih.double())
            check(worst(xw, exact) <= 1e-4,
                  f"gru_direction_fused projection {layer} B={B}")
            split = {"projection_ms": device_ms(project),
                     "recurrence_ms": device_ms(
                         lambda: rec(xw, w_hh, b_hh, h0))}
            xw_bytes = 4 * GRU_T * B * 3 * GRU_H
            h_bytes = 4 * GRU_T * B * GRU_H
            timings[f"fused_{layer}_B{B}"] = {
                "kernel_ms": device_ms(lambda: fused(xs, ws, b_ih, w_hh,
                                                     b_hh, h0)),
                **split,
                "plain_ms": device_ms(lambda: fused_twin(
                    xs, ws, b_ih, w_hh, b_hh, h0), iters=3),
                "cudnn_ms": lib_ms, "cudnn_max_abs_diff": lib_diff,
                "bound_ms": bound_ms(proj + rec_ops, nbytes, PEAK_F32_FLOPS),
                # each launch alone: x and W_ih in, xw out; xw, W_hh and
                # h0 in, h out
                "projection_bound_ms": bound_ms(
                    proj, sum(4 * x.numel() for x in (*xs, *ws)) + xw_bytes,
                    PEAK_F32_FLOPS),
                "recurrence_bound_ms": bound_ms(
                    rec_ops, xw_bytes + 4 * (w_hh.numel() + B * GRU_H)
                    + h_bytes, PEAK_F32_FLOPS),
                "gflop": (proj + rec_ops) / 1e9, "mbytes": nbytes / 1e6}
            if layer == "encoder":
                xw, w_hh, b_hh, h0 = recurrence_inputs(gen, B, torch.float32,
                                                       device)
                r_bytes = 4 * (xw.numel() + w_hh.numel() + b_hh.numel()
                               + h0.numel() + GRU_T * B * GRU_H)
                r_ops = 2 * GRU_T * B * GRU_H * 3 * GRU_H
                # torch.nn.GRU with W_ih = I and b_ih = 0 computes the
                # recurrence over xw (exactly in float32 without TF32), at
                # the cost of an extra (T*B, 3H) x (3H, 3H) product
                gru = cudnn_gru(torch.eye(3 * GRU_H, device=device),
                                torch.zeros(3 * GRU_H, device=device), w_hh,
                                b_hh, device)
                with torch.no_grad():
                    lib_out, _ = gru(xw, h0[None])
                    lib_diff = worst(lib_out, rec_twin(xw, w_hh, b_hh, h0))
                    check(lib_diff <= KERNEL_BARS["float32"],
                          f"identity-W_ih torch.nn.GRU B={B}: {lib_diff}")
                    lib_ms = device_ms(lambda: gru(xw, h0[None]))
                timings[f"recurrence_B{B}"] = {
                    "kernel_ms": device_ms(lambda: rec(xw, w_hh, b_hh, h0)),
                    # back to back from Python, as earlier phases time
                    "kernel_ms_unqueued": cuda_ms(
                        lambda: rec(xw, w_hh, b_hh, h0)),
                    "plain_ms": device_ms(
                        lambda: rec_twin(xw, w_hh, b_hh, h0), iters=3),
                    "cudnn_ms": lib_ms, "cudnn_max_abs_diff": lib_diff,
                    "bound_ms": bound_ms(r_ops, r_bytes, PEAK_F32_FLOPS),
                    "bound_by": ("bytes" if r_bytes / PEAK_BYTES
                                 > r_ops / PEAK_F32_FLOPS else "operations")}
            if B not in STATIC_BATCHES:
                continue
            xs, ws, b_ih, w_hh, b_hh, h0 = gru_inputs(gen, layer, B,
                                                      torch.float32, device)
            if layer == "encoder":
                s_xs, s_ws, acc_scale = xs, ws, None
                seconds = (proj + rec_ops) / PEAK_F32_FLOPS
            else:
                s_xs = tuple(torch.round(x * 127).to(torch.int8) for x in xs)
                q, w_scale = quantize_cols(torch.cat(ws))
                s_ws = (q[:GRU_H].contiguous(), q[GRU_H:].contiguous())
                acc_scale = w_scale / 127.0
                seconds = proj / PEAK_INT8_OPS + rec_ops / PEAK_F32_FLOPS
            _, _, s_bytes = gru_work(layer, B, 1 if layer == "decoder"
                                     else 4, 1, static=True)
            args = (s_xs, s_ws, b_ih, w_hh, b_hh, h0)
            timings[f"static_{layer}_B{B}"] = {
                "kernel_ms": device_ms(lambda: static(
                    *args, acc_scale=acc_scale)),
                "plain_ms": device_ms(lambda: static_twin(
                    *args, acc_scale=acc_scale), iters=3),
                "bound_ms": max(seconds, s_bytes / PEAK_BYTES) * 1e3,
                **gru_static_split(device, args, acc_scale,
                                   static(*args, acc_scale=acc_scale),
                                   device_ms)}
    emit({"phase": "kernel_gru", "kernel_names": list(gru_kernel.KERNELS),
          "card": card, "max_abs_err": err, "max_code_diff": max_code_diff,
          "code_equal_share": code_share,
          "saturated_share_float32": {k: n / total for k, (n, total)
                                      in saturated.items()},
          "ptxas": {name: ptxas_entries(name)
                    for name in ("gru_direction_fused", "gru_recurrence",
                                 "gru_direction_fused_static")},
          "per_launch_float32": timings})
    return err, max_code_diff, timings


def gru_static_split(device, args, acc_scale, result, device_ms):
    """The static GRU kernel's two launches through its library's entries:
    the input projection into a float32 xw (int8 x on the tensor cores,
    checked against the exact int32 product; float x the f32 product) and
    the core's recurrence over it (codes and hT must equal the kernel's),
    timed apart, with each launch's bound."""
    import torch
    from pepper_tpu_torch.ops import cuda_build
    from pepper_tpu_torch.ops.int8_matmul import int8_matmul

    xs, ws, b_ih, w_hh, b_hh, h0 = args
    B, G = xs[0].shape[1], 3 * GRU_H
    x_int8 = xs[0].dtype == torch.int8
    two = len(xs) > 1
    w0 = cuda_build.int8_kmajor(torch.cat(ws)) if x_int8 else ws[0]
    w1 = ws[1] if two and not x_int8 else None
    xw = torch.empty((GRU_T, B, G), device=device)
    out = torch.empty((GRU_T, B, GRU_H), dtype=torch.int8, device=device)
    h_out = torch.empty((B, GRU_H), device=device)

    def project():
        cuda_build.launch(
            "gru_direction_fused_static_projection", device,
            cuda_build.DTYPE_CODE[xs[0].dtype], xs[0].data_ptr(),
            xs[1].data_ptr() if two else None, w0.data_ptr(),
            w1.data_ptr() if w1 is not None else None, xs[0].shape[2],
            xs[1].shape[2] if two else 0,
            acc_scale.data_ptr() if x_int8 else None, b_ih.data_ptr(),
            xw.data_ptr(), GRU_T, B, GRU_H)

    def recur():
        cuda_build.launch(
            "gru_direction_fused_static_recurrence", device,
            cuda_build.DTYPE_CODE[w_hh.dtype], xw.data_ptr(),
            w_hh.float().data_ptr(), b_hh.data_ptr(), h0.data_ptr(),
            out.data_ptr(), h_out.data_ptr(), GRU_T, B, GRU_H, 0)

    project()
    recur()
    M = GRU_T * B
    if x_int8:
        acc = sum(int8_matmul(x.reshape(M, -1), w) for x, w in zip(xs, ws))
        exact = acc.float() * acc_scale + b_ih
        torch.cuda.synchronize()
        check(torch.equal(xw.reshape(M, G), exact),
              f"static GRU projection entry B={B}: xw differs from the "
              "exact product")
    else:
        exact = (torch.cat(xs, -1).double().reshape(M, -1)
                 @ torch.cat(ws).double() + b_ih.double())
        torch.cuda.synchronize()
        check((xw.reshape(M, G).double() - exact).abs().max().item() <= 1e-4,
              f"static GRU projection entry B={B}")
    check(torch.equal(out, result[0]) and torch.equal(h_out, result[1]),
          f"static GRU projection + recurrence B={B} differ from the kernel")
    F = sum(x.shape[2] for x in xs)
    proj_ops, rec_ops = 2 * M * F * G, 2 * M * GRU_H * G
    x_item = xs[0].element_size()
    return {
        "projection_ms": device_ms(project),
        "recurrence_ms": device_ms(recur),
        "projection_bound_ms": bound_ms(
            proj_ops, M * F * x_item + F * G * x_item + 4 * M * G,
            PEAK_INT8_OPS if x_int8 else PEAK_F32_FLOPS),
        "recurrence_bound_ms": bound_ms(
            rec_ops, 4 * M * G + 4 * GRU_H * G + 8 * B * GRU_H + M * GRU_H,
            PEAK_F32_FLOPS)}


# ---------------------------------------------------------------- phase 11

CONSENSUS_MODES = {
    # mode: (environment, quantize_mode, its kernel, the votes bar)
    "float": ({}, None, "gru_direction_fused", 1e-4),
    "static": ({}, "static", "gru_direction_fused_static", 1e-4),
    "recurrence": ({"PEPPER_GRU_FUSED": "0", "PEPPER_GRU_KERNEL": "1"},
                   None, "gru_recurrence", 1e-4),
}


def polish_trees(device):
    """The seeded full-width float polish tree (numpy, as load_params gives
    it) and its float and static-int8 serving trees on `device`."""
    import torch
    from pepper_tpu_torch.models import quantize
    from pepper_tpu_torch.models.params import params_from_jax
    from pepper_tpu_torch.models.polish_gru import init_polish_params

    params = init_polish_params(torch.Generator().manual_seed(13))
    host = {name: {k: v.numpy() for k, v in group.items()}
            for name, group in params.items()}
    return host, {None: params_from_jax(host, device),
                  "static": quantize.polish_prepare_static(params_from_jax(
                      quantize.polish_quantize_params_static(host), device))}


def vote_margin(votes):
    top2 = votes.topk(2, dim=2).values
    return top2[..., 0] - top2[..., 1]


def scene_images(bam, fasta, threads=4):
    """Every chunk image, (n, 1000, 10) uint8, that the polish CLI makes of
    a scene, in the order it hands them to the consensus."""
    from types import SimpleNamespace

    from pepper_tpu_torch.io.bam import BamReader
    from pepper_tpu_torch.io.fasta import FastaReader
    from pepper_tpu_torch.polish import pipeline

    fasta_handler = FastaReader(fasta)
    intervals = pipeline.build_polish_intervals(
        pipeline.get_polish_chromosome_list(None, fasta_handler,
                                            BamReader(bam)), fasta_handler)
    options = SimpleNamespace(bam=bam, fasta=fasta, threads=threads,
                              downsample_rate=1.0, realignment=True)
    return np.stack([record[4] for records in
                     pipeline.polish_image_shares(options, intervals)
                     for record in records])


def saturated_share(tree, batch):
    """The share of the float model's encoder and decoder outputs at
    |h| > 0.99 on the first window of `batch`, by the twins: where the
    gates saturate, a kernel and its twin agree whatever their
    arithmetic."""
    import torch
    from pepper_tpu_torch.ops import gru_kernel

    xt = batch[:, :GRU_T].transpose(0, 1).contiguous()
    hidden = torch.zeros((batch.shape[0], 2, GRU_H), device=batch.device)
    with twin_path():
        f1, b1, hid1 = gru_kernel.bigru_fused((xt,), tree["encoder"], hidden)
        f2, b2, _ = gru_kernel.bigru_fused((f1, b1), tree["decoder"], hid1)

    def share(*hs):
        return (sum((h.abs() > 0.99).sum().item() for h in hs)
                / sum(h.numel() for h in hs))

    return {"encoder": share(f1, b1), "decoder": share(f2, b2)}


def phase_consensus(device, card, scene_chunks, n_chunks=512):
    """The consensus scan on two sets of n_chunks chunks: the polish
    scene's own images (base frequencies scaled to 0..254; its chunks
    repeated to n_chunks), and seeded counts of 0..40, on which the
    random-weight encoder saturates less.  Times come from the scene's."""
    import torch

    _, trees = polish_trees(device)
    image_sets = {
        "scene": np.resize(scene_chunks, (n_chunks, *scene_chunks.shape[1:])),
        "counts_0_40": np.random.RandomState(17).randint(
            0, 41, (n_chunks, 1000, GRU_F)).astype(np.uint8)}
    result = {}
    for set_name, chunks in image_sets.items():
        images = torch.from_numpy(chunks)
        result[set_name] = {
            "saturated_share": saturated_share(
                trees[None], images[:B_POLISH].to(device).float()),
            **consensus_modes(trees, images, device,
                              timed=set_name == "scene")}
    emit({"phase": "consensus", "card": card, "chunks": n_chunks,
          "scene_chunks": len(scene_chunks), "B": B_POLISH, **result})
    return result


def consensus_modes(trees, images, device, timed):
    """Each mode of CONSENSUS_MODES on `images`, kernels against the twin
    path; with `timed`, the time of one batch of B_POLISH chunks."""
    import torch
    from pepper_tpu_torch.ops import gru_kernel
    from pepper_tpu_torch.polish import consensus

    n_chunks = len(images)
    result = {}
    for mode, (env, quantize_mode, kernel, bar) in CONSENSUS_MODES.items():
        scan = (consensus.consensus_scan_static if quantize_mode
                else consensus.consensus_scan)
        tree = trees[quantize_mode]
        counter = getattr(gru_kernel, kernel)
        worst, unequal, near_ties = 0.0, 0, 0
        with mock.patch.dict(os.environ, env):
            for start in range(0, n_chunks, B_POLISH):
                batch = images[start:start + B_POLISH].to(device).float()
                counter.launches = 0
                votes, labels, phred = scan(tree, batch)
                torch.cuda.synchronize()
                check(counter.launches == LAUNCHES_PER_BATCH,
                      f"consensus {mode}: {counter.launches} launches")
                with twin_path():
                    ref_votes, ref_labels, _ = scan(tree, batch)
                check(bool(torch.isfinite(votes).all()
                           & torch.isfinite(phred).all()),
                      f"consensus {mode}: not finite")
                worst = max(worst, (votes - ref_votes).abs().max().item())
                differ = labels != ref_labels
                unequal += differ.sum().item()
                confident = vote_margin(ref_votes) > 0.05
                near_ties += (differ & ~confident).sum().item()
                check(not bool((differ & confident).any()),
                      f"consensus {mode}: labels differ where the twin's "
                      "margin exceeds 0.05")
            check(worst <= bar, f"consensus {mode}: votes differ by {worst}")
            result[mode] = {"max_abs_vote_diff": worst,
                            "labels_unequal": unequal,
                            "labels_unequal_near_ties": near_ties}
            if timed:
                batch = images[:B_POLISH].to(device).float()
                ms = cuda_ms(lambda: scan(tree, batch), iters=3, warmup=1)
                with twin_path():
                    twin_ms = cuda_ms(lambda: scan(tree, batch), iters=1,
                                      warmup=0)
                result[mode].update(batch_ms=ms,
                                    chunks_per_s=B_POLISH / ms * 1e3,
                                    twin_batch_ms=twin_ms)
    return result


# ---------------------------------------------------------------- phase 12


def write_polish_scene(directory, length=24_000, read_len=1000, coverage=30,
                       error_rate=0.01, seed=23, truth_bam=False):
    """A truth sequence, a draft carrying seeded SNP, insertion and
    deletion errors against it every ~200 bp, and ~30x of reads of the
    truth aligned to the draft, written with the port's own BAM/FASTA
    writers (with `truth_bam`, also truth.bam: one full-length truth read
    aligned to the draft, training's labels).  Returns (bam, fasta, draft,
    truth)."""
    from pepper_tpu_torch.io.bam_writer import (BamRecord, write_bam,
                                                write_fasta)

    rng = np.random.RandomState(seed)
    draft = "".join("ACGT"[i] for i in rng.randint(0, 4, length))
    fixes = []          # (pos, draft allele, truth allele) on the draft
    for i, pos in enumerate(range(400, length - 400, 200)):
        kind = i % 3
        if kind == 0:       # the draft has a wrong base
            fixes.append((pos, draft[pos], "ACGT"[(
                "ACGT".index(draft[pos]) + 1 + rng.randint(3)) % 4]))
        elif kind == 1:     # the draft misses bases after pos
            fixes.append((pos, draft[pos], draft[pos] + "".join(
                "ACGT"[j] for j in rng.randint(0, 4, 1 + rng.randint(3)))))
        else:               # the draft has extra bases after pos
            fixes.append((pos, draft[pos:pos + 2 + rng.randint(3)],
                          draft[pos]))
    truth, cursor = [], 0
    for pos, draft_allele, truth_allele in fixes:
        truth.append(draft[cursor:pos] + truth_allele)
        cursor = pos + len(draft_allele)
    truth = "".join(truth) + draft[cursor:]
    stride = read_len // coverage
    records = []
    for n, start in enumerate(range(0, length - read_len, stride)):
        seq, cigar = _cigar_read(draft, fixes, start, read_len)
        codes = np.frombuffer(seq.encode(), np.uint8).copy()
        errors = rng.rand(len(codes)) < error_rate
        base_ix = np.searchsorted(np.frombuffer(b"ACGT", np.uint8), codes)
        codes[errors] = np.frombuffer(b"ACGT", np.uint8)[
            (base_ix[errors] + rng.randint(1, 4, errors.sum())) % 4]
        records.append(BamRecord(
            name=f"read_{n}", ref_id=0, pos=start, mapq=60, cigar=cigar,
            seq=codes.tobytes().decode(),
            qual=np.where(errors, 7, 30).tolist(),
            flag=0x10 if n % 2 else 0))
    bam, fasta = (os.path.join(directory, "polish.bam"),
                  os.path.join(directory, "draft.fa"))
    write_bam(bam, [("contig_1", length)], records)
    write_fasta(fasta, {"contig_1": draft})
    if truth_bam:
        seq, cigar = _cigar_read(draft, fixes, 0, length)
        write_bam(os.path.join(directory, "truth.bam"),
                  [("contig_1", length)],
                  [BamRecord(name="truth", ref_id=0, pos=0, mapq=60,
                             cigar=cigar, seq=seq, qual=[60] * len(seq))])
    return bam, fasta, draft, truth


def missing_kmers(sequence, truth, k=21):
    """How many of the truth's k-mers the sequence lacks: each error of a
    draft removes up to k of them, so fewer means closer to the truth."""
    have = {sequence[i:i + k] for i in range(len(sequence) - k + 1)}
    return sum(truth[i:i + k] not in have
               for i in range(len(truth) - k + 1))


def read_fasta_sequence(path):
    with open(path) as f:
        return "".join(line.strip() for line in f if not line.startswith(">"))


# (name, device, extra CLI arguments, environment, the kernel the run must
#  launch, the run whose FASTA it must equal); cpu runs launch nothing
POLISH_RUNS = (
    ("cpu_float32", "cpu", (), {}, None, None),
    ("cuda_float32", "cuda", (), {}, "gru_direction_fused", "cpu_float32"),
    ("cpu_quantized", "cpu", ("--quantized",), {}, None, None),
    ("cuda_quantized", "cuda", ("--quantized",), {},
     "gru_direction_fused_static", "cpu_quantized"),
    ("cuda_recurrence", "cuda", (),
     {"PEPPER_GRU_FUSED": "0", "PEPPER_GRU_KERNEL": "1"}, "gru_recurrence",
     "cpu_float32"),
    ("cuda_dry", "cuda", ("--dry",), {}, None, None),
)


def phase_polish(device, workdir, scene, threads=4):
    """The polish CLI on `scene` (write_polish_scene's) in every run of
    POLISH_RUNS; returns each cuda run's launches by kernel, read around
    that run alone."""
    from pepper_tpu_torch.models.checkpoint import save_params

    bam, fasta, draft, truth = scene
    host, _ = polish_trees("cpu")
    model = os.path.join(workdir, "polish.npz")
    save_params(model, host, {})
    runs, launches, differing = polish_cli_runs(device, workdir, bam, fasta,
                                                model, POLISH_RUNS, threads)
    missing = {"draft": missing_kmers(draft, truth)}
    for name in runs:
        missing[name] = missing_kmers(read_fasta_sequence(os.path.join(
            workdir, name, "consensus_pepper_polished.fa")), truth)
    # random weights polish nowhere; the dry backend must
    check(missing["cuda_dry"] < missing["draft"],
          f"the dry polish did not move toward the truth: {missing}")
    emit({"phase": "polish", "draft_length": len(draft),
          "truth_21mers_missing": missing,
          "fasta_length": {k: len(v["fasta"]) for k, v in runs.items()},
          "against_reference": differing,
          "launches": {k: v for k, v in launches.items()
                       if k.startswith("cuda")},
          "seconds": {k: v["seconds"] for k, v in runs.items()}})
    return launches


def polish_cli_runs(device, workdir, bam, fasta, model, table, threads=4):
    """The polish CLI on (bam, fasta) with `model` in every run of `table`
    (POLISH_RUNS' rows), each in workdir/<name>: a run's launches by
    kernel, read around that run alone, are only its kernel's and a
    multiple of 76; a float run's FASTA has its reference run's bytes, a
    --quantized run's too or its labels differ only at near ties (the
    reference's top-two vote margin <= 0.05).  Returns (each run's
    seconds and FASTA bytes, its launches, the differences by run)."""
    import torch
    from pepper_tpu_torch.cli import polish_main
    from pepper_tpu_torch.ops import gru_kernel
    from pepper_tpu_torch.polish import consensus

    wrappers = {name: getattr(gru_kernel, name)
                for name in gru_kernel.KERNELS}
    real_scan = {name: getattr(consensus, name)
                 for name in ("consensus_scan", "consensus_scan_static")}
    runs, launches, scans = {}, {}, {}
    for name, dev, extra, env, _, _ in table:
        out = os.path.join(workdir, name)
        argv = ["polish", "-b", bam, "-f", fasta, "-m", model, "-o", out,
                "-t", str(threads), "--batch_size", str(B_POLISH),
                "--device", str(device) if dev == "cuda" else dev, *extra]
        recorded = scans[name] = []

        def recording(fn):
            def scan(tree, images):
                votes, labels, phred = fn(tree, images)
                recorded.append((votes.cpu(), labels.cpu()))
                return votes, labels, phred
            return scan

        for wrapper in wrappers.values():
            wrapper.launches = 0
        t0 = time.time()
        with mock.patch.dict(os.environ, env), contextlib.ExitStack() as st:
            for scan_name, fn in real_scan.items():
                st.enter_context(mock.patch.object(consensus, scan_name,
                                                   recording(fn)))
            check(polish_main.main(argv) == 0, f"polish {name} failed")
        if dev == "cuda":
            torch.cuda.synchronize()
        launches[name] = {k: w.launches for k, w in wrappers.items()}
        path = os.path.join(out, "consensus_pepper_polished.fa")
        with open(path, "rb") as f:
            runs[name] = {"seconds": round(time.time() - t0, 3),
                          "fasta": f.read()}
    differing = {}
    for name, dev, extra, _, kernel, reference in table:
        counts = launches[name]
        if kernel is None:
            check(not any(counts.values()), f"{name} launched {counts}")
            continue
        n = counts[kernel]
        check(n >= LAUNCHES_PER_BATCH and n % LAUNCHES_PER_BATCH == 0,
              f"{kernel} launched {n} times in {name}")
        others = {k: v for k, v in counts.items() if k != kernel and v}
        check(not others, f"{name} also launched {others}")
        # the labels of each consensus batch against the reference run's
        unequal = near = 0
        check(len(scans[name]) == len(scans[reference]),
              f"{name}: {len(scans[name])} consensus batches")
        for (_, labels), (ref_votes, ref_labels) in zip(scans[name],
                                                        scans[reference]):
            differ = labels != ref_labels
            unequal += differ.sum().item()
            near += (differ & (vote_margin(ref_votes) <= 0.05)).sum().item()
        differing[name] = {"labels_unequal": unequal,
                           "of_them_near_ties": near,
                           "fasta_equal": runs[name]["fasta"]
                           == runs[reference]["fasta"]}
        if "--quantized" in extra:
            check(differing[name]["fasta_equal"] or near == unequal,
                  f"{name}: {unequal - near} labels differ from "
                  f"{reference} beyond near ties")
        else:
            check(differing[name]["fasta_equal"],
                  f"{name}: FASTA differs from {reference} "
                  f"({differing[name]})")
    return runs, launches, differing


# ---------------------------------------------------------------- phases 13-14


def scene_regions(device, bam, fasta, region_size=10000):
    """Phase 9's scene cut as call_variant cuts it, per region: the
    --device_pileup package (native int8 image and descriptors), the host
    windows, and the event stream of the summarizer's Python walker,
    recorded from a walk whose matrix backend is accumulate_cuda (check
    (c) of phase 14: its windows must equal the in-place walker's, and the
    native pass's, byte for byte)."""
    from pepper_tpu_torch.io.bam import BamReader
    from pepper_tpu_torch.io.fasta import FastaReader
    from pepper_tpu_torch.ops import pileup_kernel
    from pepper_tpu_torch.ops.pileup_ref import (RegionalSummary,
                                                 encode_reference_values)
    from pepper_tpu_torch.options import PepperOptions
    from pepper_tpu_torch.pipeline import summarizer
    from pepper_tpu_torch.pipeline.regions import (build_intervals,
                                                   get_chromosome_list)
    from pepper_tpu_torch.presets import set_parameters

    options = set_parameters(PepperOptions(
        bam=bam, fasta=fasta, ont_r9_guppy5_sup=True,
        sub_command="call_variant"))
    handlers = (BamReader(bam), FastaReader(fasta))
    chr_list, _ = get_chromosome_list(None, handlers[1], handlers[0], None)
    intervals, _ = build_intervals(chr_list, handlers[1], region_size, False)

    def summarize(interval, device_pileup, backend=None, walker=False):
        """create_region_summary's result, through the Python walker with
        `backend` as its matrix backend when `walker`; and the summary."""
        made = []

        class Summary(RegionalSummary):
            def __init__(self, *args, **kwargs):
                if walker:
                    kwargs.update(use_native=False, matrix_backend=backend)
                super().__init__(*args, **kwargs)
                made.append(self)

        options.device_pileup = device_pileup
        with mock.patch.object(summarizer, "RegionalSummary", Summary):
            out = summarizer.create_region_summary(options, *handlers,
                                                   *interval)
        return out, made[0]

    regions, walk_s = [], 0.0
    pileup_kernel.pileup_histogram_events.launches = 0
    for interval in intervals:
        recorded = {}

        def record(rows, cols, deltas, shape):
            recorded["events"] = (rows, cols, deltas)
            return pileup_kernel.accumulate_cuda(rows, cols, deltas, shape,
                                                 device=device)

        (package,), _ = summarize(interval, True)
        host_windows, _ = summarize(interval, False)
        t0 = time.time()
        windows, summary = summarize(interval, False, record, walker=True)
        walk_s += time.time() - t0
        golden, _ = summarize(interval, False, walker=True)
        start = interval[1]
        check(len(windows) == len(golden) == len(host_windows)
              == len(package.windows) > 0,
              f"region {start}: {len(windows)} windows through "
              f"accumulate_cuda, {len(golden)} in place, {len(host_windows)} "
              "native")
        for w, g, n in zip(windows, golden, host_windows):
            check((w.position, w.candidates) == (g.position, g.candidates)
                  == (n.position, n.candidates)
                  and w.image.tobytes() == g.image.tobytes()
                  == n.image.tobytes(),
                  f"region {start}: window {g.position} {g.candidates} "
                  "differs between the walkers")
        n_ref = summary.ref_end - summary.ref_start + 1
        channel = encode_reference_values(summary.reference_sequence[:n_ref])
        if summary.total_observed_insert_bases:
            channel = np.repeat(channel,
                                1 + summary.max_observed_insert[:n_ref])
        check(summary.region_rows == package.region_rows,
              f"region {start}: {summary.region_rows} rows")
        regions.append({"package": package, "host_windows": host_windows,
                        "events": recorded["events"], "ref": channel})
    walker = {"regions": len(regions),
              "launches": pileup_kernel.pileup_histogram_events.launches,
              "windows_equal": sum(len(r["host_windows"]) for r in regions),
              "walk_s": round(walk_s, 3),
              "events": sum(len(r["events"][0]) for r in regions)}
    check(walker["launches"] == len(regions),
          f"accumulate_cuda launched {walker['launches']} times on "
          f"{len(regions)} regions")
    return regions, walker


def dispatch_regions(regions, n=8):
    """The event flow's dispatch: n regions, the scene's in order and then
    its first ones again."""
    return [regions[i % len(regions)] for i in range(n)]


def histogram_case(device, events, n_rows):
    """Flat int32 events on the card, the host seconds to make them (the
    int32 arrays the flow uploads) and, for comparison, to bin them as the
    TPU kernel's layout wants (_bin_events, which no path of the port
    runs), the bytes of each layout, and the pinned host-to-device copy's
    milliseconds of the flat one."""
    import torch
    from pepper_tpu_torch.ops import pileup_kernel as pk

    t0 = time.perf_counter()
    flat = [np.ascontiguousarray(a, np.int32) for a in events]
    flat_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, _, _, n_tiles, capacity = pk._bin_events(*flat, n_rows)
    bin_s = time.perf_counter() - t0
    pinned = [torch.from_numpy(a).pin_memory() for a in flat]
    h2d_ms = cuda_ms(lambda: [p.to(device, non_blocking=True)
                              for p in pinned], iters=3, warmup=1)
    return [p.to(device) for p in pinned], {
        "host_flat_s": flat_s, "bin_host_s": bin_s, "h2d_ms": h2d_ms,
        "h2d_mbytes": 12 * len(flat[0]) / 1e6,
        "binned_mbytes": 12 * n_tiles * capacity / 1e6}


def phase_kernel_histogram(device, card, regions):
    """pileup_histogram_events against its twin, exactly, at the shapes of
    its two paths and harder ones; per-launch times."""
    import torch
    from pepper_tpu_torch.ops import device_windows as dw
    from pepper_tpu_torch.ops import pileup_kernel as pk

    # the small cases of tests/test_pileup_kernel.py and no events
    small = {}
    for n_events, n_rows in ((10, 40), (5000, 300), (50000, 4096), (3, 1),
                             (0, 10)):
        rng = np.random.RandomState(n_events)
        ev = (rng.randint(0, n_rows, n_events).astype(np.int32),
              rng.randint(0, 26, n_events).astype(np.int32),
              rng.choice([-1, 1], n_events).astype(np.int32))
        shape = (n_rows + 1, 26)
        pk.pileup_histogram_events.launches = 0
        out = pk.accumulate_cuda(*ev, shape, device=device)
        launched = pk.pileup_histogram_events.launches
        ref = pk.accumulate_torch(*ev, shape, device=device)
        check(launched == (n_events > 0),
              f"accumulate_cuda launched {launched} times on {n_events} "
              "events")
        check(out.dtype == np.int64 and out.shape == shape
              and np.array_equal(out, ref)
              and np.array_equal(out, pk.accumulate_numpy(*ev, shape)),
              f"accumulate_cuda differs on {n_events} events")
        small[f"{n_events}x{n_rows}"] = int(np.abs(out - ref).max()
                                           if n_events else 0)

    # the shapes of the two paths: one region (the matrix backend), and the
    # event flow's 8-region dispatch in its strided layout, each in the
    # order the walker emitted its events
    one = regions[0]
    batch = dispatch_regions(regions)
    sizes = [r["package"].region_rows for r in batch]
    stride, offsets = dw.pack_regions(sizes)
    total_rows = len(batch) * stride
    dispatch = tuple(np.concatenate(parts) for parts in zip(*[
        (np.asarray(r["events"][0], np.int64) + offsets[i],
         r["events"][1], r["events"][2]) for i, r in enumerate(batch)]))
    # one tile of region 0 holding 10x the mean tile's events
    tile_of = dispatch[0] // pk.TILE_R
    mean = len(tile_of) / (total_rows / pk.TILE_R)
    hot = int((offsets[0] + 5000) // pk.TILE_R)
    in_hot = np.flatnonzero(tile_of == hot)
    extra = np.resize(in_hot, int(10 * mean) - len(in_hot))
    skewed = tuple(np.concatenate([a, a[extra]]) for a in dispatch)
    by_row = np.argsort(dispatch[0], kind="stable")
    cases = {
        "region": (one["events"], one["package"].region_rows),
        "dispatch": (dispatch, total_rows),
        "dispatch_x4": (tuple(np.tile(a, 4) for a in dispatch), total_rows),
        "skewed": (skewed, total_rows),
        # the TPU layout's order: every warp's lanes on a few rows
        "dispatch_row_sorted": (tuple(a[by_row] for a in dispatch),
                                total_rows),
    }
    F = 26
    result = {}
    for name, (events, n_rows) in cases.items():
        flat, host = histogram_case(device, events, n_rows)
        pk.pileup_histogram_events.launches = 0
        out = pk.pileup_histogram_events(*flat, n_rows, F)
        launched = pk.pileup_histogram_events.launches
        ref = pk.pileup_histogram_events_reference(*flat, n_rows, F)
        torch.cuda.synchronize()
        err = (out.long() - ref.long()).abs().max().item()
        check(launched == 1 and out.dtype == torch.int32 and err == 0,
              f"pileup_histogram_events {name}: {launched} launches, "
              f"differs from its twin by {err}")
        n_events = len(events[0])
        keys = (flat[0].long() * F + flat[1]).contiguous()

        def library():
            return torch.zeros(n_rows * F, dtype=torch.int32,
                               device=device).index_add_(0, keys, flat[2])

        lib_err = (library().reshape(n_rows, F) - out).abs().max().item()
        check(lib_err == 0, f"index_add_ {name}: differs by {lib_err}")
        # bytes it must move: each event read once (12 B) and the image's
        # 26 feature columns written once (4 B)
        nbytes = 12 * n_events + 4 * n_rows * F

        def kernel():
            return pk.pileup_histogram_events(*flat, n_rows, F)

        result[name] = {
            "events": n_events, "rows": n_rows, "max_abs_err": err,
            "kernel_ms": cuda_ms(kernel, queued=True),
            "kernel_ms_unqueued": cuda_ms(kernel),
            "plain_ms": cuda_ms(lambda: pk.pileup_histogram_events_reference(
                *flat, n_rows, F), iters=5),
            "library_ms": cuda_ms(library, queued=True),
            "library_ms_unqueued": cuda_ms(library),
            "bound_ms": nbytes / PEAK_BYTES * 1e3,
            "bound_mbytes": nbytes / 1e6, **host}
        del flat, keys, out, ref

    # the slab wrapper (the TPU kernel's input) now runs the same kernel on
    # the slots as flat events: the region's binned slabs, exactly
    rel, bc, bd, n_tiles, capacity = pk._bin_events(
        *(np.asarray(a, np.int32) for a in one["events"]),
        one["package"].region_rows)
    slabs = [torch.from_numpy(a).to(device) for a in (rel, bc, bd)]
    pk.pileup_histogram_events.launches = 0
    out = pk.pileup_histogram(*slabs, n_tiles, capacity // pk.CHUNK_E)
    launched = pk.pileup_histogram_events.launches
    ref = pk.pileup_histogram_reference(*slabs, n_tiles,
                                        capacity // pk.CHUNK_E)
    torch.cuda.synchronize()
    check(launched == 1 and torch.equal(out, ref),
          "pileup_histogram on the region's slabs differs from its twin")
    emit({"phase": "kernel_histogram",
          "kernel_names": ["pileup_histogram_events"],
          "card": card, "small_max_abs_err": small,
          "slabs_equal_twin": True, **result})
    return result


def phase_device_flows(device, card, regions, walker):
    """The two fused flows on the scene's regions, kernels against the
    twin path, in bfloat16 and float32; (c), the matrix-backend walk, ran
    in scene_regions."""
    import torch
    from pepper_tpu_torch.models.transducer import (map_params,
                                                    params_from_jax,
                                                    transducer_infer)
    from pepper_tpu_torch.ops import device_windows as dw
    from pepper_tpu_torch.ops import lstm_kernel, pileup_kernel
    from pepper_tpu_torch.ops.pileup_kernel import upload

    params = call_params()
    packages = [r["package"] for r in regions]
    images = [p.image for p in packages]
    descriptors = [p.descriptors for p in packages]
    sizes = [p.region_rows for p in packages]
    host_windows = np.stack([w.image for r in regions
                             for w in r["host_windows"]])
    batch = dispatch_regions(regions)
    ev_args = ([r["events"] for r in batch], [r["ref"] for r in batch],
               [r["package"].descriptors for r in batch],
               [r["package"].region_rows for r in batch])
    k_images, k_events = len(host_windows), sum(
        len(d.base_index) for d in ev_args[2])
    n_events = sum(len(e[0]) for e in ev_args[0])
    counters = (pileup_kernel.pileup_histogram_events,
                lstm_kernel.lstm_direction_fused)

    def counted(fn):
        for c in counters:
            c.launches = 0
        out = fn()
        torch.cuda.synchronize()
        return out, {c.__name__: c.launches for c in counters}

    result, launches = {}, {}
    for dtype_name, dtype in (("bfloat16", torch.bfloat16),
                              ("float32", torch.float32)):
        bar = TRANSDUCER_BARS[dtype_name]
        cast = map_params(lambda p: p.to(dtype),
                          params_from_jax(params, device))

        def images_flow():
            return dw.classify_regions_images(
                cast, images, descriptors, sizes, compute_dtype=dtype,
                device=device)

        def events_flow():
            return dw.classify_regions_events(cast, *ev_args,
                                              compute_dtype=dtype,
                                              device=device)

        probs_a, count_a = counted(images_flow)
        host = transducer_infer(cast, torch.from_numpy(host_windows).to(
            device), dtype)
        probs_b, count_b = counted(events_flow)
        with twin_path():
            twin_b = events_flow()
        torch.cuda.synchronize()
        check(count_a == {"pileup_histogram_events": 0,
                          "lstm_direction_fused": 4},
              f"images flow {dtype_name} launched {count_a}")
        check(count_b == {"pileup_histogram_events": 1,
                          "lstm_direction_fused": 4},
              f"events flow {dtype_name} launched {count_b}")
        check(probs_a.shape == (k_images, 3) and probs_b.shape == (k_events, 3)
              and bool(torch.isfinite(probs_b).all()),
              f"flow outputs {tuple(probs_a.shape)} {tuple(probs_b.shape)}")
        errs = {"images_vs_host_windows": (probs_a - host).abs().max().item(),
                "events_vs_twin_path": (probs_b - twin_b).abs().max().item(),
                "events_vs_images": (probs_b[:k_images] - probs_a).abs()
                .max().item()}
        for key, err in errs.items():
            check(err <= bar, f"{dtype_name} {key}: {err} > {bar}")
        launches[dtype_name] = {"images": count_a, "events": count_b}

        # the device halves alone, inputs already on the card
        stride, offsets = dw.pack_regions(sizes)
        stacked = np.zeros((len(images) * stride, 26), np.int8)
        for r, image in enumerate(images):
            stacked[offsets[r]:offsets[r] + image.shape[0]] = image
        merged_a, _ = dw._merge_descriptors(descriptors, offsets,
                                            device=device)
        stacked_d = upload(stacked, device)
        t0 = time.perf_counter()
        packed = dw.pack_events(ev_args[0], ev_args[1], ev_args[3])
        pack_s = time.perf_counter() - t0
        rows, cols, deltas, ref_col, mask = (upload(a, device)
                                             for a in packed[:5])
        total_rows, ev_offsets = packed[5:]
        merged_b, _ = dw._merge_descriptors(ev_args[2], ev_offsets,
                                            device=device)
        images_ms = cuda_ms(lambda: dw._fused_images_classify(
            cast, stacked_d, merged_a, dtype), iters=5)
        events_ms = cuda_ms(lambda: dw._fused_events_classify(
            cast, rows, cols, deltas, ref_col, mask, merged_b, total_rows,
            dtype), iters=5)
        t0 = time.perf_counter()
        events_flow().cpu()
        wall_events = time.perf_counter() - t0
        result[dtype_name] = {
            **errs,
            "images": {"regions": len(images), "windows": k_images,
                       "windows_padded": len(merged_a["base_index"]),
                       "device_ms": images_ms,
                       "windows_per_s": k_images / images_ms * 1e3},
            "events": {"regions": len(batch), "windows": k_events,
                       "events": n_events,
                       "events_per_window": n_events / k_events,
                       "h2d_mbytes": sum(a.nbytes for a in packed[:5]) / 1e6,
                       "device_ms": events_ms,
                       "windows_per_s": k_events / events_ms * 1e3,
                       "host_pack_s": pack_s,
                       "call_wall_s": wall_events}}
    emit({"phase": "device_flows", "card": card,
          "matrix_backend_walk": walker, "launches": launches, **result})
    return launches


def histogram_row(case):
    """The kernels line's fields of one phase-13 case."""
    return {"name": "pileup_histogram", "route": "cuda",
            "source": "pepper_tpu_torch/ops/csrc/pileup_histogram.cu",
            "max_abs_err": case["max_abs_err"], "ms": case["kernel_ms"],
            "plain_ms": case["plain_ms"], "bound_ms": case["bound_ms"],
            "bound_by": "bytes", "library_ms": case["library_ms"],
            "status": "redesigned: flat events in any order, no host sort "
                      "or binning, one launch of red.global adds with warp "
                      "aggregation of equal keys; earlier design: PERF.md "
                      "section 6, rows 8 and 9",
            "library_note": "one index_add_ of the events into a zeroed "
                            "int32 image, as the plain twin does"}


# ---------------------------------------------------------------- phase 15

HP_T = 21               # ImageOptionsHP.CANDIDATE_WINDOW_SIZE + 1
HP_F = 48               # ImageOptionsHP.IMAGE_HEIGHT
HP_CHECKED_BATCHES = (B_SERVE, 37)


def hp_lstm_inputs(gen, shape, B, dtype, device):
    """One direction's inputs at the HP classifier's widths: the encoder
    reads 48 int8 window values a column over 21 columns, the decoder the
    encoder's two (-1, 1) streams."""
    import torch

    scale = 1.0 / H ** 0.5

    def u(*size, s=scale):
        return ((torch.rand(size, generator=gen, device=device) * 2 - 1)
                * s).to(dtype)

    if shape == "encoder":
        xs = (torch.randint(-125, 126, (HP_T, B, HP_F), generator=gen,
                            device=device).to(dtype),)
        ws = (u(HP_F, 4 * H),)
    else:
        xs = (u(HP_T, B, H, s=1.0), u(HP_T, B, H, s=1.0))
        ws = (u(H, 4 * H), u(H, 4 * H))
    return xs, ws, u(4 * H, s=2 * scale), u(H, 4 * H)


def within(out, ref, bar, what):
    """The largest difference of a kernel's output from its twin's, checked
    against `bar`."""
    import torch

    torch.cuda.synchronize()
    check(bool(torch.isfinite(out.float()).all()), f"{what}: not finite")
    err = (out.float() - ref.float()).abs().max().item()
    check(err <= bar, f"{what}: max abs diff {err} > {bar}")
    return err


def hp_bilstm_pallas(device):
    """models/rnn.py's bilstm on the card: bilstm_pallas, two
    lstm_recurrence launches, over each layer of the HP transducer at
    B=4096, against the twin path at the kernel bars; returns the largest
    error and the launches (of the library call, before its twin path) by
    dtype."""
    import torch
    from pepper_tpu_torch.models import rnn
    from pepper_tpu_torch.ops import lstm_kernel

    params = hp_params()
    gen = torch.Generator(device=device).manual_seed(2122)
    errors, launches = {}, {}
    for dtype_name, dtype in (("float32", torch.float32),
                              ("bfloat16", torch.bfloat16)):
        errors[dtype_name] = 0.0
        launches[dtype_name] = 0
        for layer in ("encoder", "decoder"):
            tree = {k: v.to(device=device, dtype=dtype)
                    for k, v in params[layer].items()}
            if layer == "encoder":
                x = torch.randint(-125, 126, (B_SERVE, HP_T, HP_F),
                                  generator=gen, device=device)
            else:
                x = torch.rand((B_SERVE, HP_T, 2 * H), generator=gen,
                               device=device) * 2 - 1
            x = x.to(dtype)
            before = lstm_kernel.lstm_recurrence.launches
            out = rnn.bilstm(x, tree)
            n = lstm_kernel.lstm_recurrence.launches - before
            check(n == 2, f"HP bilstm {layer}: {n} lstm_recurrence launches")
            launches[dtype_name] += n
            with twin_path():
                ref = rnn.bilstm(x, tree)
            errors[dtype_name] = max(errors[dtype_name], within(
                out, ref, KERNEL_BARS[dtype_name],
                f"HP bilstm_pallas {dtype_name} {layer}"))
    return errors, launches


def _hp_static_encoder_kernels(device_name):
    """The device kernels one HP static encoder launch runs (48 bfloat16 or
    float32 features, int8 codes out), static and static_rec, as
    torch.profiler names them; run in a process of its own, whose first
    profiler session this is (PERF.md section 7)."""
    import torch
    from torch.autograd import DeviceType
    from pepper_tpu_torch.ops import lstm_kernel

    device = torch.device(device_name)
    gen = torch.Generator(device=device).manual_seed(2123)
    names = {}
    for mode, dtype in ((mode, dtype) for dtype in (torch.bfloat16,
                                                     torch.float32)
                        for mode in ("static", "static_rec")):
        w = static_weights(gen, "encoder", dtype, mode == "static_rec",
                           device, features=HP_F)
        x = torch.randint(-125, 126, (HP_T, 64, HP_F), generator=gen,
                          device=device).to(dtype)

        def run():
            lstm_kernel.lstm_direction_fused_static(
                (x,), w["w_ih"], w["b"], w["w_hh"],
                rec_scale=w["rec_scale"], out_int8=True)
            torch.cuda.synchronize()

        run()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            run()
        names[f"{mode}_{str(dtype).split('.')[1]}"] = sorted(
            {e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA})
    return names


def hp_static_encoder_route(device):
    """Row 2's HP static encoder in a trace: in bfloat16 the core's bf16
    projection with the codes kinds' sums (projection_kernel<.., true>)
    and the core's codes body over its xw (core_kernel<.., false,
    Kind<float, signed char, ..>>); in float32 the float32 FMA projection
    (projection_narrow_kernel) and, over its xw, the float32 core's codes
    kind (f32_core_kernel<.., true, false>; static) or the bf16 core's
    int8-W_hh codes body (static_rec)."""
    import concurrent.futures
    import multiprocessing

    with concurrent.futures.ProcessPoolExecutor(
            max_workers=1,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        names = pool.submit(_hp_static_encoder_kernels, str(device)).result()
    for case, kernels in names.items():
        if case.endswith("bfloat16"):
            route = (any("projection_kernel<" in k and ", true>" in k
                         for k in kernels)
                     and any("core_kernel<" in k and ", false, " in k
                             and "signed char" in k for k in kernels))
        elif case.startswith("static_rec"):
            route = (any("projection_narrow_kernel" in k for k in kernels)
                     and any("core_kernel<" in k and "f32_core" not in k
                             and "signed char, true, false>" in k
                             for k in kernels))
        else:
            route = (any("projection_narrow_kernel" in k for k in kernels)
                     and any("f32_core_kernel<" in k
                             and ", true, false>" in k for k in kernels))
        check(route, f"HP {case} encoder: kernels {kernels}")
    return names


def phase_kernel_hp(device, card):
    """Rows 1-4 at the HP classifier's shapes (T=21, encoder F=48, decoder
    2x256, H=256): each against its twin, then per-launch times at B=4096
    in bfloat16, queued, beside the bound and cuDNN, with the route and
    the launch plan.  Returns the errors, the code shares and each row's
    figures for one batch of 4096 HP windows."""
    import torch
    from pepper_tpu_torch.ops import lstm_kernel

    fused = lstm_kernel.lstm_direction_fused
    fused_twin = lstm_kernel.lstm_direction_fused_reference
    dual = lstm_kernel.bilstm_dual_fused
    dual_twin = lstm_kernel.bilstm_dual_fused_reference
    static = lstm_kernel.lstm_direction_fused_static
    static_twin = lstm_kernel.lstm_direction_fused_static_reference
    rec = lstm_kernel.lstm_recurrence
    rec_twin = lstm_kernel.lstm_recurrence_reference
    gen = torch.Generator(device=device).manual_seed(2121)

    def hp_xw(B, dtype):
        xw = ((torch.rand((HP_T, B, 4 * H), generator=gen, device=device)
               * 4 - 2).to(dtype))
        w_hh = ((torch.rand((H, 4 * H), generator=gen, device=device) * 2
                 - 1) / H ** 0.5).to(dtype)
        return xw, w_hh

    max_err = {}
    for dtype_name, dtype in (("float32", torch.float32),
                              ("bfloat16", torch.bfloat16)):
        bar = KERNEL_BARS[dtype_name]
        worst = dict.fromkeys(("lstm_direction_fused", "bilstm_dual_fused",
                               "lstm_recurrence"), 0.0)
        for shape in ("encoder", "decoder"):
            for B in HP_CHECKED_BATCHES:
                xs, wf, b_f, w_hh_f = hp_lstm_inputs(gen, shape, B, dtype,
                                                     device)
                _, wb, b_b, w_hh_b = hp_lstm_inputs(gen, shape, 1, dtype,
                                                    device)
                singles = []
                for reverse, w, b, w_hh in ((False, wf, b_f, w_hh_f),
                                            (True, wb, b_b, w_hh_b)):
                    out = fused(xs, w, b, w_hh, reverse=reverse)
                    check(out.shape == (HP_T, B, H) and out.dtype == dtype,
                          f"HP row 1 output {tuple(out.shape)} {out.dtype}")
                    worst["lstm_direction_fused"] = max(
                        worst["lstm_direction_fused"],
                        within(out, fused_twin(xs, w, b, w_hh,
                                               reverse=reverse), bar,
                               f"HP row 1 {dtype_name} {shape} B={B} "
                               f"reverse={reverse}"))
                    singles.append(out)
                args = (xs, wf, wb, b_f, b_b, w_hh_f, w_hh_b)
                for out, ref, one in zip(dual(*args), dual_twin(*args),
                                         singles):
                    worst["bilstm_dual_fused"] = max(
                        worst["bilstm_dual_fused"],
                        within(out, ref, bar,
                               f"HP row 3 {dtype_name} {shape} B={B}"))
                    check(torch.equal(out, one), f"HP row 3 {dtype_name} "
                          f"{shape} B={B}: not the two row-1 launches' sums")
        for B in HP_CHECKED_BATCHES:
            xw, w_hh = hp_xw(B, dtype)
            for reverse in (False, True):
                out = rec(xw, w_hh, reverse=reverse)
                check(out.shape == (HP_T, B, H),
                      f"HP row 4 output {tuple(out.shape)}")
                worst["lstm_recurrence"] = max(
                    worst["lstm_recurrence"],
                    within(out, rec_twin(xw, w_hh, reverse=reverse), bar,
                           f"HP row 4 {dtype_name} B={B} reverse={reverse}"))
        max_err[dtype_name] = worst
    max_err["bilstm_pallas"], max_err["bilstm_pallas_launches"] = (
        hp_bilstm_pallas(device))

    def run(fn, xs, w, reverse=False, **kw):
        return fn(xs, w["w_ih"], w["b"], w["w_hh"], acc_scale=w["acc_scale"],
                  rec_scale=w["rec_scale"], reverse=reverse, **kw)

    codes, max_code_diff = {}, 0
    for dtype_name, dtype in (("bfloat16", torch.bfloat16),
                              ("float32", torch.float32)):
        for mode in ("static", "static_rec"):
            rec_int8 = mode == "static_rec"
            tally = {"encoder": [0, 0], "decoder": [0, 0]}
            for B in HP_CHECKED_BATCHES:
                x = torch.randint(-125, 126, (HP_T, B, HP_F), generator=gen,
                                  device=device).to(dtype)
                streams = []
                for layer in ("encoder", "decoder"):
                    xs = (x,) if layer == "encoder" else tuple(streams)
                    streams = []
                    for reverse in (False, True):
                        w = static_weights(gen, layer, dtype, rec_int8,
                                           device, features=HP_F)
                        out = run(static, xs, w, reverse, out_int8=True)
                        ref = run(static_twin, xs, w, reverse, out_int8=True)
                        torch.cuda.synchronize()
                        check(out.shape == (HP_T, B, H)
                              and out.dtype == torch.int8,
                              f"HP static output {tuple(out.shape)}")
                        diff = (out.int() - ref.int()).abs()
                        worst = diff.max().item()
                        check(worst <= 1, f"HP {dtype_name} {mode} {layer} "
                              f"B={B} reverse={reverse}: codes differ by "
                              f"{worst}")
                        max_code_diff = max(max_code_diff, worst)
                        tally[layer][0] += (diff == 0).sum().item()
                        tally[layer][1] += diff.numel()
                        streams.append(out)
            for layer, (equal, total) in tally.items():
                share = equal / total
                check(share >= CODE_BARS[mode],
                      f"HP {dtype_name} {mode} {layer}: {share} of the "
                      f"codes equal the twin's, bar {CODE_BARS[mode]}")
                codes[f"{mode}_{layer}_{dtype_name}"] = share

    timings = {}
    dtype = torch.bfloat16
    for shape in ("encoder", "decoder"):
        xs, wf, b_f, w_hh_f = hp_lstm_inputs(gen, shape, B_SERVE, dtype,
                                             device)
        _, wb, b_b, w_hh_b = hp_lstm_inputs(gen, shape, 1, dtype, device)
        args = (xs, wf, wb, b_f, b_b, w_hh_f, w_hh_b)
        flops, nbytes = launch_work(shape, B_SERVE, 2, HP_T, HP_F)
        x_cat = torch.cat(xs, dim=-1)
        joins = x_cat.shape[2] <= lstm_kernel.FUSED_X_MAX
        route = ("fused: the features join each step's product" if joins
                 else "projection first, into a float32 xw")
        one = cudnn_lstm([(wf, b_f, w_hh_f)], dtype, device)
        both = cudnn_lstm([(wf, b_f, w_hh_f), (wb, b_b, w_hh_b)], dtype,
                          device)
        timings[f"row1_{shape}"] = {
            "kernel_ms": device_ms(lambda: fused(xs, wf, b_f, w_hh_f)),
            "plain_ms": device_ms(lambda: fused_twin(xs, wf, b_f, w_hh_f),
                                  iters=3),
            "cudnn_ms": cudnn_ms(one, x_cat, queued=True),
            "bound_ms": bound_ms(flops, nbytes, PEAK_BF16_FLOPS),
            "route": route, "plan": core_plan(device, B_SERVE, joins)}
        timings[f"row3_{shape}"] = {
            "kernel_ms": device_ms(lambda: dual(*args)),
            "plain_ms": device_ms(lambda: dual_twin(*args), iters=3),
            "cudnn_ms": cudnn_ms(both, x_cat, queued=True),
            "bound_ms": 2 * bound_ms(flops, nbytes, PEAK_BF16_FLOPS),
            "route": route, "plan": core_plan(device, B_SERVE, joins, 2)}
        xs32, w32, b32, w_hh32 = hp_lstm_inputs(gen, shape, B_SERVE,
                                                torch.float32, device)
        timings[f"row1_{shape}"]["kernel_ms_float32"] = device_ms(
            lambda: fused(xs32, w32, b32, w_hh32))
    for dtype_name, hp_dtype in (("bfloat16", torch.bfloat16),
                                 ("float32", torch.float32)):
        for key, entry in static_launch_times(
                device, static, static_twin, gen, hp_dtype, HP_T,
                HP_F).items():
            layer, mode = key.split("_", 1)
            suffix = "" if dtype_name == "bfloat16" else "_float32"
            timings[f"row2_{mode}_{layer}{suffix}"] = entry
    xw, w_hh = hp_xw(B_SERVE, dtype)
    eye = torch.eye(4 * H, device=device)
    lstm = cudnn_lstm([((eye,), torch.zeros(4 * H, device=device), w_hh)],
                      dtype, device)
    r_bytes = 2 * (xw.numel() + w_hh.numel() + HP_T * B_SERVE * H)
    r_ops = 2 * HP_T * B_SERVE * H * 4 * H
    timings["row4"] = {
        "kernel_ms": device_ms(lambda: rec(xw, w_hh)),
        "plain_ms": cuda_ms(lambda: rec_twin(xw, w_hh), iters=3),
        "cudnn_ms": cudnn_ms(lstm, xw, queued=True),
        "bound_ms": bound_ms(r_ops, r_bytes, PEAK_BF16_FLOPS),
        "bound_by": ("bytes" if r_bytes / PEAK_BYTES
                     > r_ops / PEAK_BF16_FLOPS else "operations"),
        "plan": recurrence_plan(device, B_SERVE)}

    def batch(rows, runs, keys=("kernel_ms", "plain_ms", "bound_ms",
                                "cudnn_ms")):
        """A row's figures for one batch of B_SERVE HP windows: `runs`
        launches of each of `rows`."""
        return {key: runs * sum(timings[row][key] for row in rows)
                for key in keys if key in timings[rows[0]]}

    per_batch = {
        "lstm_direction_fused": batch(["row1_encoder", "row1_decoder"], 2),
        "bilstm_dual_fused": batch(["row3_encoder", "row3_decoder"], 1),
        "lstm_direction_fused_static": batch(
            ["row2_static_encoder", "row2_static_decoder"], 2),
        "lstm_direction_fused_static_rec": batch(
            ["row2_static_rec_encoder", "row2_static_rec_decoder"], 2),
        "lstm_direction_fused_static_float32": batch(
            ["row2_static_encoder_float32", "row2_static_decoder_float32"],
            2, ("kernel_ms", "plain_ms", "bound_ms", "bound_ms_f32_fma")),
        "lstm_direction_fused_static_rec_float32": batch(
            ["row2_static_rec_encoder_float32",
             "row2_static_rec_decoder_float32"],
            2, ("kernel_ms", "plain_ms", "bound_ms", "bound_ms_f32_fma")),
        "lstm_recurrence": batch(["row4"], 4)}
    emit({"phase": "kernel_hp", "card": card, "T": HP_T, "features": HP_F,
          "max_abs_err": max_err, "max_code_diff": max_code_diff,
          "equal_share": codes, "B": B_SERVE, "per_launch": timings,
          "per_batch": per_batch,
          "static_encoder_kernels": hp_static_encoder_route(device),
          "static_ptxas": [e["entry"] for e in ptxas_entries(
              "lstm_direction_fused_static")
              if "projection_kernelILb1ELb1" in e["entry"]]})
    return max_err, max_code_diff, per_batch


# ---------------------------------------------------------------- phase 16


HP_ROUTES = (
    # route: (environment, the kernel it launches, launches a batch)
    ("fused", {}, "lstm_direction_fused", 4),
    ("dual", {"PEPPER_LSTM_DUAL": "1"}, "bilstm_dual_fused", 2),
)


def hp_params():
    """The seeded full-width HP transducer (48 features, 21 columns)."""
    import torch
    from pepper_tpu_torch.models.transducer import (TransducerConfig,
                                                    init_transducer_params)

    return init_transducer_params(
        torch.Generator().manual_seed(17),
        TransducerConfig(image_features=HP_F, window=HP_T))


def phase_transducer_hp(device, card):
    """4096 HP windows through transducer_infer on each LSTM route (the
    fused kernel and the dual one) in float32 and bfloat16, and through
    the three int8 modes, each against the twin path on the card at phase
    4's and phase 8's bars; windows/s."""
    import torch
    from pepper_tpu_torch.models import quantize
    from pepper_tpu_torch.models.transducer import (map_params,
                                                    params_from_jax,
                                                    transducer_infer)

    params = hp_params()
    host = {name: {k: v.numpy() for k, v in group.items()}
            for name, group in params.items()}
    gen = torch.Generator(device=device).manual_seed(18)
    windows = torch.randint(-125, 126, (B_SERVE, HP_T, HP_F), generator=gen,
                            device=device).to(torch.int8)
    wrappers = kernel_wrappers()
    result = {}

    def launched(forward, kernel, per_batch, what):
        for wrapper in wrappers.values():
            wrapper.launches = 0
        probs = forward()
        counts = {k: w.launches for k, w in wrappers.items() if w.launches}
        check(counts == {kernel: per_batch},
              f"{what}: launches {counts}, not {per_batch} of {kernel}")
        return probs

    for dtype_name, dtype in (("float32", torch.float32),
                              ("bfloat16", torch.bfloat16)):
        cast = map_params(lambda p: p.to(dtype),
                          params_from_jax(params, device))
        for route, env, kernel, per_batch in HP_ROUTES:
            with mock.patch.dict(os.environ, env):
                def forward():
                    return transducer_infer(cast, windows, dtype)

                probs = launched(forward, kernel, per_batch,
                                 f"HP {route} {dtype_name}")
                with twin_path():
                    ref = forward()
                err, agree = checked_probs(probs, ref,
                                           TRANSDUCER_BARS[dtype_name],
                                           f"HP {route} {dtype_name}")
                ms = cuda_ms(forward, iters=5)
            result[f"{route}_{dtype_name}"] = {
                "max_abs_err": err, "argmax_agree": agree, "batch_ms": ms,
                "windows_per_s": B_SERVE / ms * 1e3}
    for key, mode, dtype in (
            ("static", "static", torch.bfloat16),
            ("static_rec", "static_rec", torch.bfloat16),
            ("dynamic", "dynamic", torch.bfloat16),
            ("static_float32", "static", torch.float32),
            ("static_rec_float32", "static_rec", torch.float32)):
        if mode == "dynamic":
            q, s = (params_from_jax(tree, device)
                    for tree in quantize.quantize_params(host))
            kernel = "lstm_recurrence"

            def forward():
                return quantize.transducer_infer_quantized(q, s, windows)
        else:
            tree = quantize.prepare_static(
                quantize.quantize_params_static(
                    host, rec_int8=mode == "static_rec"),
                dtype, device)
            kernel = "lstm_direction_fused_static"

            def forward():
                return quantize.transducer_infer_static(tree, windows, dtype)
        probs = launched(forward, kernel, 4, f"HP {key}")
        launches = wrappers[kernel].launches  # this batch's, just read
        with twin_path():
            ref = forward()
        err, agree = checked_probs(probs, ref, QUANTIZED_BARS[mode],
                                   f"HP {key}")
        ms = cuda_ms(forward, iters=5)
        result[key] = {"max_abs_err": err, "argmax_agree": agree,
                       "batch_ms": ms, "windows_per_s": B_SERVE / ms * 1e3,
                       "launches": launches}
    emit({"phase": "transducer_hp", "card": card, "B": B_SERVE, "T": HP_T,
          "features": HP_F, **result})
    return result


# ---------------------------------------------------------------- phase 17


# The largest top-two genotype margin of the cpu run at which phase 17's
# dynamic HP runs may flip a genotype.  The card's plain path itself moves
# the dynamic mode's probabilities from the cpu run's by up to 4.4e-4 on
# this scene (the activations' codes follow each row's absmax, so a last
# bit of h can move a code) and flips two genotypes; the flips seen, on
# the kernels and on the plain path, lay at cpu margins of 4.2e-6 to
# 4.8e-4 (phase 17's max_prob_diff_from_cpu and dynamic_genotype_flips;
# PERF.md)
HP_DYNAMIC_TIE_BAR = 5e-4

# CALL_RUNS' layout, with --use_hp_info: the HP transducer on the HP scene
HP_CALL_RUNS = tuple(
    (f"hp_{name}", dev, dtype, ("--use_hp_info", *extra), dual, kernel,
     per_batch, reference and f"hp_{reference}")
    for name, dev, dtype, extra, dual, kernel, per_batch, reference
    in CALL_RUNS if "--device_pileup" not in extra)


def write_reference_checkpoint(path, params):
    """`params` (a transducer tree of tensors) as the reference's trainer
    saves its model: torch.nn.LSTM and Linear state-dict keys under a
    DataParallel 'module.' prefix, weights transposed, the LSTM bias split
    into bias_ih (the sum) and a zero bias_hh, in the pickled dict of
    train_distributed.py:36-42."""
    import torch

    state = {}
    for layer in ("encoder", "decoder"):
        node = params[layer]
        for d, sfx in (("f", ""), ("b", "_reverse")):
            state[f"{layer}.weight_ih_l0{sfx}"] = node[f"w_ih_{d}"].t()
            state[f"{layer}.weight_hh_l0{sfx}"] = node[f"w_hh_{d}"].t()
            state[f"{layer}.bias_ih_l0{sfx}"] = node[f"b_{d}"]
            state[f"{layer}.bias_hh_l0{sfx}"] = torch.zeros_like(
                node[f"b_{d}"])
    for name, node in params.items():
        if name not in ("encoder", "decoder"):
            state[f"{name}.weight"] = node["w"].t()
            state[f"{name}.bias"] = node["b"]
    torch.save({"model_state_dict": {f"module.{k}": v.cpu().contiguous()
                                     for k, v in state.items()},
                "model_optimizer": {}, "hidden_size": H, "gru_layers": 1,
                "epochs": 1}, path)
    return path


def phase_call_hp(device, workdir, scene, hp_scene, threads=4):
    """call_variant through the CLI in the modes this slice serves: (a)
    --use_hp_info on an HP-tagged scene in every host-flow mode of
    CALL_RUNS, each cuda run against its cpu run, and the int8 modes again
    on the twin path on the card against the same cpu runs; (b) on phase
    9's scene,
    --model_type no_cnn and transformer (from the checkpoint's metadata),
    cuda against cpu in float32 (the transformer's attention on its
    kernel), and a reference .pkl of phase 9's weights
    against the .npz of the same weights on cuda.  Returns the HP runs'
    launches by kernel."""
    import torch
    from pepper_tpu_torch.models.alternates import (init_no_cnn_params,
                                                    init_transformer_params)

    hp_model = save_model(os.path.join(workdir, "model_hp.npz"), hp_params())
    hp_table = [(*run, hp_model) for run in HP_CALL_RUNS]
    hp_runs, hp_launches = run_calls(device, workdir, hp_scene, hp_table,
                                     threads)
    check(len(hp_runs["hp_cpu_float32"]["calls"]) > 0,
          "no HP calls on the CPU")
    # the int8 modes again on the twin path on the card: how far the card's
    # float arithmetic alone moves their calls from the cpu runs'
    twin_table = [(name.replace("hp_cuda", "hp_twin"), dev, dtype, extra,
                   dual, None, 0, reference, hp_model)
                  for name, dev, dtype, extra, dual, _, _, reference
                  in HP_CALL_RUNS
                  if dev == "cuda" and "--quantized" in extra]
    with twin_path():
        twin_runs, twin_launches = run_calls(device, workdir, hp_scene,
                                             twin_table, threads)
    hp_runs.update(twin_runs)
    hp_launches.update(twin_launches)
    # static and static_rec give the cpu call sets on both paths; dynamic,
    # the plain path included, may flip a genotype where the cpu run's top
    # two probabilities tie within HP_DYNAMIC_TIE_BAR
    hp_alt, hp_tied = check_calls(
        hp_runs, hp_launches, hp_table + twin_table,
        dict.fromkeys(("hp_cuda_dynamic", "hp_twin_dynamic"),
                      HP_DYNAMIC_TIE_BAR))

    models = {
        name: save_model(os.path.join(workdir, f"model_{name}.npz"),
                         init(torch.Generator().manual_seed(31)), name)
        for name, init in (("no_cnn", init_no_cnn_params),
                           ("transformer", init_transformer_params))}
    npz = save_model(os.path.join(workdir, "model_lstm.npz"), call_params())
    pkl = write_reference_checkpoint(os.path.join(workdir, "model.pkl"),
                                     call_params())
    # no_cnn launches no kernel; the transformer's attention runs on the
    # attention kernel, one launch a layer
    attention = {"no_cnn": (None, 0), "transformer": ("window_attention", 6)}
    table = [run for name, model in models.items() for run in (
        (f"{name}_cuda_float32", "cuda", "float32", (), False,
         *attention[name], f"{name}_cpu_float32", model),
        (f"{name}_cpu_float32", "cpu", "float32", (), False, None, 0, None,
         model))]
    table += [
        ("npz_cuda_bfloat16", "cuda", "bfloat16", (), False,
         "lstm_direction_fused", 4, "npz_cuda_bfloat16", npz),
        ("pkl_cuda_bfloat16", "cuda", "bfloat16", (), False,
         "lstm_direction_fused", 4, "npz_cuda_bfloat16", pkl)]
    runs, launches = run_calls(device, workdir, scene, table, threads)
    for name in models:
        check(len(runs[f"{name}_cpu_float32"]["calls"]) > 0,
              f"no {name} calls on the CPU")
    check_calls(runs, launches, table)
    check(runs["pkl_cuda_bfloat16"]["calls"]
          == runs["npz_cuda_bfloat16"]["calls"],
          "the .pkl run's calls differ from the .npz run's")
    runs.update(hp_runs)
    emit({"phase": "call_hp", "hp_variants_simulated": hp_scene[2],
          "calls": {k: len(v["calls"]) for k, v in runs.items()},
          "alt_order_only_differences": hp_alt,
          "max_prob_diff_from_cpu": {
              name: max_prob_diff(hp_runs[name]["probs"],
                                  hp_runs[reference]["probs"])
              for name, _, _, extra, _, _, _, reference, *_
              in hp_table + twin_table
              if reference and "--quantized" in extra},
          "dynamic_genotype_flips": {
              name: {pos: {run: margin(hp_runs[run]["probs"], pos)
                           for run in ("hp_cpu_dynamic", "hp_cuda_dynamic",
                                       "hp_twin_dynamic")}
                     for pos in sorted(sites)}
              for name, sites in hp_tied.items()},
          "launches": {k: v for k, v in {**launches, **hp_launches}.items()
                       if "cuda" in k},
          "seconds": {k: v["seconds"] for k, v in runs.items()}})
    return hp_launches


# ---------------------------------------------------------------- phase 18


HP_PAIRS = 128          # image pairs a batch, as the polish consensus's
VOTE_ROUTES = {
    # route: (environment, its kernel)
    "fused": ({}, "gru_direction_fused"),
    "recurrence": ({"PEPPER_GRU_FUSED": "0", "PEPPER_GRU_KERNEL": "1"},
                   "gru_recurrence"),
}


def vote_stats(votes, twin, what):
    """Every x10000 vote within 1 of the twin path's, at least 99.9%
    equal, labels equal wherever the twin's top-two margin exceeds 50."""
    diff = np.abs(votes.astype(np.int64) - twin)
    unequal = int((diff != 0).sum())
    check(diff.max() <= 1, f"{what}: votes differ by {diff.max()}")
    check(unequal <= 1e-3 * diff.size,
          f"{what}: {unequal} of {diff.size} votes unequal")
    top2 = np.sort(twin, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 50
    labels = votes.argmax(-1) != twin.argmax(-1)
    check(not bool((labels & clear).any()),
          f"{what}: labels differ where the twin's margin exceeds 50")
    return {"votes_unequal": unequal, "votes": int(diff.size),
            "labels_unequal": int(labels.sum())}


def phase_hp_votes(device, card):
    """The legacy HP sliding predictor (infer/hp_sliding.py): HP_PAIRS
    image pairs of 1000 columns (counts 0..40) through predict_hp on the
    polish GRU's widths (F=10, H=128, 5 classes), per route: the fused
    kernel (row 5) and, with PEPPER_GRU_FUSED=0 PEPPER_GRU_KERNEL=1, the
    recurrence kernel (row 7); launches (76 a haplotype batch), the votes
    against the twin path on the card, pairs/s, and the route's kernel time
    a pair batch (its launches at the scan's shapes, queued) beside the
    bound, the twin and cuDNN."""
    import torch
    from pepper_tpu_torch.infer import hp_sliding
    from pepper_tpu_torch.models.params import params_from_jax
    from pepper_tpu_torch.models.polish_gru import init_polish_params
    from pepper_tpu_torch.ops import gru_kernel

    params = init_polish_params(torch.Generator().manual_seed(19))
    host = {name: {k: v.numpy() for k, v in group.items()}
            for name, group in params.items()}
    rng = np.random.RandomState(29)
    pair = [rng.randint(0, 41, (HP_PAIRS, 1000, GRU_F)).astype(np.float32)
            for _ in range(2)]
    tree = params_from_jax(host, device)
    images = [torch.from_numpy(x).to(device) for x in pair]
    wrappers = kernel_wrappers()
    result = {}
    for route, (env, kernel) in VOTE_ROUTES.items():
        with mock.patch.dict(os.environ, env):
            for wrapper in wrappers.values():
                wrapper.launches = 0
            t0 = time.time()
            votes = hp_sliding.predict_hp(host, *pair, device=device)
            seconds = time.time() - t0
            counts = {k: w.launches for k, w in wrappers.items()
                      if w.launches}
            check(counts == {kernel: 2 * LAUNCHES_PER_BATCH},
                  f"hp_votes {route}: launches {counts}")
            with twin_path():
                twins = hp_sliding.predict_hp(host, *pair, device=device)
            stats = {f"hp{i + 1}": vote_stats(v, t, f"hp_votes {route} "
                                              f"hp{i + 1}")
                     for i, (v, t) in enumerate(zip(votes, twins))}

            def scan():
                return [hp_sliding.hp_votes_scan(tree, x) for x in images]

            ms = cuda_ms(scan, iters=3, warmup=1)
            with twin_path():
                twin_ms = cuda_ms(scan, iters=1, warmup=0)
        result[route] = {"kernel": kernel, "launches": counts[kernel],
                         **stats, "pair_batch_ms": ms,
                         "pairs_per_s": HP_PAIRS / ms * 1e3,
                         "twin_pair_batch_ms": twin_ms,
                         "first_call_seconds": round(seconds, 3),
                         **vote_kernel_times(device, route)}
    emit({"phase": "hp_votes", "card": card, "pairs": HP_PAIRS,
          "columns": 1000, "features": GRU_F, "hidden": GRU_H, **result})
    return result


def vote_kernel_times(device, route):
    """A route's kernel time for one pair batch (2 haplotypes x 19 windows
    x 4 directions), from its launches at the scan's shapes queued behind
    a device sleep, beside the bound, the twin and cuDNN's torch.nn.GRU
    (for the recurrence, with W_ih = I on xw: an upper bound)."""
    import torch
    from pepper_tpu_torch.ops import gru_kernel

    gen = torch.Generator(device=device).manual_seed(37)
    windows = 2 * WINDOWS
    figures = {"kernel_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
               "cudnn_ms": 0.0}

    def add(kernel_ms, plain_ms, bound, cudnn, launches):
        for key, value in zip(figures, (kernel_ms, plain_ms, bound, cudnn)):
            figures[key] += windows * launches * value

    with torch.no_grad():
        if route == "fused":
            for layer in ("encoder", "decoder"):
                xs, ws, b_ih, w_hh, b_hh, h0 = gru_inputs(
                    gen, layer, HP_PAIRS, torch.float32, device)
                proj, rec_ops, nbytes = gru_work(layer, HP_PAIRS, 4, 4)
                gru = cudnn_gru(torch.cat(ws), b_ih, w_hh, b_hh, device)
                x_cat = torch.cat(xs, dim=-1)
                add(device_ms(lambda: gru_kernel.gru_direction_fused(
                        xs, ws, b_ih, w_hh, b_hh, h0)),
                    device_ms(lambda: gru_kernel.gru_direction_fused_reference(
                        xs, ws, b_ih, w_hh, b_hh, h0), iters=3),
                    bound_ms(proj + rec_ops, nbytes, PEAK_F32_FLOPS),
                    device_ms(lambda: gru(x_cat, h0[None])), 2)
        else:
            xw, w_hh, b_hh, h0 = recurrence_inputs(gen, HP_PAIRS,
                                                   torch.float32, device)
            r_bytes = 4 * (xw.numel() + w_hh.numel() + b_hh.numel()
                           + h0.numel() + GRU_T * HP_PAIRS * GRU_H)
            r_ops = 2 * GRU_T * HP_PAIRS * GRU_H * 3 * GRU_H
            gru = cudnn_gru(torch.eye(3 * GRU_H, device=device),
                            torch.zeros(3 * GRU_H, device=device), w_hh,
                            b_hh, device)
            add(device_ms(lambda: gru_kernel.gru_recurrence(xw, w_hh, b_hh,
                                                            h0)),
                device_ms(lambda: gru_kernel.gru_recurrence_reference(
                    xw, w_hh, b_hh, h0), iters=3),
                bound_ms(r_ops, r_bytes, PEAK_F32_FLOPS),
                device_ms(lambda: gru(xw, h0[None])), 4)
    return {f"{key}_per_pair_batch": value for key, value in figures.items()}


# ---------------------------------------------------------------- phase 19


# the runner's modes: (CLI compute dtype, quantize mode or None, the kernel
# each block launches 4 times, the bar against one device: phase 4's and
# phase 8's)
RUNNER_MODES = {
    "bfloat16": ("bfloat16", None, "lstm_direction_fused",
                 TRANSDUCER_BARS["bfloat16"]),
    "float32": ("float32", None, "lstm_direction_fused",
                TRANSDUCER_BARS["float32"]),
    "static": ("bfloat16", "static", "lstm_direction_fused_static",
               QUANTIZED_BARS["static"]),
    "static_rec": ("bfloat16", "static_rec", "lstm_direction_fused_static",
                   QUANTIZED_BARS["static_rec"]),
    "dynamic": ("bfloat16", "dynamic", "lstm_recurrence",
                QUANTIZED_BARS["dynamic"]),
}


def multi_devices():
    """Every local GPU, or where there is one, cuda:0 twice: the split,
    the per-device trees and the gather then run on the one card."""
    import torch

    n = torch.cuda.device_count()
    return [torch.device("cuda", i) for i in (range(n) if n > 1 else (0, 0))]


def counted(fn):
    """fn() with every kernel's count set to 0 just before and read just
    after: (its result, the non-zero counts by kernel)."""
    import torch

    wrappers = kernel_wrappers()
    for wrapper in wrappers.values():
        wrapper.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {k: w.launches for k, w in wrappers.items() if w.launches}


def wall_s(fn, iters=5):
    """Mean wall seconds of fn() after a warm-up call, the card idle
    before and after: what a caller of the entry point waits."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters


def multi_runner(device, devices):
    """InferenceRunner at B=4096 on the 33x26 transducer at full width,
    over `devices` against one device, in every mode of RUNNER_MODES:
    probabilities within the mode's bar, each block's four launches, and
    windows/s of each (predict_images' wall time: upload, forward and read
    back)."""
    import torch
    from pepper_tpu_torch.infer.runner import InferenceRunner
    from pepper_tpu_torch.models.transducer import init_transducer_params

    params = init_transducer_params(torch.Generator().manual_seed(7))
    host = {name: {k: v.numpy() for k, v in group.items()}
            for name, group in params.items()}
    images = np.random.RandomState(8).randint(
        -125, 126, (B_SERVE, T, 26)).astype(np.int8)
    result = {}
    for mode, (dtype, quantize_mode, kernel, bar) in RUNNER_MODES.items():
        kw = dict(batch_size=B_SERVE, compute_dtype=dtype,
                  quantized=quantize_mode is not None,
                  quantize_mode=quantize_mode or "static")
        one = InferenceRunner(host, device=device, **kw)
        multi = InferenceRunner(host, devices=devices, **kw)
        expected = one.predict_images(images)
        probs, launches = counted(lambda: multi.predict_images(images))
        check(launches == {kernel: 4 * len(devices)},
              f"multi-device runner {mode}: launches {launches}")
        check(probs.shape == expected.shape and np.isfinite(probs).all(),
              f"multi-device runner {mode}: {probs.shape}")
        err = float(np.abs(probs - expected).max())
        check(err <= bar, f"multi-device runner {mode}: max abs diff {err} "
              "from one device")
        one_s = wall_s(lambda: one.predict_images(images))
        multi_s = wall_s(lambda: multi.predict_images(images))
        result[mode] = {
            "max_abs_diff_from_one_device": err, "bar": bar,
            "argmax_agree": float((probs.argmax(1)
                                   == expected.argmax(1)).mean()),
            "launches": launches,
            "one_device_windows_per_s": B_SERVE / one_s,
            "multi_device_windows_per_s": B_SERVE / multi_s}
    return result


# call_variant's 1-deep loop over this many distinct batches: more than
# the pinned blocks it keeps in flight, so that the host allocator hands
# each block out again
LOOP_BATCHES = 8


def runner_loop(device, devices):
    """call_variant's drain on the card: dispatch batch k, then resolve
    batch k-1, over LOOP_BATCHES distinct batches of B_SERVE windows on
    `device` and over `devices`, in bfloat16 and float32.  Each batch's
    probabilities are bitwise predict_images' on it when resolved and again
    after the loop (no prediction a view of a pinned block handed out
    again); with the share of resolves that found their batch done, and
    the pinned blocks created after the loop's first two batches."""
    import torch
    from pepper_tpu_torch.infer.runner import InferenceRunner
    from pepper_tpu_torch.models.transducer import init_transducer_params
    from pepper_tpu_torch.ops.pileup_ref import CandidateWindow
    from pepper_tpu_torch.utils import profiling

    def blocks_created():
        return torch.cuda.host_memory_stats()["num_host_alloc"]

    params = init_transducer_params(torch.Generator().manual_seed(7))
    host = {name: {k: v.numpy() for k, v in group.items()}
            for name, group in params.items()}
    images = np.random.RandomState(9).randint(
        -125, 126, (LOOP_BATCHES, B_SERVE, T, 26)).astype(np.int8)
    batches = [[CandidateWindow("chr1", k * B_SERVE + i, 30, ["A"], [30],
                                images[k, i]) for i in range(B_SERVE)]
               for k in range(LOOP_BATCHES)]

    def held(preds, k, what):
        check([p.position for p in preds]
              == [w.position for w in batches[k]], f"{what}: positions")
        check(np.array_equal(np.stack([p.prediction_base for p in preds]),
                             expected[k]),
              f"{what}: not bitwise predict_images' probabilities")

    result = {}
    for dtype in ("bfloat16", "float32"):
        for name, where in (("one_device", {"device": device}),
                            ("devices", {"devices": devices})):
            what = f"runner loop {dtype} {name}"
            runner = InferenceRunner(host, batch_size=B_SERVE,
                                     compute_dtype=dtype, **where)
            expected = [runner.predict_images(batch) for batch in images]
            ready_before = profiling.resolve_ready()
            resolved, inflight = [], None
            for k, batch in enumerate(batches):
                if k == 2:
                    created = blocks_created()
                handle = runner.dispatch(batch)
                if inflight is not None:
                    resolved.append(runner.resolve(inflight))
                    held(resolved[-1], k - 1, f"{what}, batch {k - 1}")
                inflight = handle
            resolved.append(runner.resolve(inflight))
            created = blocks_created() - created
            for k, preds in enumerate(resolved):
                held(preds, k, f"{what}, batch {k} read again")
            ready, total = (now - then for now, then in
                            zip(profiling.resolve_ready(), ready_before))
            result[f"{dtype}_{name}"] = {
                "batches": total, "resolves_ready": ready,
                "pinned_blocks_created_after_two_batches": created}
    return result


def multi_call(device, devices, workdir, scene, threads=4):
    """call_variant on phase 9's scene with phase 9's weights and its
    cuda_bfloat16 arguments: --num_devices 1, the CLI's --num_devices -1
    (every local GPU), and the library call over `devices`; the call sets
    equal (up to the ALT order within a site, counted, as phase 9 holds
    bfloat16), each run launching only lstm_direction_fused, 4 a block."""
    from pepper_tpu_torch.cli import main as cli
    from pepper_tpu_torch.models.checkpoint import load_params
    from pepper_tpu_torch.pipeline.call_variant import call_variant
    from pepper_tpu_torch.presets import set_parameters

    bam, fasta = scene[:2]
    model = save_model(os.path.join(workdir, "model_multi.npz"),
                       call_params())

    def argv(name, *more):
        return ["call_variant", "-b", bam, "-f", fasta, "-m", model,
                "-o", os.path.join(workdir, name), "-t", str(threads),
                "--region_size", "10000", "--ont_r9_guppy5_sup",
                "--compute_dtype", "bfloat16", "--device", str(device),
                *more]

    def library():
        args = cli.build_parser().parse_args(argv("library_devices"))
        options = set_parameters(cli.options_from_args(args))
        params, _ = load_params(model)
        return call_variant(options, params=params, devices=devices)

    runs = {"one_device": lambda: cli.main(argv("one_device",
                                                "--num_devices", "1")),
            "cli_num_devices_all": lambda: cli.main(argv(
                "cli_num_devices_all", "--num_devices", "-1")),
            "library_devices": library}
    result = {}
    with mock.patch.dict(os.environ, {"PEPPER_LSTM_DUAL": "0"}):
        for name, run in runs.items():
            t0 = time.time()
            _, launches = counted(run)
            n = launches.get("lstm_direction_fused", 0)
            check(set(launches) == {"lstm_direction_fused"} and n % 4 == 0,
                  f"call_variant {name}: launches {launches}")
            result[name] = {"seconds": round(time.time() - t0, 3),
                            "launches": launches,
                            "calls": call_set(os.path.join(workdir, name))}
    expected = result["one_device"]["calls"]
    check(len(expected) > 0, "no calls on one device")
    for name in ("cli_num_devices_all", "library_devices"):
        calls = result[name]["calls"]
        result[name]["alt_order_only"] = len(calls - expected)
        check(canonical_calls(calls) == canonical_calls(expected),
              f"call_variant {name}: calls differ from one device's: "
              f"{sorted(canonical_calls(calls) ^ canonical_calls(expected))[:10]}")
    for run in result.values():
        run["calls"] = len(run["calls"])
    return result


def multi_polish(device, devices, workdir, scene, threads=4):
    """consensus_predict on B_POLISH chunks and predict_hp on HP_PAIRS
    pairs (phase 18's inputs) over `devices` against one device: labels,
    phred and x10000 votes equal, 76 launches a block of a batch; chunks/s
    and pairs/s of each; and the polish CLI with --num_devices -1 and the
    library polish over `devices` on phase 12's scene: phase 12's cuda
    float32 FASTA bytes (a --num_devices 1 run here)."""
    import torch
    from pepper_tpu_torch.cli import polish_main
    from pepper_tpu_torch.infer import hp_sliding
    from pepper_tpu_torch.models.checkpoint import load_params, save_params
    from pepper_tpu_torch.models.polish_gru import init_polish_params
    from pepper_tpu_torch.options import PepperOptions
    from pepper_tpu_torch.polish import consensus, pipeline

    result = {}
    host, _ = polish_trees("cpu")
    chunks = np.random.RandomState(17).randint(
        0, 41, (B_POLISH, 1000, GRU_F)).astype(np.uint8)

    def predict(**where):
        return consensus.consensus_predict(host, chunks, batch_size=B_POLISH,
                                           **where)

    expected = predict(device=device)
    (labels, phred), launches = counted(lambda: predict(devices=devices))
    check(launches == {"gru_direction_fused":
                       LAUNCHES_PER_BATCH * len(devices)},
          f"multi-device consensus: launches {launches}")
    check(np.array_equal(labels, expected[0]),
          f"multi-device consensus: {(labels != expected[0]).sum()} labels "
          "differ from one device's")
    phred_diff = float(np.abs(phred - expected[1]).max())
    check(phred_diff == 0.0, f"multi-device consensus: phred {phred_diff}")
    result["consensus"] = {
        "chunks": B_POLISH, "launches": launches,
        "one_device_chunks_per_s": B_POLISH / wall_s(
            lambda: predict(device=device), iters=3),
        "multi_device_chunks_per_s": B_POLISH / wall_s(
            lambda: predict(devices=devices), iters=3)}

    hp_host = {name: {k: v.numpy() for k, v in group.items()}
               for name, group in init_polish_params(
                   torch.Generator().manual_seed(19)).items()}
    rng = np.random.RandomState(29)
    pair = [rng.randint(0, 41, (HP_PAIRS, 1000, GRU_F)).astype(np.float32)
            for _ in range(2)]
    one_votes = hp_sliding.predict_hp(hp_host, *pair, device=device)
    votes, launches = counted(lambda: hp_sliding.predict_hp(
        hp_host, *pair, devices=devices))
    check(launches == {"gru_direction_fused":
                       2 * LAUNCHES_PER_BATCH * len(devices)},
          f"multi-device predict_hp: launches {launches}")
    for ours, theirs in zip(votes, one_votes):
        check(np.array_equal(ours, theirs),
              "multi-device predict_hp: votes differ from one device's")
    result["hp_votes"] = {
        "pairs": HP_PAIRS, "launches": launches,
        "one_device_pairs_per_s": HP_PAIRS / wall_s(
            lambda: hp_sliding.predict_hp(hp_host, *pair, device=device),
            iters=3),
        "multi_device_pairs_per_s": HP_PAIRS / wall_s(
            lambda: hp_sliding.predict_hp(hp_host, *pair, devices=devices),
            iters=3)}

    bam, fasta = scene[:2]
    model = os.path.join(workdir, "polish_multi.npz")
    save_params(model, host, {})

    def cli_run(name, *more):
        return lambda: polish_main.main(
            ["polish", "-b", bam, "-f", fasta, "-m", model,
             "-o", os.path.join(workdir, name), "-t", str(threads),
             "--batch_size", str(B_POLISH), "--device", str(device), *more])

    def library():
        # one worker: its one share of every chunk splits over the devices
        # (several shares of fewer chunks than a block would fill only the
        # first device's block)
        options = PepperOptions(
            bam=bam, fasta=fasta, output_dir=os.path.join(
                workdir, "polish_library_devices"), threads=1,
            batch_size=B_POLISH)
        return pipeline.polish(options, load_params(model)[0],
                               devices=devices)

    runs = {"polish_one_device": cli_run("polish_one_device",
                                         "--num_devices", "1"),
            "polish_cli_num_devices_all": cli_run(
                "polish_cli_num_devices_all", "--num_devices", "-1"),
            "polish_library_devices": library}
    fastas = {}
    for name, run in runs.items():
        t0 = time.time()
        _, launches = counted(run)
        n = launches.get("gru_direction_fused", 0)
        check(set(launches) == {"gru_direction_fused"}
              and n % LAUNCHES_PER_BATCH == 0,
              f"{name}: launches {launches}")
        with open(os.path.join(workdir, name,
                               "consensus_pepper_polished.fa"), "rb") as f:
            fastas[name] = f.read()
        result[name] = {"seconds": round(time.time() - t0, 3),
                        "launches": launches}
    for name in ("polish_cli_num_devices_all", "polish_library_devices"):
        check(fastas[name] == fastas["polish_one_device"],
              f"{name}: FASTA differs from the one-device run's")
    launched = result["polish_library_devices"]["launches"][
        "gru_direction_fused"]
    check(launched % (LAUNCHES_PER_BATCH * len(devices)) == 0,
          f"polish over {len(devices)} devices: {launched} launches, not a "
          "block on each device")
    return result


def staged_and_sharded(device, workdir, scene, polish_scene, threads=4):
    """Where h5py is installed: the staged variant flow (make_images ->
    run_inference -> find_candidates, the CLI's float32 runner as the JAX
    package's) and the staged polish flow (make_images -> call_consensus
    -> stitch) against their one-process runs, and call_variant --sharded
    in two gloo processes, both on cuda:0, against the one-process float32
    call set."""
    import socket

    from pepper_tpu_torch.cli import main as cli
    from pepper_tpu_torch.cli import polish_main

    bam, fasta = scene[:2]
    model = save_model(os.path.join(workdir, "model_staged.npz"),
                       call_params())
    d = str(device)
    common = ["-f", fasta, "-t", str(threads), "--ont_r9_guppy5_sup"]
    region = ["-b", bam, "--region_size", "10000"]
    out = {name: os.path.join(workdir, name)
           for name in ("images", "predictions", "staged", "one_f32",
                        "sharded", "polish_images", "polish_predictions",
                        "polish_staged", "polish_one")}
    result = {}
    t0 = time.time()
    check(cli.main(["make_images", *region, *common,
                    "-o", out["images"]]) == 0, "make_images failed")
    _, launches = counted(lambda: cli.main(
        ["run_inference", "-i", out["images"], "-o", out["predictions"],
         "-m", model, "--device", d]))
    check(set(launches) == {"lstm_direction_fused"},
          f"run_inference: launches {launches}")
    check(cli.main(["find_candidates", "-i", out["predictions"],
                    "-o", out["staged"], *common]) == 0,
          "find_candidates failed")
    check(cli.main(["call_variant", *region, *common, "-m", model,
                    "-o", out["one_f32"], "--compute_dtype", "float32",
                    "--num_devices", "1", "--device", d]) == 0,
          "call_variant float32 failed")
    expected = call_set(out["one_f32"])
    check(len(expected) > 0 and call_set(out["staged"]) == expected,
          "the staged variant flow's calls differ from one process's")
    result["staged_variant"] = {"seconds": round(time.time() - t0, 3),
                                "calls": len(expected),
                                "run_inference_launches": launches}

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t0 = time.time()
    argv = [sys.executable, "-m", "pepper_tpu_torch.cli.main",
            "call_variant", "--sharded", *region, *common, "-m", model,
            "-o", out["sharded"], "--num_devices", "1", "--device", d]
    procs = [subprocess.Popen(argv, cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT,
                              env=dict(os.environ, RANK=str(rank),
                                       WORLD_SIZE="2", LOCAL_RANK=str(rank),
                                       MASTER_ADDR="127.0.0.1",
                                       MASTER_PORT=str(port),
                                       OMP_NUM_THREADS="1"))
             for rank in (0, 1)]
    try:
        logs = [proc.communicate(timeout=300)[0].decode() for proc in procs]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for rank, (proc, log) in enumerate(zip(procs, logs)):
        check(proc.returncode == 0,
              f"--sharded rank {rank} failed: {log[-2000:]}")
    files = sorted(os.listdir(os.path.join(out["sharded"], "predictions")))
    check(files == ["pepper_prediction_0.hdf", "pepper_prediction_1.hdf"],
          f"--sharded prediction files {files}")
    check(call_set(out["sharded"]) == expected,
          "--sharded calls differ from one process's")
    result["sharded_two_processes"] = {
        "seconds": round(time.time() - t0, 3), "calls": len(expected)}

    bam, fasta = polish_scene[:2]
    host, _ = polish_trees("cpu")
    from pepper_tpu_torch.models.checkpoint import save_params

    pmodel = os.path.join(workdir, "polish_staged.npz")
    save_params(pmodel, host, {})
    pcommon = ["-b", bam, "-f", fasta, "-t", str(threads), "--batch_size",
               str(B_POLISH)]
    t0 = time.time()
    check(polish_main.main(["make_images", *pcommon,
                            "-o", out["polish_images"]]) == 0,
          "polish make_images failed")
    _, launches = counted(lambda: polish_main.main(
        ["call_consensus", *pcommon, "-i", out["polish_images"],
         "-o", out["polish_predictions"], "-m", pmodel, "--device", d]))
    check(set(launches) == {"gru_direction_fused"},
          f"call_consensus: launches {launches}")
    check(polish_main.main(["stitch", "-i", out["polish_predictions"],
                            "-o", out["polish_staged"]]) == 0,
          "stitch failed")
    check(polish_main.main(["polish", *pcommon, "-m", pmodel,
                            "-o", out["polish_one"], "--num_devices", "1",
                            "--device", d]) == 0, "polish failed")
    fastas = []
    for name in ("polish_staged", "polish_one"):
        with open(os.path.join(out[name], "consensus_pepper_polished.fa"),
                  "rb") as f:
            fastas.append(f.read())
    check(fastas[0] == fastas[1],
          "the staged polish FASTA differs from one process's")
    result["staged_polish"] = {"seconds": round(time.time() - t0, 3),
                               "call_consensus_launches": launches}
    return result


def phase_multi_device(device, card):
    """Every data-parallel path of the port over all local GPUs (cuda:0
    twice where there is one): the runner, call_variant, the consensus,
    predict_hp and polish against one device, with the kernels launched on
    the card; and, where h5py is installed, the staged and sharded flows
    (decided before the phase: without it one skip line is printed)."""
    import importlib.util

    import torch

    devices = multi_devices()
    has_h5py = importlib.util.find_spec("h5py") is not None
    if not has_h5py:
        emit({"phase": "staged", "skipped": "h5py not installed"})
    result = {"devices": [str(d) for d in devices],
              "device_count": torch.cuda.device_count(),
              "runner": multi_runner(device, devices),
              "runner_loop": runner_loop(device, devices)}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        scene = write_scene(workdir)
        polish_scene = write_polish_scene(workdir)
        result["call"] = multi_call(device, devices, workdir, scene)
        result.update(multi_polish(device, devices, workdir, polish_scene))
        result["staged"] = (
            staged_and_sharded(device, workdir, scene, polish_scene)
            if has_h5py else "skipped: h5py not installed")
    emit({"phase": "multi_device", "card": card, **result})
    return result


# ---------------------------------------------------------------- phase 20

# the step checks: three Adam steps of each model on one seeded batch, in
# float64.  In float32 a last-bit difference moves a SELU pre-activation
# across 0, where SELU's slope jumps from 1.76 to 1.05: at B=4096 one such
# row in 10^7 pre-activations puts whole leaves 5e-4 to 6e-3 of their
# largest gradient apart, cuda against cpu (PERF.md, section 6); and near
# g = 0 Adam's first step is +-lr whatever g's size.  float64 takes both
# below the bars; the float32 path is held end to end by the training run.
TRAIN_STEP_MODELS = ("lstm", "hp", "no_cnn", "transformer")
# cut from 4096 to 1024 to keep the whole script within half its time
# limit once phase 21 came
TRAIN_STEP_B = 1024
TRAIN_LR, TRAIN_WD = 1e-4, 1e-4
# tests/test_trained_e2e.py's recipe, at full width
TRAIN_EPOCHS = 30
TRAIN_BATCH = 32
TRAIN_CONTIG = "chr20"

TRAIN_WORKER = r'''
import sys
import numpy as np
sys.path.insert(0, {root!r})
from pepper_tpu_torch.options import PepperOptions
from pepper_tpu_torch.parallel import dist
from pepper_tpu_torch.train.trainer import train_on_arrays

rank = int(sys.argv[1])
assert dist.init_distributed({address!r}, 2, rank) == (rank, 2)
arrays = np.load({arrays!r})
train_on_arrays(PepperOptions(batch_size={batch}), arrays["images"],
                arrays["labels"], {out!r} + ("" if rank == 0 else "_rank1"),
                devices=[{device!r}], **{kwargs!r})
dist.shutdown_distributed()
'''


def train_step_model(name):
    """Phase 20's seeded full-width params of `name` (lstm, its HP 48x21
    twin, no_cnn, transformer), its logits function for the train step
    (None: the transducer's) and its window shape."""
    import torch
    from pepper_tpu_torch.models.registry import make_family
    from pepper_tpu_torch.models.transducer import (TransducerConfig,
                                                    init_transducer_params)

    generator = torch.Generator().manual_seed(21)
    if name in ("lstm", "hp"):
        config = (TransducerConfig(image_features=48, window=21)
                  if name == "hp" else TransducerConfig())
        return (init_transducer_params(generator, config), None,
                (config.window, config.image_features))
    family = make_family(name)

    def logits(params, x, train, _):
        return family.logits(params, x, train, None)   # dropout 0

    return family.init(generator), logits, (33, 26)


def train_steps(name, device, B=TRAIN_STEP_B, steps=3, dtype="float64"):
    """`steps` Adam steps (TRAIN_LR, TRAIN_WD, dropout 0) of model `name`
    in `dtype` on one seeded batch of B windows on `device`: (the losses,
    each step's gradients, the params after, the largest move of a param),
    host arrays keyed by path."""
    import torch
    from pepper_tpu_torch.models.params import map_params
    from pepper_tpu_torch.train import step, trainer

    tree, logits_fn, (window, features) = train_step_model(name)
    tree = map_params(lambda p: p.to(getattr(torch, dtype)), tree)
    rng = np.random.RandomState(22)
    images = rng.randint(-40, 41, (B, window, features)).astype(dtype)
    labels = rng.randint(0, 3, B).astype(np.int32)
    mask = np.ones(B, dtype)
    params = trainer.trainable_params(tree, device)
    trainable = [(path, leaf) for path, leaf in step.leaves(params)
                 if leaf.requires_grad]
    optimizer = torch.optim.Adam([leaf for _, leaf in trainable],
                                 lr=TRAIN_LR, weight_decay=TRAIN_WD)
    train_step = step.make_train_step(optimizer, dropout_rate=0.0,
                                      logits_fn=logits_fn)
    losses, grads = [], []
    for _ in range(steps):
        losses.append(train_step(params, images, labels, None, mask)["loss"])
        grads.append({"/".join(path): leaf.grad.detach().cpu().clone()
                      .numpy() for path, leaf in trainable})
    moved = max(float((leaf.detach().cpu() - torch.as_tensor(init)).abs()
                      .max()) for (_, leaf), (_, init)
                in zip(step.leaves(params), step.leaves(tree)))
    return losses, grads, {"/".join(path): leaf.detach().cpu().clone()
                           .numpy() for path, leaf in step.leaves(params)}, \
        moved


def compare_train_steps(name, ours, cpu):
    """Phase 20's bars for one model's steps on the card against the CPU:
    the loss rtol 1e-5, each gradient leaf within 2e-4 of its largest
    magnitude, the params after the steps atol 1e-5; and on both, n steps
    moved a param by at least (n - 0.5) lr (the Adam steps were applied:
    each moves a param whose gradient keeps its sign by lr)."""
    losses, grads, params, moved = ours
    cpu_losses, cpu_grads, cpu_params, cpu_moved = cpu
    for where, value in (("cuda", moved), ("cpu", cpu_moved)):
        check(value >= (len(losses) - 0.5) * TRAIN_LR,
              f"{name} on {where}: the steps "
              f"moved a param by {value} at most")
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, cpu_losses))
    grad_rel = max(float(np.abs(g[k] - c[k]).max())
                   / max(float(np.abs(c[k]).max()), 1e-30)
                   for g, c in zip(grads, cpu_grads) for k in c)
    param_abs = max(float(np.abs(params[k] - cpu_params[k]).max())
                    for k in cpu_params)
    check(loss_rel <= 1e-5, f"{name}: loss rel diff {loss_rel}")
    check(grad_rel <= 2e-4, f"{name}: gradient diff {grad_rel} of max")
    check(param_abs <= 1e-5, f"{name}: params differ by {param_abs}")
    return {"loss_rel": loss_rel, "grad_rel_of_max": grad_rel,
            "params_abs": param_abs, "moved": moved, "losses": losses}


def float32_step_diffs(ours, cpu):
    """Each leaf's largest gradient difference of one float32 step, cuda
    against cpu, over the leaf's largest gradient (measured, not held to a
    bar: module docstring, phase 20)."""
    grads, cpu_grads = ours[1][0], cpu[1][0]
    return {k: float(np.abs(grads[k] - c).max())
            / max(float(np.abs(c).max()), 1e-30)
            for k, c in cpu_grads.items()}


def write_train_genome(directory, seed, n_snps, n_noise=None, length=6000):
    """tests/test_trained_e2e.py's genome with the port's writers: SNPs on
    a 40 bp grid (every third homozygous), a low-coverage population of
    reads carrying other sites' "systematic errors" (hom-ref candidates
    at ~13% VAF), 300 bp reads every 25 bp of each haplotype and every 80
    of the noise, and its truth VCF and BED."""
    from pepper_tpu_torch.io.bam_writer import (BamRecord, write_bam,
                                                write_fasta)

    rng = np.random.RandomState(seed)
    ref = "".join("ACGT"[i] for i in rng.randint(0, 4, length))

    def alt_base(pos):
        return {"A": "T", "T": "A", "C": "G", "G": "C"}[ref[pos]]

    n_noise = n_snps if n_noise is None else n_noise
    chosen = rng.choice(np.arange(300, length - 300, 40),
                        size=n_snps + n_noise, replace=False)
    variants = [(int(p), ref[p], alt_base(p), "1|1" if i % 3 == 0 else "1|0")
                for i, p in enumerate(sorted(int(p) for p in chosen[:n_snps]))]
    noise = [(int(p), ref[p], alt_base(p))
             for p in sorted(int(p) for p in chosen[n_snps:])]
    haplotypes = ([v[:3] for v in variants],
                  [v[:3] for v in variants if v[3] == "1|1"], noise)
    records, count = [], 0
    for hap_index, (hap, stride) in enumerate(zip(haplotypes, (25, 25, 80))):
        for start in range(0, length - 300 + 1, stride):
            seq, cigar = _cigar_read(ref, hap, start, 300)
            records.append(BamRecord(
                name=f"t{seed}_{hap_index}_{count}", ref_id=0, pos=start,
                mapq=60, cigar=cigar, seq=seq, qual=[30] * len(seq),
                flag=0x10 if count % 2 else 0))
            count += 1
    records.sort(key=lambda r: r.pos)
    stem = os.path.join(directory, f"train_{seed}")
    write_bam(stem + ".bam", [(TRAIN_CONTIG, length)], records)
    write_fasta(stem + ".fa", {TRAIN_CONTIG: ref})
    lines = ["##fileformat=VCFv4.2",
             f"##contig=<ID={TRAIN_CONTIG},length={length}>",
             "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tsample"]
    lines += [f"{TRAIN_CONTIG}\t{p + 1}\t.\t{r}\t{a}\t60\tPASS\t.\tGT\t{g}"
              for p, r, a, g in variants]
    with open(stem + ".vcf", "w") as f:
        f.write("\n".join(lines) + "\n")
    return dict(bam=stem + ".bam", fasta=stem + ".fa", truth=stem + ".vcf",
                length=length, variants=variants)


def train_windows(genome):
    """The labeled windows of a genome from the port's summarizer in train
    mode, in memory (random_draw_probability 1.0): (images float32, type
    labels int32)."""
    from pepper_tpu_torch.io.bam import BamReader
    from pepper_tpu_torch.io.fasta import FastaReader
    from pepper_tpu_torch.options import PepperOptions
    from pepper_tpu_torch.pipeline.regions import build_intervals
    from pepper_tpu_torch.pipeline.summarizer import create_region_summary
    from pepper_tpu_torch.presets import set_parameters

    options = set_parameters(PepperOptions(
        bam=genome["bam"], fasta=genome["fasta"], ont_r9_guppy5_sup=True,
        sub_command="make_train_images", train_mode=True,
        truth_vcf=genome["truth"], random_draw_probability=1.0,
        region=TRAIN_CONTIG, threads=1))
    bam, fasta = BamReader(genome["bam"]), FastaReader(genome["fasta"])
    intervals, _ = build_intervals([(TRAIN_CONTIG, None)], fasta,
                                   options.region_size, train_mode=True)
    bed = {TRAIN_CONTIG: [[0, genome["length"]]]}
    windows = [w for contig, start, end in intervals
               for w in create_region_summary(options, bam, fasta, contig,
                                              start, end, bed) or ()]
    return (np.stack([w.image for w in windows]).astype(np.float32),
            np.array([w.type_label for w in windows], np.int32))


def train_genome_calls(device, workdir, genome, model):
    """call_variant with the trained model on the unseen genome: cuda
    bfloat16 (the default) and float32 against cpu float32, by phase 9's
    rules; the cpu set recovers every simulated variant, all but at most
    one genotype right, and calls no other site."""
    table = [(*run, model) for run in CALL_RUNS
             if run[0] in ("cuda_bfloat16", "cuda_float32", "cpu_float32")]
    runs, launches = run_calls(device, workdir, (genome["bam"],
                                                 genome["fasta"]), table)
    alt_order_only, _ = check_calls(runs, launches, table)
    calls = {pos: (ref, alt, gt)
             for pos, ref, alt, gt in runs["cpu_float32"]["calls"]}
    recovered = genotypes = 0
    for pos, ref, alt, genotype in genome["variants"]:
        if calls.get(pos + 1, (None, None))[:2] == (ref, alt):
            recovered += 1
            genotypes += calls[pos + 1][2] == (
                "1/1" if genotype == "1|1" else "0/1")
    truth = {pos + 1 for pos, *_ in genome["variants"]}
    false = sorted(pos for pos, (_, _, gt) in calls.items()
                   if gt not in ("0/0", "./.") and pos not in truth)
    n = len(genome["variants"])
    check(recovered == n, f"recovered {recovered}/{n} variants")
    check(genotypes >= recovered - 1, f"{genotypes}/{n} genotypes right")
    check(not false, f"false positives at {false}")
    return {"variants": n, "recovered": recovered, "genotypes": genotypes,
            "alt_order_only_differences": alt_order_only,
            "launches": {k: v for k, v in launches.items()
                         if k.startswith("cuda")},
            "seconds": {k: v["seconds"] for k, v in runs.items()}}


def held_out_confusion(device, params, meta, images, labels):
    """test_model's arrays entry on the held-out windows on cuda and cpu:
    equal confusion matrices but at windows whose cpu top-two logits lie
    within 1e-4 (counted); row 1 launched 4 times a batch."""
    import torch
    from pepper_tpu_torch.models.params import params_from_jax
    from pepper_tpu_torch.models.transducer import transducer_logits
    from pepper_tpu_torch.options import PepperOptions
    from pepper_tpu_torch.train import trainer

    options = PepperOptions(batch_size=TRAIN_BATCH)
    (loss, confusion, accuracy), launches = counted(
        lambda: trainer.test_on_arrays(options, images, labels, params, meta,
                                       device=device))
    batches = -(-len(images) // TRAIN_BATCH)
    check(launches == {"lstm_direction_fused": 4 * batches},
          f"test_model launched {launches} for {batches} batches")
    cpu_loss, cpu_confusion, cpu_accuracy = trainer.test_on_arrays(
        options, images, labels, params, meta, device="cpu")
    with torch.inference_mode():
        logits = {d: transducer_logits(
            params_from_jax(params, d),
            torch.from_numpy(images).to(d)).float().cpu().numpy()
            for d in (device, "cpu")}
    top2 = np.sort(logits["cpu"], axis=1)[:, -2:]
    preds = {d: v.argmax(axis=1) for d, v in logits.items()}
    differ = np.flatnonzero(preds[device] != preds["cpu"])
    near = np.diff(top2, axis=1)[:, 0] <= 1e-4
    check(near[differ].all(), "test_model predictions differ at windows "
          f"whose cpu top-two logits are apart: {differ[~near[differ]]}")
    expected = cpu_confusion.copy()
    for i in differ:
        expected[labels[i], preds["cpu"][i]] -= 1
        expected[labels[i], preds[device][i]] += 1
    check(np.array_equal(confusion, expected),
          f"test_model confusion {confusion.tolist()} on cuda, "
          f"{cpu_confusion.tolist()} on cpu")
    return {"windows": len(images), "accuracy": accuracy,
            "cpu_accuracy": cpu_accuracy, "loss": loss, "cpu_loss": cpu_loss,
            "near_tied_windows": int(near.sum()),
            "predictions_differing": len(differ),
            "confusion": confusion.tolist(), "launches": launches}


def two_process_train(device, workdir, images, labels, kwargs):
    """train_on_arrays in two gloo processes on `device` (cuda:0) from the
    arrays (an .npz) against one process over [device, device] (the same
    global device count): final params within 2e-4
    (tests/test_multihost.py:89-90), and rank 1 writes nothing."""
    import socket

    from pepper_tpu_torch.options import PepperOptions
    from pepper_tpu_torch.train import trainer

    arrays = os.path.join(workdir, "train_arrays.npz")
    np.savez(arrays, images=images, labels=labels)
    out = os.path.join(workdir, "two_process")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    script = TRAIN_WORKER.format(root=ROOT, address=f"127.0.0.1:{port}",
                                 arrays=arrays, batch=TRAIN_BATCH, out=out,
                                 device=str(device), kwargs=kwargs)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(key, None)
    t0 = time.time()
    procs = [subprocess.Popen([sys.executable, "-c", script, str(rank)],
                              cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, env=env)
             for rank in (0, 1)]
    try:
        logs = [proc.communicate(timeout=300)[0].decode() for proc in procs]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for rank, (proc, log) in enumerate(zip(procs, logs)):
        check(proc.returncode == 0, f"train rank {rank} failed:\n"
              f"{log[-3000:]}")
    seconds = time.time() - t0
    check(os.listdir(out + "_rank1") == [], "rank 1 wrote "
          f"{os.listdir(out + '_rank1')}")
    one = os.path.join(workdir, "one_process")
    trainer.train_on_arrays(PepperOptions(batch_size=TRAIN_BATCH), images,
                            labels, one, devices=[device, device], **kwargs)
    final = [np.load(os.path.join(d, "pepper_model_final.npz"))
             for d in (out, one)]
    keys = sorted(k for k in final[1].files if k != "__meta__")
    check(keys == sorted(k for k in final[0].files if k != "__meta__"),
          "the two runs' checkpoints hold different leaves")
    diff = max(float(np.abs(final[0][k] - final[1][k]).max()) for k in keys)
    check(diff <= 2e-4, f"two processes' params differ by {diff}")
    return {"params_max_abs_diff": diff, "seconds": round(seconds, 3)}


def train_rates(device, B, iters):
    """The trainer's step (dropout 0.2 drawn over the batch) at B windows:
    steps/s and windows/s (wall time, the card idle before and after), and
    the split of a step into forward (logits and loss), backward and the
    Adam step, by CUDA events around each."""
    import torch
    from pepper_tpu_torch.models.transducer import (init_transducer_params,
                                                    transducer_logits)
    from pepper_tpu_torch.train import step, trainer

    params = trainer.trainable_params(
        init_transducer_params(torch.Generator().manual_seed(23)), device)
    leaves = [leaf for _, leaf in step.leaves(params)]
    optimizer = torch.optim.Adam(leaves, lr=TRAIN_LR, weight_decay=TRAIN_WD)
    rng = np.random.RandomState(24)
    images = rng.randint(-40, 41, (B, 33, 26)).astype(np.float32)
    labels = rng.randint(0, 3, B).astype(np.int32)
    mask = np.ones(B, np.float32)
    generator = torch.Generator(device=device).manual_seed(2)
    train_step = step.make_train_step(optimizer)
    seconds = wall_s(lambda: train_step(params, images, labels, generator,
                                        mask), iters)
    x = torch.from_numpy(images).to(device)
    y = torch.from_numpy(labels).to(device)
    m = torch.from_numpy(mask).to(device)
    split = {"forward_ms": 0.0, "backward_ms": 0.0, "optimizer_ms": 0.0}
    for _ in range(iters):
        events = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        torch.cuda.synchronize()
        events[0].record()
        logits = transducer_logits(params, x, train=True, generator=(
            step.GlobalDropout(generator, B)))
        loss = step.cross_entropy_sum(logits, y, m)
        events[1].record()
        grads = torch.autograd.grad(loss, leaves)
        events[2].record()
        for leaf, grad in zip(leaves, grads):
            leaf.grad = grad
        optimizer.step()
        events[3].record()
        events[3].synchronize()
        for key, (a, b) in zip(split, zip(events, events[1:])):
            split[key] += a.elapsed_time(b) / iters
    return {"B": B, "step_ms": seconds * 1e3, "steps_per_s": 1 / seconds,
            "windows_per_s": B / seconds, **split}


def eval_rate(device, iters=5):
    """The eval step at B=4096 through row 1's float32 kernel: windows/s
    (wall time) and launches per batch."""
    import torch
    from pepper_tpu_torch.models.transducer import init_transducer_params
    from pepper_tpu_torch.train import step, trainer

    params = trainer.trainable_params(
        init_transducer_params(torch.Generator().manual_seed(23)), device)
    rng = np.random.RandomState(25)
    images = rng.randint(-40, 41, (B_SERVE, 33, 26)).astype(np.float32)
    labels = rng.randint(0, 3, B_SERVE).astype(np.int32)
    mask = np.ones(B_SERVE, np.float32)
    eval_step = step.make_eval_step()
    _, launches = counted(lambda: eval_step(params, images, labels, mask))
    check(launches == {"lstm_direction_fused": 4},
          f"an eval batch launched {launches}")
    seconds = wall_s(lambda: eval_step(params, images, labels, mask), iters)
    return {"B": B_SERVE, "batch_ms": seconds * 1e3,
            "windows_per_s": B_SERVE / seconds, "launches": launches}


def _cpu_steps_worker() -> None:
    """A CPU reference process of phase 20: 4 threads, below the card's
    host process in priority."""
    import torch

    os.nice(10)
    torch.set_num_threads(4)


def phase_train(device, card):
    """Variant-side training at full width on the card (module docstring,
    phase 20); returns the training eval's row-1 launches."""
    import concurrent.futures
    import multiprocessing

    import torch
    from pepper_tpu_torch.models.checkpoint import load_params
    from pepper_tpu_torch.options import PepperOptions
    from pepper_tpu_torch.train import trainer

    t0 = time.time()
    # the rates first, with the host otherwise idle
    result = {"card": card,
              "rates": [train_rates(device, B, iters)
                        for B, iters in ((128, 20), (B_SERVE, 5))],
              "eval": eval_rate(device)}
    # the CPU's reference steps, in two processes (the dearest first),
    # while the card works
    pool = concurrent.futures.ProcessPoolExecutor(
        2, mp_context=multiprocessing.get_context("spawn"),
        initializer=_cpu_steps_worker)
    cpu_start, cpu_done = time.time(), {}
    try:
        cpu_steps = {name: pool.submit(train_steps, name, "cpu")
                     for name in ("lstm", "transformer", "hp", "no_cnn")}
        cpu_steps["lstm_float32"] = pool.submit(
            train_steps, "lstm", "cpu", steps=1, dtype="float32")
        for name, future in cpu_steps.items():
            future.add_done_callback(
                lambda _, name=name: cpu_done.setdefault(
                    name, round(time.time() - cpu_start, 3)))
        card_steps = {}
        for name in TRAIN_STEP_MODELS:
            card_steps[name], launches = counted(
                lambda: train_steps(name, device))
            check(not launches, f"{name} train steps launched {launches}")
        card_steps["lstm_float32"] = train_steps(
            "lstm", device, steps=1, dtype="float32")

        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
            genome = write_train_genome(workdir, seed=101, n_snps=150,
                                        n_noise=250, length=40000)
            unseen = write_train_genome(workdir, seed=202, n_snps=8)
            images, labels = train_windows(genome)
            out = os.path.join(workdir, "train_run")
            kwargs = dict(learning_rate=3e-4, step_size=10_000,
                          batch_size=TRAIN_BATCH, holdout_fraction=0.15,
                          seed=0)
            start = time.time()
            (_, accuracy), launches = counted(
                lambda: trainer.train_on_arrays(
                    PepperOptions(batch_size=TRAIN_BATCH), images, labels,
                    out, epochs=TRAIN_EPOCHS, device=device, **kwargs))
            train_s = time.time() - start
            n_test = max(1, int(len(images) * 0.15))
            eval_batches = -(-n_test // TRAIN_BATCH)
            check(launches == {"lstm_direction_fused": 4 * eval_batches},
                  f"training launched {launches}; its one eval has "
                  f"{eval_batches} batches")
            check(accuracy >= 90.0, f"held-out accuracy {accuracy} < 90%")
            result["training"] = {
                "windows": len(images), "labels": np.bincount(
                    labels, minlength=3).tolist(),
                "held_out": n_test, "epochs": TRAIN_EPOCHS,
                "batch": TRAIN_BATCH, "accuracy": accuracy,
                "seconds_beside_cpu_steps": round(train_s, 3),
                "launches": launches}
            best = os.path.join(out, "pepper_model_best.npz")
            result["call"] = train_genome_calls(device, workdir, unseen, best)
            order = np.random.RandomState(0).permutation(len(images))
            held = order[:n_test]
            params, meta = load_params(best)
            result["test_model"] = held_out_confusion(
                device, params, meta, images[held], labels[held])
            result["two_process"] = two_process_train(
                device, workdir, images, labels, dict(kwargs, epochs=1))
        card_s = round(time.time() - cpu_start, 3)
        result["steps"] = {name: compare_train_steps(
            name, card_steps[name], cpu_steps[name].result())
            for name in TRAIN_STEP_MODELS}
        diffs = float32_step_diffs(card_steps["lstm_float32"],
                                   cpu_steps["lstm_float32"].result())
        result["float32_step_grad_rel_of_max"] = {
            "worst": max(diffs.values()), "by_leaf": diffs}
        # the card's part against the CPU steps' (each model's end)
        result["step_seconds"] = {"card": card_s, "cpu_done": cpu_done}
    finally:
        pool.shutdown(cancel_futures=True)
    result["seconds"] = round(time.time() - t0, 3)
    emit({"phase": "train", **result})
    torch.cuda.synchronize()
    return result["training"]["launches"]["lstm_direction_fused"]


# ---------------------------------------------------------------- phase 21

# tests/test_polish_train_e2e.py's recipe (a 14 kb draft, lr 1e-3, batch 8,
# holdout 0.15, 6 epochs) on write_polish_scene's drafts, and an unseen
# 6 kb draft to polish with the trained model
POLISH_TRAIN_LENGTH, POLISH_UNSEEN_LENGTH = 14_000, 6_000
POLISH_TRAIN_SEEDS = (41, 43)          # the training draft, the unseen one
POLISH_TRAIN_EPOCHS = 6
POLISH_TRAIN_BATCH = 8
POLISH_TRAIN_KWARGS = dict(learning_rate=1e-3, batch_size=POLISH_TRAIN_BATCH,
                           holdout_fraction=0.15, seed=0)
POLISH_STEP_B = 16                     # the trainer's default batch
POLISH_RATE_BATCHES = (16, B_POLISH)
EVAL_LAUNCHES = 4                      # 2 layers x 2 directions, T=1000
POLISH_TRAINED_RUNS = tuple(run for run in POLISH_RUNS if run[0] in (
    "cpu_float32", "cuda_float32", "cpu_quantized", "cuda_quantized"))
# the eval confusion on cuda against the cpu's: equal but at positions
# whose cpu top-two logits lie within this margin
LOGIT_TIE = 1e-4

POLISH_TRAIN_WORKER = r'''
import sys
import numpy as np
sys.path.insert(0, {root!r})
from pepper_tpu_torch.options import PepperOptions
from pepper_tpu_torch.parallel import dist
from pepper_tpu_torch.polish.train import train_polish_on_arrays

rank = int(sys.argv[1])
assert dist.init_distributed({address!r}, 2, rank) == (rank, 2)
arrays = np.load({arrays!r})
train_polish_on_arrays(PepperOptions(), arrays["images"], arrays["labels"],
                       {out!r} + ("" if rank == 0 else "_rank1"),
                       devices=[{device!r}], **{kwargs!r})
dist.shutdown_distributed()
'''


def polish_chunk_batch(B, dtype="float32", seed=33):
    """B seeded chunks of 1000 columns: image counts 0..254, labels 0..4,
    the last row a pad row (mask 0)."""
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 255, (B, 1000, GRU_F)).astype(dtype)
    labels = rng.randint(0, 5, (B, 1000)).astype(np.int32)
    mask = np.ones(B, dtype)
    mask[-1] = 0
    return images, labels, mask


def polish_train_step(device, dtype="float64", B=POLISH_STEP_B):
    """One TBPTT step (19 window updates, TRAIN_LR, TRAIN_WD) of the
    full-width polish model in `dtype` on polish_chunk_batch(B): (the
    window losses, each window's gradients, the params after, the largest
    move of a param), host arrays keyed by path; the arguments of
    compare_train_steps."""
    import torch
    from pepper_tpu_torch.models.params import map_params
    from pepper_tpu_torch.models.polish_gru import init_polish_params
    from pepper_tpu_torch.polish import train
    from pepper_tpu_torch.train import step, trainer

    tree = map_params(lambda p: p.to(getattr(torch, dtype)),
                      init_polish_params(torch.Generator().manual_seed(32)))
    params = trainer.trainable_params(tree, device)
    named = [("/".join(path), leaf) for path, leaf in step.leaves(params)]
    optimizer = torch.optim.Adam([leaf for _, leaf in named], lr=TRAIN_LR,
                                 weight_decay=TRAIN_WD)
    grads, losses = [], []
    optimizer.register_step_pre_hook(lambda *_: grads.append(
        {path: leaf.grad.detach().cpu().numpy().copy()
         for path, leaf in named}))
    train.make_tbptt_step(optimizer)(params, *polish_chunk_batch(B, dtype),
                                     losses_out=losses)
    moved = max(float((leaf.detach().cpu() - init).abs().max())
                for (_, leaf), (_, init) in zip(named, step.leaves(tree)))
    return losses, grads, {path: leaf.detach().cpu().numpy().copy()
                           for path, leaf in named}, moved


def polish_train_rates(device, B, iters=1):
    """The TBPTT step at B chunks (float32, the host idle): steps/s and
    chunks/s (wall time), one window's forward (logits and loss), backward
    and Adam step apart (CUDA events, the mean of 3 windows), and the
    device kernels and copies one window launches (torch.profiler)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from pepper_tpu_torch.models.polish_gru import (init_polish_params,
                                                    polish_forward)
    from pepper_tpu_torch.polish import train
    from pepper_tpu_torch.train import step, trainer

    params = trainer.trainable_params(
        init_polish_params(torch.Generator().manual_seed(34)), device)
    leaves = [leaf for _, leaf in step.leaves(params)]
    optimizer = torch.optim.Adam(leaves, lr=TRAIN_LR, weight_decay=TRAIN_WD)
    images, labels, mask = polish_chunk_batch(B, seed=35)
    tbptt = train.make_tbptt_step(optimizer)
    seconds = wall_s(lambda: tbptt(params, images, labels, mask), iters)
    x = torch.from_numpy(images[:, :GRU_T]).to(device)
    y = torch.from_numpy(labels[:, :GRU_T]).to(device)
    m = torch.from_numpy(mask).to(device)
    hidden = torch.zeros((B, 2, GRU_H), device=device)

    def window(events=None):
        logits, _ = polish_forward(params, x, hidden, allow_kernel=False)
        loss = train.weighted_cross_entropy_mean(logits, y,
                                                 train.CLASS_WEIGHTS, mask=m)
        if events:
            events[1].record()
        grads = torch.autograd.grad(loss, leaves)
        if events:
            events[2].record()
        for leaf, grad in zip(leaves, grads):
            leaf.grad = grad
        optimizer.step()

    split = {"forward_ms": 0.0, "backward_ms": 0.0, "adam_ms": 0.0}
    for _ in range(3):
        events = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        torch.cuda.synchronize()
        events[0].record()
        window(events)
        events[3].record()
        events[3].synchronize()
        for key, (a, b) in zip(split, zip(events, events[1:])):
            split[key] += a.elapsed_time(b) / 3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        window()
        torch.cuda.synchronize()
    device_events = [e for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA]
    launches = sum(e.count for e in device_events)
    window_ms = sum(split.values())
    return {"B": B, "step_s": seconds, "steps_per_s": 1 / seconds,
            "chunks_per_s": B / seconds, "windows_per_step": WINDOWS,
            **split, "window_device_launches": launches,
            "window_device_ms": sum(
                getattr(e, "self_device_time_total",
                        getattr(e, "self_cuda_time_total", 0.0))
                for e in device_events) / 1e3,
            "us_per_launch": window_ms * 1e3 / max(1, launches)}


def polish_eval_rate(device, B, iters=3):
    """The polish eval step at B chunks through row 5 (float32, T=1000):
    chunks/s (wall time) and its launches a batch."""
    import torch
    from pepper_tpu_torch.models.polish_gru import init_polish_params
    from pepper_tpu_torch.polish import train
    from pepper_tpu_torch.train import trainer

    params = trainer.trainable_params(
        init_polish_params(torch.Generator().manual_seed(36)), device)
    images, labels, mask = polish_chunk_batch(B, seed=37)
    eval_step = train.make_polish_eval_step()
    _, launches = counted(lambda: eval_step(params, images, labels, mask))
    check(launches == {"gru_direction_fused": EVAL_LAUNCHES},
          f"a polish eval batch of {B} launched {launches}")
    seconds = wall_s(lambda: eval_step(params, images, labels, mask), iters)
    return {"B": B, "batch_ms": seconds * 1e3, "chunks_per_s": B / seconds,
            "launches": launches}


def row5_full_chunk(device):
    """Row 5 at T=1000 (the eval's one launch a direction over the whole
    chunk) against its twin on the card at B=16 and 128, both layers and
    directions, float32 at phase 10's bar; the kernel's ms a launch at
    B=128, queued."""
    import torch
    from pepper_tpu_torch.ops import gru_kernel

    gen = torch.Generator(device=device).manual_seed(2469)
    worst, ms = 0.0, {}
    with torch.no_grad():
        for B in POLISH_RATE_BATCHES:
            for layer in ("encoder", "decoder"):
                xs, ws, b_ih, w_hh, b_hh, h0 = gru_inputs(
                    gen, layer, B, torch.float32, device, T=1000)
                for reverse in (False, True):
                    args = (xs, ws, b_ih, w_hh, b_hh, h0)
                    out, hT = gru_kernel.gru_direction_fused(
                        *args, reverse=reverse)
                    ref, ref_hT = gru_kernel.gru_direction_fused_reference(
                        *args, reverse=reverse)
                    worst = max(worst, (out - ref).abs().max().item(),
                                (hT - ref_hT).abs().max().item())
                if B == B_POLISH:
                    ms[layer] = cuda_ms(lambda: gru_kernel.gru_direction_fused(
                        xs, ws, b_ih, w_hh, b_hh, h0), iters=5, queued=True)
    check(worst <= KERNEL_BARS["float32"],
          f"row 5 at T=1000 differs from its twin by {worst}")
    return {"max_abs_err": worst, "batches": list(POLISH_RATE_BATCHES),
            f"ms_a_launch_B{B_POLISH}": ms}


def polish_train_chunks(bam, truth_bam, fasta):
    """The labelled chunks of summarize_interval_train over a draft's
    intervals: (images float32 (N, 1000, 10), labels int32 (N, 1000))."""
    from pepper_tpu_torch.io.bam import BamReader
    from pepper_tpu_torch.io.fasta import FastaReader
    from pepper_tpu_torch.polish import pipeline

    bam_handler, truth_handler = BamReader(bam), BamReader(truth_bam)
    fasta_handler = FastaReader(fasta)
    intervals = pipeline.build_polish_intervals(
        pipeline.get_polish_chromosome_list(None, fasta_handler,
                                            bam_handler), fasta_handler)
    images, labels = [], []
    for contig, start, end in intervals:
        chunk_images, chunk_labels, _, _ = pipeline.summarize_interval_train(
            bam_handler, truth_handler, fasta_handler, contig, start, end)
        images += chunk_images
        labels += chunk_labels
    return (np.stack(images).astype(np.float32),
            np.stack(labels).astype(np.int32))


def sequence_identity(a, b):
    """difflib's ratio, without its junk heuristic (which takes every DNA
    base for junk on long sequences), as tests/test_polish_train_e2e.py
    scores it."""
    import difflib

    return difflib.SequenceMatcher(None, a, b, autojunk=False).ratio()


def polish_with_trained(device, workdir, scene, model):
    """The polish CLI with the card-trained model on the unseen draft in
    float32 and --quantized on cuda and cpu (polish_cli_runs' rules); the
    cpu float32 FASTA at >= 0.995 identity to the truth and above the
    draft's."""
    bam, fasta, draft, truth = scene
    runs, launches, differing = polish_cli_runs(
        device, workdir, bam, fasta, model, POLISH_TRAINED_RUNS)
    identity = {"draft": sequence_identity(draft, truth)}
    missing = {"draft": missing_kmers(draft, truth)}
    for name in runs:
        sequence = read_fasta_sequence(os.path.join(
            workdir, name, "consensus_pepper_polished.fa"))
        identity[name] = sequence_identity(sequence, truth)
        missing[name] = missing_kmers(sequence, truth)
    for name in ("cpu_float32", "cuda_float32"):
        check(identity[name] >= 0.995 and identity[name] > identity["draft"],
              f"{name}: identity {identity[name]} to the truth, the "
              f"draft's {identity['draft']}")
    return {"draft_length": len(draft), "identity": identity,
            "truth_21mers_missing": missing, "against_cpu": differing,
            "launches": {k: v for k, v in launches.items()
                         if k.startswith("cuda")},
            "seconds": {k: v["seconds"] for k, v in runs.items()}}


def polish_held_out(device, model, images, labels):
    """test_polish_on_arrays on the held-out chunks on cuda (row 5, 4
    launches a batch) and cpu: the loss within rtol 1e-5, the confusion
    equal but at positions whose cpu top-two logits lie within LOGIT_TIE
    (counted)."""
    import torch
    from pepper_tpu_torch.models.checkpoint import load_params
    from pepper_tpu_torch.models.params import params_from_jax
    from pepper_tpu_torch.models.polish_gru import polish_forward
    from pepper_tpu_torch.options import PepperOptions
    from pepper_tpu_torch.polish import train

    params, _ = load_params(model)
    result, launches = counted(lambda: train.test_polish_on_arrays(
        PepperOptions(), images, labels, params,
        batch_size=POLISH_TRAIN_BATCH, device=device))
    batches = -(-len(images) // POLISH_TRAIN_BATCH)
    check(launches == {"gru_direction_fused": EVAL_LAUNCHES * batches},
          f"test_polish_on_arrays launched {launches} for {batches} batches")
    cpu = train.test_polish_on_arrays(PepperOptions(), images, labels,
                                      params, batch_size=POLISH_TRAIN_BATCH,
                                      device="cpu")
    loss_rel = abs(result["loss"] - cpu["loss"]) / abs(cpu["loss"])
    check(loss_rel <= 1e-5, f"test loss {result['loss']} on cuda, "
          f"{cpu['loss']} on cpu")
    with torch.inference_mode():
        logits = {d: polish_forward(
            params_from_jax(params, d), torch.from_numpy(images).to(d),
            torch.zeros((len(images), 2, GRU_H), device=d),
            allow_kernel=True)[0].float().cpu().numpy()
            for d in (device, "cpu")}
    top2 = np.sort(logits["cpu"], axis=-1)[..., -2:]
    near = np.diff(top2, axis=-1)[..., 0] < LOGIT_TIE
    preds = {d: v.argmax(axis=-1) for d, v in logits.items()}
    differ = preds[device] != preds["cpu"]
    check(near[differ].all(), "eval predictions differ at positions whose "
          f"cpu top-two logits are apart: {np.argwhere(differ & ~near)}")
    expected = cpu["confusion"].copy()
    for i, t in zip(*np.nonzero(differ)):
        expected[labels[i, t], preds["cpu"][i, t]] -= 1
        expected[labels[i, t], preds[device][i, t]] += 1
    check(np.array_equal(result["confusion"], expected),
          f"eval confusion {result['confusion'].tolist()} on cuda, "
          f"{cpu['confusion'].tolist()} on cpu")
    return {"chunks": len(images), "loss": result["loss"],
            "cpu_loss": cpu["loss"], "loss_rel": loss_rel,
            "accuracy": result["accuracy"], "cpu_accuracy": cpu["accuracy"],
            "near_tied_positions": int(near.sum()),
            "predictions_differing": int(differ.sum()),
            "confusion": result["confusion"].tolist(), "launches": launches}


def polish_two_process(device, workdir, images, labels, kwargs):
    """train_polish_on_arrays in two gloo processes on `device` (cuda:0)
    against one process over [device, device]: final params within 2e-4
    (tests/test_multihost.py:89-90), and rank 1 writes nothing."""
    import socket

    from pepper_tpu_torch.options import PepperOptions
    from pepper_tpu_torch.polish import train

    arrays = os.path.join(workdir, "polish_train_arrays.npz")
    np.savez(arrays, images=images, labels=labels)
    out = os.path.join(workdir, "polish_two_process")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    script = POLISH_TRAIN_WORKER.format(
        root=ROOT, address=f"127.0.0.1:{port}", arrays=arrays, out=out,
        device=str(device), kwargs=kwargs)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(key, None)
    t0 = time.time()
    procs = [subprocess.Popen([sys.executable, "-c", script, str(rank)],
                              cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, env=env)
             for rank in (0, 1)]
    try:
        logs = [proc.communicate(timeout=300)[0].decode() for proc in procs]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for rank, (proc, log) in enumerate(zip(procs, logs)):
        check(proc.returncode == 0, f"polish train rank {rank} failed:\n"
              f"{log[-3000:]}")
    seconds = time.time() - t0
    check(os.listdir(out + "_rank1") == [], "rank 1 wrote "
          f"{os.listdir(out + '_rank1')}")
    one = os.path.join(workdir, "polish_one_process")
    t1 = time.time()
    train.train_polish_on_arrays(PepperOptions(), images, labels, one,
                                 devices=[device, device], **kwargs)
    one_seconds = time.time() - t1
    final = [np.load(os.path.join(d, "polish_model_final.npz"))
             for d in (out, one)]
    keys = sorted(k for k in final[1].files if k != "__meta__")
    check(keys == sorted(k for k in final[0].files if k != "__meta__"),
          "the two runs' checkpoints hold different leaves")
    diff = max(float(np.abs(final[0][k] - final[1][k]).max()) for k in keys)
    check(diff <= 2e-4, f"two processes' params differ by {diff}")
    return {"chunks": len(images), "params_max_abs_diff": diff,
            "seconds": round(seconds, 3),
            "one_process_two_devices_seconds": round(one_seconds, 3)}


def phase_polish_train(device, card):
    """Polish-side training on the card (module docstring, phase 21);
    returns row 5's and row 6's launches on its paths."""
    import concurrent.futures
    import multiprocessing

    import torch
    from pepper_tpu_torch.options import PepperOptions
    from pepper_tpu_torch.polish import train

    seconds = {}

    def part(name, fn):
        start = time.time()
        try:
            return fn()
        finally:
            seconds[name] = round(time.time() - start, 3)

    t0 = time.time()
    # the rates first, with the host otherwise idle
    result = {"card": card}
    result["rates"] = part("rates", lambda: [
        polish_train_rates(device, B) for B in POLISH_RATE_BATCHES])
    result["eval"] = part("eval", lambda: [
        polish_eval_rate(device, B) for B in POLISH_RATE_BATCHES])
    result["row_5_T1000"] = part("row_5_T1000",
                                 lambda: row5_full_chunk(device))
    # the CPU's reference steps in a process of their own while the card
    # works
    pool = concurrent.futures.ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"),
        initializer=_cpu_steps_worker)
    try:
        cpu_start = time.time()
        cpu_steps = {dtype: pool.submit(polish_train_step, "cpu", dtype)
                     for dtype in ("float64", "float32")}
        card_step, launches = part("card_steps", lambda: counted(
            lambda: polish_train_step(device)))
        check(not launches, f"the polish train step launched {launches}")
        card_step32 = polish_train_step(device, "float32")

        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
            scenes = {}
            for name, length, seed in (
                    ("train", POLISH_TRAIN_LENGTH, POLISH_TRAIN_SEEDS[0]),
                    ("unseen", POLISH_UNSEEN_LENGTH, POLISH_TRAIN_SEEDS[1])):
                directory = os.path.join(workdir, name)
                os.makedirs(directory)
                scenes[name] = (directory, write_polish_scene(
                    directory, length=length, seed=seed, truth_bam=True))
            directory, (bam, fasta, _, _) = scenes["train"]
            images, labels = part("train_images", lambda: polish_train_chunks(
                bam, os.path.join(directory, "truth.bam"), fasta))
            out = os.path.join(workdir, "polish_run")
            final, train_launches = part("training", lambda: counted(
                lambda: train.train_polish_on_arrays(
                    PepperOptions(), images, labels, out,
                    epochs=POLISH_TRAIN_EPOCHS, device=device,
                    **POLISH_TRAIN_KWARGS)))
            n_test = max(1, int(len(images) * 0.15))
            eval_batches = -(-n_test // POLISH_TRAIN_BATCH)
            check(train_launches == {"gru_direction_fused": EVAL_LAUNCHES
                                     * eval_batches * POLISH_TRAIN_EPOCHS},
                  f"training launched {train_launches}; each epoch's eval "
                  f"has {eval_batches} batches")
            check(sorted(os.listdir(out)) == sorted(
                [f"polish_epoch_{n + 1}_checkpoint.npz"
                 for n in range(POLISH_TRAIN_EPOCHS)]
                + ["polish_model_final.npz"]),
                f"the run wrote {sorted(os.listdir(out))}")
            result["training"] = {
                "chunks": len(images), "held_out": n_test,
                "labels": np.bincount(labels.ravel(), minlength=5).tolist(),
                "epochs": POLISH_TRAIN_EPOCHS, "batch": POLISH_TRAIN_BATCH,
                "launches": train_launches,
                "seconds_beside_cpu_steps": seconds["training"]}
            result["polish"] = part("polish", lambda: polish_with_trained(
                device, scenes["unseen"][0], scenes["unseen"][1], final))
            held = np.random.RandomState(0).permutation(len(images))[:n_test]
            result["test_model"] = part("test_model", lambda: polish_held_out(
                device, final, images[held], labels[held]))
            result["two_process"] = part(
                "two_process", lambda: polish_two_process(
                    device, workdir, images[:9], labels[:9],
                    dict(POLISH_TRAIN_KWARGS, epochs=1)))
        card_s = round(time.time() - cpu_start, 3)
        result["step"] = compare_train_steps(
            "polish", card_step, cpu_steps["float64"].result())
        diffs = float32_step_diffs(card_step32,
                                   cpu_steps["float32"].result())
        result["float32_step_grad_rel_of_max"] = {
            "worst": max(diffs.values()), "by_leaf": diffs}
        seconds["card_part_beside_cpu_steps"] = card_s
        seconds["cpu_steps_done"] = round(time.time() - cpu_start, 3)
    finally:
        pool.shutdown(cancel_futures=True)
    seconds["total"] = round(time.time() - t0, 3)
    result["seconds"] = seconds
    emit({"phase": "polish_train", **result})
    torch.cuda.synchronize()
    polish_launches = result["polish"]["launches"]
    return {"train_eval": train_launches["gru_direction_fused"],
            "eval_B128": result["eval"][-1]["launches"]["gru_direction_fused"],
            "trained_polish": polish_launches["cuda_float32"][
                "gru_direction_fused"],
            "trained_polish_quantized": polish_launches["cuda_quantized"][
                "gru_direction_fused_static"],
            "max_abs_err_T1000": result["row_5_T1000"]["max_abs_err"]}


# ---------------------------------------------------------------- phase 22

# the bench's modes, each with the kernel wrapper it reaches (4 a batch)
BENCH_ROUTES = {"int8_static": "lstm_direction_fused_static",
                "bf16": "lstm_direction_fused",
                "int8_dynamic": "lstm_recurrence"}
BENCH_RATIO = (0.75, 1.33)   # marginal rate over 4096 / event-timed batch
# the reduced acceptance run: its sizes, and its per-type bars, set from
# a CPU run of the same sizes before the first run on the card (every
# type's recall and precision 1.0000 there; PERF.md section 6)
ACCEPTANCE_RUN = {"genome_mb": 0.5, "train_mb": 0.2, "epochs": 12,
                  "error_model": "uniform"}
ACCEPTANCE_BARS = {"ALL": 0.98, "SNP": 0.98, "INS": 0.95, "DEL": 0.95}
TRACED_STAGE = "CALL_VARIANT (cuda bfloat16, traced)"


def host_cpu():
    """The host's CPU model (lscpu's, else /proc/cpuinfo's) and logical
    CPU count."""
    model = None
    try:
        out = subprocess.run(["lscpu"], capture_output=True, text=True,
                             timeout=30, check=True).stdout
        model = next((line.split(":", 1)[1].strip()
                      for line in out.splitlines()
                      if line.startswith("Model name:")), None)
    except (OSError, subprocess.SubprocessError):
        pass
    if model in (None, "unknown") and os.path.exists("/proc/cpuinfo"):
        with open("/proc/cpuinfo") as f:
            model = next((line.split(":", 1)[1].strip() for line in f
                          if line.startswith("model name")), model)
    return {"model": model or "unknown", "cpus": os.cpu_count()}


class _Tee:
    """A text stream that writes to a stream and keeps a copy."""

    def __init__(self, stream):
        self.stream, self.parts = stream, []

    def write(self, text):
        self.parts.append(text)
        return self.stream.write(text)

    def flush(self):
        self.stream.flush()

    def text(self):
        return "".join(self.parts)


def measure_bench(device, wrappers):
    """Part 1: the bench in its three modes through pepper_tpu_torch.bench
    at full width (B=4096), each JSON line printed, its marginal rate held
    to one event-timed batch of the same forward, 4 launches a batch."""
    import torch
    from pepper_tpu_torch import bench

    result = {}
    for mode, name in BENCH_ROUTES.items():
        wrapper = wrappers[name]
        wrapper.launches = 0
        start = time.time()
        rate = bench.bench_torch(B_SERVE, mode=mode, device=device)
        seconds = time.time() - start
        launches = wrapper.launches
        # warm-up and best of 3 at each of the two lengths
        batches = 4 * (10 + 50)
        check(launches == 4 * batches,
              f"bench {mode}: {launches} {name} launches for {batches} "
              "batches, not 4 a batch")
        line = bench.result_line(rate)
        print(json.dumps(line), flush=True)
        forward, tree = bench.bench_forward(mode, device)
        x = bench.bench_inputs(B_SERVE, device)
        with torch.inference_mode():
            wrapper.launches = 0
            probs = forward(tree, x)
            check(wrapper.launches == 4,
                  f"{mode}: {wrapper.launches} launches a batch, not 4")
            check(bool(torch.isfinite(probs).all())
                  and tuple(probs.shape) == (B_SERVE, 3),
                  f"{mode}: probabilities {tuple(probs.shape)}")
            batch_ms = cuda_ms(lambda: forward(tree, x + 1), iters=10,
                               queued=True)
        ratio = rate / (B_SERVE / batch_ms * 1e3)
        check(BENCH_RATIO[0] <= ratio <= BENCH_RATIO[1],
              f"bench {mode}: {rate:.0f} windows/s is {ratio:.3f}x the "
              f"event-timed batch's {B_SERVE / batch_ms * 1e3:.0f}")
        result[mode] = {"line": line, "kernel": name,
                        "bench_launches": launches, "batch_ms": batch_ms,
                        "event_windows_per_s": B_SERVE / batch_ms * 1e3,
                        "ratio": ratio, "seconds": round(seconds, 3)}
    return result


def traced_call(workdir, device_name):
    """One bfloat16 call_variant on phase 9's scene (one worker thread)
    inside trace(workdir/trace) and a StageTimer, in a process of its own:
    in the process that ran phases 1-21 the trace holds none of the
    call's kernel events, because a torch.profiler session run minutes
    after the first one in a process loses the kernel records, PyTorch's
    own too (PERF.md section 7): returns the call's kernel launches,
    windows, the StageTimer's stderr text and seconds."""
    import torch
    from pepper_tpu_torch.cli import main as cli
    from pepper_tpu_torch.infer.runner import InferenceRunner
    from pepper_tpu_torch.utils.profiling import StageTimer, trace

    bam, fasta, _ = write_scene(workdir)
    model = save_model(os.path.join(workdir, "model.npz"), call_params())
    argv = ["call_variant", "-b", bam, "-f", fasta, "-m", model, "-o",
            os.path.join(workdir, "traced_call"), "-t", "1",
            "--region_size", "10000", "--ont_r9_guppy5_sup",
            "--compute_dtype", "bfloat16", "--device", device_name]
    windows = []
    resolve = InferenceRunner.resolve

    def counting(runner, handle):
        predictions = resolve(runner, handle)
        windows.extend(predictions)
        return predictions

    wrappers = kernel_wrappers()
    for wrapper in wrappers.values():
        wrapper.launches = 0
    tee = _Tee(sys.stderr)
    with contextlib.redirect_stderr(tee), mock.patch.object(
            InferenceRunner, "resolve", counting):
        with trace(os.path.join(workdir, "trace")):
            with StageTimer(TRACED_STAGE, unit="windows") as timer:
                check(cli.main(argv) == 0, "traced call_variant failed")
                torch.cuda.synchronize()
                timer.add(len(windows))
    return {"launches": {name: w.launches for name, w in wrappers.items()
                         if w.launches},
            "windows": len(windows), "stderr": tee.text(),
            "seconds": round(timer.elapsed, 3)}


def measure_trace(device, workdir):
    """Part 2: trace() around one bfloat16 call_variant on phase 9's scene
    (traced_call); the trace's events of row 1's recurrence core, which
    each launch runs once, against the launch counter; the call's
    StageTimer line in the JAX package's format."""
    import concurrent.futures
    import multiprocessing
    import re

    with concurrent.futures.ProcessPoolExecutor(
            max_workers=1,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        call = pool.submit(traced_call, workdir, str(device)).result()
    row_1 = call["launches"].get("lstm_direction_fused", 0)
    check(set(call["launches"]) == {"lstm_direction_fused"} and row_1 > 0,
          f"traced call launched {call['launches']}")
    log_dir = os.path.join(workdir, "trace")
    files = [os.path.join(log_dir, f) for f in os.listdir(log_dir)
             if f.endswith(".json")]
    check(len(files) == 1, f"trace files {files}")
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    entries = [e["entry"] for e in ptxas_entries("lstm_direction_fused")
               if "core_kernel" in e["entry"]]
    names = set(entries) | set(demangled(entries))
    core_events = [e for e in kernels if e.get("name") in names]
    if len(core_events) != row_1:
        print(json.dumps({"phase": "measure_trace_names",
                          "entries": sorted(names),
                          "trace_kernels": sorted(
                              {e.get("name") for e in kernels})[:40]}),
              flush=True)
    check(len(core_events) == row_1 > 0,
          f"trace: {len(core_events)} events of row 1's core, "
          f"{row_1} launches")
    pattern = (r"\[\d\d-\d\d-\d{4} \d\d:\d\d:\d\d\] INFO: "
               + re.escape(TRACED_STAGE)
               + r" ELAPSED TIME: \d+ Min \d+ Sec "
               r"\(\d+ windows, \d+\.\d windows/s\)\n")
    lines = re.findall(pattern, call["stderr"])
    check(len(lines) == 1, f"StageTimer lines: {lines}")
    return {"row_1_launches": row_1, "row_1_core_events": len(core_events),
            "kernel_events": len(kernels),
            "distinct_kernels": len({e["name"] for e in kernels}),
            "trace_bytes": os.path.getsize(files[0]),
            "windows": call["windows"], "seconds": call["seconds"],
            "stage_line": lines[0].strip()}


def demangled(names):
    """The names as c++filt demangles them (as the profiler shows kernel
    names); [] where c++filt is missing."""
    try:
        out = subprocess.run(["c++filt"], input="\n".join(names),
                             capture_output=True, text=True, timeout=30,
                             check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return []
    return out.splitlines()


def measure_pipeline(device, workdir):
    """Part 3: bench_pipeline's main stages and its one-core window
    generation, at sizes that keep this part near a minute."""
    from pepper_tpu_torch import bench_pipeline

    threads = os.cpu_count() or 4
    stages = bench_pipeline.main_stages(
        1.0, threads, device=device, workdir=os.path.join(workdir, "main"))
    windows = bench_pipeline.bench_windows(
        1.0, "ont", 2, workdir=os.path.join(workdir, "windows"))
    table = {name: {"seconds": round(s["seconds"], 3),
                    "per_s": round(s["per_s"], 1), "unit": s["unit"]}
             for name, s in stages["stages"].items()}
    check(stages["stages"]["inference"]["count"]
          == stages["stages"]["windows"]["windows"] > 0,
          "bench_pipeline main: windows and inferences differ")
    return {"host": host_cpu(), "main": {
        "genome_mb": 1.0, "threads": threads, "reads": stages["reads"],
        "aligned_bases": stages["aligned_bases"],
        "windows": stages["stages"]["windows"]["windows"],
        "aligned_per_s_per_core": round(
            stages["stages"]["windows"]["per_core"], 1),
        "candidates_per_s": table["decode"]["per_s"],
        "inference_windows_per_s": table["inference"]["per_s"],
        "records": stages["records"], "stages": table},
        "windows": {k: round(v, 3) if isinstance(v, float) else v
                    for k, v in windows.items()}}


def measure_acceptance(device, workdir, wrappers):
    """Part 4: the reduced acceptance run through
    examples/acceptance_run.run on the card, held to ACCEPTANCE_BARS."""
    from pepper_tpu_torch.examples import acceptance_run

    for wrapper in wrappers.values():
        wrapper.launches = 0
    start = time.time()
    result = acceptance_run.run(
        ACCEPTANCE_RUN["genome_mb"], os.cpu_count() or 4,
        ACCEPTANCE_RUN["error_model"], device=device,
        train_mb=ACCEPTANCE_RUN["train_mb"],
        epochs=ACCEPTANCE_RUN["epochs"],
        base=os.path.join(workdir, "acceptance"))
    seconds = time.time() - start
    stats = result["stats"]
    for kind, bar in ACCEPTANCE_BARS.items():
        check(stats[kind]["recall"] >= bar
              and stats[kind]["precision"] >= bar,
              f"acceptance {kind}: recall {stats[kind]['recall']:.4f}, "
              f"precision {stats[kind]['precision']:.4f} below {bar}")
    return {**ACCEPTANCE_RUN, "seconds": round(seconds, 3),
            "train_accuracy": result["train_accuracy"],
            "launches": {name: w.launches for name, w in wrappers.items()
                         if w.launches},
            "table": {kind: {key: stats[kind][key]
                             for key in ("n", "tp", "fp", "fn", "recall",
                                         "precision", "gt_concordance")}
                      for kind in ("SNP", "INS", "DEL", "ALL")}}


def phase_measure(device, card):
    """The port's measurement half on the card (module docstring, phase
    22); returns each part's result."""
    wrappers = kernel_wrappers()
    seconds = {}

    def part(name, fn, *args):
        start = time.time()
        result = fn(*args)
        seconds[name] = round(time.time() - start, 3)
        emit({"phase": f"measure_{name}", "card": card, **result})
        return result

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        result = {
            "bench": part("bench", measure_bench, device, wrappers),
            "trace": part("trace", measure_trace, device, workdir),
            "pipeline": part("pipeline", measure_pipeline, device,
                             workdir),
            "acceptance": part("acceptance", measure_acceptance, device,
                               workdir, wrappers)}
    emit({"phase": "measure", "card": card, "seconds": seconds})
    return result


# ---------------------------------------------------------------- phase 23

# the runner's probabilities, kernel route against the twin route: the root
# mean square of their gap (the kernel rounds its output once where the
# bfloat16 twin rounds its scores and weights too; two heads swapped read
# 3.5e-2 to 7.9e-2 in bfloat16 and float32, CPU, 512 windows, three seeds)
TFM_RMS_BARS = {"float32": 2e-4, "bfloat16": 1e-2}
SDPA_BACKENDS = ("FLASH_ATTENTION", "EFFICIENT_ATTENTION",
                 "CUDNN_ATTENTION", "MATH")


def tfm_tree():
    """The transformer family at its published widths, seeded (torch's
    Generator), with its norms' gammas and betas and its BatchNorm running
    statistics moved off their initial 1 and 0, and the pyramid's weights
    at the benchmark cell's scale, sqrt(6 / fan_in) (at torch's default
    the probabilities hardly follow the window, and no route's fault
    would show in them)."""
    import torch
    from pepper_tpu_torch.models.registry import make_family

    gen = torch.Generator().manual_seed(23)
    tree = make_family("transformer").init(gen)
    for i in range(1, 6):
        tree[f"linear_{i}"]["w"] = tree[f"linear_{i}"]["w"] * 6 ** 0.5

    def moved(p, base):
        return base + 0.1 * (2 * torch.rand(p.shape, generator=gen) - 1)

    norms = [tree["bn1"], tree["bn2"]] + [
        layer[name] for layer in tree["layers"].values()
        for name in ("norm1", "norm2")]
    for norm in norms:
        for leaf, base in (("gamma", 1.0), ("beta", 0.0), ("mean", 0.0),
                           ("var", 1.0)):
            if leaf in norm:
                norm[leaf] = moved(norm[leaf], base)
    return tree


def sdpa_column(qkv):
    """scaled_dot_product_attention over the same heads (the library
    column: the port never calls it): the time of its default pick, and for
    each backend whether it takes heads of width 13 (its time) or why
    not."""
    import torch
    import torch.nn.functional as F

    B = qkv.shape[0]
    q, k, v = (a.reshape(B, 33, 8, 13).transpose(1, 2)
               for a in qkv.split(104, dim=-1))
    out = {"default_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v), queued=True)}
    try:
        from torch.nn.attention import SDPBackend, sdpa_kernel
    except ImportError as exc:
        out["backends"] = f"torch.nn.attention unavailable: {exc}"
        return out
    backends = {}
    for name in SDPA_BACKENDS:
        backend = getattr(SDPBackend, name, None)
        if backend is None:
            backends[name] = "not in this torch"
            continue
        try:
            with sdpa_kernel(backend):
                backends[name] = {"ms": cuda_ms(
                    lambda: F.scaled_dot_product_attention(q, k, v),
                    queued=True)}
        except RuntimeError as exc:
            backends[name] = "refused: " + str(exc).splitlines()[0][:160]
    out["backends"] = backends
    return out


def tfm_layer_parts(x, layer):
    """One encoder layer of the bfloat16 forward at B=4096 timed part by
    part, queued (ms): what B27 works on beside the attention."""
    import torch
    from pepper_tpu_torch.models import alternates
    from pepper_tpu_torch.models.rnn import linear
    from pepper_tpu_torch.ops import attention_kernel

    qkv = x @ layer["w_qkv"] + layer["b_qkv"]
    attn = attention_kernel.window_attention(qkv, 8)
    hidden = torch.relu(linear(x, layer["ffn_1"]))
    parts = {
        "qkv": lambda: x @ layer["w_qkv"] + layer["b_qkv"],
        "attention_kernel": lambda: attention_kernel.window_attention(qkv, 8),
        "out_proj": lambda: linear(attn, layer["out_proj"]),
        "norm": lambda: alternates._layernorm(x + attn, layer["norm1"]),
        "ffn_1_relu": lambda: torch.relu(linear(x, layer["ffn_1"])),
        "ffn_2": lambda: linear(hidden, layer["ffn_2"]),
        "layer": lambda: alternates._encoder_layer(x, layer, 8)}
    with torch.inference_mode():
        return {name: cuda_ms(fn, queued=True) for name, fn in parts.items()}


def heads_swapped(qkv, num_heads):
    """The kernel route with its first two heads' outputs swapped: a broken
    route that phase 23's bars must see."""
    from pepper_tpu_torch.ops import attention_kernel

    out = attention_kernel.window_attention(qkv, num_heads)
    B, T, D = out.shape
    out = out.view(B, T, num_heads, D // num_heads).clone()
    out[:, :, [0, 1]] = out[:, :, [1, 0]]
    return out.reshape(B, T, D)


def phase_tfm(device, card):
    """Phase 23 (module docstring); returns its result."""
    import torch
    from pepper_tpu_torch.infer.runner import InferenceRunner
    from pepper_tpu_torch.models.params import map_params
    from pepper_tpu_torch.ops import attention_kernel

    tree = tfm_tree()
    images = np.random.RandomState(23).randint(
        -125, 126, (B_SERVE, T, 26)).astype(np.int8)
    runs = {}
    for dtype in ("bfloat16", "float32"):
        for where, devices in (("cuda", [device]),
                               ("devices", multi_devices())):
            runner = InferenceRunner(
                tree, batch_size=B_SERVE, compute_dtype=dtype,
                model_type="transformer", device=device,
                devices=devices if len(devices) > 1 else None)
            probs, launches = counted(lambda: runner.predict_images(images))
            check(launches == {"window_attention": 6 * len(devices)},
                  f"transformer {dtype} on {where}: launches {launches}")
            with twin_path():
                twin, twin_launches = counted(
                    lambda: runner.predict_images(images))
                twin_s = wall_s(lambda: runner.predict_images(images))
            check(not twin_launches, f"the twin route launched "
                  f"{twin_launches}")
            err = float(np.abs(probs - twin).max())
            rms = float(np.sqrt(np.square(probs - twin).mean()))
            check(np.isfinite(probs).all() and rms <= TFM_RMS_BARS[dtype],
                  f"transformer {dtype} on {where}: root mean square "
                  f"{rms} from the twin route")
            with mock.patch.object(attention_kernel, "attention",
                                   heads_swapped):
                swapped = runner.predict_images(images)
            swapped_rms = float(np.sqrt(np.square(swapped - twin).mean()))
            check(swapped_rms > TFM_RMS_BARS[dtype],
                  f"transformer {dtype} on {where}: two heads swapped read "
                  f"{swapped_rms}, within the bar")
            kernel_s = wall_s(lambda: runner.predict_images(images))
            runs[f"{dtype}_{where}"] = {
                "devices": [str(d) for d in devices], "launches": launches,
                "max_abs_diff_from_twin_route": err,
                "rms_diff_from_twin_route": rms,
                "rms_bar": TFM_RMS_BARS[dtype],
                "heads_swapped_rms": swapped_rms,
                "argmax_agree": float((probs.argmax(1)
                                       == twin.argmax(1)).mean()),
                "kernel_route_windows_per_s": B_SERVE / kernel_s,
                "twin_route_windows_per_s": B_SERVE / twin_s}
    kernels = {}
    gen = torch.Generator(device=device).manual_seed(23)
    for dtype, peak in ((torch.bfloat16, PEAK_BF16_FLOPS),
                        (torch.float32, PEAK_F32_FLOPS)):
        qkv = (0.5 * torch.randn((B_SERVE, T, 312), generator=gen,
                                 device=device)).to(dtype)
        out = attention_kernel.window_attention(qkv, 8)
        twin = attention_kernel.window_attention_reference
        exact = twin(qkv.float(), 8)
        err = float((out.float() - exact).abs().max())
        err_twin = float((out.float() - twin(qkv, 8).float()).abs().max())
        bar = KERNEL_BARS[str(dtype).split(".")[1]]
        check(err <= bar and err_twin <= KERNEL_BARS["bfloat16"],
              f"window_attention {dtype}: {err} from the twin's float32 "
              f"math, {err_twin} from the twin")
        flops = B_SERVE * 2 * 2 * T * T * 104
        nbytes = B_SERVE * T * 416 * qkv.element_size()
        kernels[str(dtype).split(".")[1]] = {
            "B": B_SERVE, "kernel_ms": cuda_ms(
                lambda: attention_kernel.window_attention(qkv, 8),
                queued=True),
            "bound_ms": bound_ms(flops, nbytes, peak),
            "bound_by": "bytes" if nbytes / PEAK_BYTES > flops / peak
            else "operations",
            "plain_ms": cuda_ms(lambda: twin(qkv, 8), queued=True),
            "library": sdpa_column(qkv),
            "max_abs_diff_from_twin_float32_math": err,
            "max_abs_diff_from_twin": err_twin}
    bf16 = map_params(lambda p: p.to(device, torch.bfloat16), tree)
    x = torch.randn((B_SERVE, T, 104), generator=gen, device=device,
                    dtype=torch.bfloat16)
    layer = tfm_layer_parts(x, bf16["layers"]["0"])
    runner = InferenceRunner(tree, batch_size=B_SERVE,
                             compute_dtype="bfloat16",
                             model_type="transformer", device=device)
    top = profile_top(lambda: runner.predict_images(images))
    result = {"runs": runs, "kernel": kernels, "layer_bfloat16_ms": layer,
              "batch_bfloat16": top}
    emit({"phase": "tfm", "card": card, **result})
    return result


# ---------------------------------------------------------------- main


def run_phases(device, smi, only):
    """Some of phases 3-23 alone (after phases 1 and 2), for a short run:
    no kernel summary and no result line.  Phases 13, 14 and 17 walk phase
    9's scene without running phase 9."""
    simple = {3: phase_kernel, 4: phase_transducer, 5: phase_kernel_static,
              6: phase_kernel_recurrence, 7: phase_kernel_dual,
              8: phase_transducer_quantized, 10: phase_kernel_gru,
              15: phase_kernel_hp, 16: phase_transducer_hp,
              18: phase_hp_votes, 19: phase_multi_device, 20: phase_train,
              21: phase_polish_train, 22: phase_measure, 23: phase_tfm}
    for number in sorted(set(simple) & only):
        simple[number](device, smi)
    if only & {9, 13, 14, 17}:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
            scene = write_scene(workdir)
            if 9 in only:
                phase_call(device, workdir, scene)
            if 17 in only:
                phase_call_hp(device, workdir, scene, write_hp_scene(workdir))
            if only & {13, 14}:
                regions, walker = scene_regions(device, *scene[:2])
                if 13 in only:
                    phase_kernel_histogram(device, smi, regions)
                if 14 in only:
                    phase_device_flows(device, smi, regions, walker)
    if only & {11, 12}:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
            scene = write_polish_scene(workdir)
            if 11 in only:
                phase_consensus(device, smi, scene_images(*scene[:2]))
            if 12 in only:
                phase_polish(device, workdir, scene)


def parse_phases(argv):
    """`--phases 6,13`: the phases to run (3-23), or None for all."""
    if not argv:
        return None
    if len(argv) != 2 or argv[0] != "--phases":
        raise SystemExit("usage: chip_smoke.py [--phases N[,N...] | "
                         "--static_float32_times DIR]")
    only = {int(n) for n in argv[1].split(",")}
    if not only or not only <= set(range(3, 24)):
        raise SystemExit(f"--phases takes numbers 3-23, got {argv[1]}")
    return only


def main(argv=()) -> int:
    import torch

    argv, times_root = list(argv), None
    if argv[:1] == ["--static_float32_times"] and len(argv) == 2:
        argv, times_root = [], os.path.abspath(argv[1])
    root = times_root or ROOT
    only = parse_phases(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, root)
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
    if times_root:
        package = os.path.dirname(os.path.abspath(pepper_tpu_torch.__file__))
        check(os.path.dirname(package) == root,
              f"{package} is not {root}'s package")
        emit({"phase": "static_float32_times", "root": root, "card": smi,
              **static_float32_times(device)})
        return 0
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "kind": kind, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda})
    t0 = time.time()
    phase_build()
    if only:
        run_phases(device, smi, only)
        emit({"phase": "done", "phases": sorted(only),
              "seconds_total": round(time.time() - t0, 3)})
        return 0
    seconds = {}

    def timed(name, fn, *args):
        start = time.time()
        try:
            return fn(*args)
        finally:
            seconds[name] = round(time.time() - start, 3)

    max_err, per_launch = timed("kernel", phase_kernel, device, smi)
    timed("transducer", phase_transducer, device, smi)
    code_diff, code_share, static_launch = timed(
        "kernel_static", phase_kernel_static, device, smi)
    rec_err, rec_launch = timed("kernel_recurrence", phase_kernel_recurrence,
                                device, smi)
    dual_err, dual_launch = timed("kernel_dual", phase_kernel_dual, device,
                                  smi)
    timed("transducer_quantized", phase_transducer_quantized, device, smi)
    hp_err, hp_code_diff, hp_batch = timed("kernel_hp", phase_kernel_hp,
                                           device, smi)
    hp_transducer = timed("transducer_hp", phase_transducer_hp, device, smi)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        scene = write_scene(workdir)
        launches = timed("call", phase_call, device, workdir, scene)
        hp_launches = timed("call_hp", phase_call_hp, device, workdir, scene,
                            write_hp_scene(workdir))
        # phases 13 and 14 run on phase 9's scene
        regions, walker = timed("scene_regions", scene_regions, device,
                                *scene[:2])
        hist = timed("kernel_histogram", phase_kernel_histogram, device, smi,
                     regions)
        flow_launches = timed("device_flows", phase_device_flows, device,
                              smi, regions, walker)
        del regions
    gru_err, gru_code_diff, gru_launch = timed("kernel_gru",
                                               phase_kernel_gru, device, smi)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        scene = write_polish_scene(workdir)
        timed("consensus", phase_consensus, device, smi,
              scene_images(*scene[:2]))
        polish_launches = timed("polish", phase_polish, device, workdir,
                                scene)
    votes = timed("hp_votes", phase_hp_votes, device, smi)
    timed("multi_device", phase_multi_device, device, smi)
    train_eval_launches = timed("train", phase_train, device, smi)
    polish_train = timed("polish_train", phase_polish_train, device, smi)
    measure = timed("measure", phase_measure, device, smi)
    timed("tfm", phase_tfm, device, smi)
    emit({"phase": "done", "seconds_total": round(time.time() - t0, 3),
          "phase_seconds": seconds})

    # each kernel's work on its path for one batch of B_SERVE windows in
    # bfloat16: encoder and decoder, forward and backward
    def batch(per_layer, keys, runs=2):
        return {key: runs * sum(layer[key] for layer in per_layer)
                for key in keys}

    float_batch = batch(
        [per_launch[f"encoder_bfloat16_B{B_SERVE}"],
         per_launch[f"decoder_bfloat16_B{B_SERVE}"]],
        ("kernel_ms", "plain_ms", "bound_ms", "cudnn_ms", "projection_ms",
         "recurrence_ms"))
    static_batch = {mode: batch(
        [static_launch[f"encoder_{mode}_bfloat16"],
         static_launch[f"decoder_{mode}_bfloat16"]],
        ("kernel_ms", "plain_ms", "bound_ms", "projection_ms",
         "recurrence_ms"))
        for mode in ("static", "static_rec")}
    # row 2's float32 kinds (the float32 static modes), with both bounds
    static_f32 = {mode: batch(
        [static_launch[f"encoder_{mode}_float32"],
         static_launch[f"decoder_{mode}_float32"]],
        ("kernel_ms", "plain_ms", "bound_ms", "bound_ms_f32_fma",
         "projection_ms", "recurrence_ms"))
        for mode in ("static", "static_rec")}
    # row 1's kernel at phase 5's shapes, in the same phase
    float_same_run = batch(
        [static_launch["encoder_float_bfloat16"],
         static_launch["decoder_float_bfloat16"]], ("kernel_ms",))[
        "kernel_ms"]
    rec_batch = {key: 4 * rec_launch[key]
                 for key in ("kernel_ms", "plain_ms", "bound_ms", "cudnn_ms")}
    # a GRU kernel's work on one consensus batch of B_POLISH chunks, with
    # the kernels line's names: each window runs the encoder and the
    # decoder launch twice (the recurrence: four launches of one shape)
    line_key = {"kernel_ms": "ms", "plain_ms": "plain_ms",
                "bound_ms": "bound_ms", "cudnn_ms": "library_ms",
                "projection_ms": "projection_ms",
                "recurrence_ms": "recurrence_ms"}

    def polish_batch(kind, keys):
        return {line_key[key]: WINDOWS * 2 * sum(
            gru_launch[f"{kind}_{layer}_B{B_POLISH}"][key]
            for layer in ("encoder", "decoder")) for key in keys}

    dual_batch = batch(
        [dual_launch["encoder_bfloat16"], dual_launch["decoder_bfloat16"]],
        ("kernel_ms", "plain_ms", "bound_ms", "cudnn_bidirectional_ms",
         "two_single_launches_ms", "projection_ms", "recurrence_ms"), runs=1)
    lstm_status = ("redesigned: bfloat16 on the tensor cores (mma.sync), "
                   "W_hh split over a cluster of 4 CTAs in shared memory, "
                   "the decoder's input projection a tiled tensor-core "
                   "product of its own; float32 on the core's float32 kind "
                   "(3xTF32 on mma.sync m16n8k8, W_hh over a cluster of 8 "
                   "CTAs, every width projected first); earlier designs: "
                   "PERF.md section 6, row {}")

    def float32_batch(per_layer, runs, launches_f32, library="cudnn_ms"):
        """A row's float32 figures for one batch of B_SERVE windows, with
        the kernels line's names: both bounds, cuDNN in float32 with TF32
        off, the main path's float32 launches."""
        keys = ("kernel_ms", "plain_ms", "bound_ms", "bound_ms_f32_fma",
                library, "projection_ms", "recurrence_ms")
        fig = batch(per_layer, [k for k in keys if k in per_layer[0]], runs)
        return {"ms": fig["kernel_ms"], "plain_ms": fig["plain_ms"],
                "bound_ms": fig["bound_ms"],
                "bound_by": per_layer[0]["bound_by"],
                "bound_ms_f32_fma": fig["bound_ms_f32_fma"],
                "bound_note": per_layer[0]["bound_note"],
                "library_ms": fig[library],
                "library_allow_tf32": per_layer[0]["cudnn_allow_tf32"],
                **{k: fig[k] for k in ("projection_ms", "recurrence_ms")
                   if k in fig},
                "launches": launches_f32}
    rows = [{
        "name": "lstm_direction_fused", "route": "cuda",
        "source": "pepper_tpu_torch/ops/csrc/lstm_direction_fused.cu",
        "replaces": "pepper_tpu/ops/lstm_kernel.py:146",
        "launches": launches["cuda_bfloat16"]["lstm_direction_fused"],
        "launches_train_eval": train_eval_launches,
        "max_abs_err": max_err["bfloat16"],
        "max_abs_err_f32": max_err["float32"],
        "ms": float_batch["kernel_ms"], "plain_ms": float_batch["plain_ms"],
        "bound_ms": float_batch["bound_ms"], "bound_by": "operations",
        "library_ms": float_batch["cudnn_ms"],
        "projection_ms": float_batch["projection_ms"],
        "recurrence_ms": float_batch["recurrence_ms"],
        "status": lstm_status.format(1),
        "work": f"one batch of {B_SERVE} windows, bfloat16: encoder and "
                "decoder, forward and backward (4 launches)",
        "float32": {**float32_batch(
            [per_launch[f"encoder_float32_B{B_SERVE}"],
             per_launch[f"decoder_float32_B{B_SERVE}"]], 2,
            launches["cuda_float32"]["lstm_direction_fused"]),
            "launches_train_eval": train_eval_launches,
            "work": f"one batch of {B_SERVE} windows, float32 (phase 9's "
                    "cuda_float32 run, the training evals): 4 launches"},
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
        "projection_ms": static_batch["static"]["projection_ms"],
        "recurrence_ms": static_batch["static"]["recurrence_ms"],
        "static_rec": static_batch["static_rec"],
        "row_1_ms_same_phase": float_same_run,
        # the float epilogue (out_int8=False) a launch, which no served
        # mode runs: the encoder at 33x26, B=4096, W_hh and h out in dtype
        "float_epilogue": {
            dtype_name: {line: static_launch[
                f"float_epilogue_{dtype_name}"][key] for key, line in (
                    ("kernel_ms", "ms"), ("plain_ms", "plain_ms"),
                    ("bound_ms", "bound_ms"), ("bound_by", "bound_by"),
                    ("route", "route"))}
            for dtype_name in ("bfloat16", "float32")},
        "status": "redesigned: every combination on lstm_core.cuh, "
                  "int8 codes or the float epilogue out (the decoder's "
                  "int8 projection and static_rec's int8 recurrence on "
                  "the tensor cores, mma.sync m16n8k32; the HP encoder's "
                  "48 bfloat16 features projected first; a float32 W_hh "
                  "on the float32 core's codes kind, float32 x projected "
                  "first), int8 weights relaid "
                  "once per tree, k-major; earlier designs: PERF.md "
                  "section 6, row 2",
        "work": f"one batch of {B_SERVE} windows in the static mode, "
                "bfloat16: encoder and decoder, forward and backward (4 "
                "launches)",
        "float32": {
            **{line: static_f32["static"][key] for key, line in (
                ("kernel_ms", "ms"), ("plain_ms", "plain_ms"),
                ("bound_ms", "bound_ms"),
                ("bound_ms_f32_fma", "bound_ms_f32_fma"),
                ("projection_ms", "projection_ms"),
                ("recurrence_ms", "recurrence_ms"))},
            "bound_by": "operations",
            "bound_note": static_launch["encoder_static_float32"][
                "bound_note"],
            "launches": launches["cuda_static_float32"][
                "lstm_direction_fused_static"],
            "static_rec": {
                **static_f32["static_rec"],
                "launches": launches["cuda_static_rec_float32"][
                    "lstm_direction_fused_static"]},
            "work": f"one batch of {B_SERVE} windows in the float32 static "
                    "mode (phase 9's cuda_static_float32 run): encoder and "
                    "decoder, forward and backward (4 launches)"},
    }, {
        "name": "lstm_recurrence", "route": "cuda",
        "source": "pepper_tpu_torch/ops/csrc/lstm_recurrence.cu",
        "replaces": "pepper_tpu/ops/lstm_kernel.py:65",
        "launches": launches["cuda_dynamic"]["lstm_recurrence"],
        "max_abs_err": rec_err["bfloat16"],
        "max_abs_err_f32": rec_err["float32"],
        "ms": rec_batch["kernel_ms"], "plain_ms": rec_batch["plain_ms"],
        "bound_ms": rec_batch["bound_ms"],
        "bound_by": rec_launch["bound_by"],
        "library_ms": rec_batch["cudnn_ms"],
        "status": "redesigned: bfloat16 on lstm_core.cuh's tensor-core "
                  "body over the caller's bfloat16 xw (mma.sync, W_hh split "
                  "over a cluster of 4 CTAs), reverse in the kernel; "
                  "float32 on the core's float32 kind (3xTF32, a cluster "
                  "of 8 CTAs); earlier designs: PERF.md section 6, row 4",
        "float32": {**float32_batch(
            [rec_launch["float32"]], 4,
            hp_err["bilstm_pallas_launches"]["float32"]),
            "library_note": "torch.nn.LSTM(1024, 256) with W_ih = I in "
                            "float32, TF32 off (an upper bound)",
            "work": f"four float32 recurrences over a (33, {B_SERVE}, "
                    "1024) xw; launches: models/rnn.py's bilstm "
                    "(bilstm_pallas) over the HP transducer in float32, "
                    "phase 15"},
        "library_note": "torch.nn.LSTM(1024, 256) (cuDNN) with W_ih = I and "
                        "zero biases on xw: the same function plus an extra "
                        "(T*B, 1024) x (1024, 1024) input product, so an "
                        "upper bound on the library's time",
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
        "projection_ms": dual_batch["projection_ms"],
        "recurrence_ms": dual_batch["recurrence_ms"],
        "status": lstm_status.format(3),
        "work": f"one batch of {B_SERVE} windows, bfloat16, "
                "PEPPER_LSTM_DUAL=1: encoder and decoder (2 launches)",
        "float32": {**float32_batch(
            [dual_launch["encoder_float32"], dual_launch["decoder_float32"]],
            1, launches["cuda_dual_float32"]["bilstm_dual_fused"],
            library="cudnn_bidirectional_ms"),
            "work": f"one batch of {B_SERVE} windows, float32, "
                    "PEPPER_LSTM_DUAL=1 (phase 9's cuda_dual_float32 run): "
                    "2 launches"},
    }, {
        "name": "gru_direction_fused", "route": "cuda",
        "source": "pepper_tpu_torch/ops/csrc/gru_direction_fused.cu",
        "replaces": "pepper_tpu/ops/gru_kernel.py:122",
        "launches": polish_launches["cuda_float32"]["gru_direction_fused"],
        "max_abs_err": gru_err["fused"]["float32"],
        "max_abs_err_bf16": gru_err["fused"]["bfloat16"],
        **polish_batch("fused", ("kernel_ms", "plain_ms", "bound_ms",
                                 "cudnn_ms", "projection_ms",
                                 "recurrence_ms")),
        "bound_by": "operations",
        "status": "redesigned: input projection out of the loop, W_hh in "
                  "shared memory and registers, one row a block at B=128; "
                  "earlier design: PERF.md section 6, row 5",
        "work": f"one consensus batch of {B_POLISH} chunks, float32: "
                f"{WINDOWS} windows x encoder and decoder, forward and "
                f"backward ({LAUNCHES_PER_BATCH} launches)",
        "launches_polish_train_eval": polish_train["train_eval"],
        "launches_polish_eval_batch": polish_train["eval_B128"],
        "launches_card_trained_polish": polish_train["trained_polish"],
        "max_abs_err_T1000": polish_train["max_abs_err_T1000"],
    }, {
        "name": "gru_direction_fused_static", "route": "cuda",
        "source": "pepper_tpu_torch/ops/csrc/gru_direction_fused_static.cu",
        "replaces": "pepper_tpu/ops/gru_kernel.py:266",
        "launches": polish_launches["cuda_quantized"][
            "gru_direction_fused_static"],
        "max_abs_err": gru_code_diff, "max_abs_err_unit": "int8 code",
        "max_abs_err_hT": gru_err["static_hT"]["float32"],
        **polish_batch("static", ("kernel_ms", "plain_ms", "bound_ms",
                                  "projection_ms", "recurrence_ms")),
        "row_5_ms_same_phase": polish_batch("fused", ("kernel_ms",))["ms"],
        "status": "redesigned: on gru_core.cuh (one row a block at B=128, "
                  "W_hh on chip) with int8 codes and the f32 hT out, the "
                  "input projection out of the loop (int8 x on the tensor "
                  "cores, mma.sync m16n8k32); earlier design: PERF.md "
                  "section 6, row 6",
        "bound_by": "operations", "library_ms": None,
        "library_note": "no PyTorch call runs a GRU on int8 input codes "
                        "with int8 weights and emits int8 codes",
        "work": f"one --quantized consensus batch of {B_POLISH} chunks, "
                f"float32: {WINDOWS} windows x encoder and decoder, forward "
                f"and backward ({LAUNCHES_PER_BATCH} launches)",
        "launches_card_trained_polish": polish_train[
            "trained_polish_quantized"],
    }, {
        "name": "gru_recurrence", "route": "cuda",
        "source": "pepper_tpu_torch/ops/csrc/gru_recurrence.cu",
        "replaces": "pepper_tpu/ops/gru_kernel.py:47",
        "launches": polish_launches["cuda_recurrence"]["gru_recurrence"],
        "max_abs_err": gru_err["recurrence"]["float32"],
        "max_abs_err_bf16": gru_err["recurrence"]["bfloat16"],
        **{line_key[key]: LAUNCHES_PER_BATCH
           * gru_launch[f"recurrence_B{B_POLISH}"][key]
           for key in ("kernel_ms", "plain_ms", "bound_ms", "cudnn_ms")},
        "bound_by": gru_launch[f"recurrence_B{B_POLISH}"]["bound_by"],
        "status": "redesigned: W_hh in shared memory and registers, one "
                  "row a block at B=128; earlier design: PERF.md section 6, "
                  "row 7",
        "library_note": "torch.nn.GRU(384, 128) (cuDNN) with W_ih = I and "
                        "b_ih = 0 on xw: the same function plus an extra "
                        "(T*B, 384) x (384, 384) input product, so an upper "
                        "bound on the library's time",
        "work": f"one consensus batch of {B_POLISH} chunks, float32, "
                "PEPPER_GRU_FUSED=0 PEPPER_GRU_KERNEL=1: "
                f"{LAUNCHES_PER_BATCH} recurrences over (100, 128, 384) xw",
    }, {
        **histogram_row(hist["region"]),
        "replaces": "pepper_tpu/ops/pileup_kernel.py:117",
        "launches": walker["launches"],
        "work": "one region of phase 9's scene through accumulate_cuda as "
                f"a RegionalSummary matrix backend: {hist['region']['events']}"
                f" events, {hist['region']['rows']} rows (one launch a "
                "region)",
    }, {
        **histogram_row(hist["dispatch"]),
        "replaces": "pepper_tpu/ops/device_windows.py:192",
        "launches": flow_launches["bfloat16"]["events"][
            "pileup_histogram_events"],
        "work": "the histogram of one classify_regions_events dispatch of 8 "
                f"regions: {hist['dispatch']['events']} events, "
                f"{hist['dispatch']['rows']} rows (one launch a dispatch; "
                "its classifier is row 1's kernel)",
    }]
    # phase 22's launches: the bench's run of each row's mode (4 a batch),
    # row 1's traced call and the reduced acceptance run
    for row in rows:
        mode = {kernel: mode for mode, kernel in BENCH_ROUTES.items()}.get(
            row["name"])
        if mode:
            row["launches_bench"] = measure["bench"][mode]["bench_launches"]
    rows[0]["launches_traced_call"] = measure["trace"]["row_1_launches"]
    rows[0]["launches_acceptance_run"] = measure["acceptance"][
        "launches"].get("lstm_direction_fused", 0)
    # this slice's shapes beside each row's own: the HP classifier (rows
    # 1-4, phases 15 and 17) and the HP sliding predictor (rows 5 and 7,
    # phase 18)
    line_keys = {"kernel_ms": "ms", "plain_ms": "plain_ms",
                 "bound_ms": "bound_ms", "cudnn_ms": "library_ms"}
    hp_rows = {
        "lstm_direction_fused": ("lstm_direction_fused", "hp_cuda_bfloat16",
                                 hp_err["bfloat16"]["lstm_direction_fused"]),
        "bilstm_dual_fused": ("bilstm_dual_fused", "hp_cuda_dual_bfloat16",
                              hp_err["bfloat16"]["bilstm_dual_fused"]),
        "lstm_direction_fused_static": ("lstm_direction_fused_static",
                                        "hp_cuda_static_bfloat16",
                                        hp_code_diff),
        "lstm_recurrence": ("lstm_recurrence", "hp_cuda_dynamic",
                            hp_err["bfloat16"]["lstm_recurrence"])}
    for row in rows:
        if row["name"] in hp_rows and "replaces" in row and "hp" not in row:
            figures, run, err = hp_rows[row["name"]]
            row["hp"] = {
                **{line_keys[k]: v for k, v in hp_batch[figures].items()},
                "library_ms": hp_batch[figures].get("cudnn_ms"),
                "launches": hp_launches[run][row["name"]],
                "max_abs_err": err,
                "work": f"one batch of {B_SERVE} HP windows (T={HP_T}, "
                        f"F={HP_F}), bfloat16"}
            if row["name"] == "lstm_direction_fused_static":
                hp_f32 = hp_batch["lstm_direction_fused_static_float32"]
                row["hp"]["float32"] = {
                    "ms": hp_f32["kernel_ms"], "plain_ms": hp_f32["plain_ms"],
                    "bound_ms": hp_f32["bound_ms"],
                    "bound_ms_f32_fma": hp_f32["bound_ms_f32_fma"],
                    "launches": hp_transducer["static_float32"]["launches"],
                    "static_rec": hp_batch[
                        "lstm_direction_fused_static_rec_float32"],
                    "work": f"one batch of {B_SERVE} HP windows in the "
                            "float32 static mode (launches: phase 16's "
                            "batch)"}
        route = {"gru_direction_fused": "fused",
                 "gru_recurrence": "recurrence"}.get(row["name"])
        if route:
            figures = votes[route]
            row["hp_votes_scan"] = {
                "launches": figures["launches"],
                **{line_keys[k]: figures[f"{k}_per_pair_batch"]
                   for k in line_keys},
                "pairs_per_s": figures["pairs_per_s"],
                "votes_unequal": figures["hp1"]["votes_unequal"]
                + figures["hp2"]["votes_unequal"],
                "work": f"one hp_votes_scan batch of {HP_PAIRS} image "
                        "pairs of 1000 columns, float32: 2 x "
                        f"{LAUNCHES_PER_BATCH} launches"}
    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
