"""Build, load and launch the port's hand-written CUDA kernels.

Every kernel is one source, csrc/<name>.cu, with the shared headers it
includes; nvcc compiles it for sm_90a into its own shared library with a
plain C interface (no PyTorch headers), built at first use into the port's
build directory (build.py) and bound with ctypes.  Each library exports

    int <name>_launch(..., void* stream)   -> a cudaError_t value
    const char* <name>_error_string(int)

and may export further launchers beside it (ENTRIES).

KERNELS lists every kernel with the headers that go into its build stamp
and the argument types of its launcher; the wrappers that call them live
in lstm_kernel.py, gru_kernel.py, pileup_kernel.py and attention_kernel.py,
and the dtype codes, the H limit and the int8 weight layout both RNN
families read are here.  A failed build or launch raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess

import torch
from torch.utils.weak import WeakIdKeyDictionary

from ..build import BUILD_DIR, ensure_built, source_digest

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_LSTM = ("lstm_cell.cuh",)
_LSTM_CORE = ("lstm_core.cuh", "mma_ptx.cuh") + _LSTM
_INT8 = ("int8_projection.cuh", "mma_ptx.cuh")
_GRU = ("gru_cell.cuh", "lstm_cell.cuh")
_GRU_CORE = ("gru_core.cuh",) + _GRU
# name -> (headers it includes, argument types of <name>_launch, the
# stream last)
KERNELS = {
    "lstm_direction_fused": (_LSTM_CORE, [_I, _P, _P, _P, _P, _I, _I, _P, _P,
                                          _P, _P, _I, _I, _I, _I, _P]),
    "bilstm_dual_fused": (_LSTM_CORE, [_I, _P, _P, _P, _P, _P, _P, _I, _I, _P,
                                       _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                       _P]),
    "lstm_direction_fused_static": (
        _LSTM_CORE + ("int8_projection.cuh",),
        [_I, _I, _I, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P, _P, _P, _I, _I,
         _I, _I, _P]),
    "lstm_recurrence": (_LSTM_CORE, [_I, _P, _P, _P, _I, _I, _I, _I, _P]),
    "gru_direction_fused": (_GRU_CORE + ("gru_projection.cuh",),
                            [_I, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P, _P,
                             _P, _I, _I, _I, _I, _P]),
    "gru_direction_fused_static": (
        _GRU_CORE + ("gru_projection.cuh",) + _INT8,
        [_I, _I, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I,
         _I, _I, _I, _P]),
    "gru_recurrence": (_GRU_CORE, [_I, _P, _P, _P, _P, _P, _I, _I, _I, _P]),
    "pileup_histogram": ((), [_P, _P, _P, _L, _P, _I, _I, _P]),
    "window_attention": ((), [_I, _P, _P, _I, _P]),
}
# further launchers a kernel's library exports, <entry>_launch: entry ->
# (the kernel, argument types)
ENTRIES = {
    # the two float LSTM kernels' input projection and recurrence alone
    # (dtype first: 0 float32, 1 bfloat16)
    "lstm_direction_fused_projection": (
        "lstm_direction_fused", [_I, _P, _P, _P, _P, _I, _I, _P, _P, _I, _I,
                                 _I, _P]),
    "lstm_direction_fused_recurrence": (
        "lstm_direction_fused", [_I, _P, _P, _P, _I, _I, _I, _I, _P]),
    # the core's launch plan (dtype, B, H, dirs, fused, int out[4]);
    # launches nothing
    "lstm_direction_fused_plan": (
        "lstm_direction_fused", [_I, _I, _I, _I, _I, _P, _P]),
    # the core's plan as lstm_recurrence runs it (dtype, B, H, int out[4]);
    # launches nothing
    "lstm_recurrence_plan": ("lstm_recurrence", [_I, _I, _I, _P, _P]),
    "bilstm_dual_fused_projection": (
        "bilstm_dual_fused", [_I, _P, _P, _P, _P, _P, _P, _I, _I, _P, _P, _P,
                              _P, _I, _I, _I, _P]),
    "bilstm_dual_fused_recurrence": (
        "bilstm_dual_fused", [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P]),
    # gru_direction_fused's input projection alone, for timing it apart
    "gru_direction_fused_projection": (
        "gru_direction_fused", [_I, _P, _P, _P, _P, _I, _I, _P, _P, _I, _I,
                                _I, _P]),
    # the static kernels' two launches apart: the input projection (x's
    # dtype code first; int8 x on the tensor cores) and the recurrence over
    # its float32 xw (W_hh's dtype code first), and the LSTM cores' plan
    # for them (W_hh's dtype code, B, H, fused, int out[4]; launches
    # nothing)
    "lstm_direction_fused_static_projection": (
        "lstm_direction_fused_static", [_I, _P, _P, _I, _I, _P, _P, _P, _P,
                                        _I, _I, _I, _P]),
    "lstm_direction_fused_static_recurrence": (
        "lstm_direction_fused_static", [_I, _P, _P, _P, _P, _I, _I, _I, _I,
                                        _P]),
    "lstm_direction_fused_static_plan": (
        "lstm_direction_fused_static", [_I, _I, _I, _I, _P, _P]),
    "gru_direction_fused_static_projection": (
        "gru_direction_fused_static", [_I, _P, _P, _P, _P, _I, _I, _P, _P,
                                       _P, _I, _I, _I, _P]),
    "gru_direction_fused_static_recurrence": (
        "gru_direction_fused_static", [_I, _P, _P, _P, _P, _P, _P, _I, _I,
                                       _I, _I, _P]),
}
_libs: dict = {}

MAX_HIDDEN = 256    # kMaxHidden in csrc/lstm_cell.cuh and csrc/gru_cell.cuh
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
FLOATS = (torch.float32, torch.bfloat16)


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the port's CUDA "
            "kernels cannot be built")
    return nvcc


def build_kernel(build_dir: str = BUILD_DIR,
                 name: str = "lstm_direction_fused") -> str:
    """Compile csrc/<name>.cu into build_dir, once per digest of its
    source, its headers and the flags, under the build lock.  Returns the
    library path; ptxas's register and shared-memory report is kept beside
    it."""
    if name not in KERNELS:
        raise ValueError(f"unknown kernel {name!r}; expected one of "
                         f"{tuple(KERNELS)}")
    source = os.path.join(_CSRC, f"{name}.cu")
    headers = [os.path.join(_CSRC, h) for h in KERNELS[name][0]]
    lib_name, log_name = f"lib{name}.so", f"{name}.ptxas.txt"
    stamp = source_digest([source, *headers], " ".join(NVCC_FLAGS))

    def build(tmp):
        result = subprocess.run(
            [find_nvcc(), *NVCC_FLAGS, "-o", os.path.join(tmp, lib_name),
             source], capture_output=True, text=True)
        if result.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n"
                               + result.stdout + result.stderr)
        with open(os.path.join(tmp, log_name), "w") as f:
            f.write(result.stdout + result.stderr)

    lib_path, _ = ensure_built(name, [lib_name, log_name], stamp, build,
                               build_dir)
    return lib_path


def ptxas_report(build_dir: str = BUILD_DIR,
                 name: str = "lstm_direction_fused") -> str:
    with open(os.path.join(build_dir, f"{name}.ptxas.txt")) as f:
        return f.read()


def _kernel_lib(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is None:
        lib = ctypes.CDLL(build_kernel(name=name))
        entries = {name: KERNELS[name][1]}
        entries.update((entry, argtypes) for entry, (kernel, argtypes)
                       in ENTRIES.items() if kernel == name)
        for entry, argtypes in entries.items():
            launch_fn = getattr(lib, f"{entry}_launch")
            launch_fn.restype = ctypes.c_int
            launch_fn.argtypes = argtypes
        error_string = getattr(lib, f"{name}_error_string")
        error_string.restype = ctypes.c_char_p
        error_string.argtypes = [ctypes.c_int]
        _libs[name] = lib
    return lib


def launch(name: str, device: torch.device, *args) -> None:
    """Run <name>_launch(*args, stream) of a kernel or an entry of ENTRIES
    on the current stream of `device`; raise if the launcher reports an
    error."""
    kernel = ENTRIES[name][0] if name in ENTRIES else name
    lib = _kernel_lib(kernel)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, f"{name}_launch")(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: "
                           + getattr(lib, f"{kernel}_error_string")(err)
                           .decode())


def ptr(t):
    return None if t is None else t.data_ptr()


def aligned(t):
    """t, or a copy of it on a fresh allocation where t does not start on
    the 16-byte boundary that the kernels read weights from."""
    return t.clone() if t.data_ptr() % 16 else t


def require_cuda(t: torch.Tensor, name: str) -> None:
    if t.device.type != "cuda":
        raise RuntimeError(f"{name} runs on cuda or cpu tensors, not "
                           f"{t.device}")


def check_contiguous(tensors, device, name) -> None:
    """Every kernel wrapper's check of its tensors before a launch: on
    `device`, contiguous, and none that requires grad while grad mode is
    on (the kernels have no backward: a launch would hand back a tensor
    with no grad_fn, and training would take zero gradients silently)."""
    for t in tensors:
        if t.requires_grad and torch.is_grad_enabled():
            raise RuntimeError(
                f"{name} has no backward: an input requires grad with grad "
                "mode on; train on the eager path (allow_kernel=False) or "
                "run under torch.no_grad()/torch.inference_mode()")
        if t.device != device:
            raise TypeError(f"{name}: tensors on {t.device} and {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} takes contiguous tensors")


def check_hidden(H: int) -> None:
    if H % 32 != 0 or not 0 < H <= MAX_HIDDEN:
        raise ValueError(f"the kernels take H a multiple of 32 up to "
                         f"{MAX_HIDDEN}, got {H}")


def split_rows(w, x_parts):
    """The row slices of w (sum F_i, G) that meet each feature part."""
    out, off = [], 0
    for x in x_parts:
        out.append(w[off:off + x.shape[2]])
        off += x.shape[2]
    return tuple(out)


def int8_codes(h: torch.Tensor) -> torch.Tensor:
    """round(h*127) as int8 (round-half-to-even; |h| < 1 keeps it within
    [-127, 127])."""
    return torch.round(h * 127.0).to(torch.int8)


def int8_kmajor(w: torch.Tensor) -> torch.Tensor:
    """(K, N) int8 -> (N, K) int8, k-major: row n holds output column n's K
    codes.  That is the B operand of mma.sync m16n8k32 s8 as the tensor-core
    kernels read it (csrc/mma_ptx.cuh): each 4 bytes of a row are one B
    register, four consecutive k of one column, and 8 rows of 16 bytes one
    ldmatrix matrix.  Its inverse is the same transpose."""
    return w.t().contiguous()


def relayout_int8(w: torch.Tensor) -> torch.Tensor:
    """w (K, N) int8 k-major (int8_kmajor), the one layout every int8
    kernel reads, counted in relayout_int8.count."""
    relayout_int8.count += 1
    return int8_kmajor(w)


relayout_int8.count = 0

# weight -> (the weight's version, its k-major copy), for as long as the
# weight lives
_KEPT = WeakIdKeyDictionary()


def _version(w):
    """w's version counter, which every write in place moves; an inference
    tensor (torch.inference_mode) keeps none, and -1 stands for it."""
    return -1 if w.is_inference() else w._version


def _kept(w):
    """The k-major copy kept for w, unless w was written since."""
    version, copy = _KEPT.get(w, (None, None))
    return copy if version == _version(w) else None


def keep_relaid(w: torch.Tensor) -> torch.Tensor:
    """Relay the int8 weight w (K, N) k-major once and keep the copy for as
    long as w lives unwritten: every later launch handed w, or row slices
    of it that cover it in order, reads the copy.  The served paths call it
    once per weight tree (models/quantize.py)."""
    copy = _kept(w)
    if copy is None:
        copy = relayout_int8(w)
        _KEPT[w] = (_version(w), copy)
    return copy


def _covers(w, parts):
    """Whether the row slices `parts` make up the 2-D tensor w, in order
    (views of its storage; under torch.inference_mode a view keeps no
    _base, so the storage is what tells)."""
    storage, offset = w.untyped_storage(), w.storage_offset()
    for part in parts:
        if (part.untyped_storage() is not storage
                or part.storage_offset() != offset
                or part.stride() != w.stride()
                or part.shape[1:] != w.shape[1:]):
            return False
        offset += part.shape[0] * w.stride(0)
    return offset == w.storage_offset() + w.shape[0] * w.stride(0)


def relaid(parts) -> torch.Tensor:
    """The int8 weight that the row slices `parts` make up (one part: the
    weight itself), k-major: the copy keep_relaid kept for it, or a
    relayout made now."""
    for w in list(_KEPT.keys()):
        copy = _kept(w) if _covers(w, parts) else None
        if copy is not None:
            return copy
    return relayout_int8(parts[0] if len(parts) == 1 else torch.cat(parts))
