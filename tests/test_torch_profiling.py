"""The port's utils/profiling.py against the JAX package's: the same
stderr lines for the same stage, count and unit under a patched clock,
and a trace hook on torch.profiler (a no-op without a directory)."""

import datetime as real_datetime
import glob
import json
import os
import warnings

import pytest
import torch

import pepper_tpu.utils.profiling as jax_profiling
import pepper_tpu_torch.utils as port_utils
import pepper_tpu_torch.utils.profiling as port_profiling


class _Clock:
    """perf_counter from a list of readings; datetime.now fixed."""

    def __init__(self, readings):
        self.readings = list(readings)

    def perf_counter(self):
        return self.readings.pop(0)


class _FixedDatetime(real_datetime.datetime):
    @classmethod
    def now(cls, tz=None):
        return cls(2026, 10, 17, 9, 5, 7)


def _stderr_of(module, monkeypatch, capsys, stage, unit, count, elapsed,
               quiet=False):
    monkeypatch.setattr(module, "time", _Clock([100.0, 100.0 + elapsed]))
    monkeypatch.setattr(module, "datetime", _FixedDatetime)
    capsys.readouterr()
    with module.StageTimer(stage, unit=unit, quiet=quiet) as timer:
        timer.add(count)
    assert timer.elapsed == pytest.approx(elapsed)
    module.log_line(f"after {stage}")
    return capsys.readouterr().err


@pytest.mark.parametrize("stage,unit,count,elapsed,quiet", [
    ("INFERENCE (cuda)", "windows", 4096, 75.25, False),
    ("SIMULATE TRAIN GENOME", "items", 0, 0.4, False),
    ("VCF WRITE (pool)", "records", 12, 3725.0, False),
    ("WINDOW GENERATION", "aligned-bases", 1_662_000, 0.031, True),
])
def test_stage_timer_writes_the_jax_lines(monkeypatch, capsys, stage, unit,
                                          count, elapsed, quiet):
    ours = _stderr_of(port_profiling, monkeypatch, capsys, stage, unit,
                      count, elapsed, quiet)
    theirs = _stderr_of(jax_profiling, monkeypatch, capsys, stage, unit,
                        count, elapsed, quiet)
    assert ours == theirs
    assert ours.startswith("[10-17-2026 09:05:07] INFO: ")
    assert ("ELAPSED TIME" in ours) != quiet


def test_utils_exports_the_timer_and_the_trace_hook():
    assert port_utils.StageTimer is port_profiling.StageTimer
    assert port_utils.trace is port_profiling.trace


@pytest.mark.parametrize("log_dir", [None, ""])
def test_trace_without_a_directory_is_a_no_op(log_dir, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the profiler started")

    monkeypatch.setattr(torch.profiler, "profile", refuse)
    with port_profiling.trace(log_dir):
        value = torch.ones(3).sum().item()
    assert value == 3.0


def test_trace_writes_a_chrome_trace_naming_the_ops_run_inside(tmp_path):
    log_dir = str(tmp_path / "trace")
    with port_profiling.trace(log_dir):
        torch.arange(6.0).mul(3.0).sum()
    files = glob.glob(os.path.join(log_dir, "*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {event.get("name") for event in events}
    assert "aten::mul" in names and "aten::sum" in names


def test_port_kernels_are_the_global_functions_of_the_sources():
    import pathlib
    import re

    csrc = (pathlib.Path(port_profiling.__file__).resolve().parent.parent
            / "ops" / "csrc")
    names = set()
    for path in list(csrc.glob("*.cu")) + list(csrc.glob("*.cuh")):
        text = re.sub(r"__launch_bounds__\([^)]*\)", "", path.read_text())
        names.update(re.findall(r"__global__[^(;{]*?(\w+)\s*\(", text))
    assert names == set(port_profiling.PORT_KERNELS)


def test_port_kernel_events_count_the_port_kernels_alone():
    names = [
        "void lstm::(anonymous namespace)::core_kernel<3, 1, true, "
        "lstm::(anonymous namespace)::Kind<float, __nv_bfloat16, false> >"
        "(lstm::(anonymous namespace)::CoreArgs<float>)",
        "void lstm::(anonymous namespace)::projection_kernel<true>(int)",
        "void gru::(anonymous namespace)::core_stream_kernel<1>(float*)",
        "void (anonymous namespace)::pileup_histogram_kernel(int const*)",
        "void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float>"
        " >(float)",
        "nvjet_tst_64x64_64x13_2x1_v_bz_NNT",
        "void cublasLt::splitKreduce_kernel<32, 16, int, float>(float)",
    ]
    assert port_profiling.port_kernel_events(names) == 4


class _Event:
    def __init__(self, name, device_type):
        self.name = name
        self.device_type = device_type


@pytest.mark.parametrize("kernel_events,warns", [(2, True), (4, False),
                                                 (6, False)])
def test_trace_warns_when_it_holds_fewer_kernel_events_than_launches(
        tmp_path, monkeypatch, kernel_events, warns):
    """Four launches of row 1's wrapper inside the block (each runs at
    least one of the port's kernels) against a profile holding
    kernel_events of them, the profiler faked so that this runs on the
    CPU."""
    import contextlib

    from torch.autograd import DeviceType

    from pepper_tpu_torch.ops import lstm_kernel

    class _Profile(contextlib.AbstractContextManager):
        def __init__(self, **kwargs):
            assert (torch.profiler.ProfilerActivity.CUDA
                    in kwargs["activities"])

        def __exit__(self, *exc):
            return False

        def events(self):
            core = ("void lstm::(anonymous namespace)::core_kernel<1, 1, "
                    "false>(int)")
            return ([_Event(core, DeviceType.CUDA)] * kernel_events
                    + [_Event("aten::mm", DeviceType.CPU)] * 9)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.profiler, "profile", _Profile)
    monkeypatch.setattr(lstm_kernel.lstm_direction_fused, "launches", 7)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with port_profiling.trace(str(tmp_path)):
            lstm_kernel.lstm_direction_fused.launches += 4
    messages = [str(w.message) for w in caught
                if issubclass(w.category, RuntimeWarning)]
    assert messages == ([f"trace({str(tmp_path)!r}) holds {kernel_events} "
                         "kernel events of the port for 4 launches: the "
                         "profiler dropped some"] if warns else [])
