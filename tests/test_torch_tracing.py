"""The port's spans (utils/profiling.py `span`) in its two served paths,
`InferenceRunner.dispatch`/`resolve` and `consensus_predict`, on the CPU:
nothing recorded, no clock read and nothing allocated without a
torch.profiler session; inside one, the named and nested phases with one
batch id a runner batch, on the caller's perf_counter clock, among the
profiler's events, the collector's passes as children; outputs unchanged
either way; the benchmark's readers of them; the padded-rows counter.

Both paths run as the benchmark's entries build them, at the harness
tests' tiny traffic (benchmark/tests/test_perfcells_harness.py): a full
runner batch and a partial one, 1-deep, and one consensus_predict call of
a partial batch.  A CPU profiler session over the consensus call records
some 350,000 operator events, so each path runs once without a session
and once inside one, and the tests read those runs."""

import gc
import glob
import json
import os
import time
import tracemalloc
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import spec
from pepper_tpu_torch.utils import profiling

TINY = {"rows_per_device": 8, "pool": 2}
RUNNER_PHASES = {"runner.dispatch": None,
                 "runner.dispatch.stack": "runner.dispatch",
                 "runner.dispatch.stage": "runner.dispatch",
                 "runner.dispatch.enqueue": "runner.dispatch",
                 "runner.resolve": None,
                 "runner.resolve.wait": "runner.resolve",
                 "runner.resolve.fetch": "runner.resolve",
                 "runner.resolve.objects": "runner.resolve"}
CONSENSUS_PHASES = {"consensus.predict": None,
                    "consensus.pad": "consensus.predict",
                    "consensus.upload": "consensus.predict",
                    "consensus.enqueue": "consensus.predict",
                    "consensus.fetch": "consensus.predict"}
# (metric, the cell whose entry drives it)
METRICS = [(f"{name}.snp", "snp.stream.bf16") for name in (
    "dispatch_stack_ms", "dispatch_stage_ms", "dispatch_enqueue_ms",
    "resolve_wait_ms", "resolve_fetch_ms", "resolve_objects_ms", "gc_ms")] + [
    (f"{name}.polish", "polish.consensus.f32") for name in (
        "consensus_pad_ms", "consensus_upload_ms", "consensus_enqueue_ms",
        "consensus_fetch_ms", "gc_ms")]


def _session():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


@pytest.fixture(scope="module")
def entries():
    """{cell: its benchmark entry on the CPU at TINY}: the runner's set up
    as the harness sets it up, the consensus entry's call made as its
    set-up makes it, without the warm-up calls (a second each here)."""
    from pepper_tpu_torch.polish.consensus import consensus_predict

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    out = {}
    for name in ("snp.stream.bf16", "polish.consensus.f32"):
        cell = spec.load_cell(name)
        cell.traffic.update(TINY)
        entry = spec.load_module("entries", cell.config["entry"]).Entry(
            cell, 2 ** 31 + 19, [torch.device("cpu")])
        entry.inputs()
        out[name] = entry
    out["snp.stream.bf16"].setup()
    polish = out["polish.consensus.f32"]
    params = polish._weights()
    polish.predict = lambda images: consensus_predict(
        params, images, batch_size=polish.rows, device="cpu")
    yield out
    profiling.clear_spans()
    torch.set_num_threads(threads)


def _runner(entries):
    """A full batch and a partial one, 1-deep (dispatch, dispatch,
    resolve, resolve): their probabilities."""
    entry = entries["snp.stream.bf16"]
    runner = entry.runner
    first = runner.dispatch(entry.batches[0])
    second = runner.dispatch(entry.batches[1][:5])
    preds = runner.resolve(first) + runner.resolve(second)
    return np.stack([p.prediction_base for p in preds])


def _consensus(entries):
    """A partial batch of 5 chunks: (labels, phred)."""
    entry = entries["polish.consensus.f32"]
    return entry.predict(entry.images[0][:5])


def _readings(cell, dispatched):
    r = SimpleNamespace(dispatched=dispatched)
    return {metric: spec.metric_reader(metric).read(r)
            for metric, its_cell in METRICS if its_cell == cell}


@pytest.fixture(scope="module")
def off(entries):
    """Both paths with no profiler session and a clock that fails when a
    span reads it: outputs, what was recorded and read, and the padded
    rows counted."""
    def no_clock():
        raise AssertionError("a span read the clock")

    profiling.clear_spans()
    rows = profiling.padded_rows()
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(profiling.time, "perf_counter_ns", no_clock)
        outputs = (_runner(entries), *_consensus(entries))
    return SimpleNamespace(
        outputs=outputs, records=profiling.records(),
        spans=profiling.spans(), batch=profiling.new_batch(),
        readings={**_readings("snp.stream.bf16", 2),
                  **_readings("polish.consensus.f32", 1)},
        rows_before=rows, rows_after=profiling.padded_rows())


@pytest.fixture(scope="module")
def on(entries):
    """Each path inside a CPU profiler session of its own, the collector's
    threshold lowered so that its passes fall inside spans this small:
    outputs, the caller's perf_counter_ns brackets, what was recorded and
    read, and (the runner's) the profiler's event names."""
    out = SimpleNamespace(records={}, spans={}, brackets={}, readings={})
    threshold = gc.get_threshold()
    for cell, serve, dispatched in (
            ("snp.stream.bf16", _runner, 2),
            ("polish.consensus.f32", _consensus, 1)):
        profiling.clear_spans()
        with _session() as prof:
            gc.set_threshold(50)
            try:
                t0 = time.perf_counter_ns()
                result = serve(entries)
                out.brackets[cell] = (t0, time.perf_counter_ns())
            finally:
                gc.set_threshold(*threshold)
        out.records[cell] = profiling.records()
        out.spans[cell] = profiling.spans()
        out.readings.update(_readings(cell, dispatched))
        if cell == "snp.stream.bf16":
            probs = result
            out.names = {e.name for e in prof.events()}
        else:
            labels, phred = result
    profiling.clear_spans()
    out.outputs = (probs, labels, phred)
    return out


def test_without_a_session_nothing_is_recorded_read_or_allocated(off):
    assert off.records == [] and off.spans == {} and off.batch is None
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for _ in range(1000):
            with profiling.span("runner.resolve.wait", profiling.new_batch()):
                pass
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    here = [tracemalloc.Filter(True, profiling.__file__)]
    grown = after.filter_traces(here).compare_to(
        before.filter_traces(here), "lineno")
    assert [s for s in grown if s.size_diff > 0] == []


@pytest.mark.parametrize("cell,phases", [("snp.stream.bf16", RUNNER_PHASES),
                                         ("polish.consensus.f32",
                                          CONSENSUS_PHASES)])
def test_a_session_records_each_phase_nested_on_the_callers_clock(
        on, cell, phases):
    all_records = on.records[cell]
    assert all(r is not None for r in all_records)
    records = [r for r in all_records if r[0] != profiling.GC]
    assert {r[0] for r in records} == set(phases)
    t0, t1 = on.brackets[cell]
    runner = cell.startswith("snp")
    for name, start, end, parent, batch in records:
        assert t0 <= start <= end <= t1
        if phases[name] is None:
            assert parent is None
            continue
        outer = all_records[parent]
        assert outer[0] == phases[name]
        assert outer[4] == (batch if runner else None)
        assert outer[1] <= start <= end <= outer[2]
    batches = {}
    for name, _, _, _, batch in records:
        if phases[name] is not None or runner:
            batches.setdefault(batch, []).append(name)
    assert None not in batches
    if runner:
        # one id a batch, shared by its dispatch and its resolve
        assert len(batches) == 2
        for names in batches.values():
            assert sorted(names) == sorted(phases)
        assert set(phases) <= on.names
    else:
        assert len(batches) == 1
    leaves = {n for n, p in phases.items() if p is not None}
    assert set(on.spans[cell]) == leaves
    assert all(len(v) == (2 if runner else 1)
               for v in on.spans[cell].values())


def test_collector_passes_are_children_of_the_innermost_span(tmp_path):
    profiling.clear_spans()
    with _session():
        with profiling.span("outer", 7):
            with profiling.span("inner", 7):
                gc.collect()
    assert profiling._collector_pass not in gc.callbacks
    records = profiling.records()
    passes = [r for r in records if r[0] == profiling.GC]
    assert passes and all(records[r[3]][0] == "inner" and r[4] == 7
                          for r in passes)
    inner = next(r for r in records if r[0] == "inner")
    assert all(inner[1] <= r[1] <= r[2] <= inner[2] for r in passes)
    assert list(profiling.spans()) == ["inner"]
    assert list(profiling.gc_spans()) == ["inner"]
    # trace() starts with an empty store, and its Chrome trace shows the
    # spans as record_function ranges
    log_dir = str(tmp_path / "trace")
    with profiling.trace(log_dir):
        with profiling.span("runner.resolve.objects"):
            pass
    assert list(profiling.spans()) == ["runner.resolve.objects"]
    profiling.clear_spans()
    with open(glob.glob(os.path.join(log_dir, "*.json"))[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "runner.resolve.objects" in names


def _collector_edges() -> int:
    """The references a full collector pass walks: those of every object
    it tracks."""
    gc.collect()
    return sum(len(gc.get_referents(o)) for o in gc.get_objects())


def test_recorded_spans_give_the_collector_nothing_more_to_walk():
    """A traced window records tens of thousands of spans; the records
    hold no object the collector walks, so its passes there cost what
    they cost without the recorder."""
    profiling.clear_spans()
    with _session():
        with profiling.span("runner.resolve", 1):
            pass
        before = _collector_edges()
        for _ in range(500):
            with profiling.span("runner.resolve", 1):
                with profiling.span("runner.resolve.objects"):
                    pass
        after = _collector_edges()
    assert len(profiling.records()) == 1001
    profiling.clear_spans()
    assert after - before < 100


def test_outputs_are_bitwise_equal_with_recording_on_and_off(off, on):
    for a, b in zip(off.outputs, on.outputs):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("metric", [m for m, _ in METRICS])
def test_each_span_metric_reads_a_session_and_nothing_without_one(
        off, on, metric):
    assert on.readings[metric] is not None and on.readings[metric] > 0
    assert off.readings[metric] is None


@pytest.mark.parametrize("layer", ["runner", "consensus"])
def test_padded_rows_count_a_partial_batch(off, layer):
    """The runner's full batch of 8 and its partial one of 5, and
    consensus_predict's 5 chunks, each at a batch size of 8: both partial
    buckets are 8."""
    real, pad = (after - before for after, before
                 in zip(off.rows_after[layer], off.rows_before[layer]))
    assert (real, pad) == ((13, 3) if layer == "runner" else (5, 3))
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(profiling, "_ROWS", {layer: list(off.rows_after[layer])})
        assert (profiling.padded_line(layer, off.rows_before[layer])
                == f"padded rows 3 of {real + pad} "
                f"({100 * 3 / (real + pad):.1f}%)")
