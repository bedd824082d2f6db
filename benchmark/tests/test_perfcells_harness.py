"""The harness on the CPU at tiny sizes: the result line's keys, a cell
and a metric added by files alone, the work counts, and the modules a run
may load.  Run with `python -m pytest benchmark/tests -q`."""

from __future__ import annotations

import ast
import hashlib
import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

from benchmark import run, spec

BENCH = pathlib.Path(spec.HERE)
ROOT = pathlib.Path(spec.ROOT)
TINY = {"rows_per_device": 8, "pool": 2}


def _result(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_result_line_has_the_keys_and_the_checks_last(capsys):
    assert run.main(["--workload", "snp.stream.f32", "--seed",
                     str(2 ** 31 + 12345), "--seconds", "0.2", "--trace",
                     "0"], device="cpu", traffic=TINY) == 0
    result = _result(capsys)
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics",
                                "device"]
    assert list(result)[-1] == "checks"
    assert result["correct"] is True and result["failed"] == 0
    assert set(result["metrics"]) == {"windows_per_s", "setup_s"}
    for metric in result["metrics"].values():
        assert metric["value"] > 0 and metric["unit"]
    assert set(result["device"]) >= {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    assert set(result["checks"]) == {"prob_gap", "misplaced", "failed"}
    for check in result["checks"].values():
        assert check["value"] <= check["limit"]


def test_same_seed_same_inputs_and_weights():
    import torch

    from benchmark import generate

    cell = spec.load_cell("snp.stream.bf16")
    a = generate.make_pool(cell.config, 4, 2, (33, 26), 2 ** 31 + 7)
    b = generate.make_pool(cell.config, 4, 2, (33, 26), 2 ** 31 + 7)
    assert (a == b).all() and a.dtype.name == "int8"
    assert a.min() >= -125 and a.max() <= 125
    shapes = spec.load_module("reference", "pepper_snp").param_shapes(
        cell.config)
    w1 = generate.make_weights(shapes, 5, "cpu")
    w2 = generate.make_weights(shapes, 5, "cpu")
    assert torch.equal(w1["decoder"]["w_hh_b"], w2["decoder"]["w_hh_b"])
    polish = spec.load_cell("polish.consensus.f32").config
    chunks = generate.make_pool(polish, 2, 1, (1000, 10), 3)
    assert chunks.dtype.name == "uint8"
    assert (chunks.astype(int).sum(-1) <= 255 + 10).all()


def test_work_matches_the_hand_counts():
    snp = spec.load_module("work", "pepper_snp")
    polish = spec.load_module("work", "pepper_polish")
    assert snp.flops_per_item(spec.load_cell(
        "snp.stream.bf16").config) == 161_328_128
    assert polish.flops_per_item(spec.load_cell(
        "polish.consensus.f32").config) == 1_528_268_800


def _digest(folder):
    return {str(p.relative_to(folder)): hashlib.sha256(
        p.read_bytes()).hexdigest()
        for p in sorted(folder.rglob("*")) if p.is_file()
        and "__pycache__" not in p.parts}


def test_a_cell_and_a_metric_are_added_by_files_alone(tmp_path):
    """A copy of the benchmark gains a traffic mix, a cell's limits and a
    metric's reader as new files, and entries in BENCHMARK.json; no file
    it had changes, and the new cell reports the new metric."""
    copy = tmp_path / "benchmark"
    shutil.copytree(BENCH, copy, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    before = _digest(copy)
    (copy / "traffic" / "stream_f32_small.json").write_text(json.dumps(
        {"rows_per_device": 8, "pool": 2, "compute_dtype": "float32"}))
    (copy / "limits" / "snp.dummy.json").write_text(
        (copy / "limits" / "snp.stream.f32.json").read_text())
    (copy / "metrics" / "dummy_batches.py").write_text(
        "def read(r):\n    return float(r.batches)\n")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append(
        {"name": "snp.dummy", "config": "pepper_snp",
         "traffic": "stream_f32_small", "chips": 1, "why": "a test cell"})
    bench["end_to_end"][0]["workloads"].append("snp.dummy")
    bench["per_layer"].append(
        {"name": "dummy_batches.snp", "unit": "batches", "better": "higher",
         "source": "host_clock", "layer": "runner (infer/runner.py)",
         "moves": "windows_per_s", "workloads": ["snp.dummy"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import sys; from benchmark import run; sys.exit(run.main(["
            "'--workload', 'snp.dummy', '--seed', '11', '--seconds', '0.2',"
            " '--trace', '1'], device='cpu'))")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    done = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert done.returncode == 0, done.stderr[-2000:]
    result = json.loads(done.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    assert result["metrics"]["dummy_batches.snp"]["value"] >= 1
    after = _digest(copy)
    assert {k: v for k, v in after.items() if k in before} == before


def test_a_run_without_the_cards_prints_nothing_and_fails(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert run.main(["--workload", "snp.stream.bf16", "--seed", "1",
                     "--seconds", "1", "--trace", "0"]) != 0
    assert capsys.readouterr().out == ""


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", getattr(node.func, "attr", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_no_module_the_benchmark_runs_loads_jax_or_the_jax_package():
    sources = sorted(BENCH.rglob("*.py"))
    assert len(sources) > 15
    for path in sources:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in run.FORBIDDEN, (path, name)
            if "reference" in path.parts:
                assert top != "pepper_tpu_torch", (path, name)
