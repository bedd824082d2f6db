"""The port's bench (pepper_tpu_torch/bench.py) on the CPU: one JSON line
with bench.py's keys and metric string; each mode's forward is the port's
runner in that mode (the same probabilities on the same windows) and
reaches that mode's kernel wrapper alone; and bench_pipeline's subcommands
at a tiny size."""

import ast
import json
import pathlib
import sys

import numpy as np
import pytest
import torch

from pepper_tpu_torch import bench, bench_pipeline
from pepper_tpu_torch.infer.runner import InferenceRunner
from pepper_tpu_torch.models.transducer import TransducerConfig
from pepper_tpu_torch.ops import lstm_kernel

REPO = pathlib.Path(__file__).resolve().parent.parent
SMALL = TransducerConfig(hidden=32, linear_size=64)
# each bench mode, the runner's mode and the one kernel wrapper it reaches
ROUTES = {
    "int8_static": (dict(quantized=True, quantize_mode="static"),
                    "bilstm_fused_static"),
    "bf16": (dict(), "bilstm_fused"),
    "int8_dynamic": (dict(quantized=True, quantize_mode="dynamic"),
                     "lstm_recurrence"),
}


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One intra-op thread: the other test workers keep every core busy."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_bench_line():
    """The keys and metric string of the dict that bench.py's main
    prints."""
    tree = ast.parse((REPO / "bench.py").read_text())
    main = next(node for node in tree.body
                if isinstance(node, ast.FunctionDef) and node.name == "main")
    line = next(node for node in ast.walk(main) if isinstance(node, ast.Dict))
    keys = [key.value for key in line.keys]
    return keys, line.values[keys.index("metric")].value


@pytest.mark.parametrize("mode", bench.MODES)
def test_bench_prints_one_line_with_the_jax_keys(mode, monkeypatch, capsys):
    monkeypatch.setenv("PEPPER_BENCH_MODE", mode)
    line = bench.main(["--device", "cpu"], batch=4, n_short=1, n_long=2,
                      config=SMALL)
    printed = capsys.readouterr().out.strip().splitlines()
    assert len(printed) == 1 and json.loads(printed[0]) == line
    keys, metric = _jax_bench_line()
    assert list(line) == keys and line["metric"] == metric == bench.METRIC
    assert line["unit"] == "windows/s" and line["value"] > 0
    # the reference's model is not in the repository: no baseline
    assert line["vs_baseline"] == 0


def test_bench_defaults_to_the_jax_mode_and_refuses_others(monkeypatch):
    monkeypatch.delenv("PEPPER_BENCH_MODE", raising=False)
    seen = []
    real = bench.bench_forward

    def spy(mode, *args, **kwargs):
        seen.append(mode)
        return real(mode, *args, **kwargs)

    monkeypatch.setattr(bench, "bench_forward", spy)
    bench.bench_torch(batch=2, n_short=1, n_long=2, device="cpu",
                      config=SMALL)
    assert seen == ["int8_static"]
    with pytest.raises(ValueError, match="PEPPER_BENCH_MODE"):
        real("int4", torch.device("cpu"), SMALL)


@pytest.mark.parametrize("mode", bench.MODES)
def test_each_mode_is_the_runner_in_that_mode(mode, monkeypatch):
    runner_kwargs, wrapper = ROUTES[mode]
    forward, tree = bench.bench_forward(mode, torch.device("cpu"), SMALL)
    x = bench.bench_inputs(6, "cpu", SMALL)
    calls = {name: 0 for _, name in ROUTES.values()}
    for name in calls:
        real = getattr(lstm_kernel, name)

        def counted(*args, _name=name, _real=real, **kwargs):
            calls[_name] += 1
            return _real(*args, **kwargs)

        monkeypatch.setattr(lstm_kernel, name, counted)
    with torch.inference_mode():
        probs = forward(tree, x).numpy()
    assert calls == {name: 2 if name == wrapper and name != "lstm_recurrence"
                     else 4 if name == wrapper else 0 for name in calls}

    params = bench.init_transducer_params(torch.Generator().manual_seed(0),
                                          SMALL)
    runner = InferenceRunner(params, batch_size=8, compute_dtype="bfloat16",
                             window=SMALL.window,
                             features=SMALL.image_features, device="cpu",
                             **runner_kwargs)
    expected = runner.predict_images(x.float().numpy().astype(np.int8))
    np.testing.assert_allclose(probs, expected, rtol=0, atol=1e-6)


def test_bench_pipeline_stages_on_the_cpu(tmp_path):
    result = bench_pipeline.main_stages(0.03, 1, device="cpu",
                                        workdir=str(tmp_path))
    stages = result["stages"]
    assert set(stages) == {"simulation", "windows", "inference", "decode",
                           "vcf"}
    assert stages["inference"]["count"] == stages["windows"]["windows"] > 0
    assert result["records"] == stages["vcf"]["count"] > 0
    windows = bench_pipeline.bench_windows(0.03, "ont", 1,
                                           workdir=str(tmp_path / "w"))
    assert windows["windows"] > 0 and windows["aligned_per_s_core"] > 0


def _jax_bench_pipeline(monkeypatch, workdir):
    """The JAX package's bench_pipeline.py as a module, its compilation
    cache setup a no-op and its temporary directory `workdir`."""
    import importlib.util
    import tempfile

    from pepper_tpu.utils import jax_setup

    monkeypatch.setattr(jax_setup, "_done", True)
    spec = importlib.util.spec_from_file_location(
        "jax_bench_pipeline", REPO / "bench_pipeline.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    workdir.mkdir()
    monkeypatch.setattr(tempfile, "mkdtemp", lambda prefix=None: str(workdir))
    return module


def _logged(text, label):
    """The integer logged after `label` (log_line's lines)."""
    import re

    return int(re.search(re.escape(label) + r" ?([\d,]+)", text)
               .group(1).replace(",", ""))


def _same_files(ours, theirs, names):
    for name in names:
        assert (ours / name).read_bytes() == (theirs / name).read_bytes(), \
            name


def test_bench_pipeline_main_equals_the_jax_bench(tmp_path, monkeypatch,
                                                  capsys):
    """bench_pipeline main at 0.03 Mb, one thread, beside the JAX bench
    with the same params (JAX's PRNGKey(0) tree): the same BAM and FASTA
    bytes, windows and VCF records."""
    import jax

    from pepper_tpu.models.transducer import (
        init_transducer_params as jax_init)
    from pepper_tpu_torch.models import transducer

    jax_bench = _jax_bench_pipeline(monkeypatch, tmp_path / "jax")
    monkeypatch.setattr(sys, "argv", ["bench_pipeline.py", "0.03", "1"])
    capsys.readouterr()
    jax_bench.main()
    theirs = capsys.readouterr().err
    params = jax.tree_util.tree_map(np.array,
                                    jax_init(jax.random.PRNGKey(0)))
    monkeypatch.setattr(transducer, "init_transducer_params",
                        lambda generator: params)
    result = bench_pipeline.main_stages(0.03, 1, device="cpu",
                                        workdir=str(tmp_path / "port"))
    _same_files(tmp_path / "port", tmp_path / "jax", ("r.bam", "ref.fa"))
    assert result["stages"]["windows"]["windows"] == _logged(
        theirs, "CANDIDATE WINDOWS:") > 0
    assert result["records"] == _logged(theirs, "TOTAL RECORDS:") > 0
    assert result["true_variants"] == _logged(theirs, "TRUE VARIANTS:")


@pytest.mark.parametrize("subcommand", ["windows", "polish"])
def test_bench_pipeline_host_benches_equal_the_jax_bench(
        tmp_path, monkeypatch, capsys, subcommand):
    """windows (0.03 Mb, ont) and polish (12 kb, ont), one repeat each:
    the same BAM and FASTA bytes and the same windows or images as the
    JAX bench's."""
    jax_bench = _jax_bench_pipeline(monkeypatch, tmp_path / "jax")
    capsys.readouterr()
    if subcommand == "windows":
        jax_bench.bench_windows(0.03, "ont", 1)
        ours = bench_pipeline.bench_windows(0.03, "ont", 1,
                                            workdir=str(tmp_path / "port"))
        files, count = ("r.bam", "ref.fa"), ours["windows"]
    else:
        jax_bench.bench_polish_images(12, "ont", 1)
        ours = bench_pipeline.bench_polish_images(
            12, "ont", 1, workdir=str(tmp_path / "port"))
        files, count = ("r.bam", "d.fa"), ours["images"]
    theirs = capsys.readouterr().err
    _same_files(tmp_path / "port", tmp_path / "jax", files)
    assert count == _logged(theirs, "b/s/core),") > 0


@pytest.mark.parametrize("dtype", ["float32", "static"])
def test_bench_pipeline_consensus_lines(dtype, capsys):
    result = bench_pipeline.bench_consensus(1, 1, dtype, device="cpu",
                                            n_short=1, n_long=2)
    assert result["devices"] == ["cpu"] and result["batch"] == 1
    assert result["chunks_per_s"] * 1000 == pytest.approx(
        result["positions_per_s"])
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-1].startswith(f"B=1 dtype={dtype}: ")
    assert out[-1].endswith(" ms/batch)")


def test_bench_pipeline_main_routes_each_subcommand(monkeypatch):
    seen = []
    for name in ("main_stages", "bench_vcf_only", "bench_device",
                 "bench_consensus", "bench_polish_images", "bench_windows"):
        monkeypatch.setattr(bench_pipeline, name,
                            lambda *a, _name=name, **k: seen.append(
                                (_name, a, k)))
    for argv in (["2", "4", "--device", "cpu"], ["vcf", "10", "3"],
                 ["device", "0.5", "2", "--device", "cpu"],
                 ["consensus", "1", "128", "static", "--device", "cpu"],
                 ["polish", "50"], ["windows", "0.2", "uniform", "1"]):
        bench_pipeline.main(argv)
    assert seen[0] == ("main_stages", (2.0, 4), {"device": "cpu"})
    assert seen[1][:2] == ("bench_vcf_only", (10, 3))
    assert seen[2] == ("bench_device", (0.5, 2), {"device": "cpu"})
    assert seen[3] == ("bench_consensus", (1, 128, "static"),
                       {"device": "cpu"})
    assert seen[4] == ("bench_polish_images", (50.0, "ont", 2), {})
    assert seen[5] == ("bench_windows", (0.2, "uniform", 1), {})
    with pytest.raises(ValueError, match="float32 or static"):
        monkeypatch.undo()
        bench_pipeline.bench_consensus(1, 2, "bfloat16", device="cpu")


def test_bench_pipeline_device_flows_agree(tmp_path):
    result = bench_pipeline.bench_device(0.03, 1, device="cpu",
                                         workdir=str(tmp_path))
    assert result["b_windows"] == result["windows"] > 0
    assert result["b_vs_a_argmax_agree"] == result["windows"]
    assert result["c_windows"] > 0 and result["c_events"] > 0


def test_bench_pipeline_vcf_and_polish_images(tmp_path):
    vcf = bench_pipeline.bench_vcf_only(300, 2, workdir=str(tmp_path),
                                        contig_len=1_000_000)
    assert vcf["totals"][0] == 300 and len(vcf["stages"]) == 4
    images = bench_pipeline.bench_polish_images(12, "ont", 1,
                                                workdir=str(tmp_path))
    assert images["images"] > 0 and images["aligned_per_s_core"] > 0


def test_bench_multihost_two_processes_shard_the_same_windows(tmp_path,
                                                              monkeypatch,
                                                              capsys):
    """One gloo process and two on a tiny genome: each run's shards hold
    the same windows, and the summary line is bench_multihost.py's."""
    from pepper_tpu_torch import bench_multihost

    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
    summary = bench_multihost.main(["0.05", "1,2"])
    assert [row["hosts"] for row in summary] == [1, 2]
    assert summary[0]["windows"] == summary[1]["windows"] > 0
    assert summary[0]["speedup"] == 1.0
    printed = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(printed) == summary
    assert set(summary[0]) == {"hosts", "windows", "wall_s",
                               "windows_per_s", "speedup", "worker_cpu_s",
                               "windows_per_cpu_s"}
