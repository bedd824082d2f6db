"""The port stands alone: it imports neither JAX nor the JAX package, it
never runs on the CPU unless asked to, and it builds its native code into
its own build directory, once, even when several processes ask at once."""

import ast
import multiprocessing
import os
import pathlib

import numpy as np
import pytest
import torch

import pepper_tpu_torch
from pepper_tpu_torch.infer.runner import InferenceRunner
from pepper_tpu_torch.io import native
from pepper_tpu_torch.ops import cuda_build, lstm_kernel

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = pathlib.Path(pepper_tpu_torch.__file__).resolve().parent
# tests/simulate.py imports the JAX package; the port has its own copy
FORBIDDEN = ("jax", "jaxlib", "pepper_tpu", "simulate")


def _port_sources():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imported_modules(path):
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


def test_port_imports_no_jax_and_no_jax_package():
    sources = _port_sources()
    assert len(sources) > 20 and (REPO / "chip_smoke.py").exists()
    # the device-pileup, training, utility, bench and example modules are
    # among the scanned sources
    for module in ("ops/pileup_kernel.py", "ops/device_windows.py",
                   "infer/device_runner.py", "device.py",
                   "models/torch_convert.py", "models/alternates.py",
                   "ops/pileup_hp.py", "infer/hp_sliding.py",
                   "decode/hp_legacy.py", "io/vcf_reader.py",
                   "decode/merge_variants.py", "io/datastore.py",
                   "polish/datastore.py", "pipeline/stages.py",
                   "parallel/mesh.py", "parallel/dist.py",
                   "train/__init__.py", "train/data.py", "train/step.py",
                   "train/trainer.py", "train/resume.py",
                   "train/hyperband.py", "polish/train.py",
                   "polish/stitch_v2.py", "polish/legacy_variant_summary.py",
                   "utils/__init__.py", "utils/download_model.py",
                   "utils/vcf_compare.py", "utils/pileup_text.py",
                   "utils/merge_images.py", "utils/profiling.py",
                   "utils/simulate.py", "bench.py", "bench_pipeline.py",
                   "bench_multihost.py", "examples/__init__.py",
                   "examples/simulated_quickstart.py",
                   "examples/acceptance_run.py", "examples/chr_scale_run.py",
                   "examples/hp_acceptance_run.py",
                   "examples/polish_scale_run.py"):
        assert PORT / module in sources, module
    for path in sources:
        for module in _imported_modules(path):
            top = module.split(".")[0]
            assert top not in FORBIDDEN, f"{path} imports {module}"


def test_h5py_is_imported_inside_functions_only():
    """No module of the port imports h5py at its top level, so
    call_variant and polish import on a host without it; only
    io/datastore.py's require_h5py imports it."""
    importers = []
    for path in sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in tree.body:
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import)
                     else [node.module or ""]
                     if isinstance(node, ast.ImportFrom) else [])
            assert "h5py" not in [n.split(".")[0] for n in names], path
        if "h5py" in _imported_modules(path):
            importers.append(path.relative_to(PORT.parent).as_posix())
    assert importers == ["pepper_tpu_torch/io/datastore.py"]


def test_scan_sees_imports_inside_functions(tmp_path):
    """The AST scan walks function bodies: torch_convert's import of torch
    inside load_reference_checkpoint (the only torch.load of a pickle) is
    seen, and passes; a JAX import there would not."""
    path = PORT / "models" / "torch_convert.py"
    modules = list(_imported_modules(path))
    assert "torch" in modules and "numpy" in modules
    tree = ast.parse(path.read_text())
    loader = next(node for node in ast.walk(tree)
                  if isinstance(node, ast.FunctionDef)
                  and node.name == "load_reference_checkpoint")
    assert any(isinstance(node, ast.Import)
               and node.names[0].name == "torch" for node in ast.walk(loader))
    assert "weights_only=False" in ast.get_source_segment(path.read_text(),
                                                          loader)
    probe = tmp_path / "probe.py"
    probe.write_text("def load():\n    import jax.numpy\n")
    assert list(_imported_modules(probe)) == ["jax.numpy"]


def test_runner_without_device_never_falls_back_to_cpu():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is usable")
    from pepper_tpu_torch.models.transducer import (TransducerConfig,
                                                    init_transducer_params)

    params = init_transducer_params(torch.Generator().manual_seed(0),
                                    TransducerConfig(hidden=32,
                                                     linear_size=64))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InferenceRunner(params)
    runner = InferenceRunner(params, device="cpu")
    assert runner.predict_images(
        np.zeros((2, 33, 26), np.int8)).shape == (2, 3)


def test_call_variant_without_device_raises_here(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is usable")
    from pepper_tpu_torch.options import PepperOptions
    from pepper_tpu_torch.pipeline.call_variant import call_variant

    options = PepperOptions(output_dir=str(tmp_path / "out"), dry=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call_variant(options)
    assert not (tmp_path / "out").exists()


def test_bench_and_example_runs_without_device_raise_here(tmp_path):
    """Asked for cuda (or given no device) without a card, the bench, the
    pipeline bench and every example run raise before they simulate or
    write anything; none falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is usable")
    from pepper_tpu_torch import bench, bench_pipeline
    from pepper_tpu_torch.examples import (acceptance_run, chr_scale_run,
                                           hp_acceptance_run,
                                           polish_scale_run,
                                           simulated_quickstart)

    calls = [lambda: bench.main([]),
             lambda: bench.bench_torch(device="cuda"),
             lambda: bench_pipeline.main(["consensus"]),
             lambda: bench_pipeline.main(["device", "--device", "cuda"]),
             lambda: bench_pipeline.main_stages(workdir=str(tmp_path)),
             lambda: simulated_quickstart.main([str(tmp_path / "qs")]),
             lambda: acceptance_run.run(base=str(tmp_path / "a")),
             lambda: chr_scale_run.run(device="cuda",
                                       base=str(tmp_path / "c")),
             lambda: hp_acceptance_run.main(["--device", "cuda"]),
             lambda: polish_scale_run.run(base=str(tmp_path / "p"))]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert os.listdir(tmp_path) == []


# what the JAX package's own build writes next to its sources, maybe in
# another test process at the same time
JAX_BUILD_OUTPUTS = (".o", ".so", ".buildinfo")


def _tree_state(root, skip_suffixes=()):
    return {str(p.relative_to(root)): (p.stat().st_size, p.stat().st_mtime_ns)
            for p in root.rglob("*") if p.is_file()
            and "__pycache__" not in p.parts
            and not p.name.endswith(skip_suffixes)}


def _build_into(build_dir):
    native.build_native(build_dir)


def test_native_build_is_isolated_and_built_once(tmp_path):
    """Three processes ask for the native build into one empty directory
    at the same moment: all succeed, the outputs and their stamp are there,
    no temporary directory is left, and nothing under pepper_tpu/ or the
    port's source tree changed."""
    watched = [(REPO / "pepper_tpu", JAX_BUILD_OUTPUTS),
               (PORT / "io" / "_native", ())]
    before = [_tree_state(*w) for w in watched]
    build_dir = tmp_path / "build"
    ctx = multiprocessing.get_context("fork")
    procs = [ctx.Process(target=_build_into, args=(str(build_dir),))
             for _ in range(3)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=300)
        assert not p.is_alive() and p.exitcode == 0
    names = sorted(os.listdir(build_dir))
    assert names == sorted(native.NATIVE_OUTPUTS
                           + ["native.lock", "native.stamp"])
    assert [_tree_state(*w) for w in watched] == before
    # a fresh stamp means no rebuild: the outputs are not replaced
    mtimes = [os.stat(build_dir / n).st_mtime_ns for n in native.NATIVE_OUTPUTS]
    native.build_native(str(build_dir))
    assert mtimes == [os.stat(build_dir / n).st_mtime_ns
                      for n in native.NATIVE_OUTPUTS]


def test_default_build_dir_is_ignored_by_git():
    assert native.build_native() == os.path.join(str(PORT), "_build")
    ignore = (REPO / ".gitignore").read_text().split()
    assert "pepper_tpu_torch/_build/" in ignore


def test_kernel_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("nvcc is installed at its default path")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        lstm_kernel.build_kernel(str(tmp_path / "build"))
    assert not (tmp_path / "build" / "liblstm_direction_fused.so").exists()


def test_polish_entry_points_without_device_raise_here(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is usable")
    from pepper_tpu_torch.cli import polish_main
    from pepper_tpu_torch.options import PepperOptions
    from pepper_tpu_torch.polish.consensus import consensus_predict
    from pepper_tpu_torch.polish.pipeline import polish

    images = np.zeros((1, 1000, 10), np.uint8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        consensus_predict({}, images)
    options = PepperOptions(output_dir=str(tmp_path / "out"), dry=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        polish(options, None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        polish_main.main(["polish", "--dry", "-o", str(tmp_path / "cli")])
    assert not (tmp_path / "out").exists()
    assert not (tmp_path / "cli").exists()


def _includes(path):
    return {line.split('"')[1] for line in path.read_text().splitlines()
            if line.startswith('#include "')}


@pytest.mark.parametrize("name", sorted(cuda_build.KERNELS))
def test_kernel_stamp_covers_every_header_it_includes(name):
    """A kernel's build stamp digests its source and every header it pulls
    in, so an edit to a shared header rebuilds each kernel that uses it."""
    csrc = PORT / "ops" / "csrc"
    seen, todo = set(), [csrc / f"{name}.cu"]
    while todo:
        for header in _includes(todo.pop()) - seen:
            seen.add(header)
            todo.append(csrc / header)
    assert seen == set(cuda_build.KERNELS[name][0])


def test_every_kernel_has_a_wrapper_with_a_twin_and_a_count():
    from pepper_tpu_torch.ops import (attention_kernel, gru_kernel,
                                      pileup_kernel)

    modules = {name: module
               for module in (lstm_kernel, gru_kernel, pileup_kernel,
                              attention_kernel)
               for name in module.KERNELS}
    # each wrapper launches the library of its name, or the one its module
    # names for it
    libraries = [getattr(module, "LIBRARIES", {}).get(name, name)
                 for name, module in modules.items()]
    assert sorted(libraries) == sorted(cuda_build.KERNELS)
    for name, module in modules.items():
        assert getattr(module, name).launches >= 0
        assert callable(getattr(module, f"{name}_reference"))


def test_gru_kernel_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("nvcc is installed at its default path")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.build_kernel(str(tmp_path / "build"),
                                name="gru_direction_fused")
    assert not (tmp_path / "build" / "libgru_direction_fused.so").exists()


def test_pileup_kernel_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("nvcc is installed at its default path")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.build_kernel(str(tmp_path / "build"),
                                name="pileup_histogram")
    assert not (tmp_path / "build" / "libpileup_histogram.so").exists()


def test_device_pileup_call_variant_without_device_raises_here(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is usable")
    from pepper_tpu_torch.cli import main as cli
    from pepper_tpu_torch.options import PepperOptions
    from pepper_tpu_torch.pipeline.call_variant import call_variant

    options = PepperOptions(output_dir=str(tmp_path / "out"),
                            device_pileup=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call_variant(options, params={})
    assert not (tmp_path / "out").exists()
    from pepper_tpu_torch.models.checkpoint import save_params

    model = tmp_path / "model.npz"
    save_params(str(model), {"linear_1": {"w": np.zeros((2, 2))}},
                {"model_type": "lstm"})
    bam, fasta = tmp_path / "r.bam", tmp_path / "r.fa"
    for path in (bam, fasta, tmp_path / "r.bam.bai", tmp_path / "r.fa.fai"):
        path.write_bytes(b"")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["call_variant", "-b", str(bam), "-f", str(fasta),
                  "-m", str(model), "-o", str(tmp_path / "cli"),
                  "--device_pileup"])


def test_polish_training_entry_points_without_device_raise_here(tmp_path):
    """Polish training, its evals and the polish CLI's training
    subcommands run on cuda unless asked for the CPU, and raise here
    before they write anything."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is usable")
    from pepper_tpu_torch.cli import polish_main
    from pepper_tpu_torch.options import PepperOptions
    from pepper_tpu_torch.polish import train

    images = np.zeros((2, 1000, 10), np.float32)
    labels = np.zeros((2, 1000), np.int32)
    out = str(tmp_path / "run")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.train_polish_on_arrays(PepperOptions(), images, labels, out)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.test_polish_on_arrays(PepperOptions(), images, labels, {})
    for argv in (["train_model", "-i", str(tmp_path), "-o", out],
                 ["test_model", "-i", str(tmp_path), "-m", "m.npz"],
                 ["run_hyperband", "-i", str(tmp_path), "-o", out]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            polish_main.main(argv)
    assert not os.path.exists(out)
