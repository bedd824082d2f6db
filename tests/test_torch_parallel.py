"""The port's data-parallel and multi-process paths (parallel/mesh.py,
parallel/dist.py, the device lists of InferenceRunner, consensus_predict
and predict_hp, call_variant_sharded and polish_sharded) on the CPU.

Bars: resolve_num_devices, the padding and split, shard_intervals and
RegionManifest equal the JAX package's; over [cpu, cpu] the runner's
probabilities stay within 1e-5 of one device's in float32 and 1e-3 in
int8 (tests/test_sharded_inference.py:33,50), the consensus labels and
the x10000 HP votes are equal; the sharded path, with resume and in two
gloo processes, writes the one-process call set (record for record) and
the one-process FASTA bytes (the port's polish(), which
tests/test_torch_polish.py holds to the JAX package's bytes).
"""

import gzip
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from pepper_tpu.infer.runner import InferenceRunner as JaxRunner
from pepper_tpu.models.transducer import (TransducerConfig,
                                          init_transducer_params)
from pepper_tpu.parallel import dist as jdist
from pepper_tpu.parallel import mesh as jmesh
from pepper_tpu_torch.infer.runner import InferenceRunner
from pepper_tpu_torch.io.bam_writer import write_bam, write_fasta
from pepper_tpu_torch.models.checkpoint import save_params
from pepper_tpu_torch.options import PepperOptions
from pepper_tpu_torch.parallel import dist, mesh
from pepper_tpu_torch.pipeline import call_variant as cv
from pepper_tpu_torch.polish import pipeline
from pepper_tpu_torch.presets import set_parameters

from simulate import random_reference, simulate_reads
from test_torch_polish import one_intra_op_thread, polish_sim  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONTIG = "chrD"


# ---------------------------------------------------------------- mesh


@pytest.mark.parametrize("local", [1, 4])
def test_resolve_num_devices_equals_jax(monkeypatch, local):
    """Against the JAX package's resolve on `local` devices: the port's on
    `local` GPUs; on the CPU it is 1, as JAX on one CPU device gives."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: local)
    monkeypatch.setattr(jax, "local_device_count", lambda: local)
    one = 1
    for request in (-1, 0, None, 1, 2, 3, 4, 10**6):
        theirs = jmesh.resolve_num_devices(request)
        assert mesh.resolve_num_devices(request, "cuda") == theirs, request
        monkeypatch.setattr(jax, "local_device_count", lambda: one)
        assert mesh.resolve_num_devices(request, "cpu") == \
            jmesh.resolve_num_devices(request) == 1
        monkeypatch.setattr(jax, "local_device_count", lambda: local)
        devices = mesh.local_devices(request, "cuda")
        if theirs == 1:
            assert devices is None and mesh.local_devices(request,
                                                          "cpu") is None
        else:
            assert devices == [torch.device("cuda", i)
                               for i in range(theirs)]


@pytest.mark.parametrize("n,parts", [(0, 2), (5, 1), (5, 2), (7, 3),
                                     (8, 4)])
def test_split_rows_equals_pad_to_multiple(n, parts):
    """Contiguous row blocks in device order of JAX's zero padding."""
    array = np.arange(n * 6, dtype=np.float32).reshape(n, 2, 3) + 1
    blocks, rows = mesh.split_rows(array, parts)
    padded, j_rows = jmesh.pad_to_multiple(array, parts)
    assert rows == j_rows == n and len(blocks) == parts
    assert len({len(b) for b in blocks}) == 1
    np.testing.assert_array_equal(np.concatenate(blocks), padded)


def test_replicate_puts_one_tree_on_each_device():
    tree = {"a": {"w": np.ones((2, 3), np.float32)}, "b": {"s": None}}
    trees = mesh.replicate(tree, ["cpu", "cpu"])
    assert len(trees) == 2 and trees[0]["b"]["s"] is None
    assert trees[0]["a"]["w"] is not trees[1]["a"]["w"]
    for t in trees:
        np.testing.assert_array_equal(t["a"]["w"].numpy(), tree["a"]["w"])


def test_shard_intervals_equal_jax():
    intervals = [("c", i * 100, (i + 1) * 100) for i in range(17)]
    for count in (1, 2, 4, 5):
        shards = [dist.shard_intervals(intervals, p, count)
                  for p in range(count)]
        assert shards == [jdist.shard_intervals(intervals, p, count)
                          for p in range(count)]
        assert sorted(i for s in shards for i in s) == sorted(intervals)


def test_region_manifest_equals_jax_and_resumes(tmp_path):
    """The port's manifest reads the JAX package's files and the other
    way round, with the same pending/completed answers."""
    intervals = [("chr1", 0, 100), ("chr1", 100, 200), ("chr2", 0, 50)]
    ours = dist.RegionManifest(str(tmp_path / "ours"))
    theirs = jdist.RegionManifest(str(tmp_path / "theirs"))
    for manifest in (ours, theirs):
        manifest.write(intervals)
        manifest.mark_done(("chr1", 100, 200))
    for directory in ("ours", "theirs"):
        a = dist.RegionManifest(str(tmp_path / directory))
        b = jdist.RegionManifest(str(tmp_path / directory))
        assert a.read() == b.read() == intervals
        assert a.pending() == b.pending() == [("chr1", 0, 100),
                                              ("chr2", 0, 50)]
        assert a.completed() == b.completed() == [("chr1", 100, 200)]
        assert a.is_done(("chr1", 100, 200)) and not a.is_done(intervals[0])


def test_one_process_collectives_are_identities(monkeypatch):
    for key in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(key, raising=False)
    assert dist.init_distributed() == (0, 1)
    assert dist.init_distributed("127.0.0.1:1", 1, 0) == (0, 1)
    x = np.arange(12).reshape(4, 3)
    np.testing.assert_array_equal(dist.all_gather_rows(x), x)
    dist.barrier("noop")
    dist.shutdown_distributed()


# ---------------------------------------------------------------- runner


def _params(hidden=32):
    return jax.tree_util.tree_map(np.array, init_transducer_params(
        jax.random.PRNGKey(4), TransducerConfig(hidden=hidden,
                                                linear_size=64)))


def _images(n, seed=0):
    return np.random.RandomState(seed).randint(
        -125, 126, (n, 33, 26)).astype(np.int8)


RUNNER_MODES = [("float32", {}, 1e-5),
                ("bfloat16", {"compute_dtype": "bfloat16"}, 1e-5),
                ("static", {"quantized": True}, 1e-3),
                ("static_rec", {"quantized": True,
                                "quantize_mode": "static_rec"}, 1e-3),
                ("dynamic", {"quantized": True,
                             "quantize_mode": "dynamic"}, 1e-3)]


@pytest.mark.parametrize("name,kw,atol", RUNNER_MODES,
                         ids=[m[0] for m in RUNNER_MODES])
def test_runner_over_two_devices_equals_one(name, kw, atol):
    """37 windows at a batch of 15 over [cpu, cpu]: the batch rounds up to
    16 and every bucket to an even size; predict_images and the dispatch/
    resolve pair give one device's probabilities, argmax equal."""
    params = _params()
    one = InferenceRunner(params, batch_size=15, device="cpu", **kw)
    two = InferenceRunner(params, batch_size=15, devices=["cpu", "cpu"],
                          **kw)
    assert two.batch_size == 16 and two.num_devices == 2
    assert len(two._trees) == 2
    assert two._trees[0][0] is not two._trees[1][0]
    images = _images(37)
    expected = one.predict_images(images)
    got = two.predict_images(images)
    np.testing.assert_allclose(got, expected, atol=atol)
    np.testing.assert_array_equal(got.argmax(1), expected.argmax(1))
    blocks = two._enqueue(images[:9], np.int8)
    assert [len(p) for p, _ in blocks] == [8, 1]
    np.testing.assert_allclose(two._gather(blocks), expected[:9], atol=atol)


def test_runner_buckets_equal_the_jax_mesh_runner():
    params = _params()
    theirs = JaxRunner(params, batch_size=1000, mesh=jmesh.get_mesh(3))
    ours = InferenceRunner(params, batch_size=1000,
                           devices=["cpu", "cpu", "cpu"])
    assert ours.batch_size == theirs.batch_size == 1002
    for n in (1, 10, 255, 256, 257, 300, 700, 1000, 1002):
        assert ours._bucket(n) == theirs._bucket(n), n


# ---------------------------------------------------------------- sharded


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """tests/test_multihost.py's 5 kb scene (seed 88, four SNPs) and a
    seeded H=32 transducer as a checkpoint."""
    tmp = tmp_path_factory.mktemp("torch_parallel")
    ref = random_reference(5000, seed=88)
    alt = {"A": "T", "T": "A", "C": "G", "G": "C"}
    variants = [(p, ref[p], alt[ref[p]]) for p in (700, 1700, 2700, 3700)]
    records = simulate_reads(ref, [variants, []], read_len=300, stride=20)
    bam, fasta = str(tmp / "sim.bam"), str(tmp / "ref.fa")
    write_bam(bam, [(CONTIG, len(ref))], records)
    write_fasta(fasta, {CONTIG: ref})
    params = _params()
    model = str(tmp / "model.npz")
    save_params(model, params, {"model_type": "lstm"})
    return dict(tmp=tmp, bam=bam, fasta=fasta, params=params, model=model)


def _options(scene, out, **overrides):
    options = PepperOptions(bam=scene["bam"], fasta=scene["fasta"],
                            output_dir=str(out), threads=1,
                            ont_r9_guppy5_sup=True,
                            sub_command="call_variant", region=CONTIG,
                            region_size=1000, batch_size=64)
    for key, value in overrides.items():
        setattr(options, key, value)
    return set_parameters(options)


def _records(out_dir):
    rows = []
    with gzip.open(os.path.join(out_dir, "PEPPER_VARIANT_FULL.vcf.gz"),
                   "rt") as f:
        for line in f:
            if not line.startswith("#"):
                fields = line.rstrip("\n").split("\t")
                rows.append((fields[0], fields[1], fields[3], fields[4],
                             fields[9].split(":")[0], fields[6]))
    return rows


@pytest.fixture(scope="module")
def one_process(scene):
    out = scene["tmp"] / "one_process"
    cv.call_variant(_options(scene, out), params=scene["params"],
                    device="cpu")
    assert _records(out)
    return _records(out)


def test_sharded_call_variant_with_resume_equals_call_variant(
        scene, one_process):
    """tests/test_dist.py's flow on the port: a first run marks every
    interval done; a rerun resumes with nothing pending and decodes the
    same records; with one done-marker removed, that interval is redone
    (its stored batch kept) and the records stay the same."""
    out = scene["tmp"] / "sharded"
    totals = cv.call_variant_sharded(_options(scene, out),
                                     params=scene["params"], device="cpu")
    assert totals is not None and _records(out) == one_process
    manifest = dist.RegionManifest(os.path.join(out, "manifest"))
    assert manifest.pending() == [] and len(manifest.completed()) == 5
    first = manifest.completed()
    assert cv.call_variant_sharded(_options(scene, out),
                                   params=scene["params"],
                                   device="cpu") == totals
    assert manifest.completed() == first
    os.remove(manifest._marker(first[1]))
    assert manifest.pending() == [first[1]]
    assert cv.call_variant_sharded(_options(scene, out),
                                   params=scene["params"],
                                   device="cpu") == totals
    assert manifest.pending() == [] and _records(out) == one_process


def test_sharded_call_variant_over_a_device_list(scene, one_process):
    out = scene["tmp"] / "sharded_two"
    options = _options(scene, out)
    cv.call_variant_sharded(options, params=scene["params"],
                            devices=["cpu", "cpu"])
    assert options.num_devices == 2
    assert _records(out) == one_process


WORKER = r'''
import sys
sys.path.insert(0, {repo!r})
from pepper_tpu_torch.models.checkpoint import load_params
from pepper_tpu_torch.options import PepperOptions
from pepper_tpu_torch.parallel import dist
from pepper_tpu_torch.pipeline.call_variant import call_variant_sharded
from pepper_tpu_torch.polish.pipeline import polish_sharded
from pepper_tpu_torch.presets import set_parameters

rank, world = dist.init_distributed({address!r}, 2, int(sys.argv[1]))
assert world == 2
params, _ = load_params({model!r})
options = set_parameters(PepperOptions(
    bam={bam!r}, fasta={fasta!r}, output_dir={out!r} + "/call", threads=1,
    ont_r9_guppy5_sup=True, sub_command="call_variant", region={contig!r},
    region_size=1000, batch_size=64))
totals = call_variant_sharded(options, params=params, device="cpu")
assert (totals is not None) == (rank == 0), totals
polish_params, _ = load_params({polish_model!r})
polish_options = PepperOptions(
    bam={polish_bam!r}, fasta={polish_fasta!r},
    output_dir={out!r} + "/polish", threads=1, batch_size=8)
path = polish_sharded(polish_options, polish_params, device="cpu")
assert (path is not None) == (rank == 0), path
gathered = dist.all_gather_rows([[rank, rank + 10]] * (rank + 1))
assert gathered.tolist() == [[0, 10], [1, 11], [1, 11]], gathered
dist.shutdown_distributed()
print("RANK", rank, "DONE", totals)
'''


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def polish_one_process(polish_sim):  # noqa: F811
    options = PepperOptions(bam=polish_sim["bam"], fasta=polish_sim["fasta"],
                            output_dir=str(polish_sim["tmp"] / "one_process"),
                            threads=1, batch_size=8)
    with open(pipeline.polish(options, polish_sim["params"], device="cpu"),
              "rb") as f:
        return f.read()


def test_two_gloo_processes_give_the_one_process_outputs(
        scene, one_process, polish_sim, polish_one_process):  # noqa: F811
    """call_variant_sharded and polish_sharded in two processes of one
    gloo group: two prediction files each, rank 0's merged VCF has the
    one-process records, its FASTA the one-process bytes."""
    out = scene["tmp"] / "two_processes"
    script = WORKER.format(
        repo=REPO, address=f"127.0.0.1:{_free_port()}",
        model=scene["model"], bam=scene["bam"], fasta=scene["fasta"],
        out=str(out), contig=CONTIG, polish_model=polish_sim["model"],
        polish_bam=polish_sim["bam"], polish_fasta=polish_sim["fasta"])
    # one intra-op thread a process: two busy processes spinning on
    # every core of a shared host would slow each other tens of times
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(key, None)
    procs = [subprocess.Popen([sys.executable, "-c", script, str(rank)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, env=env)
             for rank in (0, 1)]
    outputs = []
    for proc in procs:
        try:
            outputs.append(proc.communicate(timeout=240)[0].decode())
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            raise
    for proc, text in zip(procs, outputs):
        assert proc.returncode == 0, text[-3000:]
    for stage in ("call", "polish"):
        assert sorted(os.listdir(out / stage / "predictions")) == [
            "pepper_prediction_0.hdf", "pepper_prediction_1.hdf"]
    assert _records(out / "call") == one_process
    with open(out / "polish" / "consensus_pepper_polished.fa", "rb") as f:
        assert f.read() == polish_one_process


def test_polish_sharded_one_process_with_resume(
        polish_sim, polish_one_process):  # noqa: F811
    out = polish_sim["tmp"] / "polish_sharded"
    options = PepperOptions(bam=polish_sim["bam"], fasta=polish_sim["fasta"],
                            output_dir=str(out), threads=1, batch_size=8)
    for _ in range(2):      # the second run resumes with nothing pending
        path = pipeline.polish_sharded(options, polish_sim["params"],
                                       devices=["cpu", "cpu"])
        with open(path, "rb") as f:
            assert f.read() == polish_one_process
    manifest = dist.RegionManifest(str(out / "manifest"))
    assert manifest.pending() == [] and manifest.completed()
