"""The port's polish path (models/polish_gru.py, the polish half of
models/quantize.py, polish/consensus.py, polish/pipeline.py and the polish
CLI) against the JAX package, on the CPU.

Inputs are made with numpy from a seed; parameters come from JAX's
init_polish_params and reach the port through params_from_jax.  The JAX
consensus on the CPU runs its unfused scan; the port's fused branch is
taken with PEPPER_GRU_FUSED=1 (the kernels' twins).  Bars:

  * polish_forward / polish_forward_fused: atol 2e-5 (tests/test_polish.py);
  * consensus_scan: votes atol 1e-4, labels equal, phred atol 1e-3
    (tests/test_polish.py:109-118); its carry is 128 wide, so H=128;
  * consensus_scan_static: votes atol 5e-3, labels equal where JAX's
    top-two vote margin exceeds 0.05 (see its test); the int8 tree equal to
    JAX's bit for bit;
  * polish: the same FASTA bytes as the JAX package's polish().
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pepper_tpu.io.bam_writer import BamRecord, write_bam, write_fasta
from pepper_tpu.models import quantize as jq
from pepper_tpu.models.checkpoint import save_params
from pepper_tpu.models.polish_gru import init_polish_params
from pepper_tpu.models.polish_gru import polish_forward as j_polish_forward
from pepper_tpu.options import PepperOptions as JaxOptions
from pepper_tpu.polish import consensus as jc
from pepper_tpu.polish.pipeline import polish as j_polish
from pepper_tpu_torch.cli import polish_main
from pepper_tpu_torch.models import polish_gru, quantize
from pepper_tpu_torch.models.params import params_from_jax
from pepper_tpu_torch.options import PepperOptions
from pepper_tpu_torch.polish import consensus, pipeline

from simulate import (apply_variants, random_reference, read_from_haplotype,
                      simulate_reads)

CONTIG = "ctg1"


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One intra-op thread for the module: the consensus runs thousands of
    tiny ops, and with a thread a core each waits on the slowest of them
    while the other test workers keep every core busy (tens of times
    slower); one thread computes the same."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _params(seed):
    return jax.tree_util.tree_map(np.asarray, init_polish_params(
        jax.random.PRNGKey(seed)))


def _images(n, seed, high=255):
    return np.random.RandomState(seed).randint(
        0, high, (n, 1000, 10)).astype(np.float32)


# ---------------------------------------------------------------- model


def test_polish_forward_matches_jax_over_two_windows():
    params = _params(1)
    rng = np.random.RandomState(0)
    x1, x2 = (rng.rand(3, 100, 10).astype(np.float32) for _ in range(2))
    h0 = np.zeros((3, 2, 128), np.float32)
    tparams = params_from_jax(params, "cpu")
    out1, h1 = polish_gru.polish_forward(tparams, torch.from_numpy(x1),
                                         torch.from_numpy(h0))
    out2, h2 = polish_gru.polish_forward(tparams, torch.from_numpy(x2), h1)
    j_out1, j_h1 = j_polish_forward(params, jnp.asarray(x1), jnp.asarray(h0))
    j_out2, j_h2 = j_polish_forward(params, jnp.asarray(x2), j_h1)
    for ours, theirs in ((out1, j_out1), (h1, j_h1), (out2, j_out2),
                         (h2, j_h2)):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs),
                                   atol=2e-5)


@pytest.mark.parametrize("env", [{}, {"PEPPER_GRU_KERNEL": "1"}],
                         ids=["scan", "recurrence_twin"])
def test_polish_forward_fused_and_unfused_match_jax(monkeypatch, env):
    """The fused time-major forward (kernel twins, head split in halves)
    and the unfused one (gru_scan, or the recurrence twin) against JAX's
    polish_forward, with a non-zero carried hidden state."""
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    params = _params(2)
    rng = np.random.RandomState(2)
    x = rng.randint(0, 60, (4, 100, 10)).astype(np.float32)
    h0 = rng.uniform(-0.9, 0.9, (4, 2, 128)).astype(np.float32)
    j_logits, j_hidden = j_polish_forward(params, jnp.asarray(x),
                                          jnp.asarray(h0))
    tparams = params_from_jax(params, "cpu")
    xt = torch.from_numpy(x.transpose(1, 0, 2).copy())
    logits, hidden = polish_gru.polish_forward_fused(tparams, xt,
                                                     torch.from_numpy(h0))
    np.testing.assert_allclose(logits.transpose(0, 1).numpy(),
                               np.asarray(j_logits), atol=2e-5)
    np.testing.assert_allclose(hidden.numpy(), np.asarray(j_hidden),
                               atol=2e-5)
    logits, hidden = polish_gru.polish_forward(
        tparams, torch.from_numpy(x), torch.from_numpy(h0),
        allow_kernel=True)
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits),
                               atol=2e-5)
    np.testing.assert_allclose(hidden.numpy(), np.asarray(j_hidden),
                               atol=2e-5)


# ---------------------------------------------------------------- consensus


@pytest.fixture(scope="module")
def scan_case():
    params = _params(3)
    images = _images(3, 3)
    votes, labels, phred = jc.consensus_scan(params, jnp.asarray(images))
    return params, images, (np.asarray(votes), np.asarray(labels),
                            np.asarray(phred))


@pytest.mark.parametrize("fused", ["0", "1"], ids=["scatter", "fused"])
def test_consensus_scan_matches_jax(monkeypatch, scan_case, fused):
    monkeypatch.setenv("PEPPER_GRU_FUSED", fused)
    params, images, (j_votes, j_labels, j_phred) = scan_case
    votes, labels, phred = consensus.consensus_scan(
        params_from_jax(params, "cpu"), torch.from_numpy(images))
    np.testing.assert_allclose(votes.numpy(), j_votes, atol=1e-4)
    assert labels.dtype == torch.int32
    np.testing.assert_array_equal(labels.numpy(), j_labels)
    np.testing.assert_allclose(phred.numpy(), j_phred, atol=1e-3)


def test_polish_quantize_params_static_matches_jax_bitwise():
    params = _params(4)
    ours = quantize.polish_quantize_params_static(params)
    theirs = jq.polish_quantize_params_static(params)
    assert ours.keys() == theirs.keys()
    for name in theirs:
        assert ours[name].keys() == theirs[name].keys()
        for key, value in theirs[name].items():
            assert ours[name][key].dtype == value.dtype, (name, key)
            np.testing.assert_array_equal(ours[name][key], value)
    # tensors quantize as their numpy values do
    torch_tree = quantize.polish_quantize_params_static(
        params_from_jax(params, "cpu"))
    np.testing.assert_array_equal(torch_tree["decoder"]["w_ih_f"],
                                  theirs["decoder"]["w_ih_f"])


@pytest.mark.parametrize("fused", ["0", "1"], ids=["scan", "kernel_twin"])
def test_consensus_scan_static_matches_jax(monkeypatch, fused):
    """Static int8 consensus against JAX's on the CPU.  The float sums
    before each round(h*127) run in another order in the two frameworks,
    so about one code in a million lands on the other side of a rounding
    tie, and the carry spreads it: the votes are held to the static-int8
    probability bar (5e-3, tests/test_quantize_static.py:45) and the labels
    to JAX's wherever its top-two vote margin exceeds 0.05
    (tests/test_quantize_static.py:265-272).  Every code is equal at the
    kernel level (tests/test_torch_gru.py)."""
    params = _params(5)
    images = _images(2, 5, high=40)
    q = jq.polish_quantize_params_static(params)
    j_votes, j_labels, _ = jc.consensus_scan_static(
        jax.tree_util.tree_map(jnp.asarray, q), jnp.asarray(images))
    j_votes, j_labels = np.asarray(j_votes), np.asarray(j_labels)
    monkeypatch.setenv("PEPPER_GRU_FUSED", fused)
    votes, labels, _ = consensus.consensus_scan_static(
        params_from_jax(q, "cpu"), torch.from_numpy(images))
    np.testing.assert_allclose(votes.numpy(), j_votes, atol=5e-3)
    top2 = np.sort(j_votes, axis=2)[..., -2:]
    confident = top2[..., 1] - top2[..., 0] > 0.05
    assert confident.mean() > 0.3
    np.testing.assert_array_equal(labels.numpy()[confident],
                                  j_labels[confident])
    assert (labels.numpy() == j_labels).mean() > 0.99


@pytest.mark.parametrize("quantize_mode", [None, "static"])
def test_consensus_predict_matches_jax(quantize_mode):
    """The host wrapper: uint8 chunks, a partial last batch padded to its
    power-of-two bucket, labels and phred as JAX's (static: the labels
    where JAX's top-two vote margin exceeds 0.05, as in
    test_consensus_scan_static_matches_jax)."""
    params = _params(6)
    images = _images(5, 6, high=40).astype(np.uint8)
    labels, phred = consensus.consensus_predict(
        params, images, batch_size=4, quantize_mode=quantize_mode,
        device="cpu")
    j_labels, j_phred = jc.consensus_predict(params, images, batch_size=4,
                                             quantize_mode=quantize_mode)
    assert labels.dtype == np.int32 and phred.dtype == np.float32
    if quantize_mode is None:
        np.testing.assert_array_equal(labels, j_labels)
        np.testing.assert_allclose(phred, j_phred, atol=1e-3)
        return
    j_votes, _, _ = jc.consensus_scan_static(
        jax.tree_util.tree_map(jnp.asarray,
                               jq.polish_quantize_params_static(params)),
        jnp.asarray(images, jnp.float32))
    top2 = np.sort(np.asarray(j_votes), axis=2)[..., -2:]
    confident = top2[..., 1] - top2[..., 0] > 0.05
    np.testing.assert_array_equal(labels[confident], j_labels[confident])
    assert (labels == j_labels).mean() > 0.99


@pytest.mark.parametrize("quantize_mode,atol", [(None, 1e-5),
                                                 ("static", 1e-3)])
def test_consensus_predict_refuses_a_mesh_and_unknown_modes(quantize_mode,
                                                           atol):
    """A device list, refused until item 7 was ported, now runs data
    parallel: 5 chunks at a batch of 3 over [cpu, cpu] (batch and buckets
    rounded up to 2, a padding-only block skipped) give one device's labels
    and phred (float32 1e-5, int8 1e-3); the tree memo keeps one entry a
    device and mode.  An unknown mode still raises."""
    params = _params(0)
    images = _images(5, 9, high=40).astype(np.uint8)
    one = consensus.consensus_predict(params, images, batch_size=3,
                                      quantize_mode=quantize_mode,
                                      device="cpu")
    two = consensus.consensus_predict(params, images, batch_size=3,
                                      quantize_mode=quantize_mode,
                                      devices=["cpu", "cpu"])
    np.testing.assert_array_equal(two[0], one[0])
    np.testing.assert_allclose(two[1], one[1], atol=atol)
    assert two[0].shape == (5, 1000) and two[0].dtype == np.int32
    mode = "static" if quantize_mode else None
    assert consensus._tree_cache[("cpu", mode)][0] is params
    with pytest.raises(ValueError, match="quantize_mode"):
        consensus.consensus_predict(params, images,
                                    quantize_mode="dynamic", device="cpu")


def test_dry_consensus_labels_match_jax():
    images = _images(2, 7, high=30).astype(np.uint8)
    images[:, 900:] = 0
    for ours, theirs in zip(consensus.dry_consensus_labels(images),
                            jc.dry_consensus_labels(images)):
        np.testing.assert_array_equal(ours, theirs)


# ---------------------------------------------------------------- store


def test_prediction_store_orders_as_the_hdf5_store(tmp_path):
    """Chunk ids 0..11 of one interval, written in scrambled order with a
    repeated name: the in-memory store lists contigs, prefixes and chunk
    records as PolishPredictionStore does (chunk ids as strings)."""
    from pepper_tpu.polish.datastore import PolishPredictionStore

    rng = np.random.RandomState(8)
    writes = []
    for contig, start, end in (("ctg2", 900, 2100), ("ctg10", 0, 1100),
                               ("ctg2", 0, 1100)):
        for chunk_id in rng.permutation(12):
            writes.append((contig, start, end, int(chunk_id),
                           rng.randint(0, 5000, 7), rng.randint(0, 3, 7),
                           rng.randint(0, 5, 7), rng.uniform(-5, 300, 7)))
    writes.append(writes[3][:7] + (np.full(7, 4),))   # a repeat: ignored
    ours = pipeline.PredictionStore()
    path = str(tmp_path / "p.hdf")
    with PolishPredictionStore(path, "w") as theirs:
        for args in writes:
            ours.write_prediction(*args)
            theirs.write_prediction(*args)
    with PolishPredictionStore(path, "r") as theirs:
        assert ours.contigs() == sorted(theirs.contigs())
        for contig in theirs.contigs():
            expected = list(theirs.chunk_groups(contig))
            got = list(ours.chunk_groups(contig))
            assert [g[:3] for g in got] == [g[:3] for g in expected]
            for (_, _, _, records), (_, _, _, j_records) in zip(got,
                                                                 expected):
                assert len(records) == len(j_records) == 12
                for (start, pos, bases), (j_start, j_pos, j_bases) in zip(
                        records, j_records):
                    assert start == j_start
                    np.testing.assert_array_equal(pos, j_pos)
                    assert bases.dtype == j_bases.dtype == np.uint8
                    np.testing.assert_array_equal(bases, j_bases)


# ---------------------------------------------------------------- polish


@pytest.fixture(scope="module")
def polish_sim(tmp_path_factory):
    """tests/test_polish.py's scene: a 2.4 kb draft with a SNP, a missing
    GG and two extra bases, reads of the truth, and a JAX checkpoint."""
    tmp = tmp_path_factory.mktemp("torch_polish")
    draft = random_reference(2400, seed=21)

    def alt_base(pos):
        return {"A": "T", "T": "A", "C": "G", "G": "C"}[draft[pos]]

    variants = [(300, draft[300], alt_base(300)),
                (700, draft[700], draft[700] + "GG"),
                (1100, draft[1100:1103], draft[1100])]
    truth = "".join(alt for _, _, alt in apply_variants(draft, variants))
    records = simulate_reads(draft, [variants, variants], read_len=300,
                             stride=20, name_prefix="p")
    bam, fasta = str(tmp / "reads.bam"), str(tmp / "draft.fa")
    write_bam(bam, [(CONTIG, len(draft))], records)
    write_fasta(fasta, {CONTIG: draft})
    # one full-length truth read aligned to the draft (training's labels)
    truth_seq, truth_cigar = read_from_haplotype(
        draft, apply_variants(draft, variants), 0, len(draft))
    truth_bam = str(tmp / "truth.bam")
    write_bam(truth_bam, [(CONTIG, len(draft))], [BamRecord(
        "truth", 0, 0, 60, truth_cigar, truth_seq, [60] * len(truth_seq))])
    params = _params(0)
    model = str(tmp / "polish.npz")
    save_params(model, params, {})
    return dict(tmp=tmp, bam=bam, fasta=fasta, truth=truth, params=params,
                model=model, truth_bam=truth_bam, jax={})


def _jax_fasta(sim, mode):
    if mode not in sim["jax"]:
        options = JaxOptions(
            bam=sim["bam"], fasta=sim["fasta"],
            output_dir=str(sim["tmp"] / f"jax_{mode}"), threads=2,
            dry=mode == "dry", batch_size=8, quantized=mode == "quantized")
        path = j_polish(options, None if mode == "dry" else sim["params"])
        with open(path, "rb") as f:
            sim["jax"][mode] = f.read()
    return sim["jax"][mode]


MODES = ["dry", "float", "quantized"]


@pytest.mark.parametrize("mode", MODES)
def test_polish_library_matches_jax_bytes(polish_sim, mode):
    options = PepperOptions(
        bam=polish_sim["bam"], fasta=polish_sim["fasta"],
        output_dir=str(polish_sim["tmp"] / f"lib_{mode}"), threads=1,
        dry=mode == "dry", batch_size=8, quantized=mode == "quantized")
    path = pipeline.polish(
        options, None if mode == "dry" else polish_sim["params"],
        device="cpu")
    with open(path, "rb") as f:
        ours = f.read()
    assert ours == _jax_fasta(polish_sim, mode)
    if mode == "dry":
        assert ours.decode().split("\n")[1] == polish_sim["truth"]


@pytest.mark.parametrize("mode", MODES)
def test_polish_cli_matches_jax_bytes(polish_sim, mode):
    out = str(polish_sim["tmp"] / f"cli_{mode}")
    argv = ["polish", "-b", polish_sim["bam"], "-f", polish_sim["fasta"],
            "-o", out, "-m", polish_sim["model"], "--batch_size", "8",
            "-t", "2", "--device", "cpu"]
    argv += {"dry": ["--dry"], "quantized": ["--quantized"]}.get(mode, [])
    assert polish_main.main(argv) == 0
    with open(os.path.join(out, "consensus_pepper_polished.fa"), "rb") as f:
        assert f.read() == _jax_fasta(polish_sim, mode)


def _cli_staged(sim, tag, images_by="port", consensus_by="port",
                mode="float"):
    """The staged polish chain make_images -> call_consensus -> stitch,
    each stage through the port's CLI or the JAX package's functions (its
    files are the other package's input), the consensus in `mode` (dry or
    float); returns the FASTA bytes."""
    from pepper_tpu.polish import pipeline as jpipeline

    base = sim["tmp"] / f"staged_{tag}"
    images, predictions = str(base / "images"), str(base / "predictions")
    common = ["-b", sim["bam"], "-f", sim["fasta"], "-t", "2",
              "--batch_size", "8"]
    if images_by == "port":
        assert polish_main.main(["make_images", *common, "-o", images]) == 0
    else:
        jpipeline.make_polish_images(JaxOptions(
            bam=sim["bam"], fasta=sim["fasta"], threads=2), images)
    dry = mode == "dry"
    if consensus_by == "port":
        assert polish_main.main(
            ["call_consensus", *common, "-i", images, "-o", predictions,
             "-m", sim["model"], "--device", "cpu"]
            + (["--dry"] if dry else [])) == 0
    else:
        jpipeline.call_consensus(JaxOptions(batch_size=8, dry=dry), images,
                                 predictions, None if dry else sim["params"])
    assert polish_main.main(["stitch", "-i", predictions, "-o",
                             str(base)]) == 0
    with open(base / "consensus_pepper_polished.fa", "rb") as f:
        return f.read()


def _jax_train_images(sim, tag, *flags):
    """The JAX package's train images of the scene (its
    make_polish_train_images with the CLI's flags)."""
    from pepper_tpu.polish import pipeline as jpipeline

    out = str(sim["tmp"] / f"jax_train_images_{tag}")
    options = JaxOptions(bam=sim["bam"], fasta=sim["fasta"])
    if "--no_realignment" in flags:
        options.realignment = False
    if "-r" in flags:
        options.region = flags[flags.index("-r") + 1]
    if not os.path.isdir(out):
        jpipeline.make_polish_train_images(options, sim["truth_bam"], out)
    return out


def _recording_steps(monkeypatch, module, recorded):
    """Wraps a package's make_tbptt_step: each step also records its
    batch's real rows."""
    real = module.make_tbptt_step

    def make(*args, **kwargs):
        step = real(*args, **kwargs)

        def recording(params, *rest, **kw):
            images, labels, mask = rest[-3:]
            recorded.append(int(np.asarray(mask).sum()))
            return step(params, *rest, **kw)
        return recording
    monkeypatch.setattr(module, "make_tbptt_step", make)


def _cli_train_matches_jax(sim, argv, monkeypatch, capsys):
    """A polish training subcommand through the port's CLI on the CPU
    against the JAX package on the same scene: make_train_images writes
    JAX's train images (also without realignment, on a region);
    train_model trains at batch 16 whatever --batch_size says, as JAX's
    CLI, writes JAX's files and metadata, and its .npz polishes to the JAX
    package's polish() bytes; test_model prints JAX's accuracy and
    confusion of the same model and images; run_hyperband picks JAX's
    configuration; download_models fetches JAX's files from a file://
    mirror and fails as JAX's does offline."""
    from pepper_tpu.cli import polish_main as jax_polish_main
    from pepper_tpu.models.checkpoint import load_params as jax_load_params
    from pepper_tpu.polish import train as jtrain
    from pepper_tpu_torch.polish import train

    base = sim["tmp"] / ("cli_" + "_".join(a.strip("-") for a in argv))
    common = ["-b", sim["bam"], "-f", sim["fasta"]]
    if argv[0] == "download_models":
        from test_download_models import _make_mirror

        base.mkdir()
        url = _make_mirror(base)
        outs = {}
        for name, main in (("port", polish_main.main),
                           ("jax", jax_polish_main.main)):
            outs[name] = base / f"models_{name}"
            assert main(["download_models", "-o", str(outs[name]),
                         "--description_url", url]) == 0
            assert main(["download_models", "-o", str(base / "x"),
                         "--description_url",
                         f"file://{base}/missing.csv"]) == 1
        assert sorted(os.listdir(outs["port"])) == sorted(
            os.listdir(outs["jax"])) == ["PEPPER_POLISH.pkl",
                                        "PEPPER_VARIANT_ONT.pkl"]
        for name in os.listdir(outs["jax"]):
            assert (outs["port"] / name).read_bytes() == \
                (outs["jax"] / name).read_bytes()
        return
    if argv[0] == "make_train_images":
        flags = ([] if "--truth_bam" in argv
                 else ["--no_realignment", "-r", f"{CONTIG}:0-1500"])
        ours = str(base / "images")
        assert polish_main.main(["make_train_images", *common, "--truth_bam",
                                 sim["truth_bam"], "-o", ours, *flags]) == 0
        expected = jtrain.load_polish_images(_jax_train_images(
            sim, "_".join(flags), *flags))
        got = jtrain.load_polish_images(ours)
        assert len(got[0]) >= 2 and got[1].max() >= 1
        for a, b in zip(got, expected):
            np.testing.assert_array_equal(a, b)
        return
    images = _jax_train_images(sim, "")
    n_chunks = len(jtrain.load_polish_images(images)[0])
    if argv[0] == "test_model":
        capsys.readouterr()
        assert polish_main.main(["test_model", "-i", images, "-m",
                                 sim["model"], "--batch_size", "2",
                                 "--device", "cpu"]) == 0
        printed = capsys.readouterr().err
        result = jtrain.test_polish_model(JaxOptions(), images, sim["model"],
                                          batch_size=2)
        assert f"ACCURACY: {result['accuracy']:.2f}" in printed
        assert ("CONFUSION MATRIX (rows=truth *ACGT, cols=pred):\n"
                f"{result['confusion']}") in printed
        assert result["confusion"].sum() == n_chunks * 1000
        return
    if argv[0] == "run_hyperband":
        capsys.readouterr()
        assert polish_main.main(["run_hyperband", "-i", images, "-o",
                                 str(base / "port"), "--max_iter", "1",
                                 "--eta", "2", "--batch_size", "4",
                                 "--device", "cpu"]) == 0
        printed = capsys.readouterr().err
        best = jtrain.run_polish_hyperband(
            JaxOptions(), images, str(base / "jax"), max_iter=1, eta=2,
            batch_size=4)
        assert f"config={best['config']}" in printed
        assert os.path.isfile(base / "port" / "hb_s0_c0" /
                              "polish_model_final.npz")
        return
    # train_model: one epoch at the CLI's batch (16, not --batch_size)
    from pepper_tpu.polish import train as jtrain_module

    recorded = {"port": [], "jax": []}
    _recording_steps(monkeypatch, train, recorded["port"])
    _recording_steps(monkeypatch, jtrain_module, recorded["jax"])
    args = ["-i", images, "--epochs", "1", "--batch_size", "2",
            "--learning_rate", "1e-3"]
    if len(argv) > 1:
        args += ["--weight_decay", "1e-4"]
    assert polish_main.main(["train_model", *args, "-o", str(base / "port"),
                             "--device", "cpu"]) == 0
    assert jax_polish_main.main(["train_model", *args, "-o",
                            str(base / "jax")]) == 0
    n_train = n_chunks - max(1, int(n_chunks * 0.2))
    assert n_train > 2
    assert recorded["port"] == recorded["jax"] == [min(16, n_train)] * (
        -(-n_train // 16))
    names = sorted(os.listdir(base / "port"))
    assert names == sorted(os.listdir(base / "jax")) == [
        "polish_epoch_1_checkpoint.npz", "polish_model_final.npz"]
    for name in names:
        assert jax_load_params(str(base / "port" / name))[1] == \
            jax_load_params(str(base / "jax" / name))[1]
    params, _ = jax_load_params(str(base / "port" / "polish_model_final.npz"))
    outputs = {}
    for name, options, run in (
            ("jax", JaxOptions, j_polish),
            ("port", PepperOptions,
             lambda o, p: pipeline.polish(o, p, device="cpu"))):
        path = run(options(bam=sim["bam"], fasta=sim["fasta"],
                           output_dir=str(base / f"polished_{name}"),
                           threads=1, batch_size=8), params)
        with open(path, "rb") as f:
            outputs[name] = f.read()
    assert outputs["port"] == outputs["jax"]


@pytest.mark.parametrize("argv,item", [
    (["make_images", "-b", "x.bam"], "item 14"),
    (["call_consensus", "-i", "imgs"], "item 14"),
    (["stitch", "-i", "preds"], "item 14"),
    (["make_train_images", "--truth_bam", "t.bam"], "item 11"),
    (["train_model", "-i", "imgs"], "item 11"),
    (["test_model", "-i", "imgs"], "item 11"),
    (["run_hyperband", "-i", "imgs"], "item 11"),
    (["download_models"], "item 12"),
    (["call_consensus"], "item 14"),
    (["make_train_images", "-b", "x.bam"], "item 11"),
    (["train_model"], "item 11"),
    (["polish", "-m", "model.pkl", "--device", "cpu"], "item 13"),
    (["polish", "--num_devices", "2", "--device", "cpu"], "item 7"),
])
def test_polish_cli_refuses_what_is_not_ported(polish_sim, argv, item,
                                               monkeypatch, capsys):
    """The polish CLI now refuses nothing: what it refused until its item
    was ported serves against the JAX package.  A reference .pkl (item
    13), --num_devices 2 (item 7; on the CPU it resolves to one device)
    and the staged make_images, call_consensus and stitch (item 14) write
    the bytes of the JAX package's polish() on the same weights, each
    staged case's own stage through the port's CLI beside the JAX
    package's other stages (the bare call_consensus case: every stage the
    port's), the consensus float where the port runs it and dry elsewhere;
    the training subcommands (item 11) and download_models (item 12) run
    as _cli_train_matches_jax says."""
    if item in ("item 11", "item 12"):
        _cli_train_matches_jax(polish_sim, argv, monkeypatch, capsys)
        return
    if item == "item 14":
        stage = argv[0] if len(argv) > 1 else "all"
        kinds = {"make_images": ("port", "jax", "dry"),
                 "call_consensus": ("jax", "port", "float"),
                 "stitch": ("jax", "jax", "dry"),
                 "all": ("port", "port", "dry")}[stage]
        assert _cli_staged(polish_sim, stage, *kinds) == _jax_fasta(
            polish_sim, kinds[2])
        return
    if item == "item 7":
        out = str(polish_sim["tmp"] / "cli_two_devices")
        assert polish_main.main(
            [argv[0], "-b", polish_sim["bam"], "-f", polish_sim["fasta"],
             "-o", out, "-m", polish_sim["model"], "--batch_size", "8",
             *argv[1:]]) == 0
        with open(os.path.join(out, "consensus_pepper_polished.fa"),
                  "rb") as f:
            assert f.read() == _jax_fasta(polish_sim, "float")
        return
    if item == "item 13":
        from test_torch_checkpoint_pkl import write_checkpoint

        params = polish_sim["params"]
        state = {}
        for layer, name in (("encoder", "gru_encoder"),
                            ("decoder", "gru_decoder")):
            for d, sfx in (("f", ""), ("b", "_reverse")):
                node = params[layer]
                state[f"{name}.weight_ih_l0{sfx}"] = node[f"w_ih_{d}"].T
                state[f"{name}.weight_hh_l0{sfx}"] = node[f"w_hh_{d}"].T
                state[f"{name}.bias_ih_l0{sfx}"] = node[f"b_ih_{d}"]
                state[f"{name}.bias_hh_l0{sfx}"] = node[f"b_hh_{d}"]
        state["dense1.weight"] = params["output"]["w"].T
        state["dense1.bias"] = params["output"]["b"]
        model = write_checkpoint(
            polish_sim["tmp"] / argv[2],
            {key: np.ascontiguousarray(value) for key, value in state.items()})
        out = str(polish_sim["tmp"] / "cli_pkl")
        assert polish_main.main(
            ["polish", "-b", polish_sim["bam"], "-f", polish_sim["fasta"],
             "-o", out, "-m", model, "--batch_size", "8", "-t", "2",
             *argv[3:]]) == 0
        with open(os.path.join(out, "consensus_pepper_polished.fa"),
                  "rb") as f:
            assert f.read() == _jax_fasta(polish_sim, "float")
        return
    raise AssertionError(f"no case for {argv} ({item})")
