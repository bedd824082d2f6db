"""HP mode in the port against the JAX package, on the CPU: the 48-feature
pileup (ops/pileup_hp.py), call_variant --use_hp_info, the legacy sliding
predictor (infer/hp_sliding.py) and the legacy candidate finder
(decode/hp_legacy.py).

Bars:
  * RegionalSummaryHP windows: byte for byte, native and Python walkers;
  * call_variant --use_hp_info: float32 records equal (the transducer's
    bar); static int8 the same call set up to the ALT order within a site
    and window probabilities within 5e-3 (the static twins' bar);
  * hp_votes_scan: the port's scan bit-identical to its literal window
    loop and to a second run; against JAX, and the kernels' twins against
    the unfused path, every x10000 vote within 1 and at least 99.9% equal
    (the truncation moves a vote by one where the frameworks' softmax
    differs by ~1e-7), labels equal wherever the top-two vote margin
    exceeds 50;
  * CandidateFinderHP: the same records and variants as JAX's.
"""

import gzip

import jax
import numpy as np
import pytest
import torch

from pepper_tpu.decode import hp_legacy as jlegacy
from pepper_tpu.infer import hp_sliding as jsliding
from pepper_tpu.infer.runner import InferenceRunner as JaxRunner
from pepper_tpu.io.bam import BamReader as JaxBamReader
from pepper_tpu.io.bam_writer import BamRecord, write_bam, write_fasta
from pepper_tpu.io.fasta import FastaReader as JaxFastaReader
from pepper_tpu.models.polish_gru import PolishConfig, init_polish_params
from pepper_tpu.models.transducer import (TransducerConfig,
                                          init_transducer_params)
from pepper_tpu.ops import pileup_hp as jpileup_hp
from pepper_tpu.options import PepperOptions as JaxOptions
from pepper_tpu.pipeline import call_variant as jcv
from pepper_tpu.pipeline.summarizer import \
    create_region_summary as jax_region_summary
from pepper_tpu.presets import set_parameters as jax_set_parameters
from pepper_tpu_torch.decode import hp_legacy
from pepper_tpu_torch.infer import hp_sliding
from pepper_tpu_torch.infer.runner import InferenceRunner
from pepper_tpu_torch.io.bam import BamReader
from pepper_tpu_torch.io.fasta import FastaReader
from pepper_tpu_torch.models.params import params_from_jax
from pepper_tpu_torch.models.polish_gru import polish_forward
from pepper_tpu_torch.ops import pileup_hp
from pepper_tpu_torch.options import PepperOptions
from pepper_tpu_torch.pipeline import call_variant as cv
from pepper_tpu_torch.pipeline.summarizer import create_region_summary
from pepper_tpu_torch.presets import set_parameters

from simulate import random_reference, simulate_reads
from test_pileup_hp import REF, THRESHOLDS
from test_torch_polish import one_intra_op_thread  # noqa: F401

# ---------------------------------------------------------------- pileup


def _hp_read(name, seq, hp, cigar="40M", flag=0):
    return BamRecord(name, 0, 0, 60, cigar, seq, [30] * len(seq), flag=flag,
                     hp=hp)


def _snp_reads():
    snp_seq = REF[:20] + "T" + REF[21:]
    return ([_hp_read(f"m{i}", REF, 2) for i in range(5)]
            + [_hp_read(f"s{i}", snp_seq, 1, flag=16 * (i % 2))
               for i in range(4)] + [_hp_read("u0", snp_seq, 0)])


def _indel_reads():
    ins_seq = REF[:21] + "GG" + REF[21:]
    del_seq = REF[:10] + REF[13:]
    return ([_hp_read(f"m{i}", REF, 2) for i in range(5)]
            + [_hp_read(f"i{i}", ins_seq, 1, "21M2I19M") for i in range(3)]
            + [_hp_read(f"d{i}", del_seq, i % 3, "10M3D27M")
               for i in range(4)])


def _assert_windows_equal(ours, theirs):
    assert len(ours) == len(theirs) > 0
    for a, b in zip(ours, theirs):
        assert (a.contig, a.position, a.depth, a.candidates,
                a.candidate_frequency) == (b.contig, b.position, b.depth,
                                           b.candidates,
                                           b.candidate_frequency)
        assert a.image.dtype == b.image.dtype
        assert a.image.shape == b.image.shape == (21, 48)
        assert a.image.tobytes() == b.image.tobytes()


@pytest.mark.parametrize("use_native", [True, False],
                         ids=["native", "python"])
@pytest.mark.parametrize("reads", [_snp_reads, _indel_reads],
                         ids=["snp", "indel"])
def test_hp_windows_equal_jax_byte_for_byte(tmp_path, reads, use_native):
    path = str(tmp_path / "t.bam")
    write_bam(path, [("chr1", 40)], sorted(reads(), key=lambda r: r.pos))
    windows = []
    for summary_cls, reader in ((pileup_hp.RegionalSummaryHP, BamReader),
                                (jpileup_hp.RegionalSummaryHP,
                                 JaxBamReader)):
        batch = reader(path).get_reads("chr1", 0, 39)
        summary = summary_cls("chr1", 0, 39, REF, use_native=use_native)
        summary.generate_max_insert_summary(batch)
        windows.append(summary.generate_summary(batch, **THRESHOLDS))
    _assert_windows_equal(*windows)
    assert (pileup_hp.get_feature_index_hp("A", "A", True, 2)
            == jpileup_hp.get_feature_index_hp("A", "A", True, 2) == 41)


# ---------------------------------------------------------------- call_variant


@pytest.fixture(scope="module")
def hp_sim(tmp_path_factory):
    """test_hp_e2e_model_mode's scene (2.2 kb, seed 33, a het SNP on
    haplotype 1) with an untagged third haplotype carrying an insertion,
    and a seeded 48x21 transducer at the small width."""
    tmp = tmp_path_factory.mktemp("torch_hp")
    ref = random_reference(2200, seed=33)
    het_snp = (700, ref[700], {"A": "T", "T": "A", "C": "G",
                               "G": "C"}[ref[700]])
    ins = (1300, ref[1300], ref[1300] + "AC")
    records = simulate_reads(ref, [[het_snp], [], [ins]], read_len=300,
                             stride=20)
    bam, fasta = str(tmp / "m.bam"), str(tmp / "m.fa")
    write_bam(bam, [("chrH", len(ref))], records)
    write_fasta(fasta, {"chrH": ref})
    params = jax.tree_util.tree_map(np.array, init_transducer_params(
        jax.random.PRNGKey(0), TransducerConfig(
            image_features=48, window=21, hidden=32, linear_size=64)))
    return dict(tmp=tmp, bam=bam, fasta=fasta, params=params)


def _hp_options(cls, preset, sim, out, **overrides):
    options = cls(bam=sim["bam"], fasta=sim["fasta"], output_dir=str(out),
                  threads=1, ont_r9_guppy5_sup=True,
                  sub_command="call_variant", use_hp_info=True,
                  region="chrH", batch_size=16, compute_dtype="float32")
    for key, value in overrides.items():
        setattr(options, key, value)
    return preset(options)


def _vcf_rows(out_dir):
    rows = []
    with gzip.open(f"{out_dir}/PEPPER_VARIANT_FULL.vcf.gz", "rt") as f:
        for line in f:
            if not line.startswith("#"):
                fields = line.split("\t")
                rows.append((int(fields[1]), fields[3], fields[4],
                             fields[9].split(":")[0], fields[6]))
    return rows


def _call_set(rows):
    """(pos, REF, sorted ALTs) with the genotype as the set of its alleles'
    strings: the same calls up to the ALT order within a site."""
    calls = set()
    for pos, ref, alt, gt, _ in rows:
        alts = alt.split(",")
        alleles = [ref] + alts
        genotype = tuple(sorted(alleles[int(i)] for i in gt.split("/")
                                if i != "."))
        calls.add((pos, ref, tuple(sorted(alts)), genotype))
    return calls


def test_hp_windows_of_the_scene_equal_jax(hp_sim):
    options = _hp_options(PepperOptions, set_parameters, hp_sim, "unused")
    joptions = _hp_options(JaxOptions, jax_set_parameters, hp_sim, "unused")
    ours = create_region_summary(options, BamReader(hp_sim["bam"]),
                                 FastaReader(hp_sim["fasta"]), "chrH", 0,
                                 2199)
    theirs = jax_region_summary(joptions, JaxBamReader(hp_sim["bam"]),
                                JaxFastaReader(hp_sim["fasta"]), "chrH", 0,
                                2199)
    _assert_windows_equal(ours, theirs)


@pytest.mark.parametrize("mode", ["float32", "static"])
def test_hp_call_variant_matches_jax(hp_sim, mode):
    overrides = ({} if mode == "float32"
                 else dict(quantized=True, quantize_mode=mode))
    ours, theirs = hp_sim["tmp"] / f"torch_{mode}", hp_sim["tmp"] / \
        f"jax_{mode}"
    totals = cv.call_variant(_hp_options(PepperOptions, set_parameters,
                                         hp_sim, ours, **overrides),
                             params=hp_sim["params"], device="cpu")
    jax_totals = jcv.call_variant(_hp_options(JaxOptions, jax_set_parameters,
                                              hp_sim, theirs, **overrides),
                                  params=hp_sim["params"])
    assert totals[0] > 0 and totals[0] == jax_totals[0]
    if mode == "float32":
        assert _vcf_rows(ours) == _vcf_rows(theirs)
        return
    assert _call_set(_vcf_rows(ours)) == _call_set(_vcf_rows(theirs))
    windows = create_region_summary(
        _hp_options(PepperOptions, set_parameters, hp_sim, ours),
        BamReader(hp_sim["bam"]), FastaReader(hp_sim["fasta"]), "chrH", 0,
        2199)
    images = np.stack([w.image for w in windows])
    probs = InferenceRunner(hp_sim["params"], window=21, features=48,
                            quantized=True, quantize_mode=mode,
                            compute_dtype="float32",
                            device="cpu").predict_images(images)
    j_probs = JaxRunner(hp_sim["params"], window=21, features=48,
                        quantized=True,
                        quantize_mode=mode).predict_images(images)
    np.testing.assert_allclose(probs, j_probs, rtol=0, atol=5e-3)


# ---------------------------------------------------------------- sliding


def _polish_params(seed, features):
    return jax.tree_util.tree_map(np.array, init_polish_params(
        jax.random.PRNGKey(seed), PolishConfig(image_features=features,
                                               hidden=128, num_classes=5)))


def _images(seed, shape):
    return np.array(jax.random.normal(jax.random.PRNGKey(seed), shape))


def window_loop(params, images):
    """The reference's loop stated literally in the port
    (predict_hp_distributed_cpu.py:54-95): hidden carry, x10000 softmax
    truncated to int, zero-pad and add."""
    B, L, _ = images.shape
    C = params["output"]["w"].shape[1]
    hidden = torch.zeros((B, 2, 128), dtype=images.dtype)
    votes = torch.zeros((B, L, C), dtype=torch.int32)
    for i in range(0, L, hp_sliding.WINDOW_JUMP):
        if i + hp_sliding.TRAIN_WINDOW > L:
            break
        logits, hidden = polish_forward(
            params, images[:, i:i + hp_sliding.TRAIN_WINDOW], hidden)
        chunk = (torch.softmax(logits.float(), dim=2)
                 * hp_sliding.VOTE_SCALE).to(torch.int32)
        padded = torch.zeros_like(votes)
        padded[:, i:i + hp_sliding.TRAIN_WINDOW] = chunk
        votes = votes + padded
    return votes.numpy()


def assert_votes_close(ours, theirs, what):
    """Every vote within 1, at least 99.9% equal, labels equal where the
    top-two margin of `theirs` exceeds 50."""
    diff = np.abs(ours.astype(np.int64) - theirs)
    unequal = int((diff != 0).sum())
    print(f"{what}: {unequal} of {diff.size} votes unequal, max "
          f"{diff.max()}")
    assert diff.max() <= 1 and unequal <= 1e-3 * diff.size, what
    top2 = np.sort(theirs, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 50
    np.testing.assert_array_equal(ours.argmax(-1)[clear],
                                  theirs.argmax(-1)[clear])


def test_scan_equals_window_loop_and_jax():
    """tests/test_hp_sliding.py's shapes: (3, 300, 12), H=128."""
    params = _polish_params(0, 12)
    images = _images(1, (3, 300, 12))
    tree = params_from_jax(params, "cpu")
    x = torch.from_numpy(images)
    got = hp_sliding.hp_votes_scan(tree, x, allow_kernel=False).numpy()
    assert got.dtype == np.int32 and got.shape == (3, 300, 5)
    np.testing.assert_array_equal(got, window_loop(tree, x))
    np.testing.assert_array_equal(
        got, hp_sliding.hp_votes_scan(tree, x, allow_kernel=False).numpy())
    want = np.asarray(jsliding.hp_votes_scan(params, images,
                                             allow_kernel=False))
    assert_votes_close(got, want, "port vs JAX")
    interior = got[:, 100:-100].sum(axis=2)
    assert interior.min() >= 2 * (hp_sliding.VOTE_SCALE - 5)
    assert interior.max() <= 2 * hp_sliding.VOTE_SCALE


@pytest.mark.parametrize("env", [{"PEPPER_GRU_FUSED": "1"},
                                 {"PEPPER_GRU_FUSED": "0",
                                  "PEPPER_GRU_KERNEL": "1"}],
                         ids=["fused", "recurrence"])
def test_scan_kernel_twins_match_unfused_path(monkeypatch, env):
    """allow_kernel routes each window through a GRU kernel (on the CPU
    its twin): the votes hold to the unfused scan's at the vote bars."""
    params = params_from_jax(_polish_params(2, 8), "cpu")
    x = torch.from_numpy(_images(3, (4, 400, 8)))
    want = hp_sliding.hp_votes_scan(params, x, allow_kernel=False).numpy()
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    got = hp_sliding.hp_votes_scan(params, x, allow_kernel=True).numpy()
    assert_votes_close(got, want, f"twin {env}")


def test_predict_hp_pair_matches_jax():
    params = _polish_params(2, 8)
    im1, im2 = _images(3, (2, 200, 8)), _images(4, (2, 200, 8))
    v1, v2 = hp_sliding.predict_hp(params, im1, im2, allow_kernel=False,
                                   device="cpu")
    assert v1.shape == v2.shape == (2, 200, 5) and v1.dtype == np.int32
    assert (v1 != v2).any()
    again = hp_sliding.predict_hp(params, im1, im2, device="cpu")
    np.testing.assert_array_equal(again[0], v1)
    np.testing.assert_array_equal(again[1], v2)
    j1, j2 = jsliding.predict_hp(params, im1, im2, allow_kernel=False)
    assert_votes_close(v1, j1, "hp1 port vs JAX")
    assert_votes_close(v2, j2, "hp2 port vs JAX")
    # a sequence shorter than one window gets no votes
    short = hp_sliding.predict_hp(params, im1[:, :80], im2[:, :80],
                                  device="cpu")
    assert not short[0].any() and short[0].shape == (2, 80, 5)


def test_predict_hp_mesh_raises_naming_item_7():
    """Refused until item 7 was ported: predict_hp over a device list
    (the JAX package's mesh branch) pads each haplotype batch of 3 to the
    2 devices, splits it and gathers the votes in order, exactly one
    device's, and within the vote bars of JAX's mesh run."""
    from pepper_tpu.parallel.mesh import get_mesh

    params = _polish_params(5, 8)
    im1, im2 = _images(6, (3, 200, 8)), _images(7, (3, 200, 8))
    one = hp_sliding.predict_hp(params, im1, im2, allow_kernel=False,
                                device="cpu")
    two = hp_sliding.predict_hp(params, im1, im2, allow_kernel=False,
                                devices=["cpu", "cpu"])
    for ours, single in zip(two, one):
        assert ours.shape == (3, 200, 5) and ours.dtype == np.int32
        np.testing.assert_array_equal(ours, single)
    theirs = jsliding.predict_hp(params, im1, im2, allow_kernel=False,
                                 mesh=get_mesh(2))
    for ours, j_votes, what in zip(two, theirs, ("hp1", "hp2")):
        assert_votes_close(ours, np.asarray(j_votes), f"{what} mesh")


# ---------------------------------------------------------------- legacy


def _legacy_batch(tmp_path, reads):
    path = str(tmp_path / "hp.bam")
    write_bam(path, [("chr1", 40)], sorted(reads, key=lambda r: r.pos))
    return (BamReader(path).get_reads("chr1", 0, 39),
            JaxBamReader(path).get_reads("chr1", 0, 39))


def _predictions(bases_h1, bases_h2, scale=100):
    table = {"*": 0, "A": 1, "C": 2, "G": 3, "T": 4}
    pred1 = np.zeros((len(bases_h1), 5), np.int64)
    pred2 = np.zeros_like(pred1)
    for i, (b1, b2) in enumerate(zip(bases_h1, bases_h2)):
        pred1[i, table[b1]] = scale
        pred2[i, table[b2]] = scale
    return pred1, pred2


def _legacy_case(name):
    """test_hp_legacy.py's read sets and prediction maps, and a noisy one:
    per-haplotype random votes over an SNP, an insertion and a deletion."""
    snp_seq = REF[:20] + "T" + REF[21:]
    ref_reads = [BamRecord(f"m{i}", 0, 0, 60, "40M", REF, [30] * 40)
                 for i in range(6)]
    alt_reads = [BamRecord(f"s{i}", 0, 0, 60, "40M", snp_seq, [30] * 40)
                 for i in range(4)]
    bases = [REF[i] for i in range(40)]
    alt = list(bases)
    alt[20] = "T"
    positions, indices = list(range(40)), [0] * 40
    if name == "het_snp":
        return ref_reads + alt_reads, positions, indices, \
            _predictions(alt, bases)
    if name == "regression_gate":
        return ref_reads + alt_reads, positions, indices, \
            _predictions(bases, bases)
    ins_seq = REF[:21] + "GG" + REF[21:]
    del_seq = REF[:10] + REF[13:]
    reads = (ref_reads + alt_reads
             + [BamRecord(f"i{i}", 0, 0, 60, "21M2I19M", ins_seq, [30] * 42)
                for i in range(5)]
             + [BamRecord(f"d{i}", 0, 0, 60, "10M3D27M", del_seq, [30] * 37)
                for i in range(5)])
    positions = list(range(40)) + [20, 20]
    indices = [0] * 40 + [1, 2]
    rng = np.random.RandomState(9)
    pred1 = rng.randint(0, 60, (42, 5))
    pred2 = rng.randint(0, 60, (42, 5))
    for i, base in enumerate(bases + ["G", "G"]):
        pred1[i, "*ACGT".index(base)] += 400
    pred2[20, 4] += 900
    pred2[11:13, 0] += 900
    return reads, positions, indices, (pred1, pred2)


@pytest.mark.parametrize("name", ["het_snp", "regression_gate", "noisy"])
@pytest.mark.parametrize("freq_based", [False, True])
def test_candidate_finder_hp_matches_jax(tmp_path, name, freq_based):
    reads, positions, indices, (pred1, pred2) = _legacy_case(name)
    ours_batch, jax_batch = _legacy_batch(tmp_path, reads)
    kwargs = dict(freq_based=freq_based, freq=0.05)
    ours = hp_legacy.CandidateFinderHP(REF, "chr1", 0, 39, 0, 40
                                       ).find_candidates(
        ours_batch, positions, indices, pred1, pred2, **kwargs)
    theirs = jlegacy.CandidateFinderHP(REF, "chr1", 0, 39, 0, 40
                                       ).find_candidates(
        jax_batch, positions, indices, pred1, pred2, **kwargs)
    assert [repr(r) for r in ours] == [repr(r) for r in theirs]
    assert ours
    for record in ours:
        rows = [(c.pos, c.pos_end, c.allele.ref, c.allele.alt,
                 c.allele.alt_type, c.depth, c.read_support, 0,
                 c.read_support, 0, c.alt_prob_h1, c.alt_prob_h2,
                 c.non_ref_prob) for c in record.candidates]
        if rows:
            assert (hp_legacy.hp_candidates_to_variants(rows, "chr1")
                    == jlegacy.hp_candidates_to_variants(rows, "chr1"))


def test_hp_candidates_to_variants_and_filter_match_jax():
    """test_hp_legacy.py's site-assembly and threshold cases."""
    snp = (100, 101, "A", "T", 1, 30, 12, 0, 12, 0, 0.95, 0.001, 0.9)
    deletion = (100, 103, "ACG", "A", 3, 30, 10, 0, 0, 10, 0.001, 0.88,
                0.8)
    hom = (100, 101, "A", "T", 1, 30, 25, 0, 12, 13, 0.95, 0.92, 0.9)
    for rows in ([snp, deletion], [snp], [hom]):
        assert (hp_legacy.hp_candidates_to_variants(rows, "chr1")
                == jlegacy.hp_candidates_to_variants(rows, "chr1"))
    for depth, support, p1, p2, non_ref in ((30, 12, 0.9, 0.01, 0.9),
                                            (100, 5, 0.9, 0.9, 0.9),
                                            (30, 12, 0.004, 0.004, 0.0)):
        for freq_based, freq in ((False, 0), (True, 0.01)):
            ours = hp_legacy.HpCandidate(
                10, 11, hp_legacy.HpAllele("A", "T", 1), depth, support, p1,
                p2, non_ref)
            theirs = jlegacy.HpCandidate(
                10, 11, jlegacy.HpAllele("A", "T", 1), depth, support, p1,
                p2, non_ref)
            assert (hp_legacy.CandidateFinderHP.filter_candidate(
                ours, freq_based, freq)
                    == jlegacy.CandidateFinderHP.filter_candidate(
                        theirs, freq_based, freq))
