"""pepper_tpu_torch command-line interface.

The JAX package's subcommand surface: call_variant, the staged
make_images / run_inference / find_candidates, merge_variants, the
training subcommands make_train_images / train_model / test_model /
run_hyperband, download_models, version and backend_stat:

  python -m pepper_tpu_torch.cli.main call_variant -b reads.bam -f ref.fa \\
      -m model.npz|model.pkl -o out/ -t 8 --ont_r9_guppy5_sup \\
      [--use_hp_info] [--num_devices -1] [--sharded] [--device cuda]

Inference and training run on --device (default cuda; `--device cpu` runs
on the CPU); inference is data parallel over --num_devices local GPUs (-1,
the default: all of them), training over every local GPU of --device cuda
(one with --device cuda:N).  --sharded, or a process group of more than
one process (torchrun's environment, parallel/dist.py), runs the
region-manifest sharded path; in such a group train_model sums its
gradients over the processes.  The staged subcommands, the training
subcommands and --sharded pass HDF5 files and need h5py.
"""

from __future__ import annotations

import argparse
import sys

from ..options import PepperOptions
from ..presets import set_parameters


def _add_common_io(parser, need_model=False):
    parser.add_argument("-b", "--bam", required=False, default="",
                        help="Alignment BAM file (indexed).")
    parser.add_argument("-f", "--fasta", required=False, default="",
                        help="Reference FASTA file (faidx indexed).")
    parser.add_argument("-o", "--output_dir", default="./output",
                        help="Output directory.")
    parser.add_argument("-t", "--threads", type=int, default=1)
    parser.add_argument("-s", "--sample_name", default="Sample")
    if need_model:
        parser.add_argument("-m", "--model_path", default="",
                            help="Model checkpoint (.npz native, or a "
                             "reference .pkl/.pt/.pth converted on load)")


def _add_region_args(parser):
    parser.add_argument("-r", "--region", default=None,
                        help="Region like chr20 or chr20:1000-2000 or chr1-22")
    parser.add_argument("--region_size", type=int, default=100000)
    parser.add_argument("--region_bed", default=None)


def _add_image_args(parser):
    parser.add_argument("--min_mapq", type=int, default=None)
    parser.add_argument("--min_snp_baseq", type=int, default=None)
    parser.add_argument("--min_indel_baseq", type=int, default=None)
    parser.add_argument("--snp_frequency", type=float, default=None)
    parser.add_argument("--insert_frequency", type=float, default=None)
    parser.add_argument("--delete_frequency", type=float, default=None)
    parser.add_argument("--min_coverage_threshold", type=float, default=None)
    parser.add_argument("--candidate_support_threshold", type=float,
                        default=None)
    parser.add_argument("--snp_candidate_frequency_threshold", type=float,
                        default=None)
    parser.add_argument("--indel_candidate_frequency_threshold", type=float,
                        default=None)
    parser.add_argument("--skip_indels", action="store_true", default=False)
    parser.add_argument("--downsample_rate", type=float, default=1.0)
    parser.add_argument("--include_supplementary", action="store_true",
                        default=False)
    parser.add_argument("--use_hp_info", action="store_true", default=False,
                        help="Haplotagged 48-feature images (HP tags) and "
                             "the 48x21 classifier.")


def _add_inference_args(parser):
    parser.add_argument("--batch_size", type=int, default=4096)
    parser.add_argument("--dry", action="store_true", default=False,
                        help="Label-passthrough backend (pipeline test).")
    parser.add_argument("--compute_dtype", default="bfloat16",
                        choices=["float32", "bfloat16"])
    parser.add_argument("--quantized", action="store_true", default=False,
                        help="Serve int8-quantized weights.")
    parser.add_argument("--no_quantized", dest="quantized",
                        action="store_false")
    parser.add_argument("--quantize_mode", default="static",
                        choices=["static", "static_rec", "dynamic"],
                        help="int8 serving mode: static (exact 1/127 "
                             "activation scales, fused int8 kernels), "
                             "static_rec (also int8 recurrent matmuls) or "
                             "dynamic (per-batch absmax quantization).")
    parser.add_argument("--device_pileup", action="store_true",
                        default=False,
                        help="Fused device-window flow: gather + inject + "
                             "classify candidate windows from the region "
                             "image on the accelerator (one dispatch per "
                             "region batch).")
    parser.add_argument("--device_region_batch", type=int, default=32)
    parser.add_argument("--num_devices", type=int, default=-1,
                        help="Split inference batches over N local GPUs "
                             "(data parallel). -1 (default) = all local "
                             "GPUs; 1 = one device. On the CPU it is 1.")
    parser.add_argument("--device", default="cuda",
                        help="torch device for inference (default cuda; "
                             "cpu runs on the CPU).")


def _add_candidate_args(parser):
    parser.add_argument("--allowed_multiallelics", type=int, default=None)
    for name in ("snp_p_value", "insert_p_value", "delete_p_value",
                 "snp_p_value_in_lc", "insert_p_value_in_lc",
                 "delete_p_value_in_lc", "snp_q_cutoff", "indel_q_cutoff",
                 "snp_q_cutoff_in_lc", "indel_q_cutoff_in_lc",
                 "report_snp_above_freq", "report_indel_above_freq"):
        parser.add_argument(f"--{name}", type=float, default=None)
    parser.add_argument("--freq_based", action="store_true", default=False)
    parser.add_argument("--freq", type=float, default=0.10)


def _add_preset_args(parser):
    for name in ("ont_r9_guppy5_sup", "ont_r9_guppy4_hac", "ont_r10_q20",
                 "hifi", "clr"):
        parser.add_argument(f"--{name}", action="store_true", default=False)


def _add_train_args(parser):
    parser.add_argument("--truth_vcf", default=None)
    parser.add_argument("--random_draw_probability", type=float, default=0.33)
    parser.add_argument("--epochs", type=int, default=10)
    parser.add_argument("--learning_rate", type=float, default=1e-4)
    parser.add_argument("--weight_decay", type=float, default=0.0)
    parser.add_argument("--step_size", type=int, default=100)
    parser.add_argument("--retrain_model", action="store_true", default=False)
    parser.add_argument("--retrain_model_path", default=None)
    parser.add_argument("--test_file", default=None)


def build_parser():
    parser = argparse.ArgumentParser(
        prog="pepper_tpu_torch",
        description="PEPPER variant calling in PyTorch with CUDA kernels.")
    sub = parser.add_subparsers(dest="sub_command")

    p = sub.add_parser("call_variant", help="Run the full variant-calling "
                       "pipeline (images -> inference -> VCF).")
    _add_common_io(p, need_model=True)
    _add_region_args(p)
    _add_image_args(p)
    _add_inference_args(p)
    _add_candidate_args(p)
    _add_preset_args(p)
    p.add_argument("--sharded", action="store_true", default=False,
                   help="Region-manifest sharded/resumable mode (automatic "
                        "in a process group of more than one process, as "
                        "torchrun starts it); needs h5py.")

    p = sub.add_parser("make_images", help="Generate candidate images "
                       "(HDF5; needs h5py).")
    _add_common_io(p)
    _add_region_args(p)
    _add_image_args(p)
    _add_preset_args(p)

    p = sub.add_parser("run_inference", help="Classify stored images "
                       "(HDF5; needs h5py).")
    _add_common_io(p, need_model=True)
    p.add_argument("-i", "--image_dir", required=True)
    _add_inference_args(p)
    p.add_argument("--use_hp_info", action="store_true", default=False)

    p = sub.add_parser("find_candidates", help="Decode predictions to VCFs "
                       "(HDF5; needs h5py).")
    _add_common_io(p)
    p.add_argument("-i", "--input_dir", required=True)
    _add_candidate_args(p)
    _add_preset_args(p)
    p.add_argument("--use_hp_info", action="store_true", default=False)

    p = sub.add_parser("merge_variants", help="Merge PEPPER + DeepVariant "
                       "VCFs.")
    p.add_argument("-vp", "--vcf_pepper", required=True)
    p.add_argument("-vd", "--vcf_deepvariant", default=None)
    p.add_argument("-vds", "--vcf_deepvariant_snps", default=None)
    p.add_argument("-vdi", "--vcf_deepvariant_indels", default=None)
    p.add_argument("-o", "--output_dir", default="./output")

    p = sub.add_parser("make_train_images", help="Generate labeled images "
                       "(HDF5; needs h5py).")
    _add_common_io(p)
    _add_region_args(p)
    _add_image_args(p)
    _add_preset_args(p)
    _add_train_args(p)

    p = sub.add_parser("train_model", help="Train the window classifier "
                       "(HDF5 images; needs h5py).")
    _add_common_io(p, need_model=True)
    p.add_argument("-i", "--image_dir", required=True)
    _add_inference_args(p)
    _add_train_args(p)
    p.add_argument("--use_hp_info", action="store_true", default=False)
    p.add_argument("--model_type", default="lstm",
                   choices=("lstm", "no_cnn", "transformer"),
                   help="Window-classifier family (default: the reference's "
                        "live bi-LSTM transducer).")

    p = sub.add_parser("test_model", help="Evaluate a model on labeled "
                       "images (HDF5; needs h5py).")
    _add_common_io(p, need_model=True)
    p.add_argument("-i", "--image_dir", required=True)
    _add_inference_args(p)
    p.add_argument("--use_hp_info", action="store_true", default=False)

    p = sub.add_parser("run_hyperband", help="Hyperband lr/l2 search over "
                       "the window classifier (HDF5 images; needs h5py).")
    _add_common_io(p)
    p.add_argument("-i", "--image_dir", required=True)
    p.add_argument("--max_iter", type=int, default=27,
                   help="Max epochs per configuration.")
    p.add_argument("--eta", type=int, default=3)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--use_hp_info", action="store_true", default=False)
    p.add_argument("--device", default="cuda",
                   help="torch device for training (default cuda; cpu "
                        "runs on the CPU).")

    p = sub.add_parser("download_models", help="Download published PEPPER "
                       "model checkpoints (download_model.py:10-27).")
    p.add_argument("-o", "--output_dir", default="pepper_models")
    p.add_argument("--description_url", default=None,
                   help="Override the model-description CSV URL "
                        "(file:// URLs accepted for offline mirrors).")
    sub.add_parser("backend_stat", help="Print the torch device info.")
    sub.add_parser("version")
    return parser


def options_from_args(args) -> PepperOptions:
    options = PepperOptions()
    for key, value in vars(args).items():
        if hasattr(options, key):
            setattr(options, key, value)
    options.sub_command = args.sub_command
    return options


def _validate_inputs(options, args):
    """Early input validation with clear errors (CallVariant.py:20-72)."""
    import os

    def fail(message):
        sys.stderr.write(f"ERROR: {message}\n")
        raise SystemExit(1)

    if args.sub_command in ("call_variant", "make_images",
                            "make_train_images"):
        if not options.bam or not os.path.isfile(options.bam):
            fail(f"CAN NOT LOCATE BAM FILE: {options.bam!r}")
        if not (os.path.isfile(options.bam + ".bai")
                or os.path.isfile(options.bam.rsplit(".", 1)[0] + ".bai")):
            fail(f"CAN NOT LOCATE BAM INDEX (.bai) FOR: {options.bam!r}")
        if not options.fasta or not os.path.isfile(options.fasta):
            fail(f"CAN NOT LOCATE FASTA FILE: {options.fasta!r}")
        if not os.path.isfile(options.fasta + ".fai"):
            fail(f"CAN NOT LOCATE FASTA INDEX (.fai) FOR: {options.fasta!r}")
    if args.sub_command == "call_variant" and not options.dry:
        if not options.model_path or not os.path.isfile(options.model_path):
            fail(f"CAN NOT LOCATE MODEL FILE: {options.model_path!r}")
    if options.threads <= 0:
        fail("THREAD NEEDS TO BE >0.")
    if getattr(options, "batch_size", 1) <= 0:
        fail("batch_size NEEDS TO BE >0.")
    if args.sub_command == "make_train_images":
        if not options.truth_vcf or not os.path.isfile(options.truth_vcf):
            fail(f"CAN NOT LOCATE TRUTH VCF: {options.truth_vcf!r}")


def _backend_stat() -> None:
    import os

    import torch

    from ..parallel.mesh import resolve_num_devices

    print(f"torch {torch.__version__} (CUDA {torch.version.cuda})")
    available = torch.cuda.is_available()
    print(f"cuda available: {available}")
    if available:
        for index in range(torch.cuda.device_count()):
            print(f"device {index}: {torch.cuda.get_device_name(index)}")
    print(f"device count: {torch.cuda.device_count() if available else 0}")
    print("--num_devices -1 resolves to: "
          f"{resolve_num_devices(-1, 'cuda' if available else 'cpu')}")
    print(f"process {os.environ.get('RANK', '0')}/"
          f"{os.environ.get('WORLD_SIZE', '1')}")


def _load_model(options):
    """The checkpoint's params (None for --dry); sets options.model_type
    from its metadata."""
    if options.dry:
        return None
    from ..models.checkpoint import load_params

    params, meta = load_params(options.model_path)
    options.model_type = meta.get("model_type", "lstm")
    return params


def download_models_command(args, hint: str = "") -> int:
    """download_models into args.output_dir from args.description_url (or
    the published list): 0 with the count printed, 1 where the list cannot
    be fetched."""
    from ..utils.download_model import (DEFAULT_DESCRIPTION_URL,
                                        download_models)

    url = args.description_url or DEFAULT_DESCRIPTION_URL
    try:
        paths = download_models(args.output_dir, url)
    except OSError:
        return 1
    print(f"downloaded/verified {len(paths)} model(s) in "
          f"{args.output_dir}{hint}")
    return 0


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.sub_command is None:
        parser.print_help()
        return 1
    if args.sub_command == "version":
        from .. import __version__

        print(f"pepper_tpu_torch {__version__}")
        return 0
    if args.sub_command == "backend_stat":
        _backend_stat()
        return 0
    if args.sub_command == "download_models":
        return download_models_command(
            args, " — pass a .pkl to -m/--model_path (converted on load) or "
            "train natively with `pepper_tpu_torch train_model`.")

    if args.sub_command == "merge_variants":
        from ..decode.merge_variants import merge_vcf_records

        merge_vcf_records(args)
        return 0

    options = options_from_args(args)
    _validate_inputs(options, args)
    options = set_parameters(options)

    if args.sub_command == "call_variant":
        from ..parallel.dist import init_distributed, shutdown_distributed
        from ..pipeline.call_variant import (call_variant,
                                             call_variant_sharded)

        params = _load_model(options)
        _, world = init_distributed()
        try:
            if args.sharded or world > 1:
                call_variant_sharded(options, params=params,
                                     device=args.device)
            else:
                call_variant(options, params=params, device=args.device)
        finally:
            if world > 1:
                shutdown_distributed()
    elif args.sub_command in ("make_images", "make_train_images"):
        from ..pipeline.stages import make_images

        options.train_mode = args.sub_command == "make_train_images"
        make_images(options, options.output_dir)
    elif args.sub_command == "run_inference":
        from ..pipeline.stages import run_inference

        run_inference(options, args.image_dir, options.output_dir,
                      params=_load_model(options), device=args.device)
    elif args.sub_command == "find_candidates":
        from ..pipeline.stages import process_candidates

        process_candidates(options, args.input_dir, options.output_dir)
    elif args.sub_command == "train_model":
        _train_model(options, args)
    elif args.sub_command == "test_model":
        from ..train import trainer

        trainer.test_model(options, args.image_dir, device=args.device)
    elif args.sub_command == "run_hyperband":
        _run_hyperband(options, args)
    return 0


def _train_model(options, args):
    """train_model in this process, or in each of a process group's
    (torchrun's environment), which sum their gradients."""
    from ..parallel.dist import init_distributed, shutdown_distributed
    from ..train.trainer import train_model

    _, world = init_distributed()
    try:
        train_model(options, args.image_dir, options.output_dir,
                    epochs=args.epochs, learning_rate=args.learning_rate,
                    weight_decay=args.weight_decay, step_size=args.step_size,
                    retrain_model_path=args.retrain_model_path,
                    test_file=args.test_file, model_type=args.model_type,
                    device=args.device)
    finally:
        if world > 1:
            shutdown_distributed()


def _run_hyperband(options, args):
    import os
    import shutil

    from ..train.hyperband import Hyperband
    from ..train.trainer import train_model

    run_counter = {"n": 0}

    def try_params(n_iterations, config):
        run_counter["n"] += 1
        run_dir = os.path.join(options.output_dir,
                               f"hb_{config['_id']}_{run_counter['n']}")
        resume = (os.path.join(options.output_dir,
                               f"hb_{config['_id']}_best.npz")
                  if config.get("_resume") else None)
        model_path, accuracy = train_model(
            options, args.image_dir, run_dir,
            epochs=int(n_iterations),
            learning_rate=config["learning_rate"],
            weight_decay=config["weight_decay"],
            step_size=10_000, batch_size=options.batch_size,
            retrain_model_path=(resume if resume
                                and os.path.exists(resume) else None),
            device=args.device)
        best_path = os.path.join(options.output_dir,
                                 f"hb_{config['_id']}_best.npz")
        shutil.copy(model_path, best_path)
        return {"loss": -accuracy, "accuracy": accuracy,
                "checkpoint": best_path}

    hyperband = Hyperband(try_params, max_iter=args.max_iter, eta=args.eta)
    best = hyperband.run()
    print(f"BEST: acc={best['accuracy']:.3f} "
          f"config={best['config']} ckpt={best['checkpoint']}")


if __name__ == "__main__":
    sys.exit(main())
