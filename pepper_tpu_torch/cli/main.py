"""pepper_tpu_torch command-line interface.

The JAX package's subcommand surface, so far for call_variant, version and
backend_stat:

  python -m pepper_tpu_torch.cli.main call_variant -b reads.bam -f ref.fa \\
      -m model.npz -o out/ -t 8 --ont_r9_guppy5_sup [--device cuda]

Inference runs on --device (default cuda; `--device cpu` runs on the CPU).
Options the port does not serve yet raise NotImplementedError.
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
                            help="Model checkpoint (.npz native)")


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
                        help="Not ported yet (raises).")


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
                        help="-1 (default) resolves to 1 device; more than "
                             "one is not ported yet (raises).")
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
                   help="Region-manifest sharded mode; not ported yet "
                        "(raises).")

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

    if not options.bam or not os.path.isfile(options.bam):
        fail(f"CAN NOT LOCATE BAM FILE: {options.bam!r}")
    if not (os.path.isfile(options.bam + ".bai")
            or os.path.isfile(options.bam.rsplit(".", 1)[0] + ".bai")):
        fail(f"CAN NOT LOCATE BAM INDEX (.bai) FOR: {options.bam!r}")
    if not options.fasta or not os.path.isfile(options.fasta):
        fail(f"CAN NOT LOCATE FASTA FILE: {options.fasta!r}")
    if not os.path.isfile(options.fasta + ".fai"):
        fail(f"CAN NOT LOCATE FASTA INDEX (.fai) FOR: {options.fasta!r}")
    if not options.dry:
        if not options.model_path or not os.path.isfile(options.model_path):
            fail(f"CAN NOT LOCATE MODEL FILE: {options.model_path!r}")
    if options.threads <= 0:
        fail("THREAD NEEDS TO BE >0.")
    if options.batch_size <= 0:
        fail("batch_size NEEDS TO BE >0.")


def _backend_stat() -> None:
    import torch

    print(f"torch {torch.__version__} (CUDA {torch.version.cuda})")
    available = torch.cuda.is_available()
    print(f"cuda available: {available}")
    if available:
        for index in range(torch.cuda.device_count()):
            print(f"device {index}: {torch.cuda.get_device_name(index)}")
    print(f"device count: {torch.cuda.device_count() if available else 0}")


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

    options = options_from_args(args)
    _validate_inputs(options, args)
    options = set_parameters(options)
    if args.sharded:
        raise NotImplementedError(
            "--sharded (region-manifest sharded call_variant) is not ported "
            "yet: ROADMAP.md queue A, item 7")

    from ..pipeline.call_variant import call_variant

    params = None
    if not options.dry:
        from ..models.checkpoint import load_params

        params, meta = load_params(options.model_path)
        options.model_type = meta.get("model_type", "lstm")
    call_variant(options, params=params, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
