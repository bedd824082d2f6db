"""pepper_tpu_torch polish command-line interface, the JAX package's
pepper_tpu_polish surface (pepper/pepper.py:264-373), so far for polish:

  python -m pepper_tpu_torch.cli.polish_main polish -b reads.bam \\
      -f draft.fa -m polish.npz -o out/ -t 8 [--quantized] [--device cuda]

The consensus runs on --device (default cuda; `--device cpu` runs on the
CPU).  The other subcommands take no options yet: they raise
NotImplementedError naming their ROADMAP.md item, whatever follows them.
"""

from __future__ import annotations

import argparse
import sys

from ..options import PepperOptions

_NOT_PORTED = {
    "make_images": 14, "call_consensus": 14, "stitch": 14,
    "make_train_images": 14, "train_model": 11, "test_model": 11,
    "run_hyperband": 11, "download_models": 12,
}


def _add_polish_options(parser):
    parser.add_argument("-b", "--bam", default="",
                        help="Reads-to-draft alignment BAM.")
    parser.add_argument("-f", "--fasta", default="",
                        help="Draft assembly FASTA (faidx indexed).")
    parser.add_argument("-o", "--output_dir", default="./output")
    parser.add_argument("-t", "--threads", type=int, default=1)
    parser.add_argument("-r", "--region", default=None)
    parser.add_argument("--region_bed", default=None)
    parser.add_argument("--batch_size", type=int, default=128)
    parser.add_argument("--downsample_rate", type=float, default=1.0)
    parser.add_argument("--dry", action="store_true", default=False)
    parser.add_argument("--no_realignment", dest="realignment",
                        action="store_false", default=True,
                        help="Skip SW local realignment before summarizing.")
    parser.add_argument("-m", "--model_path", default="")
    parser.add_argument(
        "--num_devices", type=int, default=-1,
        help="GPUs to run the consensus on: 1, or -1 (all local "
             "devices) on a host with one; more are not ported yet.")
    parser.add_argument(
        "--quantized", action="store_true", default=False,
        help="Serve the consensus GRU through the static-int8 path "
             "(exact 1/127 activation scales on the tanh-bounded "
             "hidden streams).")
    parser.add_argument(
        "--quantize_mode", default="static", choices=["static"],
        help="Quantization scheme used with --quantized.")
    parser.add_argument("--device", default="cuda",
                        help="torch device for the consensus (default "
                             "cuda; cpu runs on the CPU).")


def build_parser():
    parser = argparse.ArgumentParser(
        prog="pepper_tpu_torch_polish",
        description="PEPPER assembly polishing in PyTorch with CUDA "
                    "kernels.")
    sub = parser.add_subparsers(dest="sub_command")

    p = sub.add_parser("polish", help="images -> consensus -> stitch")
    _add_polish_options(p)

    for name, item in _NOT_PORTED.items():
        sub.add_parser(name, add_help=False,
                       help=f"Not ported yet (ROADMAP.md item {item}).")
    return parser


def _load_polish_params(options):
    if options.dry:
        return None
    if options.model_path.endswith((".pkl", ".pt", ".pth")):
        raise NotImplementedError(
            "reference torch checkpoints (.pkl, models/torch_convert.py) "
            "are not ported yet: ROADMAP.md queue A, item 13; convert to "
            ".npz with the JAX package first")
    from ..models.checkpoint import load_params

    params, _ = load_params(options.model_path)
    return params


def _check_num_devices(requested, device) -> None:
    """One device: 1, or -1 (all local devices) where that is one."""
    import torch

    local = (torch.cuda.device_count()
             if torch.device(device).type == "cuda" else 1)
    if requested == 1 or (requested == -1 and local == 1):
        return
    raise NotImplementedError(
        f"--num_devices {requested} ({local} local devices): multi-GPU "
        "polish is not ported yet: ROADMAP.md queue A, item 7")


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] in _NOT_PORTED:
        raise NotImplementedError(
            f"the {argv[0]} subcommand is not ported yet: "
            f"ROADMAP.md queue A, item {_NOT_PORTED[argv[0]]}")
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.sub_command is None:
        parser.print_help()
        return 1

    options = PepperOptions()
    for key, value in vars(args).items():
        if hasattr(options, key):
            setattr(options, key, value)
    options.sub_command = args.sub_command

    from ..device import resolve_device
    from ..polish.pipeline import polish

    device = resolve_device(args.device)
    _check_num_devices(args.num_devices, device)
    polish(options, _load_polish_params(options), device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
