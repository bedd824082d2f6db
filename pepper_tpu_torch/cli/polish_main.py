"""pepper_tpu_torch polish command-line interface, the JAX package's
pepper_tpu_polish surface (pepper/pepper.py:264-373), so far for polish
and the staged make_images / call_consensus / stitch:

  python -m pepper_tpu_torch.cli.polish_main polish -b reads.bam \\
      -f draft.fa -m polish.npz -o out/ -t 8 [--quantized] \\
      [--num_devices -1] [--device cuda]

The consensus runs on --device (default cuda; `--device cpu` runs on the
CPU), data parallel over --num_devices local GPUs (-1, the default: all of
them).  polish runs in one process without h5py; the staged subcommands
pass the JAX package's HDF5 files and need it.  The training subcommands
and download_models take no options yet: they raise NotImplementedError
naming their ROADMAP.md item, whatever follows them.
"""

from __future__ import annotations

import argparse
import sys

from ..options import PepperOptions

_NOT_PORTED = {
    "make_train_images": 11, "train_model": 11, "test_model": 11,
    "run_hyperband": 11, "download_models": 12,
}


def _add_polish_options(parser, need_model=True):
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
    if not need_model:
        return
    parser.add_argument("-m", "--model_path", default="")
    parser.add_argument(
        "--num_devices", type=int, default=-1,
        help="GPUs to split the consensus batches over (data parallel): "
             "-1 (default) = all local GPUs; 1 = one device. On the CPU "
             "it is 1.")
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

    p = sub.add_parser("make_images", help="Polish images to HDF5 (needs "
                       "h5py).")
    _add_polish_options(p, need_model=False)

    p = sub.add_parser("call_consensus", help="HDF5 images -> HDF5 "
                       "predictions (needs h5py).")
    _add_polish_options(p)
    p.add_argument("-i", "--image_dir", required=True)

    p = sub.add_parser("stitch", help="HDF5 predictions -> polished FASTA "
                       "(needs h5py).")
    p.add_argument("-i", "--input_dir", required=True)
    p.add_argument("-o", "--output_dir", default="./output")

    for name, item in _NOT_PORTED.items():
        sub.add_parser(name, add_help=False,
                       help=f"Not ported yet (ROADMAP.md item {item}).")
    return parser


def _load_polish_params(options):
    if options.dry:
        return None
    if options.model_path.endswith((".pkl", ".pt", ".pth")):
        from ..models.torch_convert import (load_reference_checkpoint,
                                            polish_params_from_state_dict)

        params, _ = load_reference_checkpoint(
            options.model_path, convert=polish_params_from_state_dict)
        return params
    from ..models.checkpoint import load_params

    params, _ = load_params(options.model_path)
    return params


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
    if args.sub_command == "stitch":
        from ..polish.pipeline import perform_stitch

        perform_stitch(args.input_dir,
                       f"{args.output_dir.rstrip('/')}/consensus")
        return 0

    options = PepperOptions()
    for key, value in vars(args).items():
        if hasattr(options, key):
            setattr(options, key, value)
    options.sub_command = args.sub_command

    if args.sub_command == "make_images":
        from ..polish.pipeline import make_polish_images

        make_polish_images(options, options.output_dir)
        return 0

    from ..device import resolve_device
    from ..polish import pipeline

    # --num_devices reaches the pipeline as options.num_devices
    device = resolve_device(args.device)
    if args.sub_command == "polish":
        pipeline.polish(options, _load_polish_params(options), device=device)
    else:
        pipeline.call_consensus(options, args.image_dir, options.output_dir,
                                _load_polish_params(options), device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
