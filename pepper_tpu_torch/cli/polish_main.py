"""pepper_tpu_torch polish command-line interface, the JAX package's
pepper_tpu_polish surface (pepper/pepper.py:264-373): polish, the staged
make_images / call_consensus / stitch, the training subcommands
make_train_images / train_model / test_model / run_hyperband and
download_models:

  python -m pepper_tpu_torch.cli.polish_main polish -b reads.bam \\
      -f draft.fa -m polish.npz -o out/ -t 8 [--quantized] \\
      [--num_devices -1] [--device cuda]

The consensus runs on --device (default cuda; `--device cpu` runs on the
CPU), data parallel over --num_devices local GPUs (-1, the default: all of
them); training and its evals run over every local GPU of --device cuda
(one with --device cuda:N), and train_model in a process group of more
than one process (torchrun's environment, parallel/dist.py) sums its
gradients over the processes.  polish runs in one process without h5py;
the staged and training subcommands pass the JAX package's HDF5 files and
need it.
"""

from __future__ import annotations

import argparse
import sys

from ..options import PepperOptions


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
    _add_device(parser)


def _add_device(parser):
    parser.add_argument("--device", default="cuda",
                        help="torch device for the consensus and training "
                             "(default cuda; cpu runs on the CPU).")


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

    p = sub.add_parser("make_train_images", help="Labeled polish images "
                       "to HDF5 (needs h5py).")
    _add_polish_options(p, need_model=False)
    p.add_argument("--truth_bam", required=True,
                   help="Truth-to-draft alignment BAM (supervision).")

    p = sub.add_parser("train_model", help="Train the polish model on "
                       "HDF5 images (needs h5py).")
    _add_polish_options(p)
    p.add_argument("-i", "--image_dir", required=True)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--weight_decay", type=float, default=0.0)

    p = sub.add_parser("test_model", help="Evaluate a polish checkpoint "
                       "on labeled HDF5 images (needs h5py).")
    _add_polish_options(p)
    p.add_argument("-i", "--image_dir", required=True)

    p = sub.add_parser("run_hyperband", help="Hyperband lr/l2 search over "
                       "the polish trainer (HDF5 images; needs h5py).")
    _add_polish_options(p, need_model=False)
    _add_device(p)
    p.add_argument("-i", "--image_dir", required=True)
    p.add_argument("--max_iter", type=int, default=27)
    p.add_argument("--eta", type=int, default=3)
    p.add_argument("--seed", type=int, default=0)

    p = sub.add_parser("download_models", help="Download published PEPPER "
                       "model checkpoints (download_model.py:10-27).")
    p.add_argument("-o", "--output_dir", default="pepper_models")
    p.add_argument("--description_url", default=None,
                   help="Override the model-description CSV URL "
                        "(file:// URLs accepted for offline mirrors).")
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
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.sub_command is None:
        parser.print_help()
        return 1
    if args.sub_command == "download_models":
        from .main import download_models_command

        return download_models_command(args)
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
    if args.sub_command == "make_train_images":
        from ..polish.pipeline import make_polish_train_images

        make_polish_train_images(options, args.truth_bam, options.output_dir)
        return 0

    from ..device import resolve_device
    from ..polish import pipeline, train

    device = resolve_device(args.device)
    if args.sub_command == "polish":
        # --num_devices reaches the pipeline as options.num_devices
        pipeline.polish(options, _load_polish_params(options), device=device)
    elif args.sub_command == "call_consensus":
        pipeline.call_consensus(options, args.image_dir, options.output_dir,
                                _load_polish_params(options), device=device)
    elif args.sub_command == "test_model":
        train.test_polish_model(options, args.image_dir, options.model_path,
                                batch_size=options.batch_size, device=device)
    elif args.sub_command == "run_hyperband":
        train.run_polish_hyperband(options, args.image_dir,
                                   options.output_dir, max_iter=args.max_iter,
                                   eta=args.eta, seed=args.seed,
                                   batch_size=options.batch_size,
                                   device=device)
    else:
        _train_model(options, args, device)
    return 0


def _train_model(options, args, device):
    """train_model in this process, or in each of a process group's
    (torchrun's environment), which sum their gradients.  As the JAX
    package's CLI it passes no --batch_size: the trainer's 16."""
    from ..parallel.dist import init_distributed, shutdown_distributed
    from ..polish.train import train_polish_model

    _, world = init_distributed()
    try:
        train_polish_model(options, args.image_dir, options.output_dir,
                           epochs=args.epochs,
                           learning_rate=args.learning_rate,
                           weight_decay=args.weight_decay, device=device)
    finally:
        if world > 1:
            shutdown_distributed()


if __name__ == "__main__":
    sys.exit(main())
