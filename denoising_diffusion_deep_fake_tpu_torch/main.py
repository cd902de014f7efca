"""The port's training command line.

    python -m denoising_diffusion_deep_fake_tpu_torch.main train new \\
        --config_path configs/denoise.yml [--max_steps N] [--device cuda]
    ... train resume --checkpoint_path DIR
    ... train modify --config_path configs/swap.yml --checkpoint_path DIR
    ... denoise --config configs/denoiser.yml --input_list images.txt
    ... balance --config configs/balance.yml --input_list images.txt \\
        --output_list balanced.txt

Port of ``denoising_diffusion_deep_fake_tpu/main.py:44-137`` (the
reference's ``d3f`` click group), with ``argparse`` in place of ``click``
and the same subcommand and option names. ``--device`` (default ``cuda``)
is the port's counterpart of ``JAX_PLATFORMS=cpu``: ``--device cpu`` runs
the plain PyTorch path. Not ported yet: ``video`` (ROADMAP A6),
``profile`` (A10), ``serve``, ``import`` and ``export``.
"""

from __future__ import annotations

import argparse
import sys

from denoising_diffusion_deep_fake_tpu_torch.checkpoint import (
    CheckpointManager,
)
from denoising_diffusion_deep_fake_tpu_torch.config import (
    BalanceConfig,
    DeepFakeConfig,
    DenoiserConfig,
    config_from_dict,
    load_config,
    overlay_config,
    read_yaml_file_into_dict,
)


def _train_new(args):
    from denoising_diffusion_deep_fake_tpu_torch.training.runners import (
        fit_deep_fake)

    cfg = load_config(DeepFakeConfig, args.config_path)
    fit_deep_fake(cfg, max_steps=args.max_steps, device=args.device)


def _train_resume(args):
    from denoising_diffusion_deep_fake_tpu_torch.training.runners import (
        fit_deep_fake)

    meta = CheckpointManager(args.checkpoint_path).read_meta()
    cfg = config_from_dict(DeepFakeConfig, meta["hparams"])
    fit_deep_fake(cfg, resume_from=args.checkpoint_path,
                  max_steps=args.max_steps, device=args.device)


def _train_modify(args):
    from denoising_diffusion_deep_fake_tpu_torch.training.runners import (
        fit_deep_fake)

    meta = CheckpointManager(args.checkpoint_path).read_meta()
    cfg = overlay_config(DeepFakeConfig, meta["hparams"],
                         read_yaml_file_into_dict(args.config_path))
    fit_deep_fake(cfg, modify_from=args.checkpoint_path,
                  max_steps=args.max_steps, device=args.device)


def _denoise(args):
    from denoising_diffusion_deep_fake_tpu_torch.training.runners import (
        fit_denoiser)

    cfg = load_config(DenoiserConfig, args.config_path,
                      overrides={"input_image_list_path": args.input_list})
    fit_denoiser(cfg, max_steps=args.max_steps, device=args.device)


def _balance(args):
    from denoising_diffusion_deep_fake_tpu_torch.training.runners import (
        fit_balance)

    cfg = load_config(BalanceConfig, args.config_path,
                      overrides={"data_path": args.input_list,
                                 "output_image_list_path": args.output_list})
    fit_balance(cfg, max_steps=args.max_steps, device=args.device)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m denoising_diffusion_deep_fake_tpu_torch.main",
        description="Face-swap-via-denoising training on an NVIDIA GPU.")
    commands = parser.add_subparsers(dest="command", required=True)

    def command(group, name, run, help_text):
        p = group.add_parser(name, help=help_text, description=help_text)
        p.set_defaults(run=run)
        p.add_argument("--max_steps", type=int, default=None,
                       help="Stop after N optimizer steps (smoke runs).")
        p.add_argument("--device", default="cuda",
                       help="cuda (default) or cpu: the plain PyTorch path.")
        return p

    train = commands.add_parser(
        "train", help="Two-identity deep-fake training (denoise and swap "
        "modes).").add_subparsers(dest="train_command", required=True)
    p = command(train, "new", _train_new, "Start fresh from a YAML config.")
    p.add_argument("--config_path", required=True,
                   help="Path to the config yaml.")
    p = command(train, "resume", _train_resume, "Resume training: weights, "
                "optimizer, epoch and generator from the checkpoint.")
    p.add_argument("--checkpoint_path", required=True,
                   help="Checkpoint directory to resume from.")
    p = command(train, "modify", _train_modify, "Load weights, overlay new "
                "hparams, fresh optimizers: the denoise -> swap flip.")
    p.add_argument("--config_path", required=True,
                   help="Path to the config yaml.")
    p.add_argument("--checkpoint_path", required=True,
                   help="Checkpoint directory to load weights from.")
    p = command(commands, "denoise", _denoise,
                "Train a single-model denoiser.")
    p.add_argument("--config", dest="config_path", required=True,
                   help="Path to the config yaml.")
    p.add_argument("--input_list", required=True,
                   help="images.txt manifest of training images.")
    p = command(commands, "balance", _balance, "Score image difficulty and "
                "write a balanced manifest.")
    p.add_argument("--config", dest="config_path", required=True,
                   help="Path to the config yaml.")
    p.add_argument("--input_list", required=True,
                   help="images.txt manifest to balance.")
    p.add_argument("--output_list", required=True,
                   help="Where to write the difficulty-classed manifest.")
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    args.run(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
