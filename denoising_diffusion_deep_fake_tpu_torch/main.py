"""The port's command line: training, video tools and serving.

    python -m denoising_diffusion_deep_fake_tpu_torch.main train new \\
        --config_path configs/denoise.yml [--max_steps N] [--device cuda]
    ... train resume --checkpoint_path DIR
    ... train modify --config_path configs/swap.yml --checkpoint_path DIR
    ... denoise --config configs/denoiser.yml --input_list images.txt
    ... balance --config configs/balance.yml --input_list images.txt \\
        --output_list balanced.txt
    ... video prep VIDEO OUT_DIR [--width 448 --height 448]
    ... video swap VIDEO CHECKPOINT a|b [--output OUT.mp4 --batch_size 8 \\
        --sampler_steps 0 --transfer rgb|i420]
    ... serve CHECKPOINT a|b|both [--port 8000 --transfer rgb|i420 --check]
    ... import CKPT_PATH OUTPUT_DIR
    ... export CHECKPOINT_DIR OUTPUT_PATH [--step N]
    ... profile --config configs/denoiser.yml --input_list images.txt \\
        [--steps 20 --trace_dir profile_trace --report]

Port of ``denoising_diffusion_deep_fake_tpu/main.py:44-318`` (the
reference's ``d3f`` click group), with ``argparse`` in place of ``click``
and the same subcommand and option names. ``--device``
(default ``cuda``) is the port's counterpart of ``JAX_PLATFORMS=cpu``:
``--device cpu`` runs the plain PyTorch path. ``import`` and ``export``
convert files on the host and take no ``--device``; they cover every
encoder family (a ``patchify_stem`` checkpoint is not exported: the
reference has no such model). ``serve --devices n``
serves n engine replicas, one a card (on the CPU they share it). The
training commands run data-parallel when launched as several processes
with ``D3F_COORDINATOR``, ``D3F_NUM_PROCESSES`` and ``D3F_PROCESS_ID``
(``parallel/distributed.py``). ``profile`` runs
``fit_denoiser`` for ``--steps`` steps under a ``torch.profiler`` trace
(``utils/profiling.py``) and, with ``--report``, prints the trace's
per-device report as JSON: device busy and idle a step, time by category
and by kernel, the port's kernels' launches. Its first steps include
cuDNN's planning and the kernels' build, so read its times as shares.
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


def _video_prep(args):
    from denoising_diffusion_deep_fake_tpu_torch.data.video import (
        video_to_center_cropped_images)

    video_to_center_cropped_images(args.video_path, args.output_dir,
                                   args.width, args.height)


def _video_swap(args):
    from denoising_diffusion_deep_fake_tpu_torch.data.video import (
        render_fake_video)

    render_fake_video(args.video_path, args.checkpoint_path,
                      args.model_a_or_b, width=args.width,
                      height=args.height, output_path=args.output,
                      batch_size=args.batch_size,
                      sampler_steps=args.sampler_steps,
                      transfer=args.transfer, device=args.device)


def _serve(args):
    from denoising_diffusion_deep_fake_tpu_torch.serving.server import (
        run_server)

    run_server(args.checkpoint_path, args.model_a_or_b, host=args.host,
               port=args.port, height=args.height, width=args.width,
               batch_size=args.batch_size, use_ema=args.use_ema,
               sampler_steps=args.sampler_steps,
               max_wait_ms=args.max_wait_ms, transfer=args.transfer,
               devices=args.devices, max_queue_frames=args.max_queue_frames,
               request_deadline_ms=args.request_deadline_ms,
               check=args.check, device=args.device)


def _import(args):
    from denoising_diffusion_deep_fake_tpu_torch.utils.torch_import import (
        import_reference_checkpoint)

    path = import_reference_checkpoint(args.ckpt_path, args.output_dir)
    print(f"imported -> {path}")


def _export(args):
    from denoising_diffusion_deep_fake_tpu_torch.utils.torch_export import (
        export_reference_checkpoint)

    info = export_reference_checkpoint(args.checkpoint_dir, args.output_path,
                                       step=args.step)
    print(f"exported {info['keys']} tensors "
          f"(identities {','.join(info['identities'])}, "
          f"step {info['global_step']}) -> {args.output_path}")


def _profile(args):
    import json

    from denoising_diffusion_deep_fake_tpu_torch.training.runners import (
        fit_denoiser)
    from denoising_diffusion_deep_fake_tpu_torch.utils.profiling import (
        analyze_trace_dir, trace)

    cfg = load_config(DenoiserConfig, args.config_path,
                      overrides={"input_image_list_path": args.input_list})
    with trace(args.trace_dir, device=args.device) as prof:
        # One ProfilerStep# window a train step: the report's wall and gap
        # are per step (the first window holds the set-up).
        fit_denoiser(cfg, max_steps=args.steps, device=args.device,
                     step_callback=lambda *_: prof.step())
    print(f"trace written to {args.trace_dir}")
    if args.report:
        summary = analyze_trace_dir(args.trace_dir, nsteps=args.steps)
        print(json.dumps(summary if summary is not None
                         else {"error": "no trace file written"}, indent=2))


def _frame_options(p) -> None:
    p.add_argument("--width", type=int, default=448)
    p.add_argument("--height", type=int, default=448)


def _swap_options(p) -> None:
    p.add_argument("--batch_size", type=int, default=8,
                   help="Frames swapped per device batch.")
    p.add_argument("--sampler_steps", type=int, default=0,
                   help="0 = single-pass parity (default); N>0 = DDIM "
                   "refinement.")
    p.add_argument("--transfer", choices=("rgb", "i420"), default="rgb",
                   help="Host<->device wire format; i420 halves the bytes.")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m denoising_diffusion_deep_fake_tpu_torch.main",
        description="Face-swap-via-denoising training on an NVIDIA GPU.")
    commands = parser.add_subparsers(dest="command", required=True)

    def command(group, name, run, help_text, *, steps=True, device=True):
        p = group.add_parser(name, help=help_text, description=help_text)
        p.set_defaults(run=run)
        if steps:
            p.add_argument("--max_steps", type=int, default=None,
                           help="Stop after N optimizer steps (smoke runs).")
        if device:
            p.add_argument("--device", default="cuda", help="cuda "
                           "(default) or cpu: the plain PyTorch path.")
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

    video = commands.add_parser(
        "video", help="Dataset prep and face-swap rendering for videos."
    ).add_subparsers(dest="video_command", required=True)
    p = command(video, "prep", _video_prep, "Video -> centre-cropped frame "
                "dataset + images.txt manifest.", steps=False)
    p.add_argument("video_path")
    p.add_argument("output_dir")
    _frame_options(p)
    p = command(video, "swap", _video_swap, "Render a side-by-side "
                "real|fake video through a trained checkpoint.", steps=False)
    p.add_argument("video_path")
    p.add_argument("checkpoint_path")
    p.add_argument("model_a_or_b", choices=("a", "b"))
    _frame_options(p)
    p.add_argument("--output", default=None, help="Output mp4 path.")
    _swap_options(p)

    p = command(commands, "serve", _serve, "Long-running face-swap "
                "inference server (HTTP, micro-batched).", steps=False)
    p.add_argument("checkpoint_path")
    p.add_argument("model_a_or_b", choices=("a", "b", "both"))
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    _frame_options(p)
    _swap_options(p)
    p.add_argument("--max_wait_ms", type=float, default=5.0,
                   help="Max time a lone request waits for batch company.")
    p.add_argument("--use_ema", action="store_true",
                   help="Swap through the EMA shadow instead of the online "
                   "model.")
    p.add_argument("--devices", type=int, default=1,
                   help="Cards to replicate the engine over, one "
                   "replica a card.")
    p.add_argument("--max_queue_frames", type=int, default=None,
                   help="Admission watermark: queued frames beyond this "
                   "shed with 503 + Retry-After (default 8 batches).")
    p.add_argument("--request_deadline_ms", type=float, default=None,
                   help="Per-request deadline (504 when it passes); "
                   "clients can override it with X-Deadline-Ms.")
    p.add_argument("--check", action="store_true",
                   help="Deployment validation: restore, build, one device "
                   "round trip per engine, print stats JSON, exit.")

    p = command(commands, "import", _import, "Convert a reference Lightning "
                ".ckpt into a checkpoint directory (for train resume|modify, "
                "video swap and serve).", steps=False, device=False)
    p.add_argument("ckpt_path")
    p.add_argument("output_dir")
    p = command(commands, "export", _export, "Convert a checkpoint directory "
                "into a reference Lightning .ckpt (weights, EMA shadows, BN "
                "statistics and hparams).", steps=False, device=False)
    p.add_argument("checkpoint_dir")
    p.add_argument("output_path")
    p.add_argument("--step", type=int, default=None,
                   help="Checkpoint step to export (default: latest).")

    p = command(commands, "profile", _profile, "Capture a torch.profiler "
                "trace of N denoiser train steps.", steps=False)
    p.add_argument("--config", dest="config_path", required=True,
                   help="Denoiser config yaml (the profiling workload).")
    p.add_argument("--input_list", required=True,
                   help="images.txt manifest of training images.")
    p.add_argument("--steps", type=int, default=20,
                   help="Train steps to capture (the first ones include "
                   "set-up).")
    p.add_argument("--trace_dir", default="profile_trace",
                   help="Output directory of the Chrome-trace JSON.")
    p.add_argument("--report", action="store_true",
                   help="Also read the trace and print the per-device "
                   "report (no viewer needed).")
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    args.run(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
