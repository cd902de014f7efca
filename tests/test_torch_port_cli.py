"""The port's training command line on the CPU (``--device cpu``).

* ``train new``, ``train resume`` and ``train modify`` in a row on a
  two-identity dataset, then ``denoise`` and ``balance``, each cut short
  by ``--max_steps``: the checkpoints, counters and manifest each leaves;
* every option of the JAX package's click commands is an option of the
  port's subcommand of the same name (``video prep|swap`` and ``serve``
  too: they run in ``tests/test_torch_port_video.py``); ``--device``
  defaults to ``cuda``, which raises on a machine without one.

32^2, resnet18, batch 2, fp32.
"""

import argparse
import shutil

import click
import pytest
import torch
import yaml

from denoising_diffusion_deep_fake_tpu.main import cli as jax_cli
from denoising_diffusion_deep_fake_tpu_torch.checkpoint import (
    CheckpointManager,
)
from denoising_diffusion_deep_fake_tpu_torch.data.manifest import (
    read_image_manifest,
    read_image_manifest_with_classes,
)
from denoising_diffusion_deep_fake_tpu_torch.main import build_parser, main

from helpers import make_image_dataset

SMALL = dict(batch_size=2, encoder_name="resnet18", compute_dtype="float32",
             image_size=32)
COMMANDS = [("train", "new"), ("train", "resume"), ("train", "modify"),
            ("denoise",), ("balance",), ("video", "prep"), ("video", "swap"),
            ("serve",)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tmp_path(tmp_path):
    """pytest's, emptied after the test: the checkpoints of a 32^2
    resnet18 U-Net weigh 57 MB a model and twice that for Adam."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _yaml(path, data):
    path.write_text(yaml.safe_dump(data))
    return str(path)


@pytest.fixture(scope="module")
def deep_fake_cli(tmp_path_factory):
    """``train new`` (denoise mode, 2 epochs of 2 steps, stopped after 2),
    ``train resume`` (1 more step) and ``train modify`` to swap mode, and
    what each left."""
    root = tmp_path_factory.mktemp("cli")
    manifests = [make_image_dataset(root / n, n=4, size=32, seed=i)
                 for i, n in enumerate("ab")]
    ckpt = root / "ckpt"
    new_cfg = _yaml(root / "denoise.yml", dict(
        SMALL, mode="denoise", max_epochs=2, data_path_a=str(manifests[0]),
        data_path_b=str(manifests[1]), log_dir=str(root / "runs"),
        checkpoint_dir=str(ckpt)))
    swap_cfg = _yaml(root / "swap.yml", dict(
        mode="swap", learning_rate=0.005,
        checkpoint_dir=str(root / "swap_ckpt")))
    metas = {}
    main(["train", "new", "--config_path", new_cfg, "--max_steps", "2",
          "--device", "cpu"])
    metas["new"] = CheckpointManager(ckpt).read_meta()
    main(["train", "resume", "--checkpoint_path", str(ckpt),
          "--max_steps", "3", "--device", "cpu"])
    metas["resume"] = CheckpointManager(ckpt).read_meta()
    main(["train", "modify", "--config_path", swap_cfg,
          "--checkpoint_path", str(ckpt), "--max_steps", "2",
          "--device", "cpu"])
    metas["modify"] = CheckpointManager(root / "swap_ckpt").read_meta()
    yield root, metas
    shutil.rmtree(root, ignore_errors=True)


@pytest.mark.parametrize("command,step,epoch", [
    ("new", 2, 0), ("resume", 3, 1), ("modify", 2, 0)])
def test_train_commands(deep_fake_cli, command, step, epoch):
    root, metas = deep_fake_cli
    meta = metas[command]
    assert meta["step"] == meta["extra"]["global_step"] == step
    assert meta["extra"]["epoch"] == epoch
    assert meta["extra"]["rng_device"] == "cpu"
    mode = "swap" if command == "modify" else "denoise"
    assert meta["hparams"]["mode"] == mode
    folder = root / ("swap_ckpt" if command == "modify" else "ckpt") / \
        f"step_{step:010d}"
    for name in "ab":
        counters = torch.load(folder / name / "counters.pt")
        assert counters["step"] == step
        assert (folder / name / "ema_model.pt").exists() == (mode == "swap")
    if command == "modify":
        assert meta["hparams"]["learning_rate"] == 0.005
        assert meta["hparams"]["data_path_a"] == \
            metas["new"]["hparams"]["data_path_a"]


def test_denoise_command(tmp_path):
    manifest = make_image_dataset(tmp_path / "data", n=6, size=32)
    cfg = _yaml(tmp_path / "denoiser.yml", dict(
        SMALL, log_dir=str(tmp_path / "runs"),
        checkpoint_dir=str(tmp_path / "ckpt")))
    main(["denoise", "--config", cfg, "--input_list", str(manifest),
          "--max_steps", "2", "--device", "cpu"])
    manager = CheckpointManager(tmp_path / "ckpt")
    meta = manager.read_meta()
    assert meta["step"] == 2
    assert meta["hparams"]["input_image_list_path"] == str(manifest)
    assert (manager.step_dir(2) / "state" / "optimizer.pt").exists()
    assert list((tmp_path / "runs" / "denoiser").glob("events.out.*"))


def test_balance_command(tmp_path):
    manifest = make_image_dataset(tmp_path / "data", n=5, size=32)
    out = tmp_path / "balanced.txt"
    cfg = _yaml(tmp_path / "balance.yml", dict(
        SMALL, number_of_classes=3, log_dir=str(tmp_path / "runs"),
        checkpoint_dir=str(tmp_path / "ckpt")))
    main(["balance", "--config", cfg, "--input_list", str(manifest),
          "--output_list", str(out), "--max_steps", "2", "--device", "cpu"])
    paths, classes = read_image_manifest_with_classes(out)
    assert paths == read_image_manifest(manifest)
    assert len(classes) == 5 and set(classes) <= {0, 1, 2}
    assert CheckpointManager(tmp_path / "ckpt").read_meta()["step"] == 2


def _port_options(path) -> set:
    parser = build_parser()
    for word in path:
        sub = next(a for a in parser._actions
                   if isinstance(a, argparse._SubParsersAction))
        parser = sub.choices[word]
    return {s for a in parser._actions for s in a.option_strings}


@pytest.mark.parametrize("path", COMMANDS, ids=" ".join)
def test_subcommands_carry_the_jax_option_names(path):
    command = jax_cli
    for word in path:
        command = command.commands[word]
    jax_options = {s for p in command.params if isinstance(p, click.Option)
                   for s in p.opts}
    assert jax_options and jax_options <= _port_options(path)
    assert "--device" in _port_options(path)


def test_device_defaults_to_cuda(tmp_path):
    args = build_parser().parse_args(["denoise", "--config", "c.yml",
                                      "--input_list", "i.txt"])
    assert args.device == "cuda" and args.max_steps is None
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    manifest = make_image_dataset(tmp_path, n=2, size=32)
    cfg = _yaml(tmp_path / "d.yml", dict(
        SMALL, log_dir=str(tmp_path / "runs"),
        checkpoint_dir=str(tmp_path / "ckpt")))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["denoise", "--config", cfg, "--input_list", str(manifest)])
