"""Reference checkpoints into the port and back, against the JAX package.

A reference Lightning ``.ckpt`` is built here in the reference's documented
layout (``tests/test_lightning_import.py``): ``torch.save`` of
``{"state_dict", "hyper_parameters", "epoch", "global_step", ...}`` with
smp keys (from the JAX package's torch replica, ``smp_named_state_dict``)
under ``model_a.`` / ``model_b.`` / ``ema_model_{a,b}.ema_model.``, the EMA's
``initted`` / ``step`` buffers, an EMA subkey the importer must drop,
``criterion.*`` and Lightning's other top-level keys. Every model and
shadow has its own weights, BN statistics and ``num_batches_tracked``.
resnet18 in swap mode (with shadows), resnet50 in denoise mode.

* Import: every tensor bit-equal to JAX ``load_reference_checkpoint``
  carried into the port by ``state_dict_from_jax``; ``read_meta()`` equal to
  JAX's after JAX's own (orbax) import of the same file (resnet18 only).
* Export: bit-equal, key for key, to JAX ``export_unet_state_dict`` of the
  same weights (``num_batches_tracked`` included), with the reference's
  top-level keys and EMA buffers; ``import(export(x)) == x``.
* Refusals, a CPU resume from the import, a swap model from it, the CLI.
"""

import shutil

import numpy as np
import pytest
import torch

from denoising_diffusion_deep_fake_tpu.main import cli as jax_cli
from denoising_diffusion_deep_fake_tpu.utils import torch_export as jax_export
from denoising_diffusion_deep_fake_tpu.utils import torch_import as jax_import
from denoising_diffusion_deep_fake_tpu.utils.torch_replica import (
    UnetSMP,
    smp_named_state_dict,
)
from denoising_diffusion_deep_fake_tpu_torch.checkpoint import (
    CheckpointManager,
)
from denoising_diffusion_deep_fake_tpu_torch.config import (
    DeepFakeConfig,
    config_from_dict,
)
from denoising_diffusion_deep_fake_tpu_torch.inference import (
    load_swap_model,
    make_device_pipeline,
)
from denoising_diffusion_deep_fake_tpu_torch.main import build_parser, main
from denoising_diffusion_deep_fake_tpu_torch.models.unet import create_unet
from denoising_diffusion_deep_fake_tpu_torch.training.runners import (
    fit_deep_fake,
)
from denoising_diffusion_deep_fake_tpu_torch.training.state import (
    create_model_state,
)
from denoising_diffusion_deep_fake_tpu_torch.utils.jax_weights import (
    state_dict_from_jax,
)
from denoising_diffusion_deep_fake_tpu_torch.utils.torch_export import (
    export_reference_checkpoint,
)
from denoising_diffusion_deep_fake_tpu_torch.utils.torch_import import (
    import_reference_checkpoint,
    state_dict_from_smp,
)

from helpers import make_image_dataset

EPOCH, GLOBAL_STEP = 12, 3456
# encoder: the .ckpt has EMA shadows (swap mode)
CASES = {"resnet18": True, "resnet50": False}
# Each model's and shadow's weights: the replica's, scaled apart.
SCALES = {"model_a": 1.0, "model_b": 0.5, "ema_model_a": 0.9,
          "ema_model_b": 0.45}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tmp_path(tmp_path):
    """pytest's, emptied after the test: the checkpoints here weigh 100-500
    MB each."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _smp_base(encoder):
    """The replica's smp state_dict with random BN parameters, statistics
    and ``num_batches_tracked``."""
    torch.manual_seed(0)
    with torch.no_grad():
        base = smp_named_state_dict(UnetSMP(encoder))
    rng = np.random.default_rng(1)
    for key, value in base.items():
        if key.endswith("num_batches_tracked"):
            base[key] = np.asarray(rng.integers(1, 1000), np.int64)
        elif value.ndim == 1 and not key.startswith("segmentation_head"):
            spread = key.endswith(("weight", "running_var"))
            base[key] = ((1.0 if spread else 0.0) + rng.uniform(
                -0.5, 0.5, value.shape) * (1.0 if spread else 0.2)).astype(
                np.float32)
    return base


def write_reference_ckpt(path, encoder, *, with_ema, data=("a", "b"),
                         extra_keys=None):
    """A reference Lightning ``.ckpt`` at ``path``; returns its
    state_dict."""
    base = _smp_base(encoder)
    sd = {}
    for model in ("model_a", "model_b"):
        prefixes = [(model, f"{model}.")]
        if with_ema:
            prefixes.append((f"ema_{model}", f"ema_{model}.ema_model."))
        for name, prefix in prefixes:
            for key, value in base.items():
                scaled = (value if value.dtype == np.int64
                          else value * np.float32(SCALES[name]))
                sd[prefix + key] = torch.from_numpy(np.array(scaled))
        if with_ema:
            sd[f"ema_{model}.initted"] = torch.tensor(True)
            sd[f"ema_{model}.step"] = torch.tensor(10)
    if with_ema:
        # Another EMA subkey (an online copy in some ema_pytorch versions).
        sd["ema_model_a.online_model.segmentation_head.0.bias"] = \
            torch.zeros(3)
    sd["criterion.ssim.kernel"] = torch.zeros(1, 11)
    sd.update(extra_keys or {})
    hparams = {
        "mode": "swap" if with_ema else "denoise",
        "data_path_a": str(data[0]), "data_path_b": str(data[1]),
        "mean_a": [0.5, 0.5, 0.5], "std_a": [0.5, 0.5, 0.5],
        "mean_b": [0.4, 0.4, 0.4], "std_b": [0.6, 0.6, 0.6],
        "learning_rate": 0.02, "batch_size": 2,
        "noise_exponential_sampling_lambda": 8, "ema_beta": 0.9999,
        "encoder_name": encoder, "max_epochs": 300,
    }
    torch.save({"state_dict": sd, "hyper_parameters": hparams,
                "epoch": EPOCH, "global_step": GLOBAL_STEP,
                "pytorch-lightning_version": "1.9.0",
                "optimizer_states": [{}], "lr_schedulers": [{}],
                "callbacks": {}, "loops": {}}, path)
    return sd


@pytest.fixture(scope="module")
def references(tmp_path_factory):
    """``references(encoder)``: (the .ckpt, its state_dict, the port's
    import of it), made once a module."""
    made = {}

    def get(encoder):
        if encoder not in made:
            root = tmp_path_factory.mktemp(encoder)
            data = [make_image_dataset(root / n, n=2, size=64, seed=i)
                    for i, n in enumerate("ab")]
            ckpt = root / "last.ckpt"
            sd = write_reference_ckpt(ckpt, encoder,
                                      with_ema=CASES[encoder], data=data)
            made[encoder] = (ckpt, sd, import_reference_checkpoint(
                ckpt, root / "imported").parent)
        return made[encoder]

    yield get
    for ckpt, _, _ in made.values():
        shutil.rmtree(ckpt.parent, ignore_errors=True)


@pytest.fixture(params=sorted(CASES))
def reference(request, references):
    return (request.param,) + references(request.param)


def _parts(ckpt_dir, ident, with_ema):
    parts = ["model", "counters", "optimizer"] + (
        ["ema_model"] if with_ema else [])
    return CheckpointManager(ckpt_dir).restore_partial(ident, parts,
                                                       device="cpu")


def _equal(got: dict, want: dict, what: str):
    assert got.keys() == want.keys(), what
    for key in want:
        assert got[key].dtype == want[key].dtype, f"{what} {key}"
        assert torch.equal(got[key], want[key]), f"{what} {key}"


def test_import_is_jax_import_bit_for_bit(reference):
    encoder, ckpt, _, imported = reference
    want = jax_import.load_reference_checkpoint(ckpt)
    with_ema = CASES[encoder]
    assert sorted(k for k in want if k.startswith(("model", "ema"))) == \
        sorted(["model_a", "model_b"]
               + (["ema_model_a", "ema_model_b"] if with_ema else []))
    cfg = config_from_dict(DeepFakeConfig, want["hyper_parameters"],
                           validate=False)
    for ident in "ab":
        parts = _parts(imported, ident, with_ema)
        names = ["model"] + (["ema_model"] if with_ema else [])
        for name in names:
            jax_sd = state_dict_from_jax(*want[f"{name}_{ident}"])
            _equal(parts[name], jax_sd, f"{name}_{ident}")
        assert parts["counters"] == {"step": 0, "ema_step": 0}
        # A fresh Adam from the config.
        assert parts["optimizer"]["state"] == {}
        group, = parts["optimizer"]["param_groups"]
        assert (group["lr"], group["betas"]) == (
            cfg.learning_rate, (cfg.adam_b1, cfg.adam_b2))
    meta = CheckpointManager(imported).read_meta()
    assert meta["step"] == GLOBAL_STEP
    assert meta["hparams"]["mode"] == ("swap" if with_ema else "denoise")
    assert meta["extra"] == {"epoch": EPOCH, "global_step": GLOBAL_STEP,
                             "workload": "deep_fake",
                             "imported_from": str(ckpt)}


def test_read_meta_is_jax_read_meta(references, tmp_path):
    """The one test that runs JAX's (orbax) import."""
    from denoising_diffusion_deep_fake_tpu.checkpoint import (
        CheckpointManager as JaxCheckpointManager)

    ckpt, _, imported = references("resnet18")
    jax_import.import_reference_checkpoint(ckpt, tmp_path / "jax")
    want = JaxCheckpointManager(tmp_path / "jax").read_meta()
    assert CheckpointManager(imported).read_meta() == want


def test_export_is_jax_export_bit_for_bit(reference, tmp_path):
    encoder, ckpt, sd, imported = reference
    with_ema = CASES[encoder]
    out = tmp_path / "exported.ckpt"
    info = export_reference_checkpoint(imported, out)
    exported = torch.load(out, weights_only=False)
    assert set(exported) == {"state_dict", "hyper_parameters", "epoch",
                             "global_step", "pytorch-lightning_version"}
    assert (exported["epoch"], exported["global_step"]) == (EPOCH,
                                                            GLOBAL_STEP)
    assert exported["pytorch-lightning_version"] == "1.8.0"
    assert exported["hyper_parameters"] == \
        CheckpointManager(imported).read_meta()["hparams"]
    got = exported["state_dict"]
    assert info == {"keys": len(got), "global_step": GLOBAL_STEP,
                    "identities": ["a", "b"]}
    # The reference's keys, less criterion.* and the dropped EMA subkey.
    assert set(got) == {k for k in sd if not k.startswith("criterion.")
                        and ".online_model." not in k}
    names = ["model"] + (["ema_model"] if with_ema else [])
    for ident in "ab":
        for name in names:
            prefix = (f"model_{ident}." if name == "model"
                      else f"ema_model_{ident}.ema_model.")
            model_sd = {k[len(prefix):]: v.numpy() for k, v in sd.items()
                        if k.startswith(prefix)}
            want = jax_export.export_unet_state_dict(
                *jax_import.convert_smp_unet_state_dict(model_sd), encoder)
            _equal({k[len(prefix):]: v for k, v in got.items()
                    if k.startswith(prefix)},
                   {k: torch.from_numpy(np.array(v)) for k, v in want.items()},
                   f"{name}_{ident}")
        if with_ema:
            assert got[f"ema_model_{ident}.initted"].item() is True
            assert got[f"ema_model_{ident}.step"].dtype == torch.int64
            assert got[f"ema_model_{ident}.step"].item() == 0


def test_import_of_export_is_bit_equal(reference, tmp_path):
    encoder, _, _, imported = reference
    with_ema = CASES[encoder]
    export_reference_checkpoint(imported, tmp_path / "x.ckpt")
    again = import_reference_checkpoint(tmp_path / "x.ckpt",
                                        tmp_path / "again").parent
    for ident in "ab":
        got, want = (_parts(d, ident, with_ema) for d in (again, imported))
        for name in ["model"] + (["ema_model"] if with_ema else []):
            _equal(got[name], want[name], f"{name}_{ident}")
        assert got["counters"] == want["counters"]
        assert got["optimizer"] == want["optimizer"]
    got, want = (CheckpointManager(d).read_meta() for d in (again, imported))
    assert got["hparams"] == want["hparams"]
    assert got["step"] == want["step"] == GLOBAL_STEP
    assert {k: v for k, v in got["extra"].items() if k != "imported_from"} \
        == {k: v for k, v in want["extra"].items() if k != "imported_from"}


@pytest.mark.parametrize("case", ["another family", "unmapped key",
                                  "missing identity"])
def test_import_refusals(tmp_path, case):
    ckpt = tmp_path / "last.ckpt"
    sd = write_reference_ckpt(ckpt, "resnet18", with_ema=False,
                              extra_keys={"model_a.encoder.bogus.weight":
                                          torch.zeros(1)}
                              if case == "unmapped key" else None)
    ref = torch.load(ckpt, weights_only=False)
    if case == "another family":
        # A resnet18 file that names EfficientNet: the port builds the
        # family, so its keys are what the importer refuses.
        ref["hyper_parameters"]["encoder_name"] = "efficientnet-b0"
        error, match = ValueError, r"unmapped torch keys: \['encoder.bn1"
    elif case == "unmapped key":
        error, match = ValueError, r"unmapped torch keys: \['encoder.bogus"
    else:
        ref["state_dict"] = {k: v for k, v in sd.items()
                             if not k.startswith("model_b.")}
        error, match = ValueError, "model_b"
    torch.save(ref, ckpt)
    with pytest.raises(error, match=match):
        import_reference_checkpoint(ckpt, tmp_path / "out")


@pytest.mark.parametrize("case", ["single state", "patchify", "vgg"])
def test_export_refusals(tmp_path, case):
    cfg = config_from_dict(DeepFakeConfig, dict(
        encoder_name="resnet18", data_path_a="a", data_path_b="b"))
    manager = CheckpointManager(tmp_path / "ckpt")
    state = create_model_state(cfg, torch.float32, torch.device("cpu"),
                               seed=0)
    states = state if case == "single state" else {"a": state, "b": state}
    # "vgg": resnet18 states whose hparams name another family, now
    # EfficientNet, which the port builds: the states are not its U-Net.
    hparams = dict(encoder_name="efficientnet-b0" if case == "vgg"
                   else "resnet18",
                   patchify_stem=2 if case == "patchify" else 1)
    manager.save(3, states, hparams)
    error, match = {"single state": (ValueError, "two-identity"),
                    "patchify": (ValueError, "patchify_stem"),
                    "vgg": (ValueError,
                            "not a efficientnet-b0 U-Net state_dict")}[case]
    with pytest.raises(error, match=match):
        export_reference_checkpoint(tmp_path / "ckpt", tmp_path / "x.ckpt")


def test_resume_from_the_import_on_the_cpu(references, tmp_path):
    """``train resume`` from an imported swap-mode checkpoint: one step at
    64^2 from epoch ``EPOCH + 1`` and ``GLOBAL_STEP``, with a fresh Adam
    and the imported shadows; its export carries the shadows' step."""
    _, _, imported = references("resnet18")
    meta = CheckpointManager(imported).read_meta()
    cfg = config_from_dict(DeepFakeConfig, dict(
        meta["hparams"], compute_dtype="float32", log_images=False,
        log_dir=str(tmp_path / "runs"),
        checkpoint_dir=str(tmp_path / "ckpt")))
    shadow = _parts(imported, "a", True)["ema_model"]
    starts = []
    states, _, ctx = fit_deep_fake(
        cfg, resume_from=str(imported), max_steps=GLOBAL_STEP + 1,
        verbose=False, device="cpu",
        step_callback=lambda step, *_: starts.append(step))
    assert starts == [GLOBAL_STEP + 1] and ctx.epoch == EPOCH + 1
    assert ctx.global_step == GLOBAL_STEP + 1
    for state in states.values():
        assert state.step == 1 and state.has_ema and state.ema_step == 1
        steps = [s["step"] for s in state.optimizer.state_dict()[
            "state"].values()]
        assert steps and all(float(s) == 1.0 for s in steps)
    # ema_step 1 lies inside the EMA warm-up: the update copied the model.
    assert not all(torch.equal(v, shadow[k]) for k, v in
                   states["a"].ema_model.state_dict().items())
    export_reference_checkpoint(tmp_path / "ckpt", tmp_path / "x.ckpt")
    got = torch.load(tmp_path / "x.ckpt", weights_only=False)
    assert (got["global_step"], got["epoch"]) == (GLOBAL_STEP + 1, EPOCH + 1)
    assert got["state_dict"]["ema_model_a.step"].item() == 1


def test_swap_model_from_the_import(reference):
    """``load_swap_model`` of the import's shadow answers a batch as a port
    model holding the ``.ckpt``'s shadow weights does."""
    encoder, _, sd, imported = reference
    with_ema = CASES[encoder]
    name = "ema_model_a.ema_model." if with_ema else "model_a."
    swap = load_swap_model(imported, "a", use_ema=with_ema, device="cpu")
    assert swap.mean == (0.4, 0.4, 0.4) and swap.std == (0.6, 0.6, 0.6)
    straight = create_unet(encoder, dtype=torch.bfloat16)
    straight.load_state_dict(state_dict_from_smp(
        {k[len(name):]: v for k, v in sd.items() if k.startswith(name)},
        encoder))
    frames = torch.from_numpy(np.random.default_rng(2).integers(
        0, 256, (2, 32, 32, 3), np.uint8))
    got = make_device_pipeline(swap)(frames, 0)
    swap.model = straight.eval()
    want = make_device_pipeline(swap)(frames, 0)
    assert got.dtype == torch.uint8 and torch.equal(got, want)


def test_cli_import_and_export(tmp_path, capsys):
    ckpt = tmp_path / "last.ckpt"
    write_reference_ckpt(ckpt, "resnet18", with_ema=True)
    assert main(["import", str(ckpt), str(tmp_path / "imported")]) == 0
    folder = tmp_path / "imported" / f"step_{GLOBAL_STEP:010d}"
    assert capsys.readouterr().out == f"imported -> {folder}\n"
    out = tmp_path / "x.ckpt"
    assert main(["export", str(tmp_path / "imported"), str(out),
                 "--step", str(GLOBAL_STEP)]) == 0
    n_keys = len(torch.load(out, weights_only=False)["state_dict"])
    assert capsys.readouterr().out == (
        f"exported {n_keys} tensors (identities a,b, step {GLOBAL_STEP}) "
        f"-> {out}\n")
    # JAX's arguments and options, and no --device: a file conversion.
    for word, params in (("import", ["ckpt_path", "output_dir"]),
                         ("export", ["checkpoint_dir", "output_path",
                                     "step"])):
        command = jax_cli.commands[word]
        assert [p.name for p in command.params] == params
        args = build_parser().parse_args(
            [word, "x", "y"] + (["--step", "4"] if word == "export" else []))
        assert not hasattr(args, "device")
        assert [getattr(args, p) for p in params] == (
            ["x", "y"] + ([4] if word == "export" else []))
