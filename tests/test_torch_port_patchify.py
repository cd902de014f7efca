"""The patchified U-Net (``patchify_stem: p``) in the port against the JAX
package's, on the CPU.

* ``space_to_depth`` / ``depth_to_space``: JAX's NHWC channel order
  ``(py * p + px) * C + c``, bit for bit (not ``F.pixel_unshuffle``'s).
* A resnet18 ``PatchifiedUnet`` from the same weights (flax ``unet/...``
  carried to the port's ``unet.<smp key>`` by ``utils/jax_weights.py``):
  the forward in train and eval mode at 128^2, 2e-4 of the output's
  largest magnitude, the BN statistics 1e-5 relative.
* A ``patchify_stem: 2`` denoiser step against JAX's composed step, with
  ``test_torch_port_efficientnet.py``'s composition and tolerances (the
  U-Net in float64 on both sides: at 64^2 the inner U-Net's deepest level
  is 1x1, its BNs normalise two values).
* The config's divisibility check is JAX's; export of a patchified
  checkpoint is refused; ``load_swap_model`` builds the patchified model
  from its checkpoint.

64^2 (the forward 128^2), batch 2, torch on one thread.
"""

import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from denoising_diffusion_deep_fake_tpu import config as jax_config
from denoising_diffusion_deep_fake_tpu.models import create_unet as jax_unet
from denoising_diffusion_deep_fake_tpu.models import unet as jax_unet_mod
from denoising_diffusion_deep_fake_tpu_torch import config as port_config
from denoising_diffusion_deep_fake_tpu_torch.checkpoint import (
    CheckpointManager,
)
from denoising_diffusion_deep_fake_tpu_torch.inference import (
    load_swap_model,
    make_device_pipeline,
)
from denoising_diffusion_deep_fake_tpu_torch.models.unet import (
    PatchifiedUnet,
    create_unet,
    depth_to_space,
    space_to_depth,
    unet_shapes,
)
from denoising_diffusion_deep_fake_tpu_torch.training.deep_fake import (
    DeepFakeTrainer,
)
from denoising_diffusion_deep_fake_tpu_torch.utils.jax_weights import (
    state_dict_from_jax,
    state_dict_from_jax_any,
)
from denoising_diffusion_deep_fake_tpu_torch.utils.torch_export import (
    export_reference_checkpoint,
)

from test_torch_port_efficientnet import check_composed_steps, composed_steps
from test_torch_port_model import random_flax_variables

ENCODER, B, S, P = "resnet18", 2, 64, 2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tmp_path(tmp_path):
    """pytest's, emptied after the test: the checkpoints written here
    would stay on disk until pytest drops the run's directory."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _close(got, want, rel, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=rel * np.abs(want).max(), err_msg=what)


@pytest.mark.parametrize("p", [2, 4])
def test_space_to_depth_is_jax_bit_for_bit(p):
    x = np.random.default_rng(0).standard_normal((2, 8, 16, 3)).astype(
        np.float32)
    got = space_to_depth(torch.from_numpy(x), p)
    want = np.asarray(jax_unet_mod.space_to_depth(jnp.asarray(x), p))
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(
        depth_to_space(got, p).numpy(),
        np.asarray(jax_unet_mod.depth_to_space(jnp.asarray(want), p)))
    assert torch.equal(depth_to_space(got, p), torch.from_numpy(x))
    # Channel (py * p + px) * C + c holds pixel (py, px) of the block.
    assert np.array_equal(got.numpy()[0, 0, 0, (1 * p + 0) * 3 + 2],
                          x[0, 1, 0, 2])


def test_patchified_unet_matches_jax():
    # 128^2: the inner U-Net at 64^2, as test_torch_port_model.py holds
    # resnet18's (at 32^2 its train-mode BNs at 1x1 normalise two values).
    size = 2 * S
    flax_model = jax_unet(ENCODER, patchify=P)
    variables = random_flax_variables(flax_model, size, seed=0)
    port = create_unet(ENCODER, patchify=P)
    assert isinstance(port, PatchifiedUnet) and port.patch == P
    sd = state_dict_from_jax(variables["params"], variables["batch_stats"],
                             ENCODER, P)
    assert set(sd) == set(unet_shapes(ENCODER, P))
    assert all(k.startswith("unet.") for k in sd)
    assert sd["unet.encoder.conv1.weight"].shape[1] == 3 * P * P
    assert sd["unet.segmentation_head.0.weight"].shape[0] == 3 * P * P
    # The probe inversion carries the same weights as the handwritten map.
    for key, value in state_dict_from_jax_any(
            variables["params"], variables["batch_stats"], ENCODER,
            P).items():
        assert torch.equal(value, sd[key])
    port.load_state_dict(sd)
    x = np.random.default_rng(1).standard_normal(
        (B, size, size, 3)).astype(np.float32)
    want = jax.jit(lambda v, x: flax_model.apply(v, x, train=False))(
        variables, x)
    port.eval()
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (B, size, size, 3)
    _close(got, want, 2e-4, "eval")
    want, mutated = jax.jit(lambda v, x: flax_model.apply(
        v, x, train=True, mutable=["batch_stats"]))(variables, x)
    port.train()
    with torch.no_grad():
        _close(port(torch.from_numpy(x)), want, 2e-4, "train")
    stats = state_dict_from_jax({}, mutated["batch_stats"], ENCODER, P)
    port_sd = port.state_dict()
    assert stats
    for key, value in stats.items():
        np.testing.assert_allclose(port_sd[key].numpy(), value.numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=key)
    with pytest.raises(ValueError, match="divisible by 64"):
        port(torch.zeros((B, 96, 96, 3)))


def test_patchified_denoiser_step_matches_jax():
    check_composed_steps(composed_steps(ENCODER, patchify=P), ENCODER, P)


def test_config_divisibility_is_jax_check():
    for size, ok in ((64, True), (128, True), (96, False), (None, True)):
        kwargs = dict(input_image_list_path="x", patchify_stem=P,
                      image_size=size)
        if ok:
            port_config.config_from_dict(port_config.DenoiserConfig, kwargs)
            if size is not None:
                jax_config.config_from_dict(jax_config.DenoiserConfig,
                                            kwargs)
            continue
        match = "patchify_stem=2 needs image_size divisible by 64"
        with pytest.raises(ValueError, match=match):
            port_config.config_from_dict(port_config.DenoiserConfig, kwargs)
        with pytest.raises(ValueError, match=match):
            jax_config.config_from_dict(jax_config.DenoiserConfig, kwargs)


@pytest.fixture(scope="module")
def patchified_ckpt(tmp_path_factory):
    """A deep-fake checkpoint of a patchified resnet18 pair."""
    cfg = port_config.config_from_dict(port_config.DeepFakeConfig, dict(
        data_path_a="a", data_path_b="b", batch_size=B,
        encoder_name=ENCODER, compute_dtype="float32", patchify_stem=P,
        image_size=S))
    trainer = DeepFakeTrainer(cfg, steps_per_epoch=1, image_size=S,
                              device="cpu")
    states = trainer.init_states(seed=0)
    root = tmp_path_factory.mktemp("patchified")
    CheckpointManager(root / "ckpt").save(1, states,
                                          port_config.config_to_dict(cfg))
    yield root / "ckpt", states
    shutil.rmtree(root, ignore_errors=True)


def test_export_of_a_patchified_checkpoint_is_refused(patchified_ckpt,
                                                      tmp_path):
    path, _ = patchified_ckpt
    with pytest.raises(ValueError, match="patchify_stem > 1"):
        export_reference_checkpoint(path, tmp_path / "x.ckpt")


def test_load_swap_model_builds_the_patchified_model(patchified_ckpt):
    path, states = patchified_ckpt
    swap = load_swap_model(path, "a", device="cpu")
    assert isinstance(swap.model, PatchifiedUnet) and swap.model.patch == P
    want = states["a"].model.state_dict()
    got = swap.model.state_dict()
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)
    frames = torch.from_numpy(np.random.default_rng(2).integers(
        0, 256, (B, S, S, 3), np.uint8))
    out = make_device_pipeline(swap)(frames, 0)
    assert out.dtype == torch.uint8 and out.shape == frames.shape
