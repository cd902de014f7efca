"""The port's serving slice against the JAX package, on the CPU.

* ``ops/image.py``: every function against JAX's on the same numpy
  inputs, bit-equal. ``denormalise_to_uint8_rgb`` is held bit-equal on
  values that straddle integers (by 1e-3 and more), negatives and values
  above 255. Product and sum round apart in the port (as PyTorch computes
  them, and as the reference did); XLA on the CPU contracts them into one
  multiply-add, so a value within an ulp of an integer may truncate to the
  neighbouring integer: on random floats that share is stated and held
  below 1e-4, each such pixel one LSB off.
* ``ops/sampler.py``: the schedule bit-equal; ``ddim_sample`` with a toy
  predictor within 1e-6; ``swap_refine`` through the U-Net from the noise
  JAX draws from its key, within 1e-4 of the output's largest magnitude
  (XLA and PyTorch sum convolutions in other orders).
* ``inference.py``: the uint8 pipeline, single-pass, built by each
  framework's ``load_swap_model`` from a checkpoint of the same weights
  (both identities with their own statistics, online model and shadow):
  within 1 LSB, with the share of differing pixels stated.
* ``checkpoint.py``: the round trip, retention, the partial read.
* the deep-fake step's panels: JAX's tags and shapes (``jax.eval_shape`` of
  its step, with a one-layer model in place of the U-Net), each panel
  bit-equal to ``panel_grid_u8`` of the tensor it shows.
* ``serving/``: the JAX package's ``tests/test_serving.py`` cases that
  need neither i420 nor several devices, against the port's engine and
  server on the CPU, plus the refusals of both.

64^2 (32^2 for the engine and server), batch 2-4, resnet18, fp32.
"""

import dataclasses
import functools
import http.client
import json
import shutil
import socket
import threading
import time

import numpy as np
import pytest
import torch

import flax.linen as flax_nn
import jax
import jax.numpy as jnp

from denoising_diffusion_deep_fake_tpu import config as jax_config
from denoising_diffusion_deep_fake_tpu import inference as jax_inference
from denoising_diffusion_deep_fake_tpu.checkpoint import (
    CheckpointManager as JaxCheckpointManager,
)
from denoising_diffusion_deep_fake_tpu.ops import image as jax_image
from denoising_diffusion_deep_fake_tpu.ops import sampler as jax_sampler
from denoising_diffusion_deep_fake_tpu.training.deep_fake import (
    DeepFakeTrainer as JaxDeepFakeTrainer,
)
from denoising_diffusion_deep_fake_tpu.training.state import (
    ModelState as JaxModelState,
)
from denoising_diffusion_deep_fake_tpu_torch import config as port_config
from denoising_diffusion_deep_fake_tpu_torch import inference
from denoising_diffusion_deep_fake_tpu_torch.checkpoint import (
    CheckpointManager,
)
from denoising_diffusion_deep_fake_tpu_torch.models.unet import create_unet
from denoising_diffusion_deep_fake_tpu_torch.ops import image
from denoising_diffusion_deep_fake_tpu_torch.ops import sampler
from denoising_diffusion_deep_fake_tpu_torch.serving import (
    EngineOverloadedError,
    RequestExpiredError,
    SwapEngine,
)
from denoising_diffusion_deep_fake_tpu_torch.serving.server import (
    SwapServer,
    run_server,
)
from denoising_diffusion_deep_fake_tpu_torch.training.deep_fake import (
    DeepFakeTrainer,
)
from denoising_diffusion_deep_fake_tpu_torch.utils.jax_weights import (
    load_jax_state,
    state_dict_from_jax,
)

from test_torch_port_model import random_flax_variables

ENCODER, S, B = "resnet18", 64, 3
STATS = {"a": ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225)),
         "b": ((0.5, 0.45, 0.55), (0.3, 0.25, 0.2))}
WEIGHT_SEEDS = {"a": 10, "b": 11}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one thread: the test run's workers share the cores, and
    torch's own pool on each of them oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tmp_path(tmp_path):
    """pytest's, emptied after the test: the swap checkpoints written
    here weigh ~110-220 MB each."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _cfg_dict(mode, size=S, **extra):
    return dict(dict(mode=mode, data_path_a="a.txt", data_path_b="b.txt",
                     batch_size=B, encoder_name=ENCODER,
                     compute_dtype="float32", image_size=size,
                     mean_a=STATS["a"][0], std_a=STATS["a"][1],
                     mean_b=STATS["b"][0], std_b=STATS["b"][1]), **extra)


def _u8(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


# ---------------------------------------------------------------- ops/image


@pytest.mark.parametrize("shape", [(S, S, 3), (B, S, S, 3)])
@pytest.mark.parametrize("ident", ["a", "b"])
def test_normalise_uint8_rgb_bit_equal(shape, ident):
    x = _u8(shape, 0)
    mean, std = STATS[ident]
    want = np.asarray(jax_image.normalise_uint8_rgb(jnp.asarray(x), mean,
                                                    std))
    got = image.normalise_uint8_rgb(torch.from_numpy(x), mean, std).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ident", ["a", "b"])
def test_denormalise_to_uint8_rgb_bit_equal(ident):
    mean, std = STATS[ident]
    m255 = np.float32(mean) * np.float32(255)
    s255 = np.float32(std) * np.float32(255)
    # Pixel values k + d straddling every integer k from -4 to 259
    # (negatives and > 255 clamp), then mapped back to normalised floats.
    k = np.arange(-4, 260, dtype=np.float32)
    d = np.asarray([-0.5, -0.01, -1e-3, 1e-3, 0.01, 0.5, 0.999],
                   np.float32)
    pixels = (k[:, None] + d[None, :]).reshape(-1, 1)
    t = ((pixels - m255) / s255).astype(np.float32).reshape(-1, 1, 1, 3)
    want = np.asarray(jax_image.denormalise_to_uint8_rgb(jnp.asarray(t),
                                                         mean, std))
    got = image.denormalise_to_uint8_rgb(torch.from_numpy(t), mean,
                                         std).numpy()
    assert got.min() == 0 and got.max() == 255
    np.testing.assert_array_equal(got, want)

    # Random floats: the port rounds product and sum apart, XLA contracts
    # them (module notes); a flip needs a value within an ulp of an integer.
    r = np.random.default_rng(1).uniform(-3, 3, (4, 64, 64, 3)).astype(
        np.float32)
    want = np.asarray(jax_image.denormalise_to_uint8_rgb(jnp.asarray(r),
                                                         mean, std))
    got = image.denormalise_to_uint8_rgb(torch.from_numpy(r), mean,
                                         std).numpy()
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    share = float((diff > 0).mean())
    print(f"denormalise, random floats: differing share {share:.2e}")
    assert diff.max() <= 1 and share < 1e-4
    separate = np.clip(np.trunc(r * s255 + m255), 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(got, separate)


@pytest.mark.parametrize("n", [2, 9, 11])
def test_grids_bit_equal(n):
    x = np.random.default_rng(n).uniform(-1.5, 1.5, (n, 16, 24, 3)).astype(
        np.float32)
    xt = torch.from_numpy(x)
    np.testing.assert_array_equal(
        image.make_grid(xt, nrow=3, pad_value=0.25).numpy(),
        np.asarray(jax_image.make_grid(jnp.asarray(x), nrow=3,
                                       pad_value=0.25)))
    np.testing.assert_array_equal(
        image.grid_to_display(xt).numpy(),
        np.asarray(jax_image.grid_to_display(jnp.asarray(x))))
    got = image.panel_grid_u8(xt).numpy()
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(
        got, np.asarray(jax_image.panel_grid_u8(jnp.asarray(x))))


@pytest.mark.parametrize("hw", [(480, 640), (640, 480), (300, 300),
                                (101, 333)])
@pytest.mark.parametrize("aspect", [(1, 1), (16, 9), (3, 4)])
def test_center_crop_matches(hw, aspect):
    assert image.center_crop_box(*hw, *aspect) == jax_image.center_crop_box(
        *hw, *aspect)
    frame = _u8(hw + (3,), 2)
    np.testing.assert_array_equal(image.center_crop(frame, *aspect),
                                  jax_image.center_crop(frame, *aspect))


def test_prepare_frame_matches():
    pytest.importorskip("cv2")
    for hw in ((100, 180), (90, 40), (64, 64)):
        frame = _u8(hw + (3,), 3)
        want = jax_inference.prepare_frame(frame, 48, 32)
        got = inference.prepare_frame(frame, 48, 32)
        assert got.shape == (32, 48, 3) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------- ops/sampler


@pytest.mark.parametrize("steps", [1, 3, 10, 50, 199, 1000])
@pytest.mark.parametrize("r_start", [0.7, 0.999])
def test_ddim_ratio_schedule_bit_equal(steps, r_start):
    """Bit-equal up to 199 steps. From about 500, XLA's vectorised CPU loop
    contracts ``1 - i * (1 / steps)`` into a multiply-add, and knots may
    then differ by an ulp of 1 before the product with ``r_start``; the
    port rounds ``i * (1 / steps)`` first."""
    got = sampler.ddim_ratio_schedule(steps, r_start=r_start).numpy()
    want = np.asarray(jax_sampler.ddim_ratio_schedule(steps,
                                                      r_start=r_start))
    if steps < 200:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=np.spacing(np.float32(1)))


@pytest.mark.parametrize("clip", [(-1.0, 1.0), None])
def test_ddim_sample_toy_predictor(clip):
    x = np.random.default_rng(4).standard_normal((2, 8, 8, 3)).astype(
        np.float32)
    ratios = np.array(jax_sampler.ddim_ratio_schedule(7, r_start=0.8))

    def toy(z, tanh, sin):
        return 0.8 * tanh(1.3 * z) + 0.1 * sin(z)

    want = jax_sampler.ddim_sample(lambda z: toy(z, jnp.tanh, jnp.sin),
                                   jnp.asarray(x), jnp.asarray(ratios),
                                   clip=clip)
    got = sampler.ddim_sample(lambda z: toy(z, torch.tanh, torch.sin),
                              torch.from_numpy(x), torch.from_numpy(ratios),
                              clip=clip)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.fixture(scope="module")
def unet_pair(weights):
    """A JAX and a port resnet18 U-Net with the same weights, and their
    eval-mode forwards."""
    cfg = jax_config.config_from_dict(jax_config.DeepFakeConfig,
                                      _cfg_dict("swap"))
    trainer = JaxDeepFakeTrainer(cfg, steps_per_epoch=1, image_size=S)
    v = weights["a"]
    state = JaxModelState(step=jnp.int32(0), params=v["params"],
                          batch_stats=v["batch_stats"], opt_state=None)
    jax_predict = trainer.make_predict_fake()
    port = create_unet(ENCODER)
    port.load_state_dict(state_dict_from_jax(v["params"], v["batch_stats"]))
    port.eval()
    return (lambda z: jax_predict(state, z)), port


def _variables(model, seed):
    v = random_flax_variables(model, S, seed=seed)
    # Fakes inside the pixel range, so few clamp to 0 or 255.
    head = v["params"]["segmentation_head"]
    head["kernel"] = head["kernel"] * 0.02
    return v


def test_swap_refine_through_the_unet(unet_pair):
    jax_predict, port = unet_pair
    real = np.random.default_rng(5).uniform(-1, 1, (2, S, S, 3)).astype(
        np.float32)
    key = jax.random.PRNGKey(3)
    noise = np.array(jax.random.normal(key, real.shape, jnp.float32))
    clip = (-1.2, 1.4)
    want = np.asarray(jax_sampler.swap_refine(
        jax_predict, jnp.asarray(real), key, steps=3, clip=clip))
    with torch.inference_mode():
        got = sampler.swap_refine(port, torch.from_numpy(real), steps=3,
                                  clip=clip, seed=0, offset=0,
                                  noise=torch.from_numpy(noise)).numpy()
    err = np.abs(got - want).max() / np.abs(want).max()
    print(f"swap_refine 3 steps: max error {err:.2e} of max |x0|")
    assert err < 1e-4


def test_swap_refine_draws_from_the_noise_kernel_stream():
    """Without ``noise`` the initial blend is the noise kernel's (plain
    version here) at ``r_start``, keyed by seed and offset."""
    from denoising_diffusion_deep_fake_tpu_torch.ops.cuda.noise_kernel import (
        fused_noise_blend_plain)

    real = torch.from_numpy(np.random.default_rng(6).uniform(
        -1, 1, (2, 8, 8, 3)).astype(np.float32))
    seen = []

    def first_input(z):
        seen.append(z.clone())
        return z.clamp(-1, 1)

    sampler.swap_refine(first_input, real, steps=2, seed=9, offset=4)
    want = fused_noise_blend_plain(real, torch.full((2,), 0.7), seed=9,
                                   offset=4)
    assert torch.equal(seen[0], want)
    seen.clear()
    sampler.swap_refine(first_input, real, steps=2, seed=9, offset=5)
    assert not torch.equal(seen[0], want)


# ------------------------------------------------------ checkpoint / loading


def _port_trainer(mode, size=S, device="cpu", **extra):
    cfg = port_config.config_from_dict(port_config.DeepFakeConfig,
                                       _cfg_dict(mode, size, **extra))
    return DeepFakeTrainer(cfg, steps_per_epoch=1, image_size=size,
                           device=device)


@pytest.fixture(scope="module")
def weights():
    """Flax variables of both identities' models and shadows: a shadow is
    its model with every tensor moved by 5% of its spread."""
    cfg = jax_config.config_from_dict(jax_config.DeepFakeConfig,
                                      _cfg_dict("swap"))
    model = JaxDeepFakeTrainer(cfg, steps_per_epoch=1, image_size=S).model
    out = {}
    for name, seed in WEIGHT_SEEDS.items():
        out[name] = _variables(model, seed)
        rng = np.random.default_rng(seed + 100)
        out[f"ema_{name}"] = jax.tree.map(
            lambda x: (x + 0.05 * (np.std(x) or 1.0) * rng.standard_normal(
                x.shape)).astype(np.float32), out[name])
    # BN variances stay positive.
    for name in WEIGHT_SEEDS:
        stats = out[f"ema_{name}"]["batch_stats"]
        out[f"ema_{name}"]["batch_stats"] = jax.tree_util.tree_map_with_path(
            lambda p, x: np.abs(x) if "var" in jax.tree_util.keystr(p)
            else x, stats)
    return out


@pytest.fixture(scope="module")
def swap_checkpoints(weights, tmp_path_factory):
    """The same swap-mode states saved by each framework's manager."""
    tmp = tmp_path_factory.mktemp("swap_ckpt")
    jax_states, port_states = {}, {}
    trainer = _port_trainer("swap")
    fresh = trainer.init_states(seed=0)
    for name in ("a", "b"):
        v, e = weights[name], weights[f"ema_{name}"]
        jax_states[name] = JaxModelState(
            step=jnp.int32(7), params=v["params"],
            batch_stats=v["batch_stats"], opt_state=None,
            ema_params=e["params"], ema_batch_stats=e["batch_stats"],
            ema_step=jnp.int32(5))
        load_jax_state(fresh[name], jax.device_get(jax_states[name]))
        port_states[name] = fresh[name]
    hparams = dataclasses.asdict(trainer.cfg)
    JaxCheckpointManager(tmp / "jax").save(7, jax_states, hparams)
    CheckpointManager(tmp / "port").save(7, port_states, hparams)
    yield tmp / "jax", tmp / "port", port_states
    shutil.rmtree(tmp, ignore_errors=True)


@pytest.mark.parametrize("ident,use_ema,transfer,steps", [
    pytest.param("a", False, "rgb", 0, id="a-False"),
    pytest.param("b", True, "rgb", 0, id="b-True"),
    pytest.param("a", False, "i420", 0, id="a-False-i420"),
    pytest.param("b", True, "i420", 0, id="b-True-i420"),
    pytest.param("a", False, "i420", 3, id="a-False-i420-ddim3"),
])
def test_pipeline_matches_jax(swap_checkpoints, monkeypatch, ident, use_ema,
                              transfer, steps):
    """Each framework's pipeline from a checkpoint of the same weights,
    within 1 LSB (share stated): the uint8 frames, or the packed i420
    bytes. DDIM gets the noise JAX draws from its key (the port's own
    comes from the noise kernel's stream), through its ``noise``
    argument."""
    jax_dir, port_dir, _ = swap_checkpoints
    jax_model = jax_inference.load_swap_model(jax_dir, ident,
                                              use_ema=use_ema)
    port_model = inference.load_swap_model(port_dir, ident, use_ema=use_ema,
                                           device="cpu")
    other = "b" if ident == "a" else "a"
    assert port_model.mean == tuple(STATS[other][0])
    assert (port_model.mean, port_model.std) == (jax_model.mean,
                                                 jax_model.std)
    frames = _u8((B, S, S, 3), 7)
    if transfer == "i420":
        frames = image.pack_rgb_batch_to_i420_np(frames)
    key = jax.random.PRNGKey(0)
    want = np.asarray(jax_inference.make_device_pipeline(
        jax_model, sampler_steps=steps, transfer=transfer)(
        jnp.asarray(frames), key, 0))
    if steps:
        noise = torch.from_numpy(np.array(jax.random.normal(
            jax.random.fold_in(key, 0), (B, S, S, 3), jnp.float32)))
        monkeypatch.setattr(inference, "swap_refine", functools.partial(
            sampler.swap_refine, noise=noise))
    got = inference.make_device_pipeline(
        port_model, sampler_steps=steps, transfer=transfer)(
        torch.from_numpy(frames), 0).numpy()
    assert got.dtype == np.uint8 and got.shape == frames.shape
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    share = float((diff > 0).mean())
    clamped = float(((want == 0) | (want == 255)).mean())
    print(f"pipeline {ident} use_ema={use_ema} {transfer} steps={steps}: "
          f"differing share {share:.2e}, clamped share {clamped:.2f}")
    assert diff.max() <= 1
    assert clamped < 0.1


def test_checkpoint_round_trip(swap_checkpoints, tmp_path):
    _, port_dir, saved = swap_checkpoints
    manager = CheckpointManager(port_dir)
    assert manager.all_steps() == [7] and manager.latest_step() == 7
    meta = manager.read_meta()
    assert meta["step"] == 7 and meta["hparams"]["mode"] == "swap"
    assert meta["hparams"]["mean_a"] == list(STATS["a"][0])
    for name, state in saved.items():
        parts = manager.restore_partial(name, ["model", "ema_model",
                                               "optimizer", "counters"])
        for part, module in (("model", state.model),
                             ("ema_model", state.ema_model)):
            want = module.state_dict()
            assert parts[part].keys() == want.keys()
            assert all(torch.equal(parts[part][k], want[k]) for k in want)
        assert parts["counters"] == {"step": 7, "ema_step": 5}
        assert parts["optimizer"]["param_groups"] == \
            state.optimizer.state_dict()["param_groups"]
        loaded = inference.load_swap_model(port_dir, name, use_ema=True,
                                           device="cpu")
        got = loaded.model.state_dict()
        want = state.ema_model.state_dict()
        assert all(torch.equal(got[k], want[k]) for k in want)
        assert not loaded.model.training
    with pytest.raises(ValueError, match="unknown checkpoint parts"):
        manager.restore_partial("a", ["weights"])


def test_checkpoint_retention_and_meta(tmp_path):
    trainer = _port_trainer("denoise", size=32)
    states = trainer.init_states(seed=0)
    manager = CheckpointManager(tmp_path, keep=2)
    for step in (1, 2, 3):
        manager.save(step, states, {"v": step}, extra={"epoch": step})
    assert manager.all_steps() == [2, 3]
    assert not (tmp_path / "step_0000000001").exists()
    assert manager.read_meta()["hparams"] == {"v": 3}
    assert manager.read_meta(2) == {"step": 2, "hparams": {"v": 2},
                                    "extra": {"epoch": 2}}
    # A step without meta.json is incomplete and not listed.
    (tmp_path / "step_0000000009" / "a").mkdir(parents=True)
    assert manager.latest_step() == 3
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path / "empty").read_meta()


def test_restore_partial_reads_only_its_files(swap_checkpoints, tmp_path):
    import shutil

    _, port_dir, saved = swap_checkpoints
    copy_dir = tmp_path / "copy"
    shutil.copytree(port_dir, copy_dir)
    step_dir = CheckpointManager(copy_dir).step_dir(7)
    shutil.rmtree(step_dir / "b")
    for part in ("optimizer", "ema_model", "counters"):
        (step_dir / "a" / f"{part}.pt").unlink()
    model = inference.load_swap_model(copy_dir, "a", device="cpu")
    want = saved["a"].model.state_dict()
    assert all(torch.equal(model.model.state_dict()[k], want[k])
               for k in want)
    with pytest.raises(FileNotFoundError):
        inference.load_swap_model(copy_dir, "b", device="cpu")


def test_use_ema_on_denoise_checkpoint_is_clear_error(checkpoint):
    with pytest.raises(ValueError, match="no EMA shadows"):
        inference.load_swap_model(checkpoint, "a", use_ema=True,
                                  image_size=SIZE, device="cpu")


def test_load_swap_model_image_size_precedence(checkpoint, tmp_path):
    assert inference.load_swap_model(checkpoint, "a", image_size=96,
                                     device="cpu").image_size == SIZE
    trainer = _port_trainer("denoise", size=None)
    CheckpointManager(tmp_path).save(
        1, trainer.init_states(seed=0), dataclasses.asdict(trainer.cfg))
    assert inference.load_swap_model(tmp_path, "a", image_size=96,
                                     device="cpu").image_size == 96
    with pytest.raises(ValueError, match="'a' or 'b'"):
        inference.load_swap_model(tmp_path, "c", device="cpu")


def test_entry_points_need_a_gpu_unless_given_cpu(checkpoint):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a GPU")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        inference.load_swap_model(checkpoint, "a")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SwapEngine(checkpoint, "a", height=SIZE, width=SIZE)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_server(checkpoint, "a", height=SIZE, width=SIZE, check=True,
                   verbose=False)


def test_tf32_off_restores_the_callers_flags():
    """An fp32 model's forward holds cuDNN and matmuls to fp32 and then
    gives the process its own TF32 settings back."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    try:
        for flags in ((True, True), (True, False)):
            cudnn.allow_tf32, matmul.allow_tf32 = flags
            with inference._tf32_off():
                assert not cudnn.allow_tf32 and not matmul.allow_tf32
            assert (cudnn.allow_tf32, matmul.allow_tf32) == flags
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


def test_pipeline_refuses_i420(checkpoint):
    """The i420 transfer has been ported since this refusal: the pipeline
    takes packed frames, unpacks them to fp32 RGB, normalises, swaps,
    denormalises and packs the fake (parity with JAX:
    ``test_pipeline_matches_jax``); an unknown transfer is still
    refused."""
    from denoising_diffusion_deep_fake_tpu_torch.ops.augment import (
        normalise_batch)

    model = inference.load_swap_model(checkpoint, "a", device="cpu")
    with pytest.raises(ValueError, match="transfer"):
        inference.make_device_pipeline(model, transfer="yuv")
    packed = image.rgb_to_i420(torch.from_numpy(_u8((2, SIZE, SIZE, 3),
                                                    12)))
    out = inference.make_device_pipeline(model, transfer="i420")(packed, 0)
    x = normalise_batch(image.i420_to_rgb(packed), model.mean, model.std)
    want = image.rgb_to_i420(image.denormalise_to_uint8_rgb(
        model.predict(x), model.mean, model.std))
    assert out.dtype == torch.uint8 and torch.equal(out, want)


def test_ddim_pipeline_keys_noise_by_batch_index(checkpoint):
    model = inference.load_swap_model(checkpoint, "b", device="cpu")
    frames = torch.from_numpy(_u8((2, SIZE, SIZE, 3), 8))
    pipe = inference.make_device_pipeline(model, sampler_steps=1, seed=3)
    first = pipe(frames, 0)
    assert first.dtype == torch.uint8 and first.shape == frames.shape
    assert torch.equal(pipe(frames, 0), first)
    assert not torch.equal(pipe(frames, 1), first)
    other_seed = inference.make_device_pipeline(model, sampler_steps=1,
                                                seed=4)
    assert not torch.equal(other_seed(frames, 0), first)


# ------------------------------------------------------ deep-fake panels


PANEL_B, PANEL_S = 2, 32


class _TinyFlaxModel(flax_nn.Module):
    """A stand-in for the JAX trainer's U-Net in ``_jax_panel_shapes``: the
    step's tags and panel shapes do not depend on the model, and tracing
    this one is quick."""

    @flax_nn.compact
    def __call__(self, x, train=True):
        x = flax_nn.Conv(3, (1, 1))(x)
        return flax_nn.BatchNorm(use_running_average=not train)(x)


def _jax_panel_shapes(mode):
    """JAX's panel tags and shapes: ``jax.eval_shape`` of its step."""
    cfg = jax_config.config_from_dict(
        jax_config.DeepFakeConfig,
        _cfg_dict(mode, PANEL_S, batch_size=PANEL_B))
    trainer = JaxDeepFakeTrainer(cfg, steps_per_epoch=1, image_size=PANEL_S)
    trainer.model = _TinyFlaxModel()
    states = jax.eval_shape(lambda: trainer.init_states(
        jax.random.PRNGKey(0)))
    batch = jax.ShapeDtypeStruct((PANEL_B, PANEL_S, PANEL_S, 3), jnp.uint8)
    _, _, images = jax.eval_shape(
        lambda s, a, b: trainer._train_step(s, a, b, jax.random.PRNGKey(0),
                                            with_images=True),
        states, batch, batch)
    return {tag: (tuple(x.shape), np.dtype(x.dtype))
            for tag, x in images.items()}


@pytest.mark.parametrize("mode", ["denoise", "swap"])
def test_deep_fake_panels(mode):
    trainer = _port_trainer(mode, PANEL_S, batch_size=PANEL_B)
    states = trainer.init_states(seed=1)
    for state in states.values():
        if state.has_ema:
            state.ema_step = 10 ** 7
    # Each model's forward records its input and output.
    seen = {}

    def recorder(key):
        def hook(module, args, out):
            seen[key] = (args[0].detach().clone(), out.detach().clone())
        return hook

    for name, state in states.items():
        state.model.register_forward_hook(recorder(name))
        if state.has_ema:
            state.ema_model.register_forward_hook(recorder(f"ema_{name}"))
    u8 = {n: torch.from_numpy(_u8((PANEL_B, PANEL_S, PANEL_S, 3), 20 + i))
          for i, n in enumerate("ab")}
    metrics, panels = trainer.train_step(states, u8["a"], u8["b"],
                                         with_images=True)
    assert all(torch.isfinite(torch.as_tensor(v)).all()
               for v in metrics.values())
    want_shapes = _jax_panel_shapes(mode)
    assert {t: (tuple(p.shape), np.dtype("uint8"))
            for t, p in panels.items()} == want_shapes
    if mode == "denoise":
        shown = {}
        for n in "ab":
            shown[f"denoise_1_model_input/{n}"] = seen[n][0]
            shown[f"denoise_2_model_prediction/{n}"] = seen[n][1]
    else:
        shown = {}
        for n, other in (("a", "b"), ("b", "a")):
            real, fake = seen[f"ema_{other}"]
            shown[f"swap_1_real/{n}"] = real
            shown[f"swap_2_fake/{n}_to_fake"] = fake
            shown[f"swap_3_model_input/{n}"] = seen[n][0]
            shown[f"swap_4_model_prediction/{n}"] = seen[n][1]
    assert shown.keys() == panels.keys()
    for tag, x in shown.items():
        assert torch.equal(panels[tag], image.panel_grid_u8(x)), tag
    # The same step without images returns the metrics alone.
    assert isinstance(trainer.train_step(states, u8["a"], u8["b"]), dict)


# ------------------------------------------------------------ engine/server

SIZE = 32


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A denoise-mode pair at 32^2, saved by the port's manager."""
    tmp = tmp_path_factory.mktemp("serving")
    trainer = _port_trainer("denoise", size=SIZE)
    CheckpointManager(tmp / "ckpt").save(
        1, trainer.init_states(seed=0), dataclasses.asdict(trainer.cfg))
    yield tmp / "ckpt"
    shutil.rmtree(tmp, ignore_errors=True)


def _engine(checkpoint, identity="a", **kw):
    kw.setdefault("batch_size", 2)
    return SwapEngine(checkpoint, identity, height=SIZE, width=SIZE,
                      device="cpu", **kw)


@pytest.fixture(scope="module")
def engine(checkpoint):
    eng = _engine(checkpoint, batch_size=4, max_wait_ms=20.0)
    eng.warmup()
    yield eng
    eng.close()


def test_engine_single_frame(engine):
    frame = _u8((SIZE, SIZE, 3), 0)
    out = engine.swap(frame)
    assert out.shape == (SIZE, SIZE, 3) and out.dtype == np.uint8


def test_engine_stack_and_oversize(engine):
    frames = _u8((6, SIZE, SIZE, 3), 1)
    out = engine.swap(frames)  # 6 > batch_size=4 -> two device batches
    assert out.shape == frames.shape
    # Same frame, same result wherever it sits in a batch.
    np.testing.assert_array_equal(engine.swap(frames[2]), out[2])


def test_engine_micro_batches_concurrent_callers(engine):
    before = engine.stats()["batches"]
    frames = [_u8((SIZE, SIZE, 3), 20 + i) for i in range(4)]
    results = [None] * 4

    def call(i):
        results[i] = engine.swap(frames[i])

    threads = [threading.Thread(target=call, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert all(r is not None and r.shape == (SIZE, SIZE, 3) for r in results)
    stats = engine.stats()
    # 4 concurrent single-frame requests share device batches (batch 4,
    # max wait 20 ms).
    assert stats["batches"] - before <= 3
    assert stats["errors"] == 0


def test_engine_rejects_bad_input(engine):
    with pytest.raises(ValueError):
        engine.swap(np.zeros((SIZE, SIZE + 1, 3), np.uint8))
    with pytest.raises(ValueError):
        engine.swap(np.zeros((SIZE, SIZE, 3), np.float32))


def test_engine_refuses_i420_and_replicas(checkpoint, monkeypatch):
    """What the engine still refuses: an i420 geometry the format cannot
    carry (the format itself is ported, ``tests/test_torch_port_i420.py``),
    and replicas it has no device for (replicas are ported,
    ``tests/test_torch_port_parallel.py``): none, or more than the CUDA
    devices there are, before any weight is read."""
    with pytest.raises(ValueError, match="height % 4"):
        SwapEngine(checkpoint, "a", height=30, width=SIZE, transfer="i420",
                   device="cpu")
    with pytest.raises(ValueError, match="at least one replica"):
        _engine(checkpoint, devices=0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="devices=2 but 1 CUDA device"):
        SwapEngine(checkpoint, "a", height=SIZE, width=SIZE, devices=2)


@pytest.fixture(scope="module")
def server(engine):
    with SwapServer(engine, port=0) as srv:
        yield srv


def _request(port, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    conn.request(method, path, body=body, headers=headers or {})
    resp = conn.getresponse()
    data = resp.read()
    out_headers = dict(resp.getheaders())
    conn.close()
    return resp.status, data, out_headers


def test_healthz_and_stats(server):
    status, data, _ = _request(server.port, "GET", "/healthz")
    assert status == 200
    info = json.loads(data)
    assert info["status"] == "ok" and info["frame_shape"] == [SIZE, SIZE, 3]
    assert info["formats"] == ["rgb", "i420"] and info["transfer"] == "rgb"
    status, data, _ = _request(server.port, "GET", "/v1/stats")
    stats = json.loads(data)
    assert status == 200 and stats["batches"] >= 1
    assert 0 < stats["batch_occupancy"] <= 1
    assert stats["frame_shape"] == [SIZE, SIZE, 3]


def test_swap_raw_roundtrip(server, engine):
    frames = _u8((2, SIZE, SIZE, 3), 3)
    status, data, headers = _request(
        server.port, "POST", "/v1/swap_raw", body=frames.tobytes(),
        headers={"X-Shape": f"2,{SIZE},{SIZE},3"})
    assert status == 200, data
    out = np.frombuffer(data, np.uint8).reshape(
        tuple(int(s) for s in headers["X-Shape"].split(",")))
    assert out.shape == frames.shape
    # The pipeline run directly on the frames (padded to the batch).
    padded = np.zeros((4, SIZE, SIZE, 3), np.uint8)
    padded[:2] = frames
    pipe = inference.make_device_pipeline(engine.model)
    np.testing.assert_array_equal(out, pipe(torch.from_numpy(padded),
                                            0)[:2].numpy())


def test_swap_raw_refuses_i420(server):
    """``X-Format: i420`` has been ported since this refusal: a packed
    frame of another size than the engine's is refused (400), one of its
    size answered with packed frames (the i420 matrix:
    ``tests/test_torch_port_i420.py``)."""
    status, data, _ = _request(
        server.port, "POST", "/v1/swap_raw", body=b"x" * 24,
        headers={"X-Shape": "4,4", "X-Format": "i420"})
    assert status == 400 and b"expected frames" in data
    # The connection pool stays usable after the drained 400.
    status, _, _ = _request(server.port, "GET", "/healthz")
    assert status == 200
    packed = image.rgb_to_i420(torch.from_numpy(_u8((1, SIZE, SIZE, 3),
                                                    13))).numpy()
    status, data, headers = _request(
        server.port, "POST", "/v1/swap_raw", body=packed.tobytes(),
        headers={"X-Shape": f"{SIZE},{SIZE}", "X-Format": "i420"})
    assert status == 200 and headers["X-Format"] == "i420"
    assert len(data) == packed.nbytes


def test_swap_encoded_jpeg(server):
    cv2 = pytest.importorskip("cv2")
    # Oversized frame: the server centre-crops and resizes it.
    frame = _u8((SIZE * 2, SIZE * 3, 3), 4)
    ok, buf = cv2.imencode(".png", frame)
    assert ok
    status, data, headers = _request(server.port, "POST", "/v1/swap",
                                     body=buf.tobytes())
    assert status == 200, data
    assert headers["Content-Type"] == "image/jpeg"
    img = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    assert img.shape == (SIZE, SIZE, 3)


def test_swap_raw_rejects_bad_shape(server):
    status, data, _ = _request(
        server.port, "POST", "/v1/swap_raw", body=b"123",
        headers={"X-Shape": f"1,{SIZE},{SIZE},3"})
    assert status == 400 and b"bytes" in data
    status, data, _ = _request(
        server.port, "POST", "/v1/swap_raw", body=b"123",
        headers={"X-Shape": f"{SIZE},{SIZE},4"})
    assert status == 400 and b"X-Shape" in data


def test_swap_after_close_raises(checkpoint):
    eng = _engine(checkpoint)
    eng.close()
    with pytest.raises(RuntimeError, match="closed"):
        eng.swap(np.zeros((SIZE, SIZE, 3), np.uint8))


def test_swap_raises_when_the_dispatcher_stopped(checkpoint):
    """A caller queued behind a dispatcher that stopped is failed, not left
    waiting for ever."""
    eng = _engine(checkpoint)
    try:
        eng._queue.put(None)                 # the dispatcher's stop signal
        eng._dispatchers[0].thread.join(timeout=30)
        assert not eng._dispatchers[0].thread.is_alive()
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match="dispatcher stopped"):
            eng.swap(np.zeros((SIZE, SIZE, 3), np.uint8))
        assert time.monotonic() - t0 < 10
    finally:
        eng.close()


def test_oversize_stack_counts_one_request(engine):
    before = engine.stats()["requests"]
    frames = _u8((9, SIZE, SIZE, 3), 5)  # 3 slices at batch 4
    assert engine.swap(frames).shape == frames.shape
    assert engine.stats()["requests"] == before + 1


def test_stats_reports_latency_percentiles(engine):
    engine.swap(np.zeros((SIZE, SIZE, 3), np.uint8))
    stats = engine.stats()
    assert stats["p50_device_batch_ms"] > 0
    assert stats["p99_device_batch_ms"] >= stats["p50_device_batch_ms"]


def test_serve_both_identities(checkpoint):
    """One server, two engines; ?identity= routes; bad identity -> 400."""
    engines = {name: _engine(checkpoint, name) for name in ("a", "b")}
    with SwapServer(engines, port=0) as srv:
        status, data, _ = _request(srv.port, "GET", "/healthz")
        assert status == 200 and json.loads(data)["identities"] == ["a", "b"]
        frame = _u8((1, SIZE, SIZE, 3), 6)
        outs = {}
        for ident in ("a", "b"):
            status, data, _ = _request(
                srv.port, "POST", f"/v1/swap_raw?identity={ident}",
                body=frame.tobytes(),
                headers={"X-Shape": f"1,{SIZE},{SIZE},3"})
            assert status == 200, data
            outs[ident] = np.frombuffer(data, np.uint8)
        # Different models and statistics -> different fakes.
        assert not np.array_equal(outs["a"], outs["b"])
        status, data, _ = _request(
            srv.port, "POST", "/v1/swap_raw?identity=c",
            body=frame.tobytes(), headers={"X-Shape": f"1,{SIZE},{SIZE},3"})
        assert status == 400 and b"not served" in data


def test_run_server_check_mode(checkpoint, capsys):
    """``check=True`` loads, warms up and reports each engine, then
    returns without listening."""
    run_server(checkpoint, "both", height=SIZE, width=SIZE, batch_size=2,
               check=True, verbose=False, device="cpu")
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()
             if line.startswith("{")]
    assert [s["engine"] for s in lines] == ["a", "b"]
    assert all(s["serve_check"] == "ok" and s["frames"] >= 1
               and s["frame_shape"] == [SIZE, SIZE, 3] for s in lines)


# ------------------------------------------------------------- backpressure


class _GatedPipeline:
    """Wraps a pipeline so the dispatcher blocks until released: queue
    build-up becomes deterministic for the overload tests."""

    def __init__(self, inner):
        self.inner = inner
        self.entered = threading.Event()
        self.gate = threading.Event()

    def __call__(self, dev_arr, batch_idx):
        self.entered.set()
        if not self.gate.wait(timeout=60):
            raise RuntimeError("gate never opened")
        return self.inner(dev_arr, batch_idx)


def _gate(eng):
    gated = _GatedPipeline(eng._dispatchers[0].pipeline)
    eng._dispatchers[0].pipeline = gated
    return gated


def _wait_for(predicate, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.01)
    return False


def _expect_raises(fn):
    """Run fn; return the exception it raised (None if it returned)."""
    try:
        fn()
        return None
    except BaseException as e:
        return e


def test_engine_sheds_on_overload(checkpoint):
    """Past the watermark a call is rejected with a drain estimate before
    any slice is queued; admitted callers drain normally after."""
    eng = _engine(checkpoint, max_wait_ms=1.0, max_queue_frames=4)
    gated = None
    try:
        eng.warmup()
        gated = _gate(eng)
        frames = np.zeros((2, SIZE, SIZE, 3), np.uint8)
        results = []
        threads = [threading.Thread(
            target=lambda: results.append(eng.swap(frames)))
            for _ in range(3)]
        threads[0].start()
        assert gated.entered.wait(timeout=30)   # batch 1 blocked
        for t in threads[1:]:
            t.start()                            # 4 frames queued
        assert _wait_for(lambda: eng.stats()["queue_depth"] == 4)

        with pytest.raises(EngineOverloadedError) as exc:
            eng.swap(frames)                     # 4 + 2 > watermark 4
        assert exc.value.retry_after_s > 0

        gated.gate.set()
        for t in threads:
            t.join(timeout=60)
        assert len(results) == 3
        stats = eng.stats()
        assert stats["shed_requests"] == 1
        assert stats["queue_high_water"] == 4
        assert stats["queue_depth"] == 0
        assert stats["max_queue_frames"] == 4
        assert stats["errors"] == 0
    finally:
        if gated is not None:
            gated.gate.set()
        eng.close()


def test_engine_rejects_watermark_below_batch(checkpoint):
    with pytest.raises(ValueError, match="max_queue_frames"):
        _engine(checkpoint, batch_size=4, max_queue_frames=2)


def test_engine_check_admission_contract(checkpoint):
    """The pre-payload probe passes below the watermark without reserving
    capacity, sheds above it with a positive drain estimate, and counts
    early sheds apart."""
    eng = _engine(checkpoint, max_wait_ms=1.0, max_queue_frames=2)
    gated = None
    try:
        eng.warmup()
        for _ in range(10):
            eng.check_admission(2)
        assert eng.stats()["queue_depth"] == 0
        out = eng.swap(np.zeros((2, SIZE, SIZE, 3), np.uint8))
        assert out.shape == (2, SIZE, SIZE, 3)

        gated = _gate(eng)
        frames = np.zeros((2, SIZE, SIZE, 3), np.uint8)
        results = []
        threads = [threading.Thread(
            target=lambda: results.append(eng.swap(frames)))
            for _ in range(2)]
        threads[0].start()
        assert gated.entered.wait(timeout=30)
        threads[1].start()
        assert _wait_for(lambda: eng.stats()["queue_depth"] == 2)

        with pytest.raises(EngineOverloadedError) as exc:
            eng.check_admission(1)
        assert exc.value.retry_after_s > 0
        stats = eng.stats()
        assert stats["early_shed_requests"] == 1
        assert stats["shed_requests"] == 1

        gated.gate.set()
        for t in threads:
            t.join(timeout=60)
        assert len(results) == 2
        assert eng.stats()["queue_depth"] == 0
    finally:
        if gated is not None:
            gated.gate.set()
        eng.close()


def _read_http_head(sock) -> str:
    """Read from ``sock`` until the end of one header block; return it."""
    data = b""
    while b"\r\n\r\n" not in data:
        chunk = sock.recv(65536)
        if not chunk:
            break
        data += chunk
    return data.split(b"\r\n\r\n", 1)[0].decode()


@pytest.fixture()
def overloaded(checkpoint):
    """A server whose engine queue sits at the watermark behind a gate.

    Yields (server, engine, gate, finish); ``finish()`` opens the gate and
    joins the two admitted requests, asserting both got 200s.
    """
    eng = _engine(checkpoint, max_wait_ms=1.0, max_queue_frames=2)
    gated = None
    try:
        eng.warmup()
        gated = _gate(eng)
        with SwapServer(eng, port=0) as srv:
            frames = np.zeros((2, SIZE, SIZE, 3), np.uint8)
            hdrs = {"X-Shape": f"2,{SIZE},{SIZE},3"}
            replies = []
            threads = [threading.Thread(target=lambda: replies.append(
                _request(srv.port, "POST", "/v1/swap_raw",
                         body=frames.tobytes(), headers=hdrs)))
                for _ in range(2)]
            threads[0].start()
            assert gated.entered.wait(timeout=30)  # batch 1 in flight
            threads[1].start()                      # 2 frames queued (full)
            assert _wait_for(lambda: eng.stats()["queue_depth"] == 2)

            def finish():
                gated.gate.set()
                for t in threads:
                    t.join(timeout=60)
                assert [r[0] for r in replies] == [200, 200]

            yield srv, eng, gated, finish
    finally:
        if gated is not None:
            gated.gate.set()
        eng.close()


def test_server_early_sheds_without_reading_body(overloaded):
    """The 503 arrives from the headers alone: the socket announces a body
    and never sends it."""
    srv, eng, _, finish = overloaded
    nbytes = 2 * SIZE * SIZE * 3
    with socket.create_connection(("127.0.0.1", srv.port), timeout=30) as s:
        s.sendall((f"POST /v1/swap_raw HTTP/1.1\r\nHost: t\r\n"
                   f"X-Shape: 2,{SIZE},{SIZE},3\r\n"
                   f"Content-Length: {nbytes}\r\n\r\n").encode())
        head = _read_http_head(s)
    assert head.startswith("HTTP/1.1 503"), head
    assert "Connection: close" in head
    assert "Retry-After:" in head
    stats = eng.stats()
    assert stats["early_shed_requests"] == 1
    assert stats["shed_requests"] == 1
    finish()
    assert eng.stats()["queue_depth"] == 0


def test_server_expect_100_continue(overloaded):
    """An ``Expect: 100-continue`` client pays no body bytes on overload;
    once the backlog drains the same request gets 100, then 200."""
    srv, eng, _, finish = overloaded
    nbytes = 2 * SIZE * SIZE * 3
    req = (f"POST /v1/swap_raw HTTP/1.1\r\nHost: t\r\n"
           f"X-Shape: 2,{SIZE},{SIZE},3\r\n"
           f"Content-Length: {nbytes}\r\nExpect: 100-continue\r\n\r\n")

    with socket.create_connection(("127.0.0.1", srv.port), timeout=30) as s:
        s.sendall(req.encode())
        head = _read_http_head(s)
    assert head.startswith("HTTP/1.1 503"), head
    assert "Retry-After:" in head
    assert eng.stats()["early_shed_requests"] == 1

    finish()

    with socket.create_connection(("127.0.0.1", srv.port), timeout=30) as s:
        s.sendall(req.encode())
        interim = _read_http_head(s)
        assert interim.startswith("HTTP/1.1 100"), interim
        s.sendall(np.zeros((2, SIZE, SIZE, 3), np.uint8).tobytes())
        head = _read_http_head(s)
    assert head.startswith("HTTP/1.1 200"), head


def test_server_post_read_shed_keeps_connection(overloaded):
    """The authoritative check in ``swap_wire`` (probe passed, queue
    filled while the body streamed in): the body was read, so the 503 keeps
    the connection, which then serves a 200."""
    srv, eng, _, finish = overloaded
    eng.check_admission = lambda n: None   # force the post-read path
    frames = np.zeros((2, SIZE, SIZE, 3), np.uint8)
    hdrs = {"X-Shape": f"2,{SIZE},{SIZE},3"}

    conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=60)
    try:
        conn.request("POST", "/v1/swap_raw", body=frames.tobytes(),
                     headers=hdrs)
        resp = conn.getresponse()
        body = resp.read()
        assert resp.status == 503, body
        assert resp.getheader("Retry-After") is not None
        assert (resp.getheader("Connection") or "").lower() != "close"
        stats = eng.stats()
        assert stats["shed_requests"] == 1
        assert stats["early_shed_requests"] == 0

        finish()
        conn.request("POST", "/v1/swap_raw", body=frames.tobytes(),
                     headers=hdrs)
        resp = conn.getresponse()
        out = resp.read()
        assert resp.status == 200 and len(out) == frames.nbytes
    finally:
        conn.close()


def test_server_sheds_with_503_and_retry_after(overloaded):
    """503 + Retry-After + JSON error; the engine recovers."""
    srv, eng, _, finish = overloaded
    frames = np.zeros((2, SIZE, SIZE, 3), np.uint8)
    status, data, headers = _request(
        srv.port, "POST", "/v1/swap_raw", body=frames.tobytes(),
        headers={"X-Shape": f"2,{SIZE},{SIZE},3"})
    assert status == 503, data
    assert int(headers["Retry-After"]) >= 1
    assert b"overloaded" in data
    finish()
    status, data, _ = _request(srv.port, "GET", "/v1/stats")
    assert json.loads(data)["shed_requests"] == 1


# ------------------------------------------------- deadlines / cancellation


def test_engine_drops_expired_before_dispatch(checkpoint):
    """A queued request whose deadline passed burns no device batch: the
    dispatcher skips it, the waiter raises at the deadline."""
    eng = _engine(checkpoint, max_wait_ms=1.0)
    gated = None
    try:
        eng.warmup()
        batches_before = eng.stats()["batches"]
        gated = _gate(eng)
        frames = np.zeros((2, SIZE, SIZE, 3), np.uint8)

        blocker_done = []
        blocker = threading.Thread(
            target=lambda: blocker_done.append(eng.swap(frames)))
        blocker.start()
        assert gated.entered.wait(timeout=30)

        errors = []
        impatient = threading.Thread(
            target=lambda: errors.append(_expect_raises(
                lambda: eng.swap(frames, deadline_ms=200.0))))
        impatient.start()
        assert _wait_for(lambda: eng.stats()["queue_depth"] == 2)
        impatient.join(timeout=30)
        assert not impatient.is_alive()
        assert isinstance(errors[0], RequestExpiredError)
        assert eng.stats()["expired_requests"] == 1

        gated.gate.set()
        blocker.join(timeout=60)
        assert len(blocker_done) == 1
        assert _wait_for(
            lambda: eng.stats()["expired_dropped_frames"] == 2)
        stats = eng.stats()
        assert stats["batches"] == batches_before + 1
        assert stats["queue_depth"] == 0
        assert stats["errors"] == 0
        assert eng.swap(frames).shape == frames.shape
    finally:
        if gated is not None:
            gated.gate.set()
        eng.close()


def test_engine_wait_unblocks_at_deadline_even_when_claimed(checkpoint):
    """A request packed into an in-flight batch cannot be unpacked, but its
    caller stops waiting at the deadline."""
    eng = _engine(checkpoint, max_wait_ms=1.0)
    gated = None
    try:
        eng.warmup()
        gated = _gate(eng)
        frames = np.zeros((2, SIZE, SIZE, 3), np.uint8)
        errors = []
        caller = threading.Thread(
            target=lambda: errors.append(_expect_raises(
                lambda: eng.swap(frames, deadline_ms=250.0))))
        caller.start()
        assert gated.entered.wait(timeout=30)
        caller.join(timeout=30)
        assert not caller.is_alive()
        assert isinstance(errors[0], RequestExpiredError)
        stats = eng.stats()
        assert stats["expired_requests"] == 1
        assert stats["expired_dropped_frames"] == 0

        gated.gate.set()
        assert _wait_for(lambda: eng.stats()["batches"] >= 2)
        assert eng.swap(frames).shape == frames.shape
    finally:
        if gated is not None:
            gated.gate.set()
        eng.close()


def test_engine_default_deadline_and_per_call_override(checkpoint):
    """``request_deadline_ms`` applies to every call; ``deadline_ms=0``
    disables it for one."""
    eng = _engine(checkpoint, max_wait_ms=1.0, request_deadline_ms=300.0)
    gated = None
    try:
        eng.warmup()
        assert eng.stats()["request_deadline_ms"] == 300.0
        gated = _gate(eng)
        frames = np.zeros((2, SIZE, SIZE, 3), np.uint8)
        results, errors = [], []
        blocker = threading.Thread(
            target=lambda: results.append(eng.swap(frames, deadline_ms=0)))
        blocker.start()
        assert gated.entered.wait(timeout=30)
        impatient = threading.Thread(
            target=lambda: errors.append(_expect_raises(
                lambda: eng.swap(frames))))
        impatient.start()
        impatient.join(timeout=30)
        assert isinstance(errors[0], RequestExpiredError)

        gated.gate.set()
        blocker.join(timeout=60)
        assert len(results) == 1 and results[0].shape == frames.shape
    finally:
        if gated is not None:
            gated.gate.set()
        eng.close()


def test_server_deadline_header_504(checkpoint):
    """An admitted request whose X-Deadline-Ms passes gets 504; a bad
    header 400; the server stays serviceable."""
    eng = _engine(checkpoint, max_wait_ms=1.0)
    gated = None
    try:
        eng.warmup()
        gated = _gate(eng)
        with SwapServer(eng, port=0) as srv:
            frames = np.zeros((2, SIZE, SIZE, 3), np.uint8)
            hdrs = {"X-Shape": f"2,{SIZE},{SIZE},3"}
            replies = []
            blocker = threading.Thread(target=lambda: replies.append(
                _request(srv.port, "POST", "/v1/swap_raw",
                         body=frames.tobytes(), headers=hdrs)))
            blocker.start()
            assert gated.entered.wait(timeout=30)

            status, data, _ = _request(
                srv.port, "POST", "/v1/swap_raw", body=frames.tobytes(),
                headers={**hdrs, "X-Deadline-Ms": "250"})
            assert status == 504, data
            assert b"deadline" in data
            assert eng.stats()["expired_requests"] == 1

            gated.gate.set()
            blocker.join(timeout=60)
            assert [r[0] for r in replies] == [200]
            assert _wait_for(
                lambda: eng.stats()["expired_dropped_frames"] == 2)

            status, data, _ = _request(
                srv.port, "POST", "/v1/swap_raw", body=frames.tobytes(),
                headers={**hdrs, "X-Deadline-Ms": "soon"})
            assert status == 400 and b"X-Deadline-Ms" in data

            status, data, _ = _request(
                srv.port, "POST", "/v1/swap_raw", body=frames.tobytes(),
                headers=hdrs)
            assert status == 200 and len(data) == frames.nbytes
    finally:
        if gated is not None:
            gated.gate.set()
        eng.close()
