"""The port's config, optimizer and entry points, and its import guard.

* config: the YAML files load into the port's schema with the JAX
  package's values;
* optimizer: the same gradients through torch Adam and optax Adam give the
  same params and moments over several steps (1e-6 relative: the two
  formulas divide by the bias corrections in another order), and the
  per-epoch cosine rate is the JAX package's closed form;
* entry points: without a GPU they raise unless ``device="cpu"`` is given,
  and a tensor on a device other than the CPU never reaches a plain version;
* the port imports no JAX, flax, optax or JAX-package module.
"""

import ast
import re
from pathlib import Path

import numpy as np
import optax
import pytest
import torch

import jax.numpy as jnp

from denoising_diffusion_deep_fake_tpu import config as jax_config
from denoising_diffusion_deep_fake_tpu.training.optim import (
    cosine_annealing_lr as jax_cosine,
    make_adam_with_cosine,
)
from denoising_diffusion_deep_fake_tpu_torch import config as port_config
from denoising_diffusion_deep_fake_tpu_torch.device import resolve_device
from denoising_diffusion_deep_fake_tpu_torch.ops import image
from denoising_diffusion_deep_fake_tpu_torch.ops.cuda import warp_kernel
from denoising_diffusion_deep_fake_tpu_torch.training.deep_fake import (
    DeepFakeTrainer,
)
from denoising_diffusion_deep_fake_tpu_torch.training.denoiser import (
    DenoiserTrainer,
)
from denoising_diffusion_deep_fake_tpu_torch.training.optim import (
    learning_rate_at,
    make_adam,
)

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "denoising_diffusion_deep_fake_tpu_torch"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one thread: the test run's workers share the cores, and
    torch's own pool on each of them oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(**overrides):
    base = dict(input_image_list_path="unused", batch_size=2,
                learning_rate=0.02, encoder_name="resnet18",
                compute_dtype="float32")
    return port_config.config_from_dict(port_config.DenoiserConfig,
                                        dict(base, **overrides))


def test_denoiser_yaml_loads_like_the_jax_package():
    path = ROOT / "configs" / "denoiser.yml"
    port = port_config.load_config(port_config.DenoiserConfig, path,
                                   {"input_image_list_path": "x"})
    ref = jax_config.load_config(jax_config.DenoiserConfig, path,
                                 {"input_image_list_path": "x"})
    for field in ("batch_size", "learning_rate", "max_epochs",
                  "cosine_t_max", "encoder_name", "mean", "std",
                  "compute_dtype", "noise_exponential_sampling_lambda",
                  "warp_method", "aug_degrees", "aug_scale_min"):
        assert getattr(port, field) == getattr(ref, field), field


def test_config_validation_and_rescale():
    with pytest.raises(ValueError, match="unknown warp_method"):
        _cfg(warp_method="fused")
    with pytest.raises(ValueError, match="input_image_list_path"):
        _cfg(input_image_list_path="")
    with pytest.warns(UserWarning, match="0-255"):
        cfg = _cfg(mean=(128, 128, 128), std=(128, 128, 128))
    assert cfg.mean == pytest.approx((128 / 255,) * 3)


def _deep_fake_cfg(**overrides):
    base = dict(data_path_a="a", data_path_b="b", batch_size=2,
                encoder_name="resnet18", compute_dtype="float32")
    return port_config.config_from_dict(port_config.DeepFakeConfig,
                                        dict(base, **overrides))


TRAINERS = {"denoiser": (DenoiserTrainer, _cfg),
            "deep_fake": (DeepFakeTrainer, _deep_fake_cfg)}
KNOBS = [dict(remat="dots"), dict(steps_per_call=2),
         dict(color_jitter=(0.1, 0, 0, 0)), dict(upload_format="i420"),
         dict(patchify_stem=2)]


@pytest.mark.parametrize("trainer,knob", [
    pytest.param(name, knob, id=f"knob{i}" if name == "denoiser"
                 else f"{name}-knob{i}")
    for name in TRAINERS for i, knob in enumerate(KNOBS)])
def test_trainer_refuses_unported_knobs(trainer, knob):
    """Each knob without its feature in the port is refused. All five have
    been ported since, and their cases check that the trainer takes the
    knob and trains: ``knob4``, ``patchify_stem: 2``, a step of the
    patchified U-Net at 64^2 (its parity with JAX:
    ``tests/test_torch_port_patchify.py``); ``knob3``,
    ``upload_format: i420``, a step on a packed
    batch (its parity with JAX: ``tests/test_torch_port_i420.py``);
    ``knob1``, ``steps_per_call: 2``, one K-step call
    (``tests/test_torch_port_multi_step.py``); ``knob0``, ``remat: dots``,
    and ``knob2``, ``color_jitter``, a step
    (``tests/test_torch_port_remat.py``,
    ``tests/test_torch_port_color.py``)."""
    cls, make_cfg = TRAINERS[trainer]
    if "remat" in knob or "color_jitter" in knob:
        t = cls(make_cfg(**knob), steps_per_epoch=1, image_size=32,
                device="cpu")
        u8 = torch.zeros((2, 32, 32, 3), dtype=torch.uint8)
        if trainer == "denoiser":
            losses = [t.train_step(t.init_state(seed=0), u8)["loss"]]
        else:
            m = t.train_step(t.init_states(seed=0), u8, u8)
            losses = [m["loss_denoise/train_a"], m["loss_denoise/train_b"]]
        assert all(torch.isfinite(v) for v in losses)
        return
    if knob == dict(steps_per_call=2):
        t = cls(make_cfg(**knob), steps_per_epoch=1, image_size=32,
                device="cpu")
        u8 = torch.zeros((2, 32, 32, 3), dtype=torch.uint8)
        step = t.make_super_step(2)
        if trainer == "denoiser":
            state = t.init_state(seed=0)
            m = step(state, u8, u8)
            losses = [m["loss"]]
        else:
            states = t.init_states(seed=0)
            state = states["a"]
            m = step(states, u8, u8, u8, u8)
            losses = [m["loss_denoise/train_a"], m["loss_denoise/train_b"]]
        assert state.step == 2 and len(m["lr"]) == 2
        assert all(v.shape == (2,) and torch.isfinite(v).all()
                   for v in losses)
        return
    if knob == dict(upload_format="i420"):
        t = cls(make_cfg(**knob), steps_per_epoch=1, image_size=32,
                device="cpu")
        packed = image.rgb_to_i420(torch.zeros((2, 32, 32, 3),
                                               dtype=torch.uint8))
        if trainer == "denoiser":
            m = t.train_step(t.init_state(seed=0), packed)
            losses = [m["loss"]]
        else:
            m = t.train_step(t.init_states(seed=0), packed, packed)
            losses = [m["loss_denoise/train_a"], m["loss_denoise/train_b"]]
        assert all(torch.isfinite(v) for v in losses)
        return
    assert knob == dict(patchify_stem=2)
    t = cls(make_cfg(**knob), steps_per_epoch=1, image_size=64, device="cpu")
    u8 = torch.zeros((2, 64, 64, 3), dtype=torch.uint8)
    if trainer == "denoiser":
        state = t.init_state(seed=0)
        losses = [t.train_step(state, u8)["loss"]]
    else:
        states = t.init_states(seed=0)
        state = states["a"]
        m = t.train_step(states, u8, u8)
        losses = [m["loss_denoise/train_a"], m["loss_denoise/train_b"]]
    assert state.model.patch == 2
    assert next(iter(state.model.state_dict())).startswith("unet.encoder.")
    assert all(torch.isfinite(v) for v in losses)


def test_deep_fake_step_returns_image_panels():
    """``with_images``: the step returns its metrics and the uint8 panels
    under the JAX denoise-mode tags (their contents:
    tests/test_torch_port_serving.py)."""
    trainer = DeepFakeTrainer(_deep_fake_cfg(), steps_per_epoch=1,
                              image_size=32, device="cpu")
    states = trainer.init_states(seed=0)
    u8 = torch.zeros((2, 32, 32, 3), dtype=torch.uint8)
    metrics, panels = trainer.train_step(states, u8, u8, with_images=True)
    assert "loss_denoise/train_a" in metrics
    assert sorted(panels) == [f"denoise_{i}/{n}" for i in
                              ("1_model_input", "2_model_prediction")
                              for n in "ab"]
    assert all(p.dtype == torch.uint8 and p.shape == (36, 104, 3)
               for p in panels.values())


def test_learning_rate_follows_the_jax_schedule():
    for step in (0, 9, 10, 55, 999):
        got = learning_rate_at(step, 0.02, cosine_t_max=100,
                               steps_per_epoch=10)
        want = float(jax_cosine(0.02, 100, step // 10))
        # The JAX schedule is evaluated in fp32: an ulp of cos, ~1e-9 here.
        assert got == pytest.approx(want, rel=1e-6, abs=1e-9)
    assert learning_rate_at(5, 0.02, cosine_t_max=None,
                            steps_per_epoch=1) == 0.02


def test_adam_matches_optax_over_steps():
    rng = np.random.default_rng(0)
    p0 = rng.standard_normal((5, 7)).astype(np.float32)
    grads = [rng.standard_normal((5, 7)).astype(np.float32) * 10 ** -k
             for k in range(3)]
    tx = make_adam_with_cosine(0.01, b1=0.5, cosine_t_max=4,
                               steps_per_epoch=2, flatten=False)
    params = {"w": jnp.asarray(p0)}
    opt_state = tx.init(params)
    param = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = make_adam([param], 0.01, b1=0.5, device=torch.device("cpu"))
    for step, g in enumerate(grads):
        updates, opt_state = tx.update({"w": jnp.asarray(g)}, opt_state,
                                       params)
        params = optax.apply_updates(params, updates)
        param.grad = torch.from_numpy(g.copy())
        for group in opt.param_groups:
            group["lr"] = learning_rate_at(step, 0.01, cosine_t_max=4,
                                           steps_per_epoch=2)
        opt.step()
        np.testing.assert_allclose(param.detach().numpy(),
                                   np.asarray(params["w"]), rtol=1e-6,
                                   atol=1e-7)
    adam = opt_state[0]
    np.testing.assert_allclose(opt.state[param]["exp_avg"].numpy(),
                               np.asarray(adam.mu["w"]), rtol=1e-6)
    np.testing.assert_allclose(opt.state[param]["exp_avg_sq"].numpy(),
                               np.asarray(adam.nu["w"]), rtol=1e-6)


def test_entry_points_need_a_gpu_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DenoiserTrainer(_cfg(), steps_per_epoch=1, image_size=64)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    trainer = DenoiserTrainer(_cfg(), steps_per_epoch=1, image_size=64,
                              device="cpu")
    assert trainer.device == torch.device("cpu")


def test_non_cpu_tensors_never_reach_the_plain_version():
    img = torch.empty((1, 32, 3, 32), device="meta")
    alpha = torch.ones(1, device="meta")
    shift = torch.zeros((1, 32), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        warp_kernel.warp_axis_pass(img, alpha, shift)


_FORBIDDEN = re.compile(
    r"^(jax|jaxlib|flax|optax|orbax|denoising_diffusion_deep_fake_tpu)"
    r"(\.|$)")


def _imports(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


def test_port_imports_nothing_of_jax():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    bad = [(str(f.relative_to(ROOT)), name) for f in files
           for name in _imports(f) if _FORBIDDEN.match(name)]
    assert not bad, bad
    # Nor by a dynamic import of the names as strings.
    for f in files:
        text = f.read_text()
        assert not re.search(r"import_module\(\s*['\"](jax|flax|optax)",
                             text), f
