"""The port's U-Net vs the flax U-Net, from the same weights, in fp32.

Flax variables are shaped with ``jax.eval_shape`` and filled from a numpy
seed (a real ``init`` of the U-Net is slow on one CPU core), then carried
into the port with ``utils/jax_weights.py``. Tolerances: the forward is
held to 2e-4 of the output's largest magnitude and the BN running stats to
1e-5 relative: XLA and PyTorch sum the convolutions in other orders, and
train-mode BN renormalises each layer's small differences.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from denoising_diffusion_deep_fake_tpu.models import create_unet as jax_unet
from denoising_diffusion_deep_fake_tpu_torch.models.unet import create_unet
from denoising_diffusion_deep_fake_tpu_torch.training.state import (
    param_count,
)
from denoising_diffusion_deep_fake_tpu_torch.utils.jax_weights import (
    state_dict_from_jax,
)

ENCODER, B, S = "resnet18", 2, 64


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one thread: the test run's workers share the cores, and
    torch's own pool on each of them oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def random_flax_variables(model, size, seed):
    """Flax variables of ``model``'s shapes, filled from a numpy seed."""
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0),
                           jnp.zeros((1, size, size, 3)), train=False))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = jax.tree_util.keystr(path)
        if "kernel" in name:
            fan_in = int(np.prod(leaf.shape[:-1]))
            return rng.normal(0, np.sqrt(2.0 / fan_in), leaf.shape).astype(
                np.float32)
        if "'scale'" in name:
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        if "'var'" in name:
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        return rng.normal(0, 0.1, leaf.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def models():
    flax_model = jax_unet(ENCODER)
    variables = random_flax_variables(flax_model, S, seed=0)
    port = create_unet(ENCODER)
    port.load_state_dict(state_dict_from_jax(variables["params"],
                                             variables["batch_stats"]))
    x = np.random.default_rng(1).standard_normal((B, S, S, 3)).astype(
        np.float32)
    return flax_model, variables, port, x


def _close(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max())


def test_weights_cover_every_port_tensor(models):
    _, variables, port, _ = models
    sd = state_dict_from_jax(variables["params"], variables["batch_stats"])
    assert set(sd) == set(port.state_dict())
    n_flax = sum(int(np.prod(v.shape)) for v in
                 jax.tree.leaves(variables["params"]))
    assert param_count(port) == n_flax


def test_forward_eval_matches_flax(models):
    flax_model, variables, port, x = models
    want = flax_model.apply(variables, jnp.asarray(x), train=False)
    port.eval()
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.shape == (B, S, S, 3) and got.dtype == torch.float32
    _close(got.numpy(), want, 2e-4)


def test_forward_train_and_bn_stats_match_flax(models):
    flax_model, variables, port, x = models
    want, mutated = flax_model.apply(variables, jnp.asarray(x), train=True,
                                     mutable=["batch_stats"])
    sd_before = {k: v.clone() for k, v in port.state_dict().items()}
    port.train()
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    _close(got.numpy(), want, 2e-4)
    new_stats = state_dict_from_jax(variables["params"],
                                    mutated["batch_stats"])
    sd = port.state_dict()
    n_stats = 0
    for key, value in new_stats.items():
        if "running" in key:
            n_stats += 1
            np.testing.assert_allclose(sd[key].numpy(), value.numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=key)
    assert n_stats == 2 * sum(1 for k in sd if k.endswith("running_mean"))
    port.load_state_dict(sd_before)


def test_resnet34_has_the_reference_param_count():
    assert param_count(create_unet("resnet34")) == 24_436_659


def test_bf16_forward_casts_and_returns_fp32(models):
    _, _, port, x = models
    port16 = create_unet(ENCODER, dtype=torch.bfloat16)
    port16.load_state_dict(port.state_dict())
    port16.eval()
    with torch.no_grad():
        got = port16(torch.from_numpy(x))
        ref = port.eval()(torch.from_numpy(x))
    assert got.dtype == torch.float32
    # bf16 keeps ~3 significant digits through ~20 layers.
    _close(got.numpy(), ref.numpy(), 5e-2)


def test_unported_encoders_raise():
    # Every encoder family is ported (tests/test_torch_port_resnet_family.py,
    # tests/test_torch_port_encoder_*.py, tests/test_torch_port_efficientnet
    # .py): EfficientNet builds, and only an unknown name raises.
    with torch.device("meta"):
        assert create_unet("efficientnet-b0").drop_keep_probs()
    with pytest.raises(ValueError, match="unsupported encoder_name"):
        create_unet("efficientnet-b8")
