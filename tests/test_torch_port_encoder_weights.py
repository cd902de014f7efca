"""The port's eight new encoder families against the JAX package's, on the
CPU: initialisation and the weight carriers.

* Init: one name a family, every conv tensor of 4096 elements or more
  within 5% of the JAX family initializer's standard deviation, uniform
  tensors inside their bound, BN ones and zeros.
* Weight carriers: the probe inversion (``state_dict_from_jax_any``)
  equals the handwritten resnet map bit for bit on resnet34; for one name
  a family, JAX variables (the JAX package's own importer of random port
  weights) -> the port -> a reference ``.ckpt`` -> the port is bit-equal.
"""

import functools
import math
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from denoising_diffusion_deep_fake_tpu.models import densenet as jax_densenet
from denoising_diffusion_deep_fake_tpu.models import dpn as jax_dpn
from denoising_diffusion_deep_fake_tpu.models import senet as jax_senet
from denoising_diffusion_deep_fake_tpu.models import vgg as jax_vgg
from denoising_diffusion_deep_fake_tpu.utils import torch_import as jax_import
from denoising_diffusion_deep_fake_tpu_torch.models.resnet import (
    BatchNorm2d,
    Conv2d,
)
from denoising_diffusion_deep_fake_tpu_torch.models.unet import (
    create_unet,
    init_unet_,
)
from denoising_diffusion_deep_fake_tpu_torch.utils.jax_weights import (
    state_dict_from_jax,
    state_dict_from_jax_any,
)
from denoising_diffusion_deep_fake_tpu_torch.utils.torch_export import (
    export_unet_state_dict,
)
from denoising_diffusion_deep_fake_tpu_torch.utils.torch_import import (
    load_reference_checkpoint,
)

# One name a family, the smallest: init and the weight round trip.
ONE_A_FAMILY = ("vgg11", "mobilenet_v2", "densenet121", "se_resnet50",
                "xception", "inceptionv4", "inceptionresnetv2", "dpn68")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tmp_path(tmp_path):
    """pytest's, emptied after the test: each name's reference
    checkpoint and its conversions weigh 66-243 MB."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)
    _initialised.cache_clear()


@functools.lru_cache(maxsize=None)
def _initialised(name):
    """The port's ``init_unet_`` of ``name``, then random BN statistics
    (``init_unet_`` leaves them 0 and 1)."""
    model = init_unet_(create_unet(name), torch.Generator().manual_seed(3))
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for key, value in model.state_dict().items():
            if key.endswith("running_mean"):
                value.copy_(torch.randn(value.shape, generator=g) * 0.1)
            elif key.endswith("running_var"):
                value.copy_(1 + torch.rand(value.shape, generator=g))
    return model


# Each JAX family's encoder initializer (models/*.py ``_conv_init``), as
# the standard deviation for a conv's fan-in and fan-out, and whether it
# draws from a uniform: variance_scaling(2, fan_out, normal) for vgg,
# mobilenet and xception (Cadene's N(0, sqrt(2/(k*k*out)))),
# variance_scaling(2, fan_in, normal) for densenet, and torch's default
# variance_scaling(1/3, fan_in, uniform) for the others.
FAMILY_INIT = {
    "vgg11": (lambda fi, fo: math.sqrt(2 / fo), False),
    "mobilenet_v2": (lambda fi, fo: math.sqrt(2 / fo), False),
    "xception": (lambda fi, fo: math.sqrt(2 / fo), False),
    "densenet121": (lambda fi, fo: math.sqrt(2 / fi), False),
    "se_resnet50": (lambda fi, fo: math.sqrt(1 / (3 * fi)), True),
    "inceptionv4": (lambda fi, fo: math.sqrt(1 / (3 * fi)), True),
    "inceptionresnetv2": (lambda fi, fo: math.sqrt(1 / (3 * fi)), True),
    "dpn68": (lambda fi, fo: math.sqrt(1 / (3 * fi)), True),
}


@pytest.mark.parametrize("name", ONE_A_FAMILY)
def test_init_is_the_jax_family_initializer(name):
    std_of, uniform = FAMILY_INIT[name]
    model = _initialised(name)
    checked = 0
    for mname, module in model.named_modules():
        if isinstance(module, BatchNorm2d):
            assert torch.equal(module.weight, torch.ones_like(module.weight))
            assert torch.equal(module.bias, torch.zeros_like(module.bias))
            continue
        if not isinstance(module, Conv2d):
            continue
        w = module.weight
        o, i_per_group, kh, kw = w.shape
        fan_in, fan_out = i_per_group * kh * kw, o * kh * kw
        if mname.startswith("encoder"):
            std, bounded = std_of(fan_in, fan_out), uniform
        elif mname.startswith("decoder"):       # He-uniform fan-in
            std, bounded = math.sqrt(2 / fan_in), True
        else:                                   # xavier-uniform head
            std, bounded = math.sqrt(2 / (fan_in + fan_out)), True
        if bounded:
            assert w.abs().max() <= math.sqrt(3) * std * (1 + 1e-6), mname
        if w.numel() >= 4096:
            assert abs(w.std().item() / std - 1) < 0.05, mname
            checked += 1
        if module.bias is not None:
            if mname.startswith("encoder") and uniform:
                # torch's default bias: uniform(+-1/sqrt(fan_in)).
                assert module.bias.abs().max() <= 1 / math.sqrt(fan_in)
                assert module.bias.abs().max() > 0
            else:
                assert not module.bias.any(), mname
    assert checked > 10
    # The same standard deviation from the JAX module's own initializer.
    jax_module = {"vgg11": jax_vgg, "densenet121": jax_densenet,
                  "se_resnet50": jax_senet, "dpn68": jax_dpn}.get(name)
    if jax_module is not None:
        k = jax_module._conv_init(jax.random.PRNGKey(0), (3, 3, 64, 128))
        assert abs(float(jnp.std(k)) / std_of(9 * 64, 9 * 128) - 1) < 0.02


def _jax_variables(sd):
    """Flax variables of the port's weights by the JAX package's own
    importer (the port's keys are smp's)."""
    return jax_import.convert_smp_unet_state_dict(
        {k: v.numpy() for k, v in sd.items()})


def test_probe_inversion_equals_the_handwritten_resnet_map():
    model = init_unet_(create_unet("resnet34"),
                       torch.Generator().manual_seed(5))
    params, stats = _jax_variables(model.state_dict())
    handwritten = state_dict_from_jax(params, stats)
    probed = state_dict_from_jax_any(params, stats, "resnet34")
    assert list(probed) == list(model.state_dict())
    assert set(handwritten) == set(probed)
    for key, value in handwritten.items():
        assert torch.equal(value, probed[key]), key
    # Gradients: params only, no statistics.
    grads = state_dict_from_jax_any(params, {}, "resnet34")
    assert set(grads) == {k for k in handwritten if "running" not in k}


@pytest.mark.parametrize("name", ONE_A_FAMILY)
def test_jax_to_port_to_reference_ckpt_round_trip(tmp_path, name):
    sd = _initialised(name).state_dict()
    params, stats = _jax_variables(sd)
    carried = state_dict_from_jax(params, stats, name)
    assert list(carried) == list(sd)
    for key, value in carried.items():
        assert torch.equal(value, sd[key]), key
    exported = export_unet_state_dict(carried, name)
    n_bn = sum(1 for k in sd if k.endswith("running_mean"))
    assert len(exported) == len(sd) + n_bn
    ckpt = tmp_path / "last.ckpt"
    torch.save({"state_dict": {f"model_a.{k}": v
                               for k, v in exported.items()},
                "hyper_parameters": {"encoder_name": name},
                "epoch": 1, "global_step": 2}, ckpt)
    back = load_reference_checkpoint(ckpt)["model_a"]
    assert list(back) == list(sd)
    for key, value in back.items():
        assert torch.equal(value, sd[key]), key
    with pytest.raises(ValueError, match="not a leaf"):
        state_dict_from_jax(dict(params, bogus={"kernel": np.zeros(1)}),
                            stats, name)
