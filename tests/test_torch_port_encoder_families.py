"""The port's eight new encoder families against the JAX package's, on the
CPU: tables, keys and parameter counts.

* Names: each family's table is JAX's, name for name, and the port builds
  every JAX name (EfficientNet's: ``test_torch_port_efficientnet.py``).
* Keys and shapes: for all 28 names, on the meta device, the U-Net's
  state_dict equals the JAX package's torch replica's under smp's names
  (``smp_named_state_dict(UnetSMP(name))``) less BN's
  ``num_batches_tracked``; ``out_channels`` equals JAX's.
* Parameter counts: ``tests/test_models.py``'s pins, or ``jax.eval_shape``
  of JAX's U-Net for the names that file does not pin.

Initialisation and the weight carriers: ``test_torch_port_encoder_weights.py``;
forward and train steps: ``test_torch_port_encoder_steps.py`` and
``test_torch_port_encoder_blocks.py``.
"""

import functools
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from denoising_diffusion_deep_fake_tpu.models import create_unet as jax_unet
from denoising_diffusion_deep_fake_tpu.models import densenet as jax_densenet
from denoising_diffusion_deep_fake_tpu.models import dpn as jax_dpn
from denoising_diffusion_deep_fake_tpu.models import senet as jax_senet
from denoising_diffusion_deep_fake_tpu.models import unet as jax_unet_mod
from denoising_diffusion_deep_fake_tpu.models import vgg as jax_vgg
from denoising_diffusion_deep_fake_tpu.models.efficientnet import (
    EFFICIENTNET_SPECS,
)
from denoising_diffusion_deep_fake_tpu.utils.torch_replica import (
    UnetSMP,
    smp_named_state_dict,
)
from denoising_diffusion_deep_fake_tpu_torch.models import densenet, dpn
from denoising_diffusion_deep_fake_tpu_torch.models import senet, vgg
from denoising_diffusion_deep_fake_tpu_torch.models.resnet import (
    RESNET_SPECS,
)
from denoising_diffusion_deep_fake_tpu_torch.models.unet import (
    EFFICIENTNET_NAMES,
    create_unet,
    encoder_names,
)
from denoising_diffusion_deep_fake_tpu_torch.training.state import (
    param_count,
)

NEW_NAMES = [n for n in encoder_names()
             if n not in RESNET_SPECS and n not in EFFICIENTNET_NAMES]
# tests/test_models.py::test_vgg_mobilenet_param_count's pins.
PINNED = {
    "vgg11": 18_254_323, "vgg16": 23_748_531, "vgg19": 29_058_227,
    "vgg16_bn": 23_756_979, "mobilenet_v2": 6_629_235,
    "densenet121": 13_607_923, "densenet161": 38_738_611,
    "densenet169": 21_202_931, "densenet201": 28_580_851,
    "se_resnet50": 35_052_387, "se_resnet101": 56_291_235,
    "se_resnet152": 73_786_211, "se_resnext50_32x4d": 34_524_259,
    "se_resnext101_32x4d": 55_919_779, "senet154": 122_071_779,
    "xception": 28_769_691, "inceptionv4": 48_792_211,
    "inceptionresnetv2": 62_029_587, "dpn68": 16_951_773,
    "dpn68b": 16_951_773, "dpn92": 46_951_091,
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_family_tables_are_jax_tables():
    assert vgg.VGG_SPECS == jax_vgg.VGG_SPECS
    assert densenet.DENSENET_SPECS == jax_densenet.DENSENET_SPECS
    assert senet.SENetSpec._fields == jax_senet.SENetSpec._fields
    assert {k: tuple(v) for k, v in senet.SENET_SPECS.items()} == \
        {k: tuple(v) for k, v in jax_senet.SENET_SPECS.items()}
    assert dpn.DPNSpec._fields == jax_dpn.DPNSpec._fields
    assert {k: tuple(v) for k, v in dpn.DPN_SPECS.items()} == \
        {k: tuple(v) for k, v in jax_dpn.DPN_SPECS.items()}
    assert set(EFFICIENTNET_NAMES) == set(EFFICIENTNET_SPECS)
    # Every name JAX's make_encoder builds, less EfficientNet's.
    jax_names = set()
    for name in (list(jax_vgg.VGG_SPECS) + list(jax_densenet.DENSENET_SPECS)
                 + list(jax_senet.SENET_SPECS) + list(jax_dpn.DPN_SPECS)
                 + ["mobilenet_v2", "xception", "inceptionv4",
                    "inceptionresnetv2"] + list(EFFICIENTNET_SPECS)):
        jax_unet_mod.make_encoder(name)
        jax_names.add(name)
    assert set(NEW_NAMES) == jax_names - set(EFFICIENTNET_SPECS)
    assert len(NEW_NAMES) == 28
    # Every JAX name builds in the port, EfficientNet's too.
    assert set(encoder_names()) == jax_names | set(RESNET_SPECS)
    for name in EFFICIENTNET_NAMES:
        with torch.device("meta"):
            assert create_unet(name).encoder.encoder_name == name
    with pytest.raises(ValueError, match="unsupported encoder_name"):
        create_unet("vgg17")


def _replica_shapes(name):
    """The replica's smp state_dict as shapes, built on the meta device
    (``smp_named_state_dict`` reads values, so it gets broadcast zeros)."""
    with torch.device("meta"):
        replica = UnetSMP(name)
    sd = replica.state_dict()
    shim = types.SimpleNamespace(state_dict=lambda: {
        k: torch.zeros((), dtype=v.dtype).expand(v.shape)
        for k, v in sd.items()})
    return {k: tuple(v.shape) for k, v in smp_named_state_dict(shim).items()
            if not k.endswith("num_batches_tracked")}


@pytest.mark.parametrize("name", NEW_NAMES)
def test_unet_has_smp_keys_shapes_and_jax_channels(name):
    with torch.device("meta"):
        port = create_unet(name)
    got = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert got == _replica_shapes(name)
    jax_encoder = jax_unet_mod.make_encoder(name)
    assert tuple(port.encoder.out_channels) == tuple(
        jax_encoder.out_channels)
    assert (port.decoder.center is not None) == name.startswith("vgg")


@functools.lru_cache(maxsize=None)
def _jax_param_count(name):
    shapes = jax.eval_shape(lambda: jax_unet(name).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=False))
    return sum(int(np.prod(v.shape))
               for v in jax.tree.leaves(shapes["params"]))


@pytest.mark.parametrize("name", NEW_NAMES)
def test_param_count_is_pinned_or_jax(name):
    with torch.device("meta"):
        port = create_unet(name)
    want = PINNED[name] if name in PINNED else _jax_param_count(name)
    assert param_count(port) == want
