"""The port's resnet encoder family against the JAX package's, on the CPU.

* ``RESNET_SPECS`` is JAX's table, name for name.
* For the five names the JAX package's torch replica has, the port's
  U-Net has the replica's smp keys (less BN's ``num_batches_tracked``) at
  their shapes, built on the meta device; the parameter counts of all nine
  names are pinned (the other four against ``jax.eval_shape`` of JAX's
  U-Net).
* Bottleneck, ResNeXt and wide blocks: forward, backward and the BN running
  statistics of the encoder and of the U-Net in train mode, fp32, against
  JAX from the same weights (``utils/jax_weights.py``), within 1e-5 of each
  tensor's largest magnitude. The specs are cut to one block a stage and
  registered under new names in both packages' tables with
  ``monkeypatch.setitem`` (no JAX file changes); one real ``resnet50``
  U-Net runs an eval forward.
"""

import copy
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from denoising_diffusion_deep_fake_tpu.models import resnet as jax_resnet
from denoising_diffusion_deep_fake_tpu.models import create_unet as jax_unet
from denoising_diffusion_deep_fake_tpu.utils.torch_import import (
    convert_smp_unet_state_dict,
)
from denoising_diffusion_deep_fake_tpu.utils.torch_replica import (
    ENCODER_SPECS,
    UnetSMP,
    smp_named_state_dict,
)
from denoising_diffusion_deep_fake_tpu_torch.models import resnet
from denoising_diffusion_deep_fake_tpu_torch.models.unet import create_unet
from denoising_diffusion_deep_fake_tpu_torch.training.state import (
    param_count,
)
from denoising_diffusion_deep_fake_tpu_torch.utils.jax_weights import (
    state_dict_from_jax,
)

B, S = 2, 32
# The U-Net's parameter count for each name (smp's Unet with the default
# decoder): chip_smoke.py phase 14b holds the card's models to these.
PARAM_COUNTS = {
    "resnet18": 14_328_499,
    "resnet34": 24_436_659,
    "resnet50": 32_521_395,
    "resnet101": 51_513_523,
    "resnet152": 67_157_171,
    "resnext50_32x4d": 31_993_267,
    "resnext101_32x8d": 95_755_699,
    "wide_resnet50_2": 75_847_603,
    "wide_resnet101_2": 133_851_059,
}
# One block a stage, each spec's own geometry.
TINY = {
    "tiny_bottleneck": dict(kind="bottleneck", blocks=(1, 1, 1, 1),
                            expansion=4),
    "tiny_resnext": dict(kind="bottleneck", blocks=(1, 1, 1, 1),
                         expansion=4, groups=32, base_width=4),
    "tiny_wide": dict(kind="bottleneck", blocks=(1, 1, 1, 1), expansion=4,
                      base_width=128),
}


def test_specs_are_jax_specs():
    assert list(resnet.RESNET_SPECS) == list(jax_resnet.RESNET_SPECS)
    assert resnet.ResNetSpec._fields == jax_resnet.ResNetSpec._fields
    for name, spec in jax_resnet.RESNET_SPECS.items():
        assert tuple(resnet.RESNET_SPECS[name]) == tuple(spec), name
    assert set(PARAM_COUNTS) == set(resnet.RESNET_SPECS)


def _replica_shapes(name):
    """The replica's smp state_dict as shapes, built on the meta device
    (``smp_named_state_dict`` reads values, so it gets broadcast zeros)."""
    with torch.device("meta"):
        replica = UnetSMP(name)
    sd = replica.state_dict()
    shim = types.SimpleNamespace(state_dict=lambda: {
        k: torch.zeros((), dtype=v.dtype).expand(v.shape)
        for k, v in sd.items()})
    return {k: tuple(v.shape) for k, v in smp_named_state_dict(shim).items()}


@pytest.mark.parametrize("name", sorted(ENCODER_SPECS))
def test_unet_has_the_replica_keys_and_shapes(name):
    with torch.device("meta"):
        port = create_unet(name)
    want = {k: s for k, s in _replica_shapes(name).items()
            if not k.endswith("num_batches_tracked")}
    got = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert got == want
    assert param_count(port) == PARAM_COUNTS[name]
    expansion = resnet.RESNET_SPECS[name].expansion
    assert port.encoder.out_channels == (3, 64, 64 * expansion,
                                         128 * expansion, 256 * expansion,
                                         512 * expansion)


@pytest.mark.parametrize("name", sorted(set(resnet.RESNET_SPECS)
                                        - set(ENCODER_SPECS)))
def test_param_count_equals_jax(name):
    with torch.device("meta"):
        port = create_unet(name)
    shapes = jax.eval_shape(lambda: jax_unet(name).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=False))
    n_jax = sum(int(np.prod(v.shape))
                for v in jax.tree.leaves(shapes["params"]))
    assert param_count(port) == n_jax == PARAM_COUNTS[name]


def test_unknown_encoder_names_roadmap_a11():
    # Every family is ported, EfficientNet's too; an unknown name raises
    # and lists the names the port builds.
    with torch.device("meta"):
        assert create_unet("efficientnet-b0").encoder_name == \
            "efficientnet-b0"
    with pytest.raises(ValueError, match="efficientnet-b7"):
        create_unet("resnet19")


@pytest.fixture
def tiny_specs(monkeypatch):
    for name, fields in TINY.items():
        monkeypatch.setitem(jax_resnet.RESNET_SPECS, name,
                            jax_resnet.ResNetSpec(**fields))
        monkeypatch.setitem(resnet.RESNET_SPECS, name,
                            resnet.ResNetSpec(**fields))


def _close(got, want, rel, what):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * np.abs(want).max(), err_msg=what)


def _random_unet(name, seed, dtype=torch.float32):
    """The port's U-Net with its init's convolutions and random BN
    parameters and statistics; and the same weights as flax variables,
    carried by the JAX package's own importer (the port's keys are
    smp's)."""
    port = create_unet(name, dtype=dtype)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for key, value in port.state_dict().items():
            if value.dim() != 1 or key.startswith("segmentation_head"):
                continue
            spread = key.endswith(("weight", "running_var"))
            value.copy_((1.0 if spread else 0.0)
                        + (torch.rand(value.shape, generator=g) - 0.5)
                        * (1.0 if spread else 0.2))
    params, stats = convert_smp_unet_state_dict(
        {k: v.numpy() for k, v in port.state_dict().items()})
    return port, {"params": params, "batch_stats": stats}


def _check(got, want, what):
    _close(got.detach().numpy(), np.asarray(want), 1e-5, what)


@pytest.mark.parametrize("name", sorted(TINY))
def test_bottleneck_train_step_matches_jax(tiny_specs, name):
    """The encoder's features and the U-Net's output, gradients and new BN
    running statistics in train mode, float64 on both sides: in fp32 a
    step's gradients at a random point are not a smooth function of the
    weights at 64^2 x 2 (a maxpool or ReLU input within rounding of its
    switch moves a channel's gradient by whole percents: measured up to
    7% of a tensor's largest entry between the frameworks here, even with
    every BN bias raised by 1), so fp32 could only be held at searched
    points (test_torch_port_deep_fake.py). The port's BN takes its batch
    statistics in fp32 whatever the input (models/resnet.py), so the
    running statistics keep fp32's rounding; the U-Net returns fp32."""
    port, variables = _random_unet(name, seed=5, dtype=torch.float64)
    port = port.double()
    variables = jax.tree.map(lambda a: np.asarray(a, np.float64), variables)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((B, S, S, 3))
    cot = rng.standard_normal((B, S, S, 3)).astype(np.float32)
    with jax.enable_x64(True):
        flax_model = jax_unet(name, dtype=jnp.float64)

        def loss(params):
            out, mutated = flax_model.apply(
                {"params": params, "batch_stats": variables["batch_stats"]},
                x, train=True, mutable=["batch_stats", "intermediates"],
                capture_intermediates=lambda mdl, _: isinstance(
                    mdl, jax_resnet.ResNetEncoder))
            feats = mutated["intermediates"]["encoder"]["__call__"][0]
            return jnp.sum(out * cot), (out, feats, mutated["batch_stats"])

        (_, (want, feats, stats)), grads = jax.jit(jax.value_and_grad(
            loss, has_aux=True))(variables["params"])
    port.train()
    x_port = torch.from_numpy(x)
    with torch.no_grad():
        got = copy.deepcopy(port.encoder)(x_port.permute(0, 3, 1, 2))
    assert [g.shape[1] for g in got] == list(port.encoder.out_channels)
    assert len(got) == len(feats) == 6
    for i, (g, w) in enumerate(zip(got, feats)):
        _check(g.permute(0, 2, 3, 1), w, f"{name} feature {i}")
    out = port(x_port)
    (out * torch.from_numpy(cot)).sum().backward()
    _check(out, want, f"{name} output")
    sd, params = port.state_dict(), dict(port.named_parameters())
    n_grads = n_stats = 0
    for key, value in state_dict_from_jax(grads, stats).items():
        if "running" in key:
            n_stats += 1
            _check(sd[key], value, f"{name} {key}")
        else:
            n_grads += 1
            _check(params[key].grad, value, f"{name} grad {key}")
    assert n_grads == len(params)
    assert n_stats == 2 * sum(1 for k in sd if k.endswith("running_mean"))


def test_resnet50_eval_forward_matches_jax():
    port, variables = _random_unet("resnet50", seed=7)
    x = np.random.default_rng(8).standard_normal((B, 32, 32, 3)).astype(
        np.float32)
    flax_model = jax_unet("resnet50")
    want = jax.jit(lambda v, x: flax_model.apply(v, x, train=False))(
        variables, x)
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x))
    _check(got, want, "resnet50 eval forward")
