"""The port's fixed-architecture encoders compute what the JAX package's
do, on the CPU, from the same weights (the JAX package's own importer
turns the port's smp-named weights into flax variables).

* mobilenet_v2, xception, inceptionv4, inceptionresnetv2: the whole
  U-Net's eval forward and its encoder's six levels in fp32.
* Train steps of sub-modules against the JAX sub-modules in float64
  (output, input gradient, every weight's gradient, the new BN running
  statistics): an InvertedResidual; an Xception ``Block`` with
  ``start_with_relu=False``; Inception_A, Reduction_A, Inception_B and
  Inception_C; block35, block17 and the final block8 without its ReLU;
  the SE-Net bottlenecks of se_resnet (the stride on the 1x1 ``conv1``)
  and senet154 (64 groups, the 3x3 downsample).

Tolerance: 1e-5 of each tensor's largest magnitude, as in
``test_torch_port_resnet_family.py``.
"""

import copy
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from denoising_diffusion_deep_fake_tpu.models import create_unet as jax_unet
from denoising_diffusion_deep_fake_tpu.models import (
    inceptionresnetv2 as jax_irv2,
)
from denoising_diffusion_deep_fake_tpu.models import inceptionv4 as jax_iv4
from denoising_diffusion_deep_fake_tpu.models import mobilenet as jax_mobile
from denoising_diffusion_deep_fake_tpu.models import senet as jax_senet
from denoising_diffusion_deep_fake_tpu.models import xception as jax_xception
from denoising_diffusion_deep_fake_tpu.utils.torch_import import (
    convert_smp_unet_state_dict,
)
from denoising_diffusion_deep_fake_tpu_torch.models import inceptionresnetv2
from denoising_diffusion_deep_fake_tpu_torch.models import inceptionv4
from denoising_diffusion_deep_fake_tpu_torch.models import mobilenet, senet
from denoising_diffusion_deep_fake_tpu_torch.models import xception
from denoising_diffusion_deep_fake_tpu_torch.models.unet import (
    create_unet,
    init_unet_,
)

B, S = 2, 32
F64 = jnp.float64


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=1e-5 * np.abs(want).max(), err_msg=what)


def _random_unet(name, seed, dtype=torch.float32):
    """The port's U-Net with its init's convolutions and random BN
    parameters and statistics (and SE or up-projection biases), and the
    same weights as flax variables by the JAX package's importer."""
    port = init_unet_(create_unet(name, dtype=dtype),
                      torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for key, value in port.state_dict().items():
            if value.dim() != 1 or key.startswith("segmentation_head"):
                continue
            spread = key.endswith(("weight", "running_var"))
            value.copy_((1.0 if spread else 0.0)
                        + (torch.rand(value.shape, generator=g) - 0.5)
                        * (1.0 if spread else 0.2))
    if dtype == torch.float64:
        port = port.double()
    params, stats = convert_smp_unet_state_dict(
        {k: v.numpy() for k, v in port.state_dict().items()})
    return port, {"params": params, "batch_stats": stats}


ENCODERS = {"mobilenet_v2": jax_mobile.MobileNetV2Encoder,
            "xception": jax_xception.XceptionEncoder,
            "inceptionv4": jax_iv4.InceptionV4Encoder,
            "inceptionresnetv2": jax_irv2.InceptionResNetV2Encoder}


@pytest.mark.parametrize("name", sorted(ENCODERS))
def test_fixed_architecture_eval_matches_jax(name):
    """The whole U-Net in eval, fp32: the encoder's six levels and the
    output."""
    port, variables = _random_unet(name, seed=13)
    x = np.random.default_rng(14).standard_normal((1, S, S, 3)).astype(
        np.float32)
    flax_model = jax_unet(name)

    def apply(v, x):
        out, mutated = flax_model.apply(
            v, x, train=False, mutable=["intermediates"],
            capture_intermediates=lambda mdl, _: isinstance(
                mdl, ENCODERS[name]))
        return out, mutated["intermediates"]["encoder"]["__call__"][0]

    want, feats = jax.jit(apply)(variables, x)
    port.eval()
    x_port = torch.from_numpy(x)
    with torch.no_grad():
        got = port.encoder(x_port.permute(0, 3, 1, 2))
        out = port(x_port)
    assert len(got) == len(feats) == 6
    for i, (g, w) in enumerate(zip(got, feats)):
        _close(g.permute(0, 2, 3, 1), w, f"{name} feature {i}")
    _close(out, want, f"{name} eval forward")


# case: (the smp prefix of the sub-module in its U-Net, the port module,
# the JAX module, the input's NCHW shape). Under ``jax.jit`` JAX cannot
# differentiate its count-map average pool (``avg_pool_3x3_no_pad_count``:
# its ``reduce_window`` gets a traced zero as its initial value, so it is
# not the differentiable window sum), so the Inception_A/B/C cases, whose
# input goes straight into that pool, hold the weights' gradients only.
NO_INPUT_GRAD = {"inception_a", "inception_b", "inception_c"}
SUBMODULES = {
    "inverted_residual": (
        "encoder.features.3.", lambda: mobilenet.InvertedResidual(24, 24, 1, 6),
        lambda: jax_mobile.InvertedResidual(24, strides=1, expand_ratio=6,
                                            dtype=F64), (B, 24, 16, 16)),
    "xception_block1": (
        "encoder.block1.",
        lambda: xception.XceptionBlock(64, 128, 2, 2, start_with_relu=False),
        lambda: jax_xception.XceptionBlock(64, 128, 2, 2,
                                           start_with_relu=False, dtype=F64),
        (B, 64, 16, 16)),
    "inception_a": (
        "encoder.features.6.", lambda: inceptionv4.Mixed("inception_a"),
        lambda: jax_iv4._Branches("inception_a", dtype=F64), (B, 384, 8, 8)),
    "reduction_a": (
        "encoder.features.10.", lambda: inceptionv4.Mixed("reduction_a"),
        lambda: jax_iv4._Branches("reduction_a", dtype=F64), (B, 384, 8, 8)),
    "inception_b": (
        "encoder.features.11.", lambda: inceptionv4.Mixed("inception_b"),
        lambda: jax_iv4._Branches("inception_b", dtype=F64),
        (B, 1024, 4, 4)),
    "inception_c": (
        "encoder.features.19.", lambda: inceptionv4.Mixed("inception_c"),
        lambda: jax_iv4._Branches("inception_c", dtype=F64),
        (B, 1536, 4, 4)),
    "block35": (
        "encoder.repeat.0.",
        lambda: inceptionresnetv2.ResidualBlock("block35", 0.17),
        lambda: jax_irv2.ResidualBlock("block35", 0.17, dtype=F64),
        (B, 320, 8, 8)),
    "block17": (
        "encoder.repeat_1.0.",
        lambda: inceptionresnetv2.ResidualBlock("block17", 0.10),
        lambda: jax_irv2.ResidualBlock("block17", 0.10, dtype=F64),
        (B, 1088, 4, 4)),
    "block8_no_relu": (
        "encoder.block8.",
        lambda: inceptionresnetv2.ResidualBlock("block8", 1.0, relu=False),
        lambda: jax_irv2.ResidualBlock("block8", 1.0, relu=False,
                                       dtype=F64), (B, 2080, 4, 4)),
    "se_resnet_bottleneck": (
        "encoder.layer2.0.",
        lambda: senet.SEBottleneck(256, 128, "se_resnet", 2),
        lambda: jax_senet.SEBottleneckBlock(128, "se_resnet", 2, dtype=F64),
        (B, 256, 8, 8)),
    "senet154_bottleneck": (
        "encoder.layer2.0.",
        lambda: senet.SEBottleneck(256, 128, "se_bottleneck", 2, groups=64,
                                   downsample_3x3=True),
        lambda: jax_senet.SEBottleneckBlock(128, "se_bottleneck", 2,
                                            groups=64, downsample_3x3=True,
                                            dtype=F64), (B, 256, 8, 8)),
}


def _leaf(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _flax_leaves(sd, prefix):
    """Each port key's flax leaf, ``(tree, path in the sub-module)``, by
    the JAX package's importer of the key alone."""
    out = {}
    for key, value in sd.items():
        params, stats = convert_smp_unet_state_dict(
            {prefix + key: np.zeros(value.shape)})
        tree, node = ("params", params) if params else ("batch_stats", stats)
        path = []
        while isinstance(node, dict):
            (k, node), = node.items()
            path.append(k)
        out[key] = (tree, tuple(path[2:]))  # less "encoder", the module
    return out


@pytest.mark.parametrize("case", list(SUBMODULES))
def test_submodule_train_step_matches_jax(case):
    prefix, make_port, make_jax, shape = SUBMODULES[case]
    port = make_port().double().train()
    g = torch.Generator().manual_seed(15)
    with torch.no_grad():
        for key, value in port.state_dict().items():
            if value.dim() == 4:
                value.copy_(torch.randn(value.shape, generator=g,
                                        dtype=value.dtype)
                            / math.sqrt(value[0].numel()))
            else:
                spread = key.endswith(("weight", "running_var"))
                value.copy_((1.0 if spread else 0.0)
                            + (torch.rand(value.shape, generator=g,
                                          dtype=value.dtype) - 0.5)
                            * (1.0 if spread else 0.2))
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    leaves = _flax_leaves(sd, prefix)
    params, stats = convert_smp_unet_state_dict(
        {prefix + k: v for k, v in sd.items()})
    name = prefix.split(".")[1:-1]
    name = "_".join(name)
    params, stats = params["encoder"][name], stats["encoder"][name]
    rng = np.random.default_rng(16)
    x = rng.standard_normal(shape)
    with torch.no_grad():
        out_shape = copy.deepcopy(port)(torch.from_numpy(x)).shape
    cot = rng.standard_normal(out_shape)
    to_nhwc = (0, 2, 3, 1)
    with jax.enable_x64(True):
        module = make_jax()

        def loss(params, x):
            out, mutated = module.apply(
                {"params": params, "batch_stats": stats}, x, train=True,
                mutable=["batch_stats"])
            return (jnp.sum(out * cot.transpose(to_nhwc)),
                    (out, mutated["batch_stats"]))

        argnums = 0 if case in NO_INPUT_GRAD else (0, 1)
        (_, (want, new_stats)), grads = jax.jit(
            jax.value_and_grad(loss, argnums=argnums, has_aux=True))(
                params, x.transpose(to_nhwc))
    x_port = torch.from_numpy(x).requires_grad_(True)
    out = port(x_port)
    (out * torch.from_numpy(cot)).sum().backward()
    _close(out.permute(to_nhwc), want, f"{case} output")
    if case not in NO_INPUT_GRAD:
        grads, grad_x = grads
        _close(x_port.grad.permute(to_nhwc), grad_x, f"{case} input "
               "gradient")
    named = dict(port.named_parameters())
    trees = {"params": grads, "batch_stats": new_stats}
    for key, value in port.state_dict().items():
        tree, path = leaves[key]
        want_v = np.asarray(_leaf(trees[tree], path))
        got_v = named[key].grad if tree == "params" else value
        if want_v.ndim == 4:
            want_v = want_v.transpose(3, 2, 0, 1)
        _close(got_v, want_v, f"{case} {key}")
