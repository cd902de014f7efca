"""The port's new encoder families with a spec table compute what the JAX
package's do, on the CPU, from the same weights (the JAX package's own
importer turns the port's smp-named weights into flax variables).

vgg, densenet, senet and dpn: a U-Net train step (encoder features,
output, every gradient, the new BN running statistics) in float64 on both
sides against JAX's, each spec cut to one block a stage and registered
under a new name in both packages' tables with ``monkeypatch.setitem`` (no
JAX file changes): a vgg ``_bn`` layout, densenet121's growth,
se_resnext50_32x4d's wiring (the SE module, the grouped 3x3, the ceil-mode
stem pool) and dpn68b's (the ``b=True`` split of ``c1x1_c``). senet154's
bottleneck steps in ``test_torch_port_encoder_blocks.py``. The fixed architectures are
``test_torch_port_encoder_blocks.py``'s.

Tolerance: 1e-5 of each tensor's largest magnitude, as in
``test_torch_port_resnet_family.py``, which says why train steps are held
in float64 (fp32 gradients at a random point are not smooth enough for
1e-5 between the frameworks).
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from denoising_diffusion_deep_fake_tpu.models import create_unet as jax_unet
from denoising_diffusion_deep_fake_tpu.models import densenet as jax_densenet
from denoising_diffusion_deep_fake_tpu.models import dpn as jax_dpn
from denoising_diffusion_deep_fake_tpu.models import senet as jax_senet
from denoising_diffusion_deep_fake_tpu.models import vgg as jax_vgg
from denoising_diffusion_deep_fake_tpu.utils.torch_import import (
    convert_smp_unet_state_dict,
)
from denoising_diffusion_deep_fake_tpu_torch.models import densenet, dpn
from denoising_diffusion_deep_fake_tpu_torch.models import senet, vgg
from denoising_diffusion_deep_fake_tpu_torch.models.unet import (
    create_unet,
    init_unet_,
)

B, S = 2, 32
F64 = jnp.float64
_VGG_TINY = (64, "M", 128, "M", 256, "M", 512, "M", 512, "M")
# name: (the two packages' table modules and table name, each package's
# spec, JAX's encoder class).
TINY = {
    "vgg_tiny_bn": (jax_vgg, vgg, "VGG_SPECS", lambda m: (_VGG_TINY, True),
                    jax_vgg.VGGEncoder),
    "densenet_tiny": (jax_densenet, densenet, "DENSENET_SPECS",
                      lambda m: ((1, 1, 1, 1), 32, 64),
                      jax_densenet.DenseNetEncoder),
    "se_resnext50_tiny": (jax_senet, senet, "SENET_SPECS",
                          lambda m: m.SENetSpec("se_resnext", (1, 1, 1, 1),
                                                groups=32),
                          jax_senet.SENetEncoder),
    # dpn68b's widths, one block a stage: each stage's output is
    # bw + 3 inc channels.
    "dpn68b_tiny": (jax_dpn, dpn, "DPN_SPECS",
                    lambda m: m.DPNSpec(
                        (4, 5, 6, 7), (3, 10, 112, 224, 352, 704), True, 10,
                        128, 32, True, (1, 1, 1, 1), (16, 32, 32, 64)),
                    jax_dpn.DPNEncoder),
}


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


def _leaves(tree, path=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, path + (key,))
        else:
            yield path + (key,), value


def _carried(grads, stats, sd):
    """The flax gradients and statistics under the port's keys: each
    module's keys, each filled with its own number, through the JAX
    package's importer (the weights file holds the port's own carrier
    against that importer)."""
    trees = {"params": grads, "batch_stats": stats}
    modules = {}
    for key in sd:
        modules.setdefault(key.rsplit(".", 1)[0], []).append(key)
    out = {}
    for keys in modules.values():
        params, stat = convert_smp_unet_state_dict(
            {k: np.full(sd[k].shape, i, np.float64)
             for i, k in enumerate(keys)})
        for tree, converted in (("params", params), ("batch_stats", stat)):
            for path, marked in _leaves(converted):
                leaf = trees[tree]
                for k in path:
                    leaf = leaf[k]
                leaf = np.array(leaf)
                out[keys[int(np.ravel(marked)[0])]] = torch.from_numpy(
                    leaf.transpose(3, 2, 0, 1).copy() if leaf.ndim == 4
                    else leaf)
    return {k: out[k] for k in sd}


@pytest.mark.parametrize("name", sorted(TINY))
def test_tiny_family_train_step_matches_jax(monkeypatch, name):
    jax_table, port_table, table, spec, encoder_cls = TINY[name]
    monkeypatch.setitem(getattr(jax_table, table), name, spec(jax_table))
    monkeypatch.setitem(getattr(port_table, table), name, spec(port_table))
    port, variables = _random_unet(name, seed=11, dtype=torch.float64)
    rng = np.random.default_rng(12)
    x = rng.standard_normal((B, S, S, 3))
    cot = rng.standard_normal((B, S, S, 3))
    with jax.enable_x64(True):
        flax_model = jax_unet(name, dtype=F64)

        def loss(params):
            out, mutated = flax_model.apply(
                {"params": params, "batch_stats": variables["batch_stats"]},
                x, train=True, mutable=["batch_stats", "intermediates"],
                capture_intermediates=lambda mdl, _: isinstance(
                    mdl, encoder_cls))
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
        _close(g.permute(0, 2, 3, 1), w, f"{name} feature {i}")
    out = port(x_port)
    (out * torch.from_numpy(cot)).sum().backward()
    _close(out, want, f"{name} output")
    sd, params = port.state_dict(), dict(port.named_parameters())
    carried = _carried(grads, stats, sd)
    # A conv bias under a train-mode BN (the vgg _bn forms) has a zero
    # gradient but for rounding: both sides must be below 1e-9 of the
    # model's largest gradient there, where 1e-5 of the tensor's own
    # largest entry would hold rounding noise against rounding noise.
    floor = 1e-9 * max(np.abs(v.numpy()).max() for k, v in carried.items()
                       if "running" not in k)
    n_grads = n_stats = 0
    for key, value in carried.items():
        if "running" in key:
            n_stats += 1
            _close(sd[key], value, f"{name} {key}")
            continue
        n_grads += 1
        got = params[key].grad
        if value.abs().max() < floor:
            assert got.abs().max() < floor, f"{name} grad {key}"
        else:
            _close(got, value, f"{name} grad {key}")
    assert n_grads == len(params)
    assert n_stats == 2 * sum(1 for k in sd if k.endswith("running_mean"))


