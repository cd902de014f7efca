"""Spatial parallelism (``spatial_parallel > 1``) for the nine encoder
families beside resnet and the patchified U-Net, on the CPU.

In one process:

* the halo geometry of every op these families add to resnet's
  (``parallel/halo.py``): TF "same" convs (3x3 and 5x5, stride 1 and 2,
  their pads asymmetric at the extents used), SENet's ceil-mode stem pool,
  the inceptions' count-excluding 3x3 average pool, 3/2/1 and 3/1/1 max
  pools, 2x2 average and max pools, 7x1 and 3x1 convs and the
  squeeze-excite mean: a tensor cut into S row blocks, each through the
  port's own module or function with its true neighbour rows (the
  exchange and the spatial sum done in-process), against the op on the
  whole tensor, to 1e-12;
* every encoder name of the port, and ``patchify_stem: 2``, builds a
  spatial trainer in a stand-in group of two.

Across spawned gloo ranks of ``torch_port_spatial_worker.py`` (``file://``
stores, float64 U-Nets, as ``test_torch_port_spatial.py``): a denoiser
step at 64^2 over spatial 2 (global batch 2) for one name of each family
(for xception and inceptionresnetv2, the two largest, whose ops the
others step through, a train-mode forward and its loss) and resnet18
with ``patchify_stem: 2``; efficientnet-b0,
se_resnext50_32x4d and inceptionv4 at 32^2, where the deepest levels are
gathered and run replicated; efficientnet-b0's swap pair (against one
process with its loss in the ranks' row shares) and balancer; b0 at data
2 x spatial 2. Each against the one-process step at
``test_torch_port_spatial.py``'s tolerances (the loss 1e-5 relative;
gradients, BN buffers, Adam moments and shadows 1e-5 of each tensor's
largest; weights by Adam's first-step rule), the ranks' states equal.
The one-process steps are held against JAX by the families' own tests
(``test_torch_port_encoder_steps.py``, ``test_torch_port_efficientnet.py``,
``test_torch_port_patchify.py``); here efficientnet-b0 and the patchified
resnet18
over spatial 2 are also held against JAX's (1, 2) CPU mesh forward and
its loss directly. The census of b0's spatial step counts its
squeeze-excite sums.

Ranks 2 and 3, out of any group after the data 2 x spatial 2 step, take
turns at the one-process references while ranks 0 and 1 run the spatial
steps; the test compares each case as soon as both are written and
deletes them (an inceptionresnetv2 step's tensors are ~1 GB in fp32).
"""

import os
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from denoising_diffusion_deep_fake_tpu.models import create_unet as jax_unet
from denoising_diffusion_deep_fake_tpu.models import (
    efficientnet as jax_eff,
)
from denoising_diffusion_deep_fake_tpu.ops.losses import (
    mse_ssim_loss as jax_loss,
)
from denoising_diffusion_deep_fake_tpu.parallel import create_mesh
from denoising_diffusion_deep_fake_tpu.parallel.mesh import (
    batch_sharding,
    replicated_sharding,
)
from denoising_diffusion_deep_fake_tpu_torch import config
from denoising_diffusion_deep_fake_tpu_torch.models import efficientnet
from denoising_diffusion_deep_fake_tpu_torch.models.resnet import (
    Conv2d,
    avg_pool2d,
    max_pool2d,
)
from denoising_diffusion_deep_fake_tpu_torch.models.unet import (
    drop_keep_probs,
    encoder_names,
)
from denoising_diffusion_deep_fake_tpu_torch.parallel import halo
from denoising_diffusion_deep_fake_tpu_torch.training.denoiser import (
    DenoiserTrainer,
)
from denoising_diffusion_deep_fake_tpu_torch.utils.jax_weights import (
    state_dict_from_jax,
)

from test_torch_port_efficientnet import _Jax, _Random
from test_torch_port_model import random_flax_variables
from test_torch_port_parallel import fake_group
from test_torch_port_spatial import _emulated_exchange, _mesh
import torch_port_spatial_worker as worker

RANK_TIMEOUT_S = 240


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------ the halo geometry


def _same(k: int, s: int, groups: int = 1):
    conv = efficientnet.SameConv2d(8, 8, k, s, groups=groups, bias=False)
    conv.weight.data = conv.weight.data.double()
    return conv


def _conv(kernel, padding):
    conv = Conv2d(8, 8, kernel, 1, padding, bias=False)
    conv.weight.data = conv.weight.data.double()
    return conv


# Each op as the port's model calls it, on NCHW float64: the whole tensor
# outside a layout, a rank's rows inside one.
OPS = {
    "same3x3_stride2": _same(3, 2),
    "same5x5_stride2_depthwise": _same(5, 2, groups=8),
    "same3x3": _same(3, 1),
    "same5x5_depthwise": _same(5, 1, groups=8),
    "maxpool3x3_stride2_ceil": lambda x: max_pool2d(x, 3, 2, 0,
                                                    ceil_mode=True),
    "avgpool3x3_count_excluding": lambda x: avg_pool2d(
        x, 3, 1, 1, count_include_pad=False),
    "maxpool3x3_stride2": lambda x: max_pool2d(x, 3, 2, 1),
    "maxpool3x3": lambda x: max_pool2d(x, 3, 1, 1),
    "avgpool2x2_stride2": lambda x: avg_pool2d(x, 2, 2),
    "maxpool2x2_stride2": lambda x: max_pool2d(x, 2, 2),
    "conv7x1": _conv((7, 1), (3, 0)),
    "conv1x7": _conv((1, 7), (0, 3)),
    "conv3x1": _conv((3, 1), (1, 0)),
    "se_mean": halo.spatial_mean,
}


@pytest.mark.parametrize("spatial", [2, 4])
@pytest.mark.parametrize("op", sorted(OPS))
def test_family_ops_against_the_whole_op(op, spatial, monkeypatch):
    """32 rows by 14 columns: the stride-2 "same" convs pad (0, 1) and (1,
    2) in H at the global edges only (a rank that padded its own rows
    would put zeros at each interior boundary) and (0, 1), (1, 2) in W;
    the ceil-mode pool's W keeps its ceil (7 columns, not 6); the SE
    mean's rank sums add up to the whole sum."""
    fn = OPS[op]
    torch.manual_seed(7)
    if isinstance(fn, torch.nn.Module):
        torch.nn.init.normal_(fn.weight)
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (2, 8, 32, 14)))
    want = fn(x)
    n = x.shape[2] // spatial
    blocks = [x[:, :, s * n:(s + 1) * n] for s in range(spatial)]
    total = sum(b.sum((2, 3), keepdim=True) for b in blocks)
    monkeypatch.setattr(halo, "exchange_rows", _emulated_exchange(x))
    monkeypatch.setattr(halo, "spatial_sum", lambda t, mesh: total)
    got = []
    for s, block in enumerate(blocks):
        layout = halo.RowLayout(_mesh(spatial, s))
        monkeypatch.setattr(halo, "active", lambda: layout)
        got.append(fn(block))
    if op == "se_mean":
        for g in got:
            torch.testing.assert_close(g, want, rtol=1e-12, atol=1e-12)
        return
    got = torch.cat(got, dim=2)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


def test_same_pads_and_halos_of_the_efficientnet_shapes():
    """The "same" pads from the global extent are the halos (``k - t -
    top`` below): 3x3/2 at 448 (0, 1), 5x5/2 at 112 (1, 2), 3x3/1 (1, 1),
    5x5/1 (2, 2); a rank's own 224 or 56 rows would give the same pads,
    but 7 rows (448 over 4 at stride 16) would pad 5x5/2 by (2, 2)."""
    for n, k, s, pads in ((448, 3, 2, (0, 1)), (112, 5, 2, (1, 2)),
                          (448, 3, 1, (1, 1)), (28, 5, 1, (2, 2))):
        assert halo.same_pads(n, k, s) == pads
        assert tuple(halo.halo_rows(k, s, pads[0])) == pads
    assert halo.same_pads(7, 5, 2) == (2, 2)
    assert halo.halo_rows(7, 1, 3) == (3, 3)
    assert halo.halo_rows(1, 1, 0) == (0, 0)
    assert halo.halo_rows(3, 2, 0) == (0, 1)
    assert halo.halo_rows(2, 2, 0) == (0, 0)


def test_a_gather_keeps_a_halo_reach(monkeypatch):
    """``gather_before_stride`` gathers where the rows do not divide by the
    stride, or would leave fewer than ``reach`` rows a rank past it."""
    gathered = []
    monkeypatch.setattr(halo, "gather_rows",
                        lambda y, mesh, dim: gathered.append(y) or y)
    for rows, reach, want in ((4, 1, False), (4, 2, False), (4, 3, True),
                              (3, 1, True), (2, 2, True)):
        layout = halo.RowLayout(_mesh(2, 0))
        monkeypatch.setattr(halo._STATE, "layout", layout)
        gathered.clear()
        halo.gather_before_stride(torch.zeros(1, 1, rows, 4), 2, reach)
        assert bool(gathered) == want, (rows, reach)
        assert layout.sharded == (not want)


# ------------------------------------------- every name builds a trainer


@pytest.mark.parametrize("name", encoder_names())
def test_every_encoder_builds_a_spatial_trainer(name, monkeypatch):
    """spatial_parallel: 2 in a group of two: no encoder refuses it."""
    fake_group(monkeypatch)
    cfg = config.config_from_dict(config.DenoiserConfig, dict(
        input_image_list_path="x", batch_size=2, image_size=64,
        encoder_name=name, spatial_parallel=2, compute_dtype="float32"))
    trainer = DenoiserTrainer(cfg, steps_per_epoch=1, image_size=64,
                              device="cpu")
    assert (trainer.mesh.data, trainer.mesh.spatial) == (1, 2)


def test_the_patchified_unet_builds_a_spatial_trainer(monkeypatch):
    fake_group(monkeypatch)
    cfg = config.config_from_dict(config.DenoiserConfig, dict(
        input_image_list_path="x", batch_size=2, image_size=448,
        encoder_name="resnet34", patchify_stem=2, spatial_parallel=2))
    trainer = DenoiserTrainer(cfg, steps_per_epoch=1, image_size=448,
                              device="cpu")
    assert (trainer.mesh.data, trainer.mesh.spatial) == (1, 2)


# ------------------------------------------------------- the spawned ranks


def _mismatches(got: dict, one: dict, lr: float) -> list[str]:
    """``test_torch_port_spatial.py``'s ``_hold_step`` as a list of what
    fails: the metrics 1e-5 relative; BN buffers, gradients, Adam moments
    and shadows 1e-5 of each tensor's largest; weights by Adam's
    first-step rule (within 2 lr, and 1e-6 where the gradient is clear of
    0); a forward's prediction (``pred``) 1e-6 of its largest."""
    if set(got) != set(one):
        return [f"keys differ: {sorted(set(got) ^ set(one))[:5]}"]
    out = []
    metrics = [k for k in one if k.startswith("metric.")]
    if not metrics:
        out.append("no metric")
    for k in metrics:
        if abs(got[k] - one[k]) > 1e-5 * abs(one[k]):
            out.append(f"{k}: {got[k]} vs {one[k]}")
    weights = 0
    if "pred" in one:
        diff = float((got["pred"] - one["pred"]).abs().max())
        scale = float(one["pred"].abs().max())
        return out + ([f"pred: {diff:.3g} vs {scale:.3g}"]
                      if diff > 1e-6 * scale else [])
    for k, want in one.items():
        if k in metrics or k == "fingerprint":
            continue
        identity, kind, name = k.split(".", 2)
        diff = (got[k].double() - want.double()).abs()
        if kind in ("model", "shadow") and "running_" not in name:
            grad = one[f"{identity}.grad.{name}"].double()
            clear = (grad.abs() > 2e-2 * grad.abs().max()) & (
                grad.abs() > 1e-6)
            if diff.max() > 2 * lr + 1e-6 or (
                    clear.any() and diff[clear].max() > 1e-6):
                out.append(f"{k}: weight moved {float(diff.max()):.3g} "
                           "from the reference's")
            weights += 1
        else:
            scale = float(want.double().abs().max())
            if float(diff.max()) > 1e-5 * scale + 1e-12:
                out.append(f"{k}: {float(diff.max()):.3g} vs {scale:.3g}")
    if not weights:
        out.append("no weight")
    return out


def _jax_forward_inputs(encoder: str, patchify: int, seed: int) -> dict:
    """Random flax weights of a 64^2 U-Net (the head scaled into (-1, 1)),
    a float64 input and target, and b0's drop masks, for both sides."""
    variables = random_flax_variables(jax_unet(encoder, patchify=patchify),
                                      worker.SIZE, seed=seed)
    params = variables["params"]
    head = (params["unet"] if patchify > 1 else params)["segmentation_head"]
    head["kernel"] = head["kernel"] * 0.1
    rng = np.random.default_rng(seed + 1)
    shape = (2, worker.SIZE, worker.SIZE, 3)
    target = rng.uniform(-1, 1, shape)
    x = np.sqrt(0.5) * target + np.sqrt(0.5) * rng.standard_normal(shape)
    n = len(drop_keep_probs(encoder))
    masks = rng.random((n, 2)) < 0.6 if n else None
    return {"variables": variables, "x": x, "target": target,
            "masks": masks, "encoder": encoder, "patchify": patchify}


def _jax_mesh_forward(inputs: dict) -> dict:
    """JAX's train-mode forward on its own (1, 2) CPU mesh (the input's H
    over ``spatial``), float64, the masks injected into its bernoulli, and
    its loss against the target."""
    saved = jax_eff.jax
    if inputs["masks"] is not None:
        jax_eff.jax = _Jax(_Random(inputs["masks"]))
    try:
        with jax.enable_x64(True):
            model = jax_unet(inputs["encoder"], dtype=jnp.float64,
                             patchify=inputs["patchify"])
            mesh = create_mesh(1, spatial=2, devices=jax.devices()[:2])
            v64 = jax.device_put(
                jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                             inputs["variables"]), replicated_sharding(mesh))
            x = jax.device_put(jnp.asarray(inputs["x"]),
                               batch_sharding(mesh, spatial_dim=1))
            pred, _ = jax.jit(lambda v, x: model.apply(
                v, x, train=True, mutable=["batch_stats"],
                rngs={"dropout": jax.random.PRNGKey(5)}))(v64, x)
            loss = jax_loss(pred, jnp.asarray(inputs["target"]))
            return {"pred": np.asarray(pred), "loss": float(loss)}
    finally:
        jax_eff.jax = saved


def _await(path: Path, procs: list, deadline: float) -> dict:
    """Rank 0's published step at ``path``, once it is there; fails if a
    rank died or the deadline passed."""
    while not path.exists():
        for p in procs:
            if p.poll() not in (None, 0):
                raise AssertionError(f"a rank failed before {path.name}")
        if time.monotonic() > deadline:
            raise AssertionError(f"no {path.name} before the timeout")
        time.sleep(0.05)
    return torch.load(path, weights_only=False)


@pytest.fixture(scope="module")
def families(tmp_path_factory):
    """Every case's mismatches against its one-process step, the ranks'
    fingerprints, census and forwards, and JAX's mesh forwards."""
    workdir = tmp_path_factory.mktemp("spatial_families")
    jax_inputs = {}
    for i, (key, encoder, patchify) in enumerate(worker.JAX_FORWARDS):
        inputs = jax_inputs[key] = _jax_forward_inputs(encoder, patchify,
                                                       seed=30 + i)
        v = inputs["variables"]
        torch.save({"state_dict": state_dict_from_jax(
                        v["params"], v["batch_stats"], encoder, patchify),
                    "x": torch.from_numpy(inputs["x"]),
                    "target": torch.from_numpy(inputs["target"]),
                    "masks": None if inputs["masks"] is None
                    else torch.from_numpy(inputs["masks"]),
                    "encoder": encoder, "patchify": patchify},
                   workdir / f"jax_forward_{key}.pt")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    repo = str(Path(__file__).resolve().parents[1])
    env["PYTHONPATH"] = os.pathsep.join(
        [repo, str(Path(__file__).parent), env.get("PYTHONPATH", "")])
    store = f"file://{workdir / 'store'}"
    logs = [open(workdir / f"rank{r}.log", "w") for r in range(4)]
    procs = [subprocess.Popen(
        [sys.executable, str(Path(worker.__file__)), store, str(r),
         str(workdir), "families"], stdout=logs[r], stderr=subprocess.STDOUT,
        env=env, cwd=repo) for r in range(4)]
    jax_side = {}

    def jax_forwards():
        for key, inputs in jax_inputs.items():
            jax_side[key] = _jax_mesh_forward(inputs)

    # JAX compiles and runs its forwards (mostly outside the GIL) while
    # this thread compares each case as soon as the ranks have published
    # its step and its reference.
    jax_thread = threading.Thread(target=jax_forwards)
    jax_thread.start()
    held, gaps = {}, {}
    try:
        deadline = time.monotonic() + RANK_TIMEOUT_S
        for case in (worker.D2S2_CASE,) + worker.FAMILY_CASES:
            key = case[0]
            paths = [workdir / f"{kind}_{key}.pt" for kind in ("ref", "fam")]
            one, got = (_await(path, procs, deadline) for path in paths)
            for path in paths:
                path.unlink()
            held[key] = _mismatches(got, one, worker.LR)
            gaps[key] = max(
                float((got[k].double() - v.double()).abs().max()
                      / max(float(v.double().abs().max()), 1e-30))
                for k, v in one.items() if ".grad." in k or k == "pred")
            del got, one
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1))
        for r, p in enumerate(procs):
            assert p.returncode == 0, (workdir / f"rank{r}.log").read_text()
    finally:
        jax_thread.join()
        for p in procs:
            if p.poll() is None:
                p.kill()
        for f in logs:
            f.close()
    assert len(jax_side) == len(jax_inputs), "a JAX forward failed"
    got = [torch.load(workdir / f"families_rank{r}.pt", weights_only=False)
           for r in range(4)]
    yield {"held": held, "gaps": gaps, "ranks": got, "jax": jax_side}
    shutil.rmtree(workdir, ignore_errors=True)


@pytest.mark.parametrize("key", [c[0] for c in worker.FAMILY_CASES]
                         + [worker.D2S2_CASE[0]])
def test_family_spatial_step_matches_one_process(families, key):
    """Rank 0's step against one process's (the swap pair's with its loss
    in the ranks' row shares; xception's and inceptionresnetv2's forward
    and loss); the other ranks hold rank 0's state."""
    assert not families["held"][key], "\n".join(families["held"][key])
    ranks = families["ranks"][:4 if key.endswith("_d2s2") else 2]
    assert len({r["fingerprints"][key] for r in ranks}) == 1, key


@pytest.mark.parametrize("key", [k for k, _, _ in worker.JAX_FORWARDS])
def test_spatial_forward_matches_jax_mesh(families, key):
    """The port's forward over spatial 2 (float64, train mode, b0's drop
    masks injected) against JAX's (1, 2) mesh forward: to 1e-6 of its
    largest, and the loss to 1e-5 relative, on both ranks."""
    want = families["jax"][key]
    ranks = families["ranks"][:2]
    pred = torch.cat([r["jax"][key]["pred"] for r in ranks], dim=1)
    assert pred.shape == want["pred"].shape
    scale = np.abs(want["pred"]).max()
    assert np.abs(pred.numpy() - want["pred"]).max() <= 1e-6 * scale
    for r in ranks:
        loss = r["jax"][key]["loss"]
        assert abs(loss - want["loss"]) <= 1e-5 * abs(want["loss"])


def test_census_counts_the_squeeze_excite_sums(families):
    """A b0 step over spatial 2: halos exchanged, gradients reduced, and
    among the all-reduces each sharded SE block's sum, forward and
    backward; clean under the spatial policy."""
    for r in families["ranks"][:2]:
        c = r["census"]
        assert c["violations"] == [], c["summary"]
        assert c["summary"]["collective-permute"]["count"] > 0
        sums = c["summary"]["all-reduce"]["spatial_sums"]
        assert sums > 0 and sums % 2 == 0, c["summary"]


def test_float64_batch_norm_takes_float64_statistics():
    """One process's train-mode BN takes a float64 input's running
    statistics in float64, as a group's global BN does: a channel whose
    batch mean is 0 (a 1x1 conv of a BN's output, each MBConv expansion)
    keeps a running mean of float64 rounding, not fp32's. In fp32 the
    spatial steps' running means of such channels (~1e-16) stood apart
    from one process's (~1e-10) by the whole of the latter."""
    from denoising_diffusion_deep_fake_tpu_torch.models.resnet import (
        BatchNorm2d)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 4, 8, 8)) * 1e3)
    x = x - x.mean((0, 2, 3), keepdim=True)
    bn = BatchNorm2d(4).double()
    bn.train()
    bn(x)
    assert bn.running_mean.abs().max() < 1e-14
    torch.testing.assert_close(
        bn.running_var, 0.1 * x.var((0, 2, 3), unbiased=False) + 0.9,
        rtol=1e-14, atol=0)
