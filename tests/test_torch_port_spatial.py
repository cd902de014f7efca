"""The port's spatial parallelism (``spatial_parallel > 1``) on the CPU.

In one process:

* the halo geometry of ``parallel/halo.py`` for every convolution and pool
  shape of the resnet family (3x3 at stride 1 and 2, grouped, the 7x7
  stem, 1x1 at stride 1 and 2, the stem's ``-inf``-padded max pool): a
  tensor cut into S row blocks, each padded with its true neighbour rows
  (the exchange done in-process), through the port's ``halo.conv2d`` /
  ``halo.max_pool2d``, against the op on the whole tensor;
* the SSIM's 5-row halo and the losses' shares: the shares of S row
  blocks add up to the whole batch's SSIM and loss;
* the noise kernels' row window (plain versions): a rank's rows drawn with
  their window bit-equal to those rows of the whole draw, runs that start
  inside a Philox group included;
* the mesh's data and spatial indices, ``shard_rows`` and
  ``noise_window``, and the loader's shard by data index.

Across four spawned gloo ranks of ``torch_port_spatial_worker.py`` on
``file://`` stores (float64 U-Nets, as ``test_torch_port_distributed.py``
holds them): ``data 2 x spatial 2`` and ``spatial 2`` steps against one
process and against JAX's own ``(data, spatial)`` mesh step, the 32^2 step
whose deepest level runs replicated (the swap pair against one process
with its loss in row shares, and the witness for that reference),
``remat`` bit-equal to no remat, the census, the balancer's scores, the
panels, and ``fit_denoiser`` from the config's knobs.
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
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from denoising_diffusion_deep_fake_tpu import config as jax_config
from denoising_diffusion_deep_fake_tpu.models import create_unet as jax_unet
from denoising_diffusion_deep_fake_tpu.ops.noise import blend_noise
from denoising_diffusion_deep_fake_tpu.parallel import (
    create_mesh,
    shard_batch,
    shard_state,
)
from denoising_diffusion_deep_fake_tpu.training import denoiser as jax_denoiser
from denoising_diffusion_deep_fake_tpu.training.optim import (
    make_adam_with_cosine,
)
from denoising_diffusion_deep_fake_tpu.training.state import ModelState
from denoising_diffusion_deep_fake_tpu_torch.ops import (
    augment as port_augment,
)
from denoising_diffusion_deep_fake_tpu_torch.ops import losses, ssim
from denoising_diffusion_deep_fake_tpu_torch.ops.cuda import (
    noise_kernel as nk,
)
from denoising_diffusion_deep_fake_tpu_torch.parallel import (
    distributed,
    halo,
)
from denoising_diffusion_deep_fake_tpu_torch.parallel import (
    collectives,
)
from denoising_diffusion_deep_fake_tpu_torch.parallel.mesh import (
    Mesh,
    noise_window,
    shard_batch as port_shard_batch,
    shard_rows,
)
from denoising_diffusion_deep_fake_tpu_torch.utils.jax_weights import (
    state_dict_from_jax,
)

from helpers import make_image_dataset
from test_torch_port_distributed import _close
from test_torch_port_model import random_flax_variables
import torch_port_dp_worker as dp
import torch_port_spatial_worker as worker

RANK_TIMEOUT_S = 240


# ------------------------------------------------------ the halo geometry


def _emulated_exchange(whole: torch.Tensor):
    """``exchange_rows`` in one process: a rank's block with its true
    neighbour rows of ``whole`` (the global edges ``pad``-filled, or
    bare)."""
    def exchange(x, above, below, mesh, *, dim, pad):
        n = x.shape[dim]
        a = mesh.spatial_index * n
        total = whole.shape[dim]
        lo, hi = max(a - above, 0), min(a + n + below, total)
        parts = [whole.narrow(dim, lo, hi - lo)]
        if pad is not None:
            shape = list(x.shape)
            if a - above < 0:
                shape[dim] = above - a
                parts.insert(0, torch.full(shape, pad, dtype=x.dtype))
            if a + n + below > total:
                shape[dim] = a + n + below - total
                parts.append(torch.full(shape, pad, dtype=x.dtype))
        return torch.cat(parts, dim)
    return exchange


def _mesh(spatial: int, s: int, data: int = 1, d: int = 0) -> Mesh:
    return Mesh(data=data, spatial=spatial, rank=d * spatial + s,
                world=data * spatial)


# (kernel, stride, padding, groups, pool): every conv and pool shape of the
# resnet family's U-Net.
OPS = {
    "conv3x3": (3, 1, 1, 1, False),
    "conv3x3_stride2": (3, 2, 1, 1, False),
    "grouped3x3": (3, 1, 1, 4, False),
    "grouped3x3_stride2": (3, 2, 1, 4, False),
    "stem7x7_stride2": (7, 2, 3, 1, False),
    "conv1x1": (1, 1, 0, 1, False),
    "downsample1x1_stride2": (1, 2, 0, 1, False),
    "maxpool3x3_stride2": (3, 2, 1, 1, True),
}


@pytest.mark.parametrize("spatial", [2, 4])
@pytest.mark.parametrize("op", sorted(OPS))
def test_halo_geometry_against_the_whole_op(op, spatial, monkeypatch):
    kernel, stride, padding, groups, pool = OPS[op]
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((2, 8, 32, 12)))
    if pool:
        x = x.relu()       # the stem's max pool follows a ReLU
        want = F.max_pool2d(x, kernel, stride, padding)
    else:
        w = torch.from_numpy(rng.standard_normal(
            (8, 8 // groups, kernel, kernel)))
        want = F.conv2d(x, w, None, stride, padding, 1, groups)
    monkeypatch.setattr(halo, "exchange_rows", _emulated_exchange(x))
    n = x.shape[2] // spatial
    got = []
    for s in range(spatial):
        layout = halo.RowLayout(_mesh(spatial, s))
        block = x[:, :, s * n:(s + 1) * n]
        got.append(halo.max_pool2d(block, kernel, stride, padding, layout)
                   if pool else halo.conv2d(block, w, None, stride,
                                            padding, 1, groups, layout))
    got = torch.cat(got, dim=2)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


def test_halo_rows_of_the_resnet_shapes():
    assert halo.halo_rows(3, 1, 1) == (1, 1)
    assert halo.halo_rows(3, 2, 1) == (1, 0)
    assert halo.halo_rows(7, 2, 3) == (3, 2)
    assert halo.halo_rows(1, 1, 0) == (0, 0)
    assert halo.halo_rows(1, 2, 0) == (0, 0)
    assert halo.halo_rows(3, 1, 2, dilation=2) == (2, 2)


def test_an_exchange_needs_as_many_rows_as_its_halo():
    with pytest.raises(ValueError, match="halo of 3 rows above"):
        collectives.exchange_rows(torch.zeros(1, 1, 2, 4), 3, 2,
                                  _mesh(2, 0), dim=2, pad=0.0)


@pytest.mark.parametrize("spatial", [2, 4])
def test_loss_shares_add_up_to_the_whole_batch(spatial, monkeypatch):
    """The SSIM's valid blur reads 5 rows beyond a rank's on each side:
    edge ranks hold 5 map rows fewer, and the shares (sums over global
    counts) add up to the whole batch's SSIM, MSE and loss."""
    rng = np.random.default_rng(3)
    p = torch.from_numpy(rng.uniform(-1.1, 1.1, (2, 64, 24, 3)).astype(
        np.float32))
    t = torch.from_numpy(rng.uniform(-1, 1, (2, 64, 24, 3)).astype(
        np.float32))
    whole = torch.cat([p, t], dim=-1)

    def rescaled_exchange(x, above, below, mesh, *, dim, pad):
        # The SSIM exchanges its rescaled, clipped inputs.
        full = torch.cat([torch.clamp((whole[..., :3] + 1) / 2, 0, 1),
                          torch.clamp((whole[..., 3:] + 1) / 2, 0, 1)], -1)
        return _emulated_exchange(full)(x, above, below, mesh, dim=dim,
                                        pad=pad)

    monkeypatch.setattr(ssim, "exchange_rows", rescaled_exchange)
    n = 64 // spatial
    shares = {"ssim": [], "mse": [], "loss": []}
    for s in range(spatial):
        mesh = _mesh(spatial, s)
        rows = slice(s * n, (s + 1) * n)
        pr, tr = p[:, rows], t[:, rows]
        shares["mse"].append(losses.mse_loss(pr, tr, mesh=mesh))
        shares["loss"].append(losses.mse_ssim_loss(pr, tr, mesh=mesh))
        shares["ssim"].append(ssim.ssim(
            torch.clamp((pr + 1) / 2, 0, 1), torch.clamp((tr + 1) / 2, 0, 1),
            mesh=mesh))
    want = {"mse": losses.mse_loss(p, t), "loss": losses.mse_ssim_loss(p, t),
            "ssim": ssim.ssim(torch.clamp((p + 1) / 2, 0, 1),
                              torch.clamp((t + 1) / 2, 0, 1))}
    for k, v in shares.items():
        torch.testing.assert_close(sum(v), want[k], rtol=1e-6, atol=0)


# ------------------------------------------------- the noise row window


@pytest.mark.parametrize("shape,spatial", [((3, 45, 45, 3), 3),
                                           ((2, 32, 20, 3), 4),
                                           ((2, 12, 7, 1), 2),
                                           ((4, 16, 16, 3), 2)])
def test_noise_row_window_equals_the_rows_of_the_whole_draw(shape, spatial):
    """A spatial rank's rows with their window: bit-equal to those rows of
    the launch on the whole batch (fp32 and uint8 forms), and a window of
    one run is the contiguous launch at that base. At W * C = 135, 7 and
    a data row's base of 3 images, runs start inside a Philox group."""
    rng = np.random.default_rng(11)
    b, h, w, c = shape
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    u8 = torch.from_numpy(rng.integers(0, 256, shape, np.uint8))
    ratios = torch.from_numpy(rng.uniform(0, 1, b).astype(np.float32))
    whole = nk.fused_noise_blend(x, ratios, seed=5, offset=7)
    whole_u8 = nk.fused_normalise_noise_blend(u8, ratios, 0.5, 0.25, seed=5,
                                              offset=7)
    lb, n = b // 2 if b % 2 == 0 else b, h // spatial
    starts = set()
    for d in range(b // lb):
        for s in range(spatial):
            mesh = _mesh(spatial, s, b // lb, d)
            imgs, rows = slice(d * lb, (d + 1) * lb), slice(s * n,
                                                            (s + 1) * n)
            block = shard_rows(port_shard_batch(x, mesh), mesh)
            assert torch.equal(block, x[imgs, rows])
            window = noise_window(mesh, block)
            assert window["sample_stride"] == h * w * c
            starts |= {(window["element_base"] + j * h * w * c) % 4
                       for j in range(lb)}
            got = nk.fused_noise_blend(block, ratios[imgs], seed=5, offset=7,
                                       **window)
            assert torch.equal(got, whole[imgs, rows])
            got_u8 = nk.fused_normalise_noise_blend(
                shard_rows(u8[imgs], mesh), ratios[imgs], 0.5, 0.25, seed=5,
                offset=7, **window)
            assert torch.equal(got_u8, whole_u8[imgs, rows])
    if w * c % 4:
        assert starts - {0}, "no run starts inside a Philox group"
    one = nk.fused_noise_blend(x[1:2], ratios[1:2], seed=5, offset=7,
                               element_base=h * w * c,
                               sample_stride=2 * h * w * c)
    assert torch.equal(one, whole[1:2])


def test_noise_row_window_refuses_a_stride_below_a_sample():
    x = torch.zeros((2, 4, 4, 3))
    with pytest.raises(ValueError, match="sample_stride"):
        nk.fused_noise_blend(x, torch.zeros(2), seed=0, sample_stride=8)


# ------------------------------------------------------------- the mesh


def test_mesh_indices_rows_and_windows():
    mesh = _mesh(2, 1, data=2, d=1)
    assert (mesh.rank, mesh.data_index, mesh.spatial_index) == (3, 1, 1)
    assert mesh.spatial_ranks == (2, 3)
    x = torch.arange(4 * 6 * 2 * 1).reshape(4, 6, 2, 1)
    assert torch.equal(port_shard_batch(x, mesh), x[2:])
    rows = shard_rows(port_shard_batch(x, mesh), mesh)
    assert torch.equal(rows, x[2:, 3:]) and rows.is_contiguous()
    assert noise_window(mesh, rows) == {
        "element_base": (2 * 6 + 3) * 2, "sample_stride": 12}
    assert noise_window(mesh, rows, replicated=True)["element_base"] == 6
    with pytest.raises(ValueError, match="an image of 6 rows over 4"):
        shard_rows(x, _mesh(4, 0))
    flat = _mesh(1, 0, data=2, d=1)
    assert noise_window(flat, x[2:]) == {"element_base": 24,
                                         "sample_stride": None}


def test_the_loader_shards_by_data_row(monkeypatch):
    monkeypatch.setattr(distributed, "process_count", lambda: 4)
    monkeypatch.setattr(distributed, "process_index", lambda: 3)
    assert distributed.local_batch_size(8, 2) == 4
    assert distributed.data_shard(2) == (1, 2)
    assert distributed.data_shard(4) is None
    assert distributed.data_shard() == (3, 4)
    with pytest.raises(ValueError, match="does not divide"):
        distributed.local_batch_size(8, 3)
    with pytest.raises(ValueError, match="data axis 2"):
        distributed.local_batch_size(5, 2)


# ------------------------------------------------------- the spawned ranks


def _jax_inputs(batch: int, seed: int) -> tuple:
    rng = np.random.default_rng(seed)
    s = worker.SIZE
    inputs = {
        "u8": rng.integers(0, 256, (batch, s, s, 3), np.uint8),
        "params": {
            "angle": rng.uniform(-15, 15, batch).astype(np.float32),
            "scale": rng.uniform(0.8, 1.2, batch).astype(np.float32),
            "tx": rng.uniform(-0.2, 0.2, batch).astype(np.float32),
            "ty": rng.uniform(-0.2, 0.2, batch).astype(np.float32),
            "apply": np.ones(batch, bool)},
        "ratios": rng.uniform(0.0, 0.6, batch).astype(np.float32),
        "noise": rng.standard_normal((batch, s, s, 3)).astype(np.float32)}
    variables = random_flax_variables(jax_unet(dp.ENCODER), s, seed=seed + 1)
    head = variables["params"]["segmentation_head"]
    head["kernel"] = head["kernel"] * 0.1   # predictions inside (-1, 1)
    return inputs, variables


def _jax_mesh_step(inputs, variables, data: int, spatial: int,
                   monkeypatch) -> dict:
    """JAX's train step on its own ``(data, spatial)`` mesh with the knobs
    in the config (so its spatial pin H-shards the U-Net, as
    ``tests/test_parallel.py:77-115`` builds it), fed the port's warp of
    the injected params and the injected noise, the U-Net in float64
    (``test_torch_port_distributed.py``'s ``_jax_two_device_step``)."""
    batch = inputs["u8"].shape[0]
    cfg = jax_config.config_from_dict(jax_config.DenoiserConfig, dict(
        input_image_list_path="x", batch_size=batch, learning_rate=0.02,
        encoder_name=dp.ENCODER, compute_dtype="float32",
        warp_method="gather", mean=(0.5,) * 3, std=(0.5,) * 3,
        data_parallel=data, spatial_parallel=spatial), validate=False)
    trainer = jax_denoiser.DenoiserTrainer(cfg, steps_per_epoch=10,
                                           image_size=worker.SIZE)
    image = jnp.asarray(port_augment.augment_batch(
        torch.from_numpy(inputs["u8"]), cfg.mean, cfg.std, None,
        params={k: torch.from_numpy(v) for k, v in inputs["params"].items()},
        method="gather").numpy())
    ratios = jnp.asarray(inputs["ratios"]).reshape(-1, 1, 1, 1)
    noise = jnp.asarray(inputs["noise"])
    monkeypatch.setattr(jax_denoiser, "augment_batch",
                        lambda key, batch, mean, std, aug, method: image)
    monkeypatch.setattr(jax_denoiser, "blend_random_amount_of_noise",
                        lambda key, x, lam: (blend_noise(x, noise, ratios),
                                             ratios))
    with jax.enable_x64(True):
        trainer.model = jax_unet(dp.ENCODER, dtype=jnp.float64)
        trainer.tx = make_adam_with_cosine(0.02, cosine_t_max=cfg.cosine_t_max,
                                           steps_per_epoch=10, flatten=False)
        p64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                           variables["params"])
        state = ModelState(step=jnp.zeros((), jnp.int32), params=p64,
                           batch_stats=variables["batch_stats"],
                           opt_state=trainer.tx.init(p64))
        mesh = create_mesh(data, spatial=spatial,
                           devices=jax.devices()[:data * spatial])
        step = trainer.make_train_step(donate=False)
        new_state, metrics = step(
            shard_state(state, mesh),
            shard_batch(inputs["u8"], mesh, spatial=True),
            jax.random.PRNGKey(7))
        mu = jax.tree.map(np.asarray, new_state.opt_state[0].mu)
        stats = jax.tree.map(np.asarray, new_state.batch_stats)
    return {"loss": float(metrics["loss"]),
            "grads": state_dict_from_jax(
                jax.tree.map(lambda m: m / 0.1, mu), {}),
            "stats": state_dict_from_jax({}, stats)}


def _scores_one_process() -> torch.Tensor:
    trainer = worker.make_trainer("balance", 2)
    state = dp.float64_states(trainer, "balance")
    batch = torch.from_numpy(worker.inputs("balance", 3, seed=5)[0])
    return trainer.make_validation_step()(state, batch, offset=9)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The four ranks' saved results and the references, computed while
    the ranks run."""
    workdir = tmp_path_factory.mktemp("spatial")
    make_image_dataset(workdir, n=4, size=32, seed=0)
    jax_sides = {}
    for world in (4, 2):
        inputs, variables = _jax_inputs(world, seed=20 + world)
        jax_sides[world] = (inputs, variables)
        torch.save({"state_dict": state_dict_from_jax(
                        variables["params"], variables["batch_stats"]),
                    "u8": torch.from_numpy(inputs["u8"]),
                    "params": {k: torch.from_numpy(v)
                               for k, v in inputs["params"].items()},
                    "ratios": torch.from_numpy(inputs["ratios"]),
                    "noise": torch.from_numpy(inputs["noise"])},
                   workdir / f"jax_inputs_{world}.pt")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    repo = str(Path(__file__).resolve().parents[1])
    env["PYTHONPATH"] = os.pathsep.join(
        [repo, str(Path(__file__).parent), env.get("PYTHONPATH", "")])
    store = f"file://{workdir / 'store'}"
    procs = [subprocess.Popen(
        [sys.executable, str(Path(worker.__file__)), store, str(r),
         str(workdir)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env, cwd=repo) for r in range(4)]
    jax_side = {}

    def jax_steps():
        for key, world, data, spatial in (("mesh_2", 2, 1, 2),
                                          ("mesh_4", 4, 2, 2),
                                          ("one_4", 4, 1, 1)):
            with pytest.MonkeyPatch.context() as mp:
                jax_side[key] = _jax_mesh_step(*jax_sides[world], data,
                                               spatial, mp)

    # JAX compiles and runs its steps (mostly outside the GIL) while this
    # thread runs the one-process steps and the ranks run theirs.
    jax_thread = threading.Thread(target=jax_steps)
    jax_thread.start()
    try:
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            one = {"denoiser_4": worker.one_step("denoiser", 4)}
            one.update({w: worker.one_step(w, 2)
                        for w in ("denoiser", "swap", "balance")})
            with worker.loss_in_row_shares(2):
                one["swap_shares"] = worker.one_step("swap", 2)
            one["denoiser_32"] = worker.one_step("denoiser", 2, 32)
            one["scores"] = _scores_one_process()
            one["panels"] = worker.panels()
        finally:
            torch.set_num_threads(threads)
        jax_thread.join()
        assert len(jax_side) == 3, "a JAX step failed"
        deadline = time.monotonic() + RANK_TIMEOUT_S
        outs = []
        for p in procs:
            try:
                outs.append(p.communicate(
                    timeout=max(deadline - time.monotonic(), 1))[0])
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                raise AssertionError(f"a rank timed out:\n{p.communicate()[0]}")
        for p, out in zip(procs, outs):
            assert p.returncode == 0, out
    finally:
        jax_thread.join()
        for p in procs:
            if p.poll() is None:
                p.kill()
    got = {world: [torch.load(workdir / f"spatial{world}_rank{r}.pt",
                              weights_only=False) for r in range(world)]
           for world in (4, 2)}
    yield {"one": one, "jax": jax_side, "ranks": got, "workdir": workdir}
    shutil.rmtree(workdir, ignore_errors=True)


def _hold_step(got: dict, one: dict, lr: float) -> None:
    """A spatial step against the one-process step at the tolerances of
    ``test_torch_port_distributed.py``: the losses 1e-5 relative; BN
    buffers, gradients, Adam moments and shadows 1e-5 of each tensor's
    largest; weights by Adam's first-step rule."""
    assert set(got) == set(one)
    metrics = [k for k in one if k.startswith("metric.")]
    assert metrics
    for k in metrics:
        assert abs(got[k] - one[k]) <= 1e-5 * abs(one[k]), k
    weights = 0
    for k, want in one.items():
        if k in metrics or k == "fingerprint":
            continue
        identity, kind, name = k.split(".", 2)
        if kind in ("model", "shadow") and "running_" not in name:
            grad = one[f"{identity}.grad.{name}"].double()
            diff = (got[k].double() - want.double()).abs()
            assert diff.max() <= 2 * lr + 1e-6, k
            clear = (grad.abs() > 2e-2 * grad.abs().max()) & (
                grad.abs() > 1e-6)
            assert not clear.any() or diff[clear].max() <= 1e-6, k
            weights += 1
        else:
            _close(got[k], want, 1e-5, k)
    assert weights


@pytest.mark.parametrize("workload", ["denoiser", "swap", "balance"])
def test_spatial_step_matches_one_process(ranks, workload):
    """spatial_parallel: 2 at 64^2, a global batch of 2: rank 0 holds the
    one-process step's state (and rank 1 rank 0's, below); the swap pair
    that of the one-process step with its loss in the ranks' row shares
    (``loss_in_row_shares``: the same U-Nets on the whole batch, nothing
    exchanged; the witness below)."""
    one = ranks["one"]["swap_shares" if workload == "swap" else workload]
    _hold_step(ranks["ranks"][2][0][workload], one, worker.LR)


def test_spatial_step_with_replicated_levels_matches_one_process(ranks):
    """At 32^2 a rank's stride-16 level has one row: the encoder gathers it
    and runs its deepest stage replicated, the decoder takes its rows
    back; the step is still the one-process step."""
    _hold_step(ranks["ranks"][2][0]["denoiser_32"],
               ranks["one"]["denoiser_32"], 1e-3)


def test_data_by_spatial_step_matches_one_process(ranks):
    """data_parallel: 2 x spatial_parallel: 2, four ranks at 64^2 x 4
    (rank 0 held; the others hold its state, below)."""
    _hold_step(ranks["ranks"][4][0]["denoiser"], ranks["one"]["denoiser_4"],
               1e-3)


def test_loss_row_shares_alone_part_the_swap_pair(ranks):
    """The witness for holding the spatial swap pair against
    ``loss_in_row_shares``: in one process, with nothing exchanged, the
    loss's row order alone leaves model a's gradients within 1e-5 of the
    plain step's but parts model b's (trained on a's post-Adam shadow) by
    more than 1e-3 of a tensor's largest."""
    plain, shares = ranks["one"]["swap"], ranks["one"]["swap_shares"]
    parted = {}
    for k, want in plain.items():
        if ".grad." in k:
            diff = (shares[k].double() - want.double()).abs().max()
            parted[k] = float(diff / want.double().abs().max())
    a = [v for k, v in parted.items() if k.startswith("0.")]
    b = [v for k, v in parted.items() if k.startswith("1.")]
    assert a and b
    assert max(a) <= 1e-5, max(a)
    assert max(b) > 1e-3, max(b)


@pytest.mark.parametrize("policy", ["dots", "full"])
def test_spatial_remat_step_is_the_step_without_remat(ranks, policy):
    """remat with spatial_parallel: 2: the recompute issues the halo
    exchanges and the gather again inside the backward, and the step is
    bit for bit the step without remat on every rank."""
    for r in ranks["ranks"][2]:
        assert (r[f"remat_{policy}"]["fingerprint"]
                == r["denoiser"]["fingerprint"])


@pytest.mark.parametrize("world", [2, 4])
def test_ranks_hold_the_same_state(ranks, world):
    prints = {r["denoiser"]["fingerprint"] for r in ranks["ranks"][world]}
    assert len(prints) == 1
    if world == 2:
        for w in ("swap", "balance", "denoiser_32"):
            assert len({r[w]["fingerprint"]
                        for r in ranks["ranks"][2]}) == 1, w


@pytest.mark.parametrize("world", [2, 4])
def test_spatial_step_matches_jax_mesh(ranks, world):
    """The port's (1, 2) and (2, 2) steps against JAX's own mesh steps of
    the same weights and injected numbers: the loss to 1e-5; gradients
    1e-4 of each tensor's largest and BN statistics 1e-5 against JAX's
    (1, 2) mesh step, and at (2, 2) against JAX's one-device step. On the
    8-device CPU mesh JAX's own (2, 2) step gives the one-device step's
    loss but gradients up to 2.6 times a tensor's largest away from it
    (its (1, 2) and (1, 4) steps agree with it to 2e-6), so its (2, 2)
    gradients are no reference (ROADMAP A9c)."""
    mesh = ranks["jax"][f"mesh_{world}"]
    ref = ranks["jax"]["mesh_2" if world == 2 else "one_4"]
    for port in (r["jax"] for r in ranks["ranks"][world]):
        for want in (mesh["loss"], ref["loss"]):
            assert abs(port["loss"] - want) <= 1e-5 * abs(want)
        assert set(ref["grads"]) == set(port["grads"])
        for name, want in ref["grads"].items():
            _close(port["grads"][name], want, 1e-4, name)
        assert ref["stats"]
        for name, want in ref["stats"].items():
            np.testing.assert_allclose(port["stats"][name].double().numpy(),
                                       want.double().numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=name)


def test_census_of_a_spatial_step(ranks):
    """Halo exchanges counted (JAX's collective-permute), the gradients
    reduced, nothing gathered above 16 MiB: clean under the spatial
    policy, and the halos flagged under the data-only one."""
    for r in ranks["ranks"][2]:
        c = r["census"]
        assert c["violations"] == [], c["summary"]
        assert c["summary"]["collective-permute"]["count"] > 0
        assert c["summary"]["all-reduce"]["count"] > 0
        assert any("collective-permute" in v for v in c["data_only"])


def test_balancer_scores_on_rows(ranks):
    """Each rank scores its rows of every image; the summed shares are
    every image's one-process score, on every rank."""
    for r in ranks["ranks"][2]:
        torch.testing.assert_close(r["scores"], ranks["one"]["scores"],
                                   rtol=1e-5, atol=0)


def test_panels_gathered_over_the_data_row(ranks):
    """with_images: each panel is the whole images' grid on every rank of
    the data row, within 1 LSB of one process's (an fp32 step)."""
    one = ranks["one"]["panels"]
    for r in ranks["ranks"][2]:
        assert set(r["panels"]) == set(one)
        for tag, want in one.items():
            got = r["panels"][tag]
            assert got.shape == want.shape, tag
            assert (got.int() - want.int()).abs().max() <= 1, tag


def test_fit_denoiser_from_knobs(ranks):
    """fit_denoiser with spatial_parallel: 2 in the config alone runs a
    step on a (1, 2) mesh; the ranks end with the same weights."""
    fits = [r["fit"] for r in ranks["ranks"][2]]
    for f in fits:
        assert f["mesh"] == (1, 2)
        assert len(f["losses"]) == 1 and np.isfinite(f["losses"][0])
    assert fits[0]["losses"] == fits[1]["losses"]
    assert all(torch.equal(a, b) for a, b in zip(fits[0]["weights"],
                                                 fits[1]["weights"]))
