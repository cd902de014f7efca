"""The port's data parallelism across two real processes (gloo, CPU).

Two ranks of ``torch_port_dp_worker.py`` join one process group on a
``file://`` store (no port to race for between test workers) and run
every check of that module once; this file holds what they saved against
references it computes meanwhile:

* the one-process step of the same global batch (the denoiser, the swap
  pair, the balancer), the U-Net in float64 on both sides (the warp, the
  noise and the loss stay fp32): the loss 1e-5 relative; BN buffers,
  gradients, Adam moments and shadows 1e-5 of each tensor's largest.
  The new weights are held as ``test_torch_port_step.py`` holds them:
  Adam's first step moves a weight by ``lr * g / (|g| + eps)``, about
  +-lr whatever ``|g|``, so where a gradient is near 0 the fp32 parts'
  rounding can flip its sign; 1e-6 where ``|g|`` is above 2% of the
  tensor's largest and above 1e-6, 2 lr + 1e-6 everywhere. In fp32 the
  two runs' gradients differ by up to ~7% of a tensor's largest: a
  decoder BN's bias gradient is a sum that nearly cancels (the next BN
  removes a per-channel shift), so the summation order shows;
* the JAX package's step of the same weights and injected global numbers
  on a 2-device mesh of its own (``create_mesh(2)``, ``shard_state``,
  ``shard_batch``, as ``tests/test_distributed.py:240-274``), at
  ``test_torch_port_step.py``'s tolerances (loss 1e-5 relative, gradients
  1e-4 of each tensor's largest, BN statistics 1e-5), the U-Net in float64
  on both sides;
* the census of a 2-rank denoiser step, ``remat`` in a group, the loop's
  lockstep, and two 2-step ``fit_denoiser`` runs (host loader, device
  cache).

Every rank runs under a timeout: a rank that fails alone leaves its peer
waiting in a collective.
"""

import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

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
from denoising_diffusion_deep_fake_tpu_torch.utils.jax_weights import (
    state_dict_from_jax,
)

from helpers import make_image_dataset
from test_torch_port_model import random_flax_variables
import torch_port_dp_worker as worker

RANK_TIMEOUT_S = 240
LR = 1e-3


def _launch(workdir: Path) -> list[subprocess.Popen]:
    env = dict(os.environ, OMP_NUM_THREADS="1")
    repo = str(Path(__file__).resolve().parents[1])
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    store = f"file://{workdir / 'store'}"
    return [subprocess.Popen(
        [sys.executable, str(Path(worker.__file__)), store, "2", str(r),
         str(workdir)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env, cwd=repo) for r in range(2)]


def _finish(procs) -> list[str]:
    deadline = time.monotonic() + RANK_TIMEOUT_S
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(
                timeout=max(deadline - time.monotonic(), 1))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out = p.communicate()[0]
            raise AssertionError(f"a rank timed out:\n{out}")
        outs.append(out)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    return outs


# ------------------------------------------------------------ the JAX step


def _jax_inputs(seed: int = 11) -> dict:
    rng = np.random.default_rng(seed)
    b, s = worker.GLOBAL_BATCH, worker.SIZE
    inputs = {
        "u8": rng.integers(0, 256, (b, s, s, 3), np.uint8),
        "params": {
            "angle": rng.uniform(-15, 15, b).astype(np.float32),
            "scale": rng.uniform(0.8, 1.2, b).astype(np.float32),
            "tx": rng.uniform(-0.2, 0.2, b).astype(np.float32),
            "ty": rng.uniform(-0.2, 0.2, b).astype(np.float32),
            "apply": np.ones(b, bool)},
        "ratios": rng.uniform(0.0, 0.6, b).astype(np.float32),
        "noise": rng.standard_normal((b, s, s, 3)).astype(np.float32)}
    variables = random_flax_variables(jax_unet(worker.ENCODER), s, seed=12)
    # Predictions inside (-1, 1), as test_torch_port_step.py keeps them:
    # an element at the loss's clamp edge switches its gradient on or off.
    head = variables["params"]["segmentation_head"]
    head["kernel"] = head["kernel"] * 0.1
    return inputs, variables


def _jax_two_device_step(inputs, variables, monkeypatch) -> dict:
    """JAX's real train step on a 2-device mesh, its augmented batch
    replaced by the port's warp of the injected params (the bilinear
    gather floors each sample coordinate: where XLA contracts a
    multiply-add that PyTorch rounds apart, a coordinate on an integer
    takes another tap, a step in the input that the gradients show at
    ~1%), its noise by the injected numbers and its U-Net by a float64
    one."""
    cfg = jax_config.config_from_dict(jax_config.DenoiserConfig, dict(
        input_image_list_path="x", batch_size=worker.GLOBAL_BATCH,
        learning_rate=0.02, encoder_name=worker.ENCODER,
        compute_dtype="float32", warp_method="gather", mean=(0.5,) * 3,
        std=(0.5,) * 3, data_parallel=2), validate=False)
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
        trainer.model = jax_unet(worker.ENCODER, dtype=jnp.float64)
        trainer.tx = make_adam_with_cosine(0.02, cosine_t_max=cfg.cosine_t_max,
                                           steps_per_epoch=10, flatten=False)
        p64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                           variables["params"])
        state = ModelState(step=jnp.zeros((), jnp.int32), params=p64,
                           batch_stats=variables["batch_stats"],
                           opt_state=trainer.tx.init(p64))
        mesh = create_mesh(2, devices=jax.devices()[:2])
        step = trainer.make_train_step(donate=False)
        new_state, metrics = step(shard_state(state, mesh),
                                  shard_batch(inputs["u8"], mesh),
                                  jax.random.PRNGKey(7))
        mu = jax.tree.map(np.asarray, new_state.opt_state[0].mu)
        stats = jax.tree.map(np.asarray, new_state.batch_stats)
    return {"loss": float(metrics["loss"]),
            "grads": state_dict_from_jax(
                jax.tree.map(lambda m: m / 0.1, mu), {}),
            "stats": state_dict_from_jax({}, stats)}


# ------------------------------------------------------------ the fixture


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' saved results and the references, computed while the
    ranks run."""
    workdir = tmp_path_factory.mktemp("dp")
    make_image_dataset(workdir, n=8, size=32, seed=0)
    inputs, variables = _jax_inputs()
    torch.save({"state_dict": state_dict_from_jax(
                    variables["params"], variables["batch_stats"]),
                "u8": torch.from_numpy(inputs["u8"]),
                "params": {k: torch.from_numpy(v)
                           for k, v in inputs["params"].items()},
                "ratios": torch.from_numpy(inputs["ratios"]),
                "noise": torch.from_numpy(inputs["noise"])},
               workdir / "jax_inputs.pt")
    procs = _launch(workdir)
    try:
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            one = {w: worker.one_step(w, lambda x, t: x)
                   for w in ("denoiser", "swap", "balance")}
        finally:
            torch.set_num_threads(threads)
        with pytest.MonkeyPatch.context() as mp:
            jax_side = _jax_two_device_step(inputs, variables, mp)
        _finish(procs)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    got = [torch.load(workdir / f"rank{r}.pt", weights_only=False)
           for r in range(2)]
    yield {"one": one, "jax": jax_side, "ranks": got, "workdir": workdir}
    shutil.rmtree(workdir, ignore_errors=True)  # ~1 GB of states and files


def _close(got, want, tol, name):
    got, want = got.double(), want.double()
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    assert err <= tol * scale + 1e-12, f"{name}: {err} vs {scale}"


@pytest.mark.parametrize("workload", ["denoiser", "swap", "balance"])
def test_two_rank_step_matches_one_process(ranks, workload):
    one = ranks["one"][workload]
    dp = ranks["ranks"][0][workload]
    assert set(one) == set(dp)
    one, dp = ({k: v for k, v in d.items() if k != "fingerprint"}
               for d in (one, dp))
    metrics = [k for k in one if k.startswith("metric.")]
    assert metrics
    for k in metrics:
        assert abs(dp[k] - one[k]) <= 1e-5 * abs(one[k]), k
    weights = 0
    for k, want in one.items():
        if k in metrics:
            continue
        identity, kind, name = k.split(".", 2)
        if kind in ("model", "shadow") and "running_" not in name:
            # A weight after Adam's first step (a shadow copies its
            # model's): the rule of the module docstring.
            grad = one[f"{identity}.grad.{name}"].double()
            diff = (dp[k].double() - want.double()).abs()
            assert diff.max() <= 2 * LR + 1e-6, k
            clear = (grad.abs() > 2e-2 * grad.abs().max()) & (
                grad.abs() > 1e-6)
            assert not clear.any() or diff[clear].max() <= 1e-6, k
            weights += 1
        else:
            _close(dp[k], want, 1e-5, k)
    assert weights


@pytest.mark.parametrize("workload", ["denoiser", "swap", "balance"])
def test_ranks_hold_the_same_state(ranks, workload):
    """The ranks' states stay replicas of each other after a step: the
    digests of every metric and tensor, at full precision, are equal."""
    a, b = (r[workload]["fingerprint"] for r in ranks["ranks"])
    assert a == b


def test_two_rank_step_matches_jax_two_device_mesh(ranks):
    jax_side, port = ranks["jax"], ranks["ranks"][0]["jax"]
    assert abs(port["loss"] - jax_side["loss"]) <= 1e-5 * abs(
        jax_side["loss"])
    assert set(jax_side["grads"]) == set(port["grads"])
    for name, want in jax_side["grads"].items():
        _close(port["grads"][name], want, 1e-4, name)
    assert jax_side["stats"]
    for name, want in jax_side["stats"].items():
        np.testing.assert_allclose(port["stats"][name].double().numpy(),
                                   want.double().numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=name)


def test_census_of_a_two_rank_step(ranks):
    for r in ranks["ranks"]:
        c = r["census"]
        assert c["violations"] == [], c["summary"]
        assert c["summary"]["all-reduce"]["count"] > 0
        assert c["all_reduce_bytes"] >= c["grad_bytes"]
        assert "collective-permute" not in c["summary"]


def test_remat_in_a_group(ranks):
    """Under remat the recompute issues batch norm's all-reduces again
    (more calls than without), the step's gradients and BN statistics are
    the ones without remat: the statistics are written once."""
    for r in ranks["ranks"]:
        runs = r["remat"]
        none = runs["none"]
        for policy in ("dots", "full"):
            assert runs[policy]["all_reduces"] > none["all_reduces"]
            for got, want in zip(runs[policy]["grads"] + runs[policy][
                    "buffers"], none["grads"] + none["buffers"]):
                assert torch.equal(got, want), policy


def test_loop_lockstep(ranks):
    """A NaN on rank 1 alone raises on both ranks at the same step; a
    SIGTERM flag on rank 1 alone stops both at the same boundary (the
    flags are all-gathered every 10 calls)."""
    r0, r1 = (r["lockstep"] for r in ranks["ranks"])
    assert r0["diverged_at"] == r1["diverged_at"] == 3
    assert "rank 1" in r0["diverged_msg"]
    assert r0["stopped_at"] == r1["stopped_at"] == 10


def test_fit_denoiser_two_ranks(ranks):
    """Two steps from the manifest on each rank's shard, through the host
    loader and the device cache alike; one checkpoint, written by the
    primary; every rank restores its step and the shared generator."""
    for r in ranks["ranks"]:
        f = r["fit"]
        assert f["step"] == f["global_step"] == 2
        assert f["restored_step"] == f["saved_step"] == 2
        assert f["generator_equal"] and f["restored_equal"]
        assert f["host_equals_cache"]
    for cache in ("host", "device"):
        ckpt = ranks["workdir"] / f"fit_ckpt_{cache}"
        assert sorted(p.name for p in ckpt.iterdir()) == [
            "step_0000000002"]
        logs = list((ranks["workdir"] / f"fit_logs_{cache}").rglob(
            "events.out.tfevents.*"))
        assert len(logs) == 1
