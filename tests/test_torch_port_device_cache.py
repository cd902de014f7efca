"""``data_cache: device``: the dataset on the device, against JAX's cache
and against the host loader's runs, on the CPU.

* ``data/device_cache.py``: the order of an epoch equal to JAX's
  ``DeviceDatasetCache.order_for_epoch``, shuffled and class-balanced, with
  N not a multiple of the batch; the dataset rows equal to JAX's;
  ``gather_batch`` with an int and with a 0-dim tensor position equal to
  JAX's ``gather_batch`` across the epoch's wrap; the refusals with JAX's
  messages (and the config's, raised by both packages: ``i420`` beside
  the cache is ``tests/test_torch_port_i420.py``'s); the loader's RAM
  store left empty, or reused when already full;
* ``training/runners.py`` with the cache: ``fit_denoiser``,
  ``fit_deep_fake`` (denoise, swap) and ``fit_balance`` bit-equal to their
  host runs at K = 1 and K = 2 (``steps_per_call``): every weight, BN
  buffer, Adam moment, shadow and counter, the generator, every event
  record (scalars and panels) and the balanced manifest; a cached swap run
  resumed from its checkpoint bit-equal to the uninterrupted one;
* ``BalanceTrainer.score_dataset_from_cache`` equal to ``score_dataset``
  with a tail batch;
* the K-step call's identity: the same objects after a new epoch's order,
  others for an order buffer replaced instead of filled (so a CUDA graph
  is not captured anew for a new epoch, and is for a replaced buffer).

The card's side is in ``tests/test_torch_port_cuda.py`` and
``chip_smoke.py`` phase 13. 32^2, resnet18, batch 2, fp32; torch on one
thread.
"""

import shutil
import struct
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from helpers import make_image_dataset

from denoising_diffusion_deep_fake_tpu import config as jax_config
from denoising_diffusion_deep_fake_tpu.data import loader as jax_loader
from denoising_diffusion_deep_fake_tpu.data import (
    device_cache as jax_device_cache,
)
from denoising_diffusion_deep_fake_tpu_torch import config as port_config
from denoising_diffusion_deep_fake_tpu_torch.checkpoint import _named
from denoising_diffusion_deep_fake_tpu_torch.data import device_cache
from denoising_diffusion_deep_fake_tpu_torch.data import loader
from denoising_diffusion_deep_fake_tpu_torch.data.manifest import (
    read_image_manifest,
    write_image_manifest,
)
from denoising_diffusion_deep_fake_tpu_torch.training import runners
from denoising_diffusion_deep_fake_tpu_torch.training.balance import (
    BalanceTrainer,
)
from denoising_diffusion_deep_fake_tpu_torch.training.denoiser import (
    DenoiserTrainer,
)
from denoising_diffusion_deep_fake_tpu_torch.training.loop import LoopContext
from denoising_diffusion_deep_fake_tpu_torch.training.multi_step import (
    make_cached_super_step,
)

S, B = 32, 2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tmp_path(tmp_path):
    """pytest's, emptied after the test: the runners' checkpoints and
    event files would stay on disk until pytest drops the run's directory."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _classed_manifest(root, n):
    manifest = make_image_dataset(root, n=n, size=8)
    classed = root / "classed" / "images.txt"
    write_image_manifest(classed, read_image_manifest(manifest),
                         [0, 0, 0, 1, 1, 2, 2, 2, 2][:n])
    return classed


def _both_caches(manifest, **kw):
    port = device_cache.DeviceDatasetCache(loader.ImageLoader(manifest, **kw),
                                           device="cpu")
    ref = jax_device_cache.DeviceDatasetCache(
        jax_loader.ImageLoader(manifest, use_native=False, **kw))
    return port, ref


# ------------------------------------------------------------ the cache


@pytest.mark.parametrize("balanced", [False, True])
def test_order_for_epoch_matches_jax(tmp_path, balanced):
    """7 images in batches of 2: 3 steps an epoch, the order trimmed to 6."""
    manifest = (_classed_manifest(tmp_path, 7) if balanced
                else make_image_dataset(tmp_path, n=7, size=8))
    port, ref = _both_caches(manifest, batch_size=B, seed=4,
                             class_balanced=balanced)
    assert port.steps_per_epoch == ref.steps_per_epoch == 3
    np.testing.assert_array_equal(port.dataset.numpy(),
                                  np.asarray(ref.dataset))
    buffer = port.order
    for epoch in (0, 1, 5):
        got = port.order_for_epoch(epoch)
        assert got is buffer and got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(ref.order_for_epoch(epoch)))


@pytest.mark.parametrize("tensor_pos", [False, True])
def test_gather_batch_matches_jax_across_the_wrap(tmp_path, tensor_pos):
    manifest = make_image_dataset(tmp_path, n=7, size=8)
    port, ref = _both_caches(manifest, batch_size=B, seed=2)
    spe = port.steps_per_epoch
    order, ref_order = port.order_for_epoch(1), ref.order_for_epoch(1)
    for step in range(2 * spe + 1):
        pos = step % spe * B
        if tensor_pos:
            pos = torch.tensor(pos, dtype=torch.int64)
        got = device_cache.gather_batch(port.dataset, order, pos, B)
        want = jax_device_cache.gather_batch(ref.dataset, ref_order,
                                             jnp.asarray(step), B, spe)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("case", ["over_limit", "under_a_batch"])
def test_refusals_carry_jax_messages(tmp_path, case):
    manifest = make_image_dataset(tmp_path, n=3, size=8)
    kw = (dict(batch_size=2) if case == "over_limit"
          else dict(batch_size=4))
    limit = 100 if case == "over_limit" else 8 << 30
    with pytest.raises(ValueError) as want:
        jax_device_cache.DeviceDatasetCache(
            jax_loader.ImageLoader(manifest, use_native=False, **kw),
            limit_bytes=limit)
    with pytest.raises(ValueError) as got:
        device_cache.DeviceDatasetCache(loader.ImageLoader(manifest, **kw),
                                        limit_bytes=limit, device="cpu")
    assert str(got.value) == str(want.value)


def test_multi_process_cache_is_refused(tmp_path, monkeypatch):
    """No longer refused: inside a process group of two, a rank's cache
    holds its loader's manifest shard (JAX ``device_cache.py:97-136``),
    trimmed to whole local batches, and its epoch order is the shard
    loader's own."""
    manifest = make_image_dataset(tmp_path, n=7, size=8)
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 2)
    shard = loader.ImageLoader(manifest, 2, shard=(1, 2))
    cache = device_cache.DeviceDatasetCache(shard, device="cpu")
    assert cache.n_images == 3 and cache.steps_per_epoch == 1
    want = np.stack([loader.default_decode(p) for p in shard.paths])
    assert np.array_equal(cache.dataset.numpy(), want)
    order = cache.order_for_epoch(2).numpy()
    assert np.array_equal(order, shard._epoch_order(2)[:2])


@pytest.mark.parametrize("overrides,match", [
    (dict(data_cache="device", spatial_parallel=2), "data axis only"),
    (dict(data_cache="hbm"), "data_cache"),
])
def test_config_checks_match_jax(overrides, match):
    data = dict(input_image_list_path="x", batch_size=2, **overrides)
    with pytest.raises(ValueError, match=match):
        jax_config.config_from_dict(jax_config.DenoiserConfig, data)
    with pytest.raises(ValueError, match=match):
        port_config.config_from_dict(port_config.DenoiserConfig, data)


@pytest.mark.parametrize("store", ["empty", "full"])
def test_ram_store(tmp_path, store):
    """The cache decodes without filling the loader's RAM store (a second
    copy on the host), and reuses a store that is already full."""
    manifest = make_image_dataset(tmp_path, n=5, size=8)
    decoded = []

    def decode(path):
        decoded.append(path)
        return loader.default_decode(path)

    ld = loader.ImageLoader(manifest, 2, decode_fn=decode, cache=True)
    if store == "full":
        ld._load_batch(np.arange(5))
    decoded.clear()
    cache = device_cache.DeviceDatasetCache(ld, device="cpu")
    assert len(decoded) == (5 if store == "empty" else 0)
    assert ld._cache_valid.sum() == (0 if store == "empty" else 5)
    want = np.stack([loader.default_decode(p) for p in ld.paths])
    np.testing.assert_array_equal(cache.dataset.numpy(), want)


# ------------------------------------------------------------ the runners


def _event_records(log_dir) -> list:
    """Every record's payload of the event file under ``log_dir`` without
    its leading wall time (field 1, a double), sorted: the balancer's
    histogram and the metric worker write from two threads."""
    (path,) = log_dir.glob("events.out.tfevents.*")
    data, out, i = path.read_bytes(), [], 0
    while i < len(data):
        (n,) = struct.unpack("<Q", data[i:i + 8])
        payload = data[i + 12:i + 12 + n]
        assert payload[:1] == b"\x09"
        out.append(payload[9:])
        i += 16 + n
    return sorted(out)


def _cfg(kind, root, **over):
    common = dict(batch_size=B, encoder_name="resnet18",
                  compute_dtype="float32", image_size=S, max_epochs=2,
                  handle_preemption=False,
                  last_checkpoint_min_interval_s=1e9,
                  log_dir=str(root / "runs"),
                  checkpoint_dir=str(root / "ckpt"))
    data = root.parent.parent / "data"
    if kind == "denoiser":
        return port_config.config_from_dict(port_config.DenoiserConfig, dict(
            common, input_image_list_path=str(data / "a" / "images.txt"),
            **over))
    if kind == "balance":
        return port_config.config_from_dict(port_config.BalanceConfig, dict(
            common, data_path=str(data / "b" / "images.txt"),
            output_image_list_path=str(root / "balanced.txt"),
            number_of_classes=3, **over))
    return port_config.config_from_dict(port_config.DeepFakeConfig, dict(
        common, mode=kind.split("_")[-1], ema_update_after_step=1,
        data_path_a=str(data / "a" / "images.txt"),
        data_path_b=str(data / "b" / "images.txt"), **over))


FIT = {"denoiser": runners.fit_denoiser, "balance": runners.fit_balance,
       "deep_fake_denoise": runners.fit_deep_fake,
       "deep_fake_swap": runners.fit_deep_fake}
# (workload, K): identity a has 7 images (3 steps an epoch: with K = 2 a
# group and the tail single), identity b 5 (2 steps an epoch).
CASES = [("denoiser", 1), ("denoiser", 2), ("deep_fake_denoise", 1),
         ("deep_fake_swap", 2), ("balance", 1), ("balance", 2)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each case's run from the host loader and from the cache, image
    panels at step 2, and for the cached swap run 1 epoch and a resume."""
    root = tmp_path_factory.mktemp("device_cache")
    for name, n in (("a", 7), ("b", 5)):
        make_image_dataset(root / "data" / name, n=n, size=S, seed=len(name)
                           + n)
    patch = pytest.MonkeyPatch()
    patch.setattr(LoopContext, "want_images",
                  lambda self: self.global_step == 2)
    out = {"root": root}

    def run(kind, k, cache, sub, **kw):
        cfg = _cfg(kind, root / "runs" / sub, steps_per_call=k,
                   data_cache=cache)
        calls = []
        result = FIT[kind](cfg, verbose=False, device="cpu",
                           step_callback=lambda step, *_: calls.append(step),
                           **kw)
        return cfg, result, calls

    try:
        for kind, k in CASES:
            for cache in ("host", "device"):
                out[kind, k, cache] = run(kind, k, cache,
                                          f"{kind}_{k}_{cache}")
        cfg, _, _ = run("deep_fake_swap", 2, "device", "resumed",
                        max_steps=2)
        out["resumed"] = run("deep_fake_swap", 2, "device", "resumed",
                             resume_from=cfg.checkpoint_dir)
    finally:
        patch.undo()
    yield out
    shutil.rmtree(root, ignore_errors=True)


def _tensors(state) -> dict:
    out = {f"model.{k}": v for k, v in state.model.state_dict().items()}
    if state.has_ema:
        out.update({f"ema.{k}": v
                    for k, v in state.ema_model.state_dict().items()})
    for i, per in state.optimizer.state_dict()["state"].items():
        out.update({f"adam.{i}.{k}": v for k, v in per.items()})
    return out


def _assert_runs_equal(got, want):
    (g_states, g_trainer, g_ctx), (w_states, w_trainer, w_ctx) = got, want
    assert g_ctx.global_step == w_ctx.global_step
    g_states, w_states = _named(g_states), _named(w_states)
    for name, w in w_states.items():
        g = g_states[name]
        assert (g.step, g.ema_step, g.has_ema) == (w.step, w.ema_step,
                                                   w.has_ema), name
        gt, wt = _tensors(g), _tensors(w)
        assert gt.keys() == wt.keys()
        bad = [k for k in wt if not torch.equal(gt[k], wt[k])]
        assert not bad, (name, bad[:5])
    if w_trainer.generator is not None:
        assert torch.equal(g_trainer.generator.get_state(),
                           w_trainer.generator.get_state())


@pytest.mark.parametrize("kind,k", CASES)
def test_cached_run_is_the_host_run(runs, kind, k):
    host_cfg, host, host_calls = runs[kind, k, "host"]
    dev_cfg, dev, dev_calls = runs[kind, k, "device"]
    assert dev_calls == host_calls
    assert host_calls[-1] == (6 if kind == "denoiser" else 4)
    _assert_runs_equal(dev, host)
    workload = "deep_fake" if kind.startswith("deep_fake") else kind
    records = [_event_records(Path(c.log_dir) / workload)
               for c in (dev_cfg, host_cfg)]
    assert records[0] == records[1]
    assert len(records[0]) > 2 * host_calls[-1]
    if kind == "balance":
        assert (open(dev_cfg.output_image_list_path).read()
                == open(host_cfg.output_image_list_path).read())


def test_cached_resume_is_the_uninterrupted_run(runs):
    _, whole, _ = runs["deep_fake_swap", 2, "device"]
    _, resumed, calls = runs["resumed"]
    assert calls == [3, 4]   # epoch 1: the panel step 2, then step 3
    _assert_runs_equal(resumed, whole)


def test_score_dataset_from_cache_equals_score_dataset(tmp_path):
    """5 images in batches of 2: the tail batch of 1 padded by its image."""
    manifest = make_image_dataset(tmp_path, n=5, size=S)
    cfg = port_config.config_from_dict(port_config.BalanceConfig, dict(
        data_path=str(manifest), batch_size=B, encoder_name="resnet18",
        compute_dtype="float32", image_size=S))
    trainer = BalanceTrainer(cfg, steps_per_epoch=2, image_size=S,
                             device="cpu")
    state = trainer.init_state(1)
    ld = loader.ImageLoader(manifest, B, shuffle=False,
                            drop_remainder=False)
    want_idx, want = trainer.score_dataset(state, ld.epoch(0), epoch=3)
    cache = device_cache.DeviceDatasetCache(loader.ImageLoader(
        manifest, B, seed=9), device="cpu")
    got_idx, got = trainer.score_dataset_from_cache(state, cache, epoch=3)
    np.testing.assert_array_equal(got_idx, np.arange(5))
    np.testing.assert_array_equal(want_idx, np.arange(5))
    np.testing.assert_array_equal(got, want)
    assert len(got) == 5 and np.isfinite(got).all()


def test_k_step_identity_keeps_across_epochs_not_caches(tmp_path):
    """What decides a recapture: a new epoch's order leaves every object
    and pointer of the K-step call's identity as it was; a cache whose
    order buffer or dataset is replaced (a buffer replaced instead of
    filled) gives other tensors, read from the cache at the call."""
    manifest = make_image_dataset(tmp_path, n=5, size=S)
    cfg = port_config.config_from_dict(port_config.DenoiserConfig, dict(
        input_image_list_path=str(manifest), batch_size=B,
        encoder_name="resnet18", compute_dtype="float32", image_size=S))
    trainer = DenoiserTrainer(cfg, steps_per_epoch=2, image_size=S,
                              device="cpu")
    state = trainer.init_state(0)
    cache = device_cache.DeviceDatasetCache(loader.ImageLoader(
        manifest, B, seed=1), device="cpu")
    step = make_cached_super_step(trainer.make_super_step(2), [cache],
                                  cache.steps_per_epoch)
    before = step.identity(state)
    assert before[-2] is cache.dataset and before[-1] is cache.order
    pointers = [o.data_ptr() for o in before if isinstance(o, torch.Tensor)]
    for epoch in range(3):
        cache.order_for_epoch(epoch)
        after = step.identity(state)
        assert len(after) == len(before) and all(
            a is b for a, b in zip(after, before))
        assert [o.data_ptr() for o in after
                if isinstance(o, torch.Tensor)] == pointers
    for i, name in ((-1, "order"), (-2, "dataset")):
        replaced = getattr(cache, name).clone()
        setattr(cache, name, replaced)
        after = step.identity(state)
        assert len(after) == len(before)
        assert after[i] is replaced and before[i] is not replaced
