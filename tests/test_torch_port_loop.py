"""The port's training-from-disk slice against the JAX package, on the CPU.

* ``data/loader.py``: ``ImageLoader``'s cv2 route against JAX's (``use_native=False``
  on both) on PNG datasets: the same epoch order for several (seed, epoch) pairs,
  shuffled and class-balanced; the same batches bit for bit, a cubic
  resize of a mismatched image included; ``PairedLoader``'s length; a
  decode error surfaces; an empty manifest raises; the RAM cache decodes
  each image once; ``device_prefetch`` hands the batches over unchanged.
* ``utils/logging_scheduler.py``: JAX's decisions over a scripted clock.
* ``utils/tb.py``: for the same calls, the port's event file and a
  ``tensorboardX`` file read back by TensorBoard's ``EventAccumulator``
  give the same tags, steps and scalar values, and the same pixels (the
  balancer's histogram, drawn without matplotlib, by its bar heights);
  every record's masked CRC-32C checks against ``tensorboardX``'s
  implementation.
* ``checkpoint.py``: the JAX ``tests/test_checkpoint.py`` cases: the full
  round trip bit for bit (one state; the identity dict with shadows; the
  generator), retention, a chosen step, a missing checkpoint, the
  consistency of a non-blocking save whose states change right after the
  call, a background failure surfacing, ``reset_for_modify``.
* ``training/loop.py``: the JAX ``tests/test_loop_guard.py`` and
  ``tests/test_preemption.py`` cases.
* ``training/runners.py``: ``fit_denoiser`` ends bit-equal to direct
  ``train_step`` calls on the loader's batches (image steps included);
  ``fit_deep_fake`` for 2 epochs bit-equal to 1 epoch and a resume; the
  ``modify`` flip from denoise to swap; ``fit_balance``'s manifest and
  histogram; the denoiser's and balancer's panels against JAX's tags and
  shapes (``jax.eval_shape`` of its step).

32^2, resnet18, batch 2, fp32; torch on one thread, since the test workers
share the machine's cores.
"""

import contextlib
import os
import shutil
import signal
import socket
import struct
import sys
import types

import numpy as np
import pytest
import torch

import flax.linen as flax_nn
import jax
import jax.numpy as jnp

from denoising_diffusion_deep_fake_tpu import config as jax_config
from denoising_diffusion_deep_fake_tpu.data import loader as jax_loader
from denoising_diffusion_deep_fake_tpu.training.balance import (
    BalanceTrainer as JaxBalanceTrainer,
)
from denoising_diffusion_deep_fake_tpu.training.denoiser import (
    DenoiserTrainer as JaxDenoiserTrainer,
)
from denoising_diffusion_deep_fake_tpu.training.runners import (
    _log_difficulty_histogram as jax_log_histogram,
)
from denoising_diffusion_deep_fake_tpu.utils.logging_scheduler import (
    LoggingScheduler as JaxLoggingScheduler,
)
from denoising_diffusion_deep_fake_tpu.utils.tb import (
    TensorBoardLogger as JaxTensorBoardLogger,
)
from denoising_diffusion_deep_fake_tpu_torch import config as port_config
from denoising_diffusion_deep_fake_tpu_torch import checkpoint as ckpt_mod
from denoising_diffusion_deep_fake_tpu_torch.checkpoint import (
    CheckpointManager,
    load_rng_state,
    reset_for_modify,
    save_rng_state,
)
from denoising_diffusion_deep_fake_tpu_torch.data import loader
from denoising_diffusion_deep_fake_tpu_torch.data.manifest import (
    read_image_manifest,
    read_image_manifest_with_classes,
    write_image_manifest,
)
from denoising_diffusion_deep_fake_tpu_torch.ops.augment import (
    AffineAugmentConfig,
    augment_batch,
    sample_affine_params,
)
from denoising_diffusion_deep_fake_tpu_torch.ops.image import panel_grid_u8
from denoising_diffusion_deep_fake_tpu_torch.ops.noise import blend_noise
from denoising_diffusion_deep_fake_tpu_torch.training import runners
from denoising_diffusion_deep_fake_tpu_torch.training.balance import (
    BalanceTrainer,
)
from denoising_diffusion_deep_fake_tpu_torch.training.deep_fake import (
    DeepFakeTrainer,
)
from denoising_diffusion_deep_fake_tpu_torch.training.denoiser import (
    DenoiserTrainer,
)
from denoising_diffusion_deep_fake_tpu_torch.training.loop import (
    LoopContext,
    PreemptionGuard,
    TrainingDivergedError,
)
from denoising_diffusion_deep_fake_tpu_torch.training.optim import make_adam
from denoising_diffusion_deep_fake_tpu_torch.training.state import (
    shadow_tensors,
)
from denoising_diffusion_deep_fake_tpu_torch.utils import tb
from denoising_diffusion_deep_fake_tpu_torch.utils.logging_scheduler import (
    LoggingScheduler,
)

from helpers import make_image_dataset

S, B = 32, 2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tmp_path(tmp_path):
    """pytest's, emptied after the test: the checkpoints of a 32^2
    resnet18 U-Net weigh 57 MB a model and twice that for Adam."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


# ------------------------------------------------------------------ loader


def _both_loaders(manifest, **kw):
    """The cv2 route of both loaders (the native route is held against
    JAX's in test_torch_port_codec.py)."""
    return (loader.ImageLoader(manifest, use_native=False, **kw),
            jax_loader.ImageLoader(manifest, use_native=False, **kw))


def _classed_manifest(tmp_path, n=9):
    manifest = make_image_dataset(tmp_path, n=n, size=8)
    classed = tmp_path / "bal" / "images.txt"
    write_image_manifest(classed, read_image_manifest(manifest),
                         [0, 0, 0, 0, 0, 0, 1, 1, 2][:n])
    return classed


@pytest.mark.parametrize("seed,epoch", [(0, 0), (0, 1), (7, 3)])
@pytest.mark.parametrize("balanced", [False, True])
def test_epoch_order_matches_jax(tmp_path, seed, epoch, balanced):
    manifest = (_classed_manifest(tmp_path) if balanced
                else make_image_dataset(tmp_path, n=9, size=8))
    port, ref = _both_loaders(manifest, batch_size=2, seed=seed,
                              class_balanced=balanced)
    np.testing.assert_array_equal(port._epoch_order(epoch),
                                  ref._epoch_order(epoch))


def test_batches_match_jax_with_a_resized_image(tmp_path):
    import cv2

    manifest = make_image_dataset(tmp_path, n=7, size=S)
    odd = np.random.default_rng(3).integers(0, 256, (20, 44, 3), np.uint8)
    cv2.imwrite(str(tmp_path / "000002.png"), odd)   # not S x S: resized
    for drop in (True, False):
        port, ref = _both_loaders(manifest, batch_size=3, seed=4,
                                  drop_remainder=drop)
        assert port.image_size == ref.image_size == S
        assert port.batches_per_epoch == ref.batches_per_epoch
        for epoch in (0, 1):
            got, want = list(port.epoch(epoch)), list(ref.epoch(epoch))
            assert len(got) == len(want) == port.batches_per_epoch
            for (gb, gi), (wb, wi) in zip(got, want):
                assert gb.dtype == np.uint8 and gi.dtype == np.int32
                np.testing.assert_array_equal(gb, wb)
                np.testing.assert_array_equal(gi, wi)


def test_paired_loader_length_and_pairs(tmp_path):
    a = make_image_dataset(tmp_path / "a", n=7, size=8)
    b = make_image_dataset(tmp_path / "b", n=4, size=8, seed=1)
    port = loader.PairedLoader(loader.ImageLoader(a, 2),
                               loader.ImageLoader(b, 2, seed=1))
    ref = jax_loader.PairedLoader(
        jax_loader.ImageLoader(a, 2, use_native=False),
        jax_loader.ImageLoader(b, 2, seed=1, use_native=False))
    assert port.batches_per_epoch == ref.batches_per_epoch == 2
    got, want = list(port.epoch(1)), list(ref.epoch(1))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for (gb, gi), (wb, wi) in zip(g, w):
            np.testing.assert_array_equal(gb, wb)
            np.testing.assert_array_equal(gi, wi)
    with pytest.raises(ValueError, match="image_size"):
        loader.PairedLoader(loader.ImageLoader(a, 2),
                            loader.ImageLoader(b, 2, image_size=16))


def test_loader_errors(tmp_path):
    manifest = make_image_dataset(tmp_path, n=4, size=8)

    def broken(path):
        raise IOError(f"cannot decode {path}")

    bad = loader.ImageLoader(manifest, 2, image_size=8, decode_fn=broken)
    with pytest.raises(IOError, match="cannot decode"):
        list(bad.epoch(0))
    empty = tmp_path / "empty.txt"
    empty.write_text("")
    with pytest.raises(ValueError, match="empty image manifest"):
        loader.ImageLoader(empty, 2)
    with pytest.raises(ValueError, match="difficulty-classed"):
        loader.ImageLoader(manifest, 2, class_balanced=True)
    with pytest.raises(ValueError, match="every process"):
        loader.ImageLoader(manifest, 2, shard=(0, 8))


def test_ram_cache_decodes_each_image_once(tmp_path):
    manifest = make_image_dataset(tmp_path, n=6, size=16)
    calls = []

    def counting(path):
        calls.append(path)
        return loader.default_decode(path)

    cached = loader.ImageLoader(manifest, 3, image_size=16,
                                decode_fn=counting)
    first = [b for b, _ in cached.epoch(0)]
    assert len(calls) == 6
    again = [b for b, _ in cached.epoch(0)]
    assert len(calls) == 6
    for a, b in zip(first, again):
        np.testing.assert_array_equal(a, b)
    assert not loader.ImageLoader(manifest, 2, cache_limit_bytes=10
                                  )._cache_enabled


def test_device_prefetch_hands_batches_over(tmp_path):
    manifest = make_image_dataset(tmp_path, n=6, size=8)
    ld = loader.ImageLoader(manifest, 2)
    host = list(ld.epoch(0))
    got = list(loader.device_prefetch(ld.epoch(0), "cpu"))
    assert len(got) == len(host)
    for (gb, gi), (hb, hi) in zip(got, host):
        assert isinstance(gb, torch.Tensor) and gb.dtype == torch.uint8
        np.testing.assert_array_equal(gb.numpy(), hb)
        np.testing.assert_array_equal(gi, hi)   # 1-D: stays on the host
    # Leaving early stops the worker; an error reaches the consumer.
    with contextlib.closing(loader.device_prefetch(ld.epoch(0), "cpu")) as g:
        next(g)

    def failing():
        yield (np.zeros((1, 2, 2, 3), np.uint8),)
        raise RuntimeError("upstream")

    with pytest.raises(RuntimeError, match="upstream"):
        list(loader.device_prefetch(failing(), "cpu"))


# --------------------------------------------------------------- scheduler


def test_scheduler_decisions_match_jax():
    t = [100.0]
    port, ref = LoggingScheduler(lambda: t[0]), JaxLoggingScheduler(
        lambda: t[0])
    # (step, seconds since start): crosses 10 s, 1 min, 15 min and 2 h,
    # repeats a step, and logs each interval once on either side of it.
    script = [(0, 0), (1, 5), (2, 10.5), (2, 30), (3, 21), (4, 59), (5, 62),
              (6, 90), (7, 125), (8, 899), (9, 960), (10, 1500), (11, 1561),
              (12, 2200), (13, 7199), (14, 7300), (15, 10900), (16, 10905),
              (17, 14600)]
    decisions = []
    for step, elapsed in script:
        t[0] = 100.0 + elapsed
        port.update_with_step_number(step)
        ref.update_with_step_number(step)
        assert port.should_we_log_this_step() == \
            ref.should_we_log_this_step(), (step, elapsed)
        decisions.append(port.should_we_log_this_step())
    assert True in decisions and False in decisions
    for elapsed in (30, 300, 3600, 10000):
        assert port.interval_for_elapsed(elapsed) == \
            ref.interval_for_elapsed(elapsed)


# ------------------------------------------------------------- tensorboard


def _records(path):
    """Every record of an event file, each CRC checked with tensorboardX's
    own CRC-32C."""
    from tensorboardX.record_writer import masked_crc32c

    data, out, i = path.read_bytes(), [], 0
    while i < len(data):
        header = data[i:i + 8]
        (n,) = struct.unpack("<Q", header)
        (crc_h,) = struct.unpack("<I", data[i + 8:i + 12])
        payload = data[i + 12:i + 12 + n]
        (crc_p,) = struct.unpack("<I", data[i + 12 + n:i + 16 + n])
        assert crc_h == masked_crc32c(header)
        assert crc_p == masked_crc32c(payload)
        out.append(payload)
        i += 16 + n
    return out


def _accumulate(log_dir):
    # TensorBoard's own stub of the TF API reads event files; importing
    # TensorFlow itself would take longer than this whole file.
    sys.modules.setdefault("tensorboard.compat.notf",
                           types.ModuleType("tensorboard.compat.notf"))
    from tensorboard.backend.event_processing import event_accumulator as ea

    acc = ea.EventAccumulator(str(log_dir), size_guidance={
        ea.SCALARS: 0, ea.IMAGES: 0})
    acc.Reload()
    return acc


def _pixels(encoded: bytes) -> np.ndarray:
    import io

    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(encoded)).convert("RGB"))


def test_event_file_reads_like_tensorboardx(tmp_path):
    rng = np.random.default_rng(0)
    grid_u8 = rng.integers(0, 256, (36, 104, 3), np.uint8)
    batch = (rng.random((9, 8, 8, 3)).astype(np.float32) * 2.4 - 1.2)
    classes = np.array([0, 1, 1, 3, 3, 3, 9, 9, 2, 1, 1, 1])
    writers = {"port": tb.TensorBoardLogger(tmp_path / "port"),
               "jax": JaxTensorBoardLogger(tmp_path / "jax")}
    for name, w in writers.items():
        w.log_scalars({"loss": 0.25, "lr": 0.01, "epoch": 0.0}, 0)
        w.log_scalars({"loss": float(np.float32(0.1) / 3), "lr": 0.005,
                       "epoch": 1.0}, 7)
        w.log_batch_as_image_grid("panel_u8", grid_u8, 3)
        w.log_batch_as_image_grid("panel_float", batch, 5)
        if name == "port":
            w.log_figure(runners.HISTOGRAM_TAG,
                         runners.difficulty_histogram_image(classes, 10), 7)
        else:
            jax_log_histogram(types.SimpleNamespace(tb=w, global_step=7),
                              classes)
        w.flush()
        w.close()
    port_file = next((tmp_path / "port").glob("events.out.tfevents.*"))
    assert port_file.name.endswith("." + socket.gethostname())
    assert len(_records(port_file)) == 1 + 6 + 3
    port, ref = _accumulate(tmp_path / "port"), _accumulate(tmp_path / "jax")
    assert sorted(port.Tags()["scalars"]) == sorted(ref.Tags()["scalars"])
    assert sorted(port.Tags()["images"]) == sorted(ref.Tags()["images"])
    for tag in ref.Tags()["scalars"]:
        assert [(e.step, e.value) for e in port.Scalars(tag)] == \
            [(e.step, e.value) for e in ref.Scalars(tag)]
    for tag in ("panel_u8", "panel_float"):
        (got,), (want,) = port.Images(tag), ref.Images(tag)
        assert (got.step, got.width, got.height) == \
            (want.step, want.width, want.height)
        np.testing.assert_array_equal(_pixels(got.encoded_image_string),
                                      _pixels(want.encoded_image_string))
    (hist,) = port.Images(runners.HISTOGRAM_TAG)
    (ref_hist,) = ref.Images(runners.HISTOGRAM_TAG)
    assert hist.step == ref_hist.step == 7
    # One bar a class, the tallest class's bar the plot's full height.
    img = _pixels(hist.encoded_image_string)
    h, w = runners.HISTOGRAM_SIZE
    m = runners.HISTOGRAM_MARGIN
    slot = (w - 2 * m) // 10
    counts = np.bincount(classes, minlength=10)
    bar = np.all(img == runners.HISTOGRAM_BAR, axis=-1)
    heights = [int(bar[:, m + i * slot + slot // 2].sum()) for i in range(10)]
    assert heights == [round((h - 2 * m) * c / counts.max()) for c in counts]


# -------------------------------------------------------------- checkpoint


def _denoiser(tmp_path=None, **extra):
    cfg = dict(input_image_list_path="x", batch_size=B,
               encoder_name="resnet18", compute_dtype="float32",
               image_size=S, seed=3)
    if tmp_path is not None:
        cfg.update(log_dir=str(tmp_path / "runs"),
                   checkpoint_dir=str(tmp_path / "ckpt"))
    return port_config.config_from_dict(port_config.DenoiserConfig,
                                        dict(cfg, **extra))


def _stepped_denoiser(seed=0, steps=1):
    trainer = DenoiserTrainer(_denoiser(), steps_per_epoch=4, image_size=S,
                              device="cpu")
    state = trainer.init_state(seed)
    u8 = torch.from_numpy(np.random.default_rng(seed).integers(
        0, 256, (B, S, S, 3), np.uint8))
    for _ in range(steps):
        trainer.train_step(state, u8)
    return trainer, state


def _deep_fake_cfg(tmp_path=None, **extra):
    cfg = dict(mode="denoise", data_path_a="a", data_path_b="b",
               batch_size=B, encoder_name="resnet18",
               compute_dtype="float32", image_size=S, seed=5,
               ema_update_after_step=1)
    if tmp_path is not None:
        cfg.update(log_dir=str(tmp_path / "runs"),
                   checkpoint_dir=str(tmp_path / "ckpt"))
    return port_config.config_from_dict(port_config.DeepFakeConfig,
                                        dict(cfg, **extra))


def _stepped_swap_pair(steps=3):
    trainer = DeepFakeTrainer(_deep_fake_cfg(mode="swap"), steps_per_epoch=2,
                              image_size=S, device="cpu")
    states = trainer.init_states(seed=1)
    rng = np.random.default_rng(1)
    for _ in range(steps):
        a, b = (torch.from_numpy(rng.integers(0, 256, (B, S, S, 3),
                                              np.uint8)) for _ in "ab")
        trainer.train_step(states, a, b)
    return trainer, states


def _tensors(state) -> dict:
    """Every tensor of a state: model, shadow, optimizer."""
    out = {f"model.{k}": v for k, v in state.model.state_dict().items()}
    if state.has_ema:
        out.update({f"ema.{k}": v
                    for k, v in state.ema_model.state_dict().items()})
    for i, per in state.optimizer.state_dict()["state"].items():
        out.update({f"opt.{i}.{k}": v for k, v in per.items()})
    return out


def assert_states_equal(got, want):
    got, want = ckpt_mod._named(got), ckpt_mod._named(want)
    assert got.keys() == want.keys()
    for name in want:
        g, w = got[name], want[name]
        assert (g.step, g.ema_step, g.has_ema) == \
            (w.step, w.ema_step, w.has_ema), name
        gt, wt = _tensors(g), _tensors(w)
        assert gt.keys() == wt.keys(), name
        bad = [k for k in wt if not torch.equal(gt[k], wt[k])]
        assert not bad, (name, bad[:5])


@pytest.mark.parametrize("kind", ["single", "identity_dict"])
def test_checkpoint_round_trip_bit_equal(tmp_path, kind):
    if kind == "single":
        trainer, states = _stepped_denoiser()
        build = lambda: trainer.init_state(9)   # noqa: E731
    else:
        trainer, states = _stepped_swap_pair()
        assert all(s.ema_step > 1 for s in states.values())
        build = lambda: trainer.init_states(9, with_ema=True)  # noqa: E731
    manager = CheckpointManager(tmp_path)
    extra = save_rng_state({"epoch": 2}, trainer.generator)
    manager.save(4, states, {"k": 1}, extra)
    drawn = torch.rand(5, generator=trainer.generator)
    fresh = torch.Generator().manual_seed(123)
    restored, meta = manager.restore(build, generator=fresh)
    assert meta["step"] == 4 and meta["extra"]["epoch"] == 2
    assert_states_equal(restored, states)
    assert torch.equal(torch.rand(5, generator=fresh), drawn)
    if kind == "single":
        assert (tmp_path / "step_0000000004" / "state" / "model.pt").exists()
        # The states built for a restore must match the checkpoint's.
        with pytest.raises(ValueError, match="no 'a' state"):
            manager.restore(lambda: {"a": trainer.init_state(0)})
    else:
        with pytest.raises(ValueError, match="EMA shadow"):
            manager.restore(lambda: trainer.init_states(0, with_ema=False))


def test_checkpoint_retention_and_chosen_step(tmp_path):
    trainer, state = _stepped_denoiser(steps=0)
    manager = CheckpointManager(tmp_path, keep=2)
    saved = {}
    for step in (1, 2, 3):
        with torch.no_grad():
            next(state.model.parameters()).add_(1.0)
        state.step = step
        manager.save(step, state, {"v": step})
        saved[step] = {k: v.clone() for k, v in _tensors(state).items()}
    assert manager.all_steps() == [2, 3]
    restored, meta = manager.restore(lambda: trainer.init_state(0), step=2)
    assert meta["hparams"] == {"v": 2} and restored.step == 2
    assert all(torch.equal(v, saved[2][k])
               for k, v in _tensors(restored).items())
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path / "empty").restore(
            lambda: trainer.init_state(0))


def test_async_save_is_consistent(tmp_path):
    """``block=False``: the files hold the states as they were at the
    call, though the states change right after it."""
    trainer, state = _stepped_denoiser()
    want = {k: v.clone() for k, v in _tensors(state).items()}
    manager = CheckpointManager(tmp_path, keep=2)
    manager.save(1, state, {"lr": 0.1}, block=False)
    with torch.no_grad():
        for t in _tensors(state).values():
            if t.is_floating_point():
                t.add_(1.0)
    state.step = 99
    # A second save right after waits for the first.
    manager.save(2, state, {"lr": 0.2}, block=False)
    assert manager.read_meta(1)["hparams"]["lr"] == 0.1
    assert manager.all_steps() == [1, 2]
    restored, _ = manager.restore(lambda: trainer.init_state(0), step=1)
    assert restored.step == 1
    assert all(torch.equal(v, want[k])
               for k, v in _tensors(restored).items())


def test_async_save_failure_surfaces(tmp_path, monkeypatch):
    _, state = _stepped_denoiser(steps=0)
    manager = CheckpointManager(tmp_path)

    def full_disk(*args, **kwargs):
        raise IOError("disk full")

    monkeypatch.setattr(ckpt_mod.torch, "save", full_disk)
    manager.save(1, state, {}, block=False)
    with pytest.raises(RuntimeError, match="async checkpoint save failed"):
        manager.wait_until_finished()
    manager.wait_until_finished()   # the error is reported once
    assert manager.all_steps() == []


def test_reset_for_modify_keeps_weights_fresh_optimizer():
    trainer, states = _stepped_swap_pair(steps=2)
    before = {n: _tensors(s) for n, s in states.items()}
    make = lambda params: make_adam(params, 0.01, device=trainer.device)  # noqa
    reset_for_modify(states, make)
    for name, state in states.items():
        assert state.step == 0 and state.optimizer.state_dict()["state"] == {}
        assert state.ema_step == 2 and state.has_ema
        for k, v in _tensors(state).items():
            assert torch.equal(v, before[name][k]), k
        params = list(state.model.parameters())
        assert state.optimizer.param_groups[0]["params"] == params


def test_generator_state_refuses_another_device_type():
    g = torch.Generator().manual_seed(1)
    extra = save_rng_state({}, g)
    assert extra["rng_device"] == "cpu"
    with pytest.raises(ValueError, match="saved on 'cuda'"):
        load_rng_state(dict(extra, rng_device="cuda"), g)
    assert not load_rng_state({}, g)


# -------------------------------------------------------------------- loop


def _ctx(tmp_path, clock=None, **over):
    cfg = _denoiser(tmp_path, **over)
    kw = {} if clock is None else {"clock": clock}
    return LoopContext(cfg, {"k": 1}, workload="denoiser", **kw)


def test_nan_metric_raises_with_emergency_checkpoint(tmp_path):
    trainer, state = _stepped_denoiser()
    ctx = _ctx(tmp_path)
    ctx.log_step({"loss": torch.tensor(float("nan"))})
    with pytest.raises(TrainingDivergedError, match="loss"):
        ctx.drain_metrics(states=state, generator=trainer.generator)
    assert ctx.ckpt.latest_step() == 0
    ctx.close()


def test_nan_metric_surfaces_at_close(tmp_path):
    ctx = _ctx(tmp_path)
    ctx.log_step({"loss": torch.tensor(float("inf")), "lr": 0.1})
    with pytest.raises(TrainingDivergedError, match="loss"):
        ctx.close()


def test_async_scalars_reach_the_event_file(tmp_path):
    ctx = _ctx(tmp_path, log_every_n_steps=2)
    for i in range(5):
        ctx.log_step({"loss": torch.tensor(0.125 * i), "lr": 0.5})
        ctx.global_step += 1
    ctx.close()
    acc = _accumulate(tmp_path / "runs" / "denoiser")
    assert [(e.step, e.value) for e in acc.Scalars("loss")] == \
        [(0, 0.0), (2, 0.25), (4, 0.5)]
    assert [e.value for e in acc.Scalars("lr")] == [0.5] * 3


def test_wall_clock_checkpoint_cadence(tmp_path):
    t = [1000.0]
    trainer, state = _stepped_denoiser(steps=0)
    ctx = _ctx(tmp_path, clock=lambda: t[0], checkpoint_every_hours=1.0,
               last_checkpoint_min_interval_s=600.0)
    ctx.maybe_checkpoint(state, trainer.generator)
    ctx.maybe_checkpoint(state, trainer.generator, force=True)
    assert ctx.ckpt.latest_step() is None        # neither due yet
    t[0] += 3601
    ctx.global_step = 7
    ctx.maybe_checkpoint(state, trainer.generator)   # non-blocking
    assert ctx.ckpt.latest_step() == 7
    t[0] += 599
    ctx.global_step = 8
    ctx.maybe_checkpoint(state, trainer.generator, force=True)
    assert ctx.ckpt.latest_step() == 7           # rate-limited
    t[0] += 1
    ctx.maybe_checkpoint(state, trainer.generator, force=True)
    assert ctx.ckpt.latest_step() == 8
    ctx.close()


def test_guard_catches_sigterm_and_restores():
    previous = signal.getsignal(signal.SIGTERM)
    guard = PreemptionGuard()
    try:
        assert not guard.triggered
        os.kill(os.getpid(), signal.SIGTERM)
        assert guard.triggered
    finally:
        guard.restore()
    assert signal.getsignal(signal.SIGTERM) == previous


def test_sigterm_mid_run_ends_training_with_final_checkpoint(tmp_path):
    manifest = make_image_dataset(tmp_path, n=4, size=S)
    cfg = _denoiser(tmp_path, input_image_list_path=str(manifest),
                    max_epochs=100_000)

    def sigterm_at_step_3(step, state, metrics):
        if step == 3:
            os.kill(os.getpid(), signal.SIGTERM)

    state, _, ctx = runners.fit_denoiser(cfg, verbose=False, device="cpu",
                                         step_callback=sigterm_at_step_3)
    assert ctx.preempted() and ctx.global_step == 3 and state.step == 3
    assert CheckpointManager(cfg.checkpoint_dir).all_steps() == [3]


# ----------------------------------------------------------------- runners


def _images_every_other_step(monkeypatch):
    """Image steps at even global steps, whatever the wall clock says."""
    monkeypatch.setattr(LoopContext, "want_images",
                        lambda self: self.global_step % 2 == 0)


def test_fit_denoiser_is_its_train_steps(tmp_path, monkeypatch):
    _images_every_other_step(monkeypatch)
    manifest = make_image_dataset(tmp_path, n=8, size=S)
    cfg = _denoiser(tmp_path, input_image_list_path=str(manifest),
                    max_epochs=1)
    state, trainer, ctx = runners.fit_denoiser(cfg, verbose=False,
                                               device="cpu")
    assert ctx.global_step == state.step == 4

    direct = DenoiserTrainer(_denoiser(tmp_path, input_image_list_path=str(
        manifest), max_epochs=1), steps_per_epoch=4, image_size=S,
        device="cpu")
    want = direct.init_state(cfg.seed)
    for batch, _ in loader.ImageLoader(manifest, B, seed=cfg.seed).epoch(0):
        direct.train_step(want, torch.from_numpy(batch))
    assert_states_equal(state, want)
    assert torch.equal(trainer.generator.get_state(),
                       direct.generator.get_state())
    restored, meta = CheckpointManager(cfg.checkpoint_dir).restore(
        lambda: direct.init_state(0))
    assert_states_equal(restored, want)
    assert meta["extra"]["global_step"] == 4
    assert meta["hparams"] == port_config.config_to_dict(cfg)
    acc = _accumulate(tmp_path / "runs" / "denoiser")
    assert [e.step for e in acc.Scalars("loss")] == [0, 1, 2, 3]
    for tag in ("image", "image_noisy", "image_prediction"):
        assert [e.step for e in acc.Images(tag)] == [0, 2]


@pytest.fixture(scope="module")
def deep_fake_runs(tmp_path_factory):
    """Swap mode, 2 epochs of 2 steps: uninterrupted, and stopped after
    epoch 0 then resumed from its checkpoint."""
    root = tmp_path_factory.mktemp("deep_fake")
    manifests = [make_image_dataset(root / n, n=5, size=S, seed=i)
                 for i, n in enumerate("ab")]
    patch = pytest.MonkeyPatch()
    _images_every_other_step(patch)
    runs = {}
    try:
        for name in ("whole", "resumed"):
            cfg = _deep_fake_cfg(root / name, mode="swap", max_epochs=2,
                                 data_path_a=str(manifests[0]),
                                 data_path_b=str(manifests[1]))
            if name == "resumed":
                runners.fit_deep_fake(cfg, max_steps=2, verbose=False,
                                      device="cpu")
                starts = []
                runs[name] = runners.fit_deep_fake(
                    cfg, resume_from=cfg.checkpoint_dir, verbose=False,
                    device="cpu", step_callback=lambda step, *_: (
                        starts.append(step)))
                runs["resumed_first_step"] = starts[0]
            else:
                runs[name] = runners.fit_deep_fake(cfg, verbose=False,
                                                   device="cpu")
    finally:
        patch.undo()
    runs["root"] = root
    yield runs
    shutil.rmtree(root, ignore_errors=True)


def test_resume_is_bit_equal_to_the_uninterrupted_run(deep_fake_runs):
    whole_states, whole_trainer, whole_ctx = deep_fake_runs["whole"]
    states, trainer, ctx = deep_fake_runs["resumed"]
    assert deep_fake_runs["resumed_first_step"] == 3   # started at step 2
    assert ctx.global_step == whole_ctx.global_step == 4
    assert all(s.has_ema and s.ema_step == 4 for s in states.values())
    assert_states_equal(states, whole_states)
    assert torch.equal(trainer.generator.get_state(),
                       whole_trainer.generator.get_state())
    # The resumed run's event file has epoch 1's rows and panels.
    root = deep_fake_runs["root"]
    resumed_log = max((root / "resumed" / "runs" / "deep_fake").glob(
        "events.*"), key=lambda p: p.stat().st_mtime)
    records = _records(resumed_log)
    assert any(b"swap_4_model_prediction/b" in r for r in records)


def test_modify_flips_denoise_to_swap(deep_fake_runs, tmp_path):
    root = deep_fake_runs["root"]
    manifests = [str(root / n / "images.txt") for n in "ab"]
    cfg = _deep_fake_cfg(tmp_path / "denoise", max_epochs=1,
                         data_path_a=manifests[0], data_path_b=manifests[1])
    denoised, _, _ = runners.fit_deep_fake(cfg, verbose=False, device="cpu")
    assert all(not s.has_ema and s.step == 2 for s in denoised.values())
    flip = port_config.overlay_config(
        port_config.DeepFakeConfig, port_config.config_to_dict(cfg),
        dict(mode="swap", learning_rate=0.005, ema_update_after_step=100,
             checkpoint_dir=str(tmp_path / "swap")))
    seen = {}

    def at_flip(step, states, metrics):
        seen.update({n: (s.step, dict(s.optimizer.state_dict()["state"]))
                     for n, s in states.items()})

    states, trainer, ctx = runners.fit_deep_fake(
        flip, modify_from=cfg.checkpoint_dir, max_steps=1, verbose=False,
        device="cpu", step_callback=at_flip)
    assert ctx.global_step == 1 and ctx.epoch == 0
    for name, state in states.items():
        # A fresh Adam and step: one update made.
        assert seen[name][0] == 1 and state.ema_step == 1
        assert all(float(p["step"]) == 1 for p in seen[name][1].values())
    # Decay 0 in the warm-up: ema_b is b before its step (the checkpoint's
    # weights), ema_a is a after its step.
    for got, want in zip(shadow_tensors(states["b"].ema_model),
                         shadow_tensors(denoised["b"].model)):
        assert torch.equal(got, want)
    for got, want in zip(shadow_tensors(states["a"].ema_model),
                         shadow_tensors(states["a"].model)):
        assert torch.equal(got, want)
    assert trainer.cfg.learning_rate == 0.005


def test_fit_balance_writes_a_manifest(tmp_path, monkeypatch):
    _images_every_other_step(monkeypatch)
    manifest = make_image_dataset(tmp_path, n=5, size=S)
    out = tmp_path / "balanced.txt"
    cfg = port_config.config_from_dict(port_config.BalanceConfig, dict(
        data_path=str(manifest), output_image_list_path=str(out),
        batch_size=B, encoder_name="resnet18", compute_dtype="float32",
        max_epochs=1, number_of_classes=4, log_dir=str(tmp_path / "runs"),
        checkpoint_dir=str(tmp_path / "ckpt")))
    state, _, ctx = runners.fit_balance(cfg, verbose=False, device="cpu")
    assert ctx.global_step == state.step == 2
    paths, classes = read_image_manifest_with_classes(out)
    assert paths == read_image_manifest(manifest)
    assert len(classes) == 5 and 0 in classes and 3 in classes
    acc = _accumulate(tmp_path / "runs" / "balance")
    assert [e.step for e in acc.Images(runners.HISTOGRAM_TAG)] == [2]
    assert [e.step for e in acc.Images("image_prediction")] == [0]
    assert "rng_state" not in CheckpointManager(
        cfg.checkpoint_dir).read_meta()["extra"]


# ------------------------------------------------------------------ panels


class _TinyFlaxModel(flax_nn.Module):
    """The JAX step's tags and panel shapes do not depend on the model."""

    @flax_nn.compact
    def __call__(self, x, train=True):
        x = flax_nn.Conv(3, (1, 1))(x)
        return flax_nn.BatchNorm(use_running_average=not train)(x)


def _jax_panel_shapes(kind):
    if kind == "denoiser":
        cfg = jax_config.config_from_dict(jax_config.DenoiserConfig, dict(
            input_image_list_path="x", batch_size=B))
        trainer = JaxDenoiserTrainer(cfg, steps_per_epoch=1, image_size=S)
    else:
        cfg = jax_config.config_from_dict(jax_config.BalanceConfig, dict(
            data_path="x", batch_size=B))
        trainer = JaxBalanceTrainer(cfg, steps_per_epoch=1, image_size=S)
    trainer.model = _TinyFlaxModel()
    state = jax.eval_shape(lambda: trainer.init_state(jax.random.PRNGKey(0)))
    batch = jax.ShapeDtypeStruct((B, S, S, 3), jnp.uint8)
    _, _, images = jax.eval_shape(
        lambda s, x: trainer._train_step(s, x, jax.random.PRNGKey(0),
                                         with_images=True), state, batch)
    return {tag: (tuple(x.shape), np.dtype(x.dtype))
            for tag, x in images.items()}


@pytest.mark.parametrize("kind", ["denoiser", "balancer"])
def test_single_model_panels(kind):
    rng = np.random.default_rng(4)
    u8 = torch.from_numpy(rng.integers(0, 256, (B, S, S, 3), np.uint8))
    noise = torch.from_numpy(rng.standard_normal((B, S, S, 3)).astype(
        np.float32))
    if kind == "denoiser":
        cfg = _denoiser()
        trainer = DenoiserTrainer(cfg, steps_per_epoch=1, image_size=S,
                                  device="cpu")
        params = sample_affine_params(
            B, AffineAugmentConfig.random_affine(),
            generator=torch.Generator().manual_seed(2))
        ratios = torch.tensor([0.2, 0.6])
        image = augment_batch(u8, cfg.mean, cfg.std, trainer.aug,
                              params=params)
        noisy = blend_noise(image, noise, ratios.reshape(B, 1, 1, 1))
        kw = dict(affine_params=params, ratios=ratios, noise=noise)
    else:
        cfg = port_config.config_from_dict(port_config.BalanceConfig, dict(
            data_path="x", batch_size=B, encoder_name="resnet18",
            compute_dtype="float32"))
        trainer = BalanceTrainer(cfg, steps_per_epoch=1, image_size=S,
                                 device="cpu")
        image, noisy = trainer._images(u8, 0, noise)
        kw = dict(noise=noise)
    state = trainer.init_state(0)
    seen = []
    state.model.register_forward_hook(
        lambda m, args, out: seen.append(out.detach().clone()))
    metrics, panels = trainer.train_step(state, u8, with_images=True, **kw)
    assert torch.isfinite(metrics["loss"])
    assert {t: (tuple(p.shape), np.dtype("uint8"))
            for t, p in panels.items()} == _jax_panel_shapes(kind)
    for tag, x in (("image", image), ("image_noisy", noisy),
                   ("image_prediction", seen[0])):
        assert torch.equal(panels[tag], panel_grid_u8(x)), tag
