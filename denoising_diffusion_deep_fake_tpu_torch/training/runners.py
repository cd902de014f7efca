"""Workload runners: config -> data -> trainer -> loop -> checkpoints.

Port of ``denoising_diffusion_deep_fake_tpu/training/runners.py:276-502``.
Each ``fit_*`` is one reference CLI entry point, end to end:

* ``fit_deep_fake``: ``d3f train new``, and with ``resume_from`` or
  ``modify_from`` ``train resume`` / ``train modify``;
* ``fit_denoiser``: ``d3f denoise``;
* ``fit_balance``: ``d3f balance``, which also writes the difficulty-classed
  manifest the reference never wrote.

All three read uint8 batches from an ``images.txt`` manifest
(``data/loader.py``), upload them ahead of the step (``device_prefetch``),
take one trainer step a batch (with image panels when the loop's
wall-clock scheduler asks for them), and hand metrics, panels and
checkpoints to ``training/loop.py``. Each runs on ``device`` (``cuda``
when None; it raises without one) and decodes with ``decode_fn``, or
when None with the loader's choice (``data/loader.py``: the native batch
loader, cv2, or the port's codec, nvJPEG on a CUDA machine without cv2;
each run prints ``loader.decoder``).

With ``steps_per_call: K > 1``, ``_drive_epoch`` groups steps as JAX's
(``runners.py:159-230`` there): K consecutive steps run as one call of the
trainer's ``make_super_step`` (one CUDA graph replay on the card,
``training/multi_step.py``) whenever no image panel is due, nothing is
buffered and a whole group fits before ``max_steps``; image steps, epoch
tails and ``max_steps`` remainders run as single steps. ``step_callback``,
the checkpoint check and the preemption check run once a group, the loop
fans the group's metrics out to one row a step.

Resume, as JAX's: the checkpoint's own ``mode`` decides whether shadows are
built before the restore; training starts at the epoch after the saved one,
at the saved ``global_step``, with the trainer's generator restored.
``modify`` keeps the weights, BN buffers and shadows, gives fresh
optimizers and steps, and attaches shadows in swap mode (``ensure_ema``).

With ``data_cache: device`` (JAX ``runners.py:90-134``, ``:232-237``)
each loader's decoded dataset goes to the device once
(``data/device_cache.py``) and the step calls are ``training/cached.py``'s:
an epoch copies its order to the device and drives steps that gather
their own batches, with no loader thread and no ``device_prefetch``;
``fit_balance`` scores from the cache (JAX ``:452-463``). A cache that
cannot be made raises: there is no way back to the host loader.

Data parallelism (JAX ``:280-293, :359-368, :407-414``): each ``fit_*``
first opens the process group when the ``D3F_*`` launch variables are set
(``parallel/distributed.py``); each rank then loads its data row's shard
of the manifest at the local batch size (``batch_size // data``, ``data =
processes // spatial_parallel``: the spatial ranks of a data row load the
same whole images and keep their H rows after the warp), builds its cache
from that shard, makes every rank's states rank 0's after the init
or the restore (``shard_state``), and runs the loop in lockstep
(``training/loop.py``), the primary alone printing, logging and saving.
The balancer scores the whole unsharded dataset on every rank, through
the host loader when the device cache holds only a shard, and the primary
writes the histogram and the manifest.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable, NamedTuple

import numpy as np

from denoising_diffusion_deep_fake_tpu_torch.checkpoint import (
    CheckpointManager,
    reset_for_modify,
)
from denoising_diffusion_deep_fake_tpu_torch.config import (
    BalanceConfig,
    DeepFakeConfig,
    DenoiserConfig,
    config_to_dict,
)
from denoising_diffusion_deep_fake_tpu_torch.data.device_cache import (
    DeviceDatasetCache,
)
from denoising_diffusion_deep_fake_tpu_torch.data.loader import (
    ImageLoader,
    PairedLoader,
    device_prefetch,
)
from denoising_diffusion_deep_fake_tpu_torch.data.manifest import (
    write_image_manifest,
)
from denoising_diffusion_deep_fake_tpu_torch.training.balance import (
    BalanceTrainer,
    compute_difficulty_index,
)
from denoising_diffusion_deep_fake_tpu_torch.training.cached import (
    cached_steps_for,
)
from denoising_diffusion_deep_fake_tpu_torch.training.deep_fake import (
    DeepFakeTrainer,
)
from denoising_diffusion_deep_fake_tpu_torch.training.denoiser import (
    DenoiserTrainer,
)
from denoising_diffusion_deep_fake_tpu_torch.training.loop import LoopContext
from denoising_diffusion_deep_fake_tpu_torch.training.multi_step import (
    make_cached_super_step,
)
from denoising_diffusion_deep_fake_tpu_torch.parallel.distributed import (
    data_shard,
    is_primary,
    local_batch_size,
    maybe_initialize_from_env,
)
from denoising_diffusion_deep_fake_tpu_torch.parallel.mesh import shard_state
from denoising_diffusion_deep_fake_tpu_torch.training.optim import make_adam

HISTOGRAM_TAG = "difficulty_class_histogram"


def print_hparams(hparams: dict) -> None:
    print("\nHyper Parameters:")
    for k, v in hparams.items():
        print(f"\t{k}: {v}")
    print()


def _steps_per_epoch(cfg, loader) -> int:
    return (cfg.steps_per_epoch if cfg.steps_per_epoch is not None
            else loader.batches_per_epoch)


class _StepSet(NamedTuple):
    """The calls one workload loop drives (JAX's ``_StepSet``): a step, a
    step with panels and, with ``steps_per_call`` K > 1, the K-step call
    (made once, so its graph is captured once a run). From the host loader
    each takes the step's uploaded batches; from the cache none
    (``training/cached.py``)."""

    plain: Callable
    img: Callable
    super: Callable | None
    k: int


def _host_steps(trainer, k: int) -> _StepSet:
    return _StepSet(trainer.train_step,
                    functools.partial(trainer.train_step, with_images=True),
                    trainer.make_super_step(k) if k > 1 else None, k)


def _build_steps(cfg, trainer, epoch_batches, *loaders, verbose: bool):
    """``(caches, steps, epochs)``, JAX's ``_build_steps``: the step set
    and ``epochs(epoch)``, an epoch's stream of step arguments. From the
    host loader (``caches`` None), ``epoch_batches(epoch)`` (tuples of
    uint8 arrays) uploaded ahead by ``device_prefetch``; with
    ``data_cache: device``, a ``DeviceDatasetCache`` of each loader and
    steps that gather from them."""
    k = cfg.steps_per_call
    if verbose:
        for loader in loaders:
            print(f"images of {loader.manifest_path} decoded by "
                  f"{loader.decoder}")
    if cfg.data_cache != "device":
        return (None, _host_steps(trainer, k),
                lambda epoch: device_prefetch(
                    epoch_batches(epoch), trainer.device,
                    upload_format=cfg.upload_format))
    caches = [DeviceDatasetCache(loader, device=trainer.device,
                                 limit_bytes=cfg.device_cache_limit_bytes)
              for loader in loaders]
    if verbose:
        for cache in caches:
            print(f"dataset on {cache.device}: {cache.n_images} images, "
                  f"{cache.nbytes / 1e9:.2f} GB, decoded in "
                  f"{cache.decode_s:.2f} s, uploaded in "
                  f"{cache.upload_s:.2f} s")
    spe = min(c.steps_per_epoch for c in caches)
    plain, img = cached_steps_for(trainer, caches, spe)
    super_step = (make_cached_super_step(trainer.make_super_step(k), caches,
                                         spe) if k > 1 else None)
    return (caches, _StepSet(plain, img, super_step, k),
            functools.partial(_cached_batches, caches, spe))


def _cached_batches(caches, spe: int, epoch: int):
    """An epoch's stream on the cached path: ``epoch``'s orders copied into
    the caches' buffers, then ``()`` once a step (the steps gather their
    own batches)."""
    for cache in caches:
        cache.order_for_epoch(epoch)
    return (() for _ in range(spe))


def _drive_epoch(ctx: LoopContext, states, generator, batches, steps, *,
                 step_callback, max_steps, verbose) -> bool:
    """One epoch's batches through the step calls, in place on ``states``;
    True when training is to stop (``max_steps`` reached, or SIGTERM).
    Groups of ``steps.k`` as JAX's ``_drive_epoch`` (the module docstring);
    ``step_callback`` gets a group's ``(K,)`` metrics."""
    done = False
    it = iter(batches)
    buffered: list = []  # epoch-tail items that failed to fill a group
    while not done:
        if buffered:
            step_args = buffered.pop(0)
        else:
            try:
                step_args = next(it)
            except StopIteration:
                break
        want_img = ctx.want_images()
        remaining = (None if max_steps is None
                     else max_steps - ctx.global_step)
        if (steps.super is not None and not want_img and not buffered
                and (remaining is None or remaining >= steps.k)):
            group = [step_args]
            while len(group) < steps.k:
                try:
                    group.append(next(it))
                except StopIteration:
                    break
            if len(group) == steps.k:
                flat = [x for pos in zip(*group) for x in pos]
                metrics = steps.super(states, *flat)
                ctx.log_step(metrics, states=states, generator=generator,
                             n_steps=steps.k)
                ctx.global_step += steps.k
                if step_callback is not None:
                    step_callback(ctx.global_step, states, metrics)
                done = _post_step(ctx, states, generator, max_steps, verbose)
                continue
            # Short group (epoch tail): run what was pulled as singles.
            step_args, *rest = group
            buffered.extend(rest)
        if want_img:
            metrics, images = steps.img(states, *step_args)
            ctx.log_step(metrics, images, states=states, generator=generator)
        else:
            metrics = steps.plain(states, *step_args)
            ctx.log_step(metrics, states=states, generator=generator)
        ctx.global_step += 1
        if step_callback is not None:
            step_callback(ctx.global_step, states, metrics)
        done = _post_step(ctx, states, generator, max_steps, verbose)
    return done


def _post_step(ctx: LoopContext, states, generator, max_steps,
               verbose) -> bool:
    """Bookkeeping after each call (a step or a group), shared by the
    three loops."""
    ctx.maybe_checkpoint(states, generator)
    if ctx.preempted():
        if verbose:
            print("preemption signal received — saving and exiting")
        return True
    return max_steps is not None and ctx.global_step >= max_steps


@contextlib.contextmanager
def _abort_on_error(ctx: LoopContext):
    """Stop the loop's threads on any exception leaving the train loop
    (divergence, a raising step_callback, KeyboardInterrupt), then let it
    go on."""
    try:
        yield
    except BaseException:
        ctx.abort()
        raise


def _run_epochs(ctx: LoopContext, trainer, steps, epochs, states,
                start_epoch: int, *, step_callback, max_steps, verbose,
                after_epoch=None) -> None:
    """The epoch loop every runner shares over a step set and its epochs
    (``_build_steps``), its final save and ``close``.
    ``after_epoch(epoch)`` runs before the epoch's save."""
    cfg, generator = ctx.cfg, trainer.generator
    with _abort_on_error(ctx):
        for epoch in range(start_epoch, cfg.max_epochs):
            ctx.epoch = epoch
            with contextlib.closing(epochs(epoch)) as batches:
                done = _drive_epoch(ctx, states, generator, batches, steps,
                                    step_callback=step_callback,
                                    max_steps=max_steps, verbose=verbose)
            if after_epoch is not None:
                after_epoch(epoch)
            ctx.maybe_checkpoint(states, generator, force=True)  # 'last'
            if done:
                break
        ctx.maybe_checkpoint(states, generator, final=True)
        ctx.close()


def _start(cfg, verbose: bool, device) -> tuple[dict, bool]:
    """Open the process group if the launch asks for one; the hparams,
    printed by the primary, and whether this process prints."""
    maybe_initialize_from_env(device=device)
    verbose = verbose and is_primary()
    hparams = config_to_dict(cfg)
    if verbose:
        print_hparams(hparams)
    return hparams, verbose


# ------------------------------------------------------------------ deep fake


def fit_deep_fake(cfg: DeepFakeConfig, *, resume_from: str | None = None,
                  modify_from: str | None = None, max_steps: int | None = None,
                  verbose: bool = True, step_callback=None, device=None,
                  decode_fn=None):
    """Train the two-identity workload; returns (states, trainer, context)."""
    hparams, verbose = _start(cfg, verbose, device)
    lb = local_batch_size(cfg.batch_size, cfg.spatial_parallel)
    loaders = [ImageLoader(path, lb, image_size=cfg.image_size,
                           seed=cfg.seed + i,
                           class_balanced=cfg.class_balanced_sampling,
                           decode_fn=decode_fn,
                           shard=data_shard(cfg.spatial_parallel))
               for i, path in enumerate((cfg.data_path_a, cfg.data_path_b))]
    paired = PairedLoader(*loaders)
    trainer = DeepFakeTrainer(cfg,
                              steps_per_epoch=_steps_per_epoch(cfg, paired),
                              image_size=paired.image_size, device=device)
    _, steps, epochs = _build_steps(
        cfg, trainer, lambda epoch: ((ba, bb) for (ba, _), (bb, _)
                                     in paired.epoch(epoch)),
        *loaders, verbose=verbose)
    ctx = LoopContext(cfg, hparams, workload="deep_fake", mesh=trainer.mesh)
    with _abort_on_error(ctx):
        states, start_epoch = _deep_fake_states(cfg, trainer, ctx,
                                                resume_from, modify_from)
        shard_state(states, trainer.mesh)
    _run_epochs(ctx, trainer, steps, epochs, states, start_epoch,
                step_callback=step_callback, max_steps=max_steps,
                verbose=verbose)
    return states, trainer, ctx


def _deep_fake_states(cfg, trainer, ctx, resume_from, modify_from):
    """The states to train and the first epoch: fresh, resumed (the
    counters and generator too) or modified (fresh optimizers)."""
    if not (resume_from or modify_from):
        return trainer.init_states(cfg.seed), 0
    source = CheckpointManager(resume_from or modify_from)
    # The checkpoint's own mode decides whether it has shadows.
    ckpt_mode = source.read_meta()["hparams"].get("mode", cfg.mode)
    states, meta = source.restore(
        lambda: trainer.init_states(cfg.seed, with_ema=ckpt_mode == "swap"),
        generator=trainer.generator if resume_from else None)
    start_epoch = 0
    if resume_from:
        start_epoch = int(meta["extra"].get("epoch", 0)) + 1
        ctx.global_step = int(meta["extra"].get("global_step", 0))
    else:
        states = reset_for_modify(states, functools.partial(
            make_adam, learning_rate=cfg.learning_rate, b1=cfg.adam_b1,
            b2=cfg.adam_b2, device=trainer.device))
    if cfg.mode == "swap":
        states = trainer.ensure_ema(states)
    return states, start_epoch


# ------------------------------------------------------------------- denoiser


def fit_denoiser(cfg: DenoiserConfig, *, max_steps: int | None = None,
                 verbose: bool = True, step_callback=None, device=None,
                 decode_fn=None):
    """Train the single-model denoiser; returns (state, trainer, context)."""
    hparams, verbose = _start(cfg, verbose, device)
    loader = ImageLoader(cfg.input_image_list_path,
                         local_batch_size(cfg.batch_size,
                                          cfg.spatial_parallel),
                         image_size=cfg.image_size, seed=cfg.seed,
                         class_balanced=cfg.class_balanced_sampling,
                         decode_fn=decode_fn,
                         shard=data_shard(cfg.spatial_parallel))
    trainer = DenoiserTrainer(cfg,
                              steps_per_epoch=_steps_per_epoch(cfg, loader),
                              image_size=loader.image_size, device=device)
    _, steps, epochs = _build_steps(
        cfg, trainer, lambda epoch: ((b,) for b, _ in loader.epoch(epoch)),
        loader, verbose=verbose)
    state = shard_state(trainer.init_state(cfg.seed), trainer.mesh)
    ctx = LoopContext(cfg, hparams, workload="denoiser", mesh=trainer.mesh)
    _run_epochs(ctx, trainer, steps, epochs, state, 0,
                step_callback=step_callback, max_steps=max_steps,
                verbose=verbose)
    return state, trainer, ctx


# -------------------------------------------------------------------- balance


def fit_balance(cfg: BalanceConfig, *, max_steps: int | None = None,
                verbose: bool = True, step_callback=None, device=None,
                decode_fn=None):
    """Train at the fixed noise ratio, then after every epoch score each
    image, log the class histogram and write the balanced manifest;
    returns (state, trainer, context)."""
    hparams, verbose = _start(cfg, verbose, device)
    loader = ImageLoader(cfg.data_path,
                         local_batch_size(cfg.batch_size,
                                          cfg.spatial_parallel),
                         image_size=cfg.image_size, seed=cfg.seed,
                         decode_fn=decode_fn,
                         shard=data_shard(cfg.spatial_parallel))
    # Scoring: the whole dataset in manifest order, no remainder dropped,
    # so every image gets a class; not sharded: the classes come from a
    # min-max over the whole dataset, so every rank scores everything.
    val_loader = ImageLoader(cfg.data_path, cfg.batch_size,
                             image_size=cfg.image_size, shuffle=False,
                             drop_remainder=False, decode_fn=decode_fn)
    trainer = BalanceTrainer(cfg,
                             steps_per_epoch=_steps_per_epoch(cfg, loader),
                             image_size=loader.image_size, device=device)
    caches, steps, epochs = _build_steps(
        cfg, trainer, lambda epoch: ((b,) for b, _ in loader.epoch(epoch)),
        loader, verbose=verbose)
    state = shard_state(trainer.init_state(cfg.seed), trainer.mesh)
    ctx = LoopContext(cfg, hparams, workload="balance", mesh=trainer.mesh)

    def score(epoch: int) -> None:
        if caches and data_shard(cfg.spatial_parallel) is None:
            # Its rows are in manifest order, as val_loader's.
            indices, losses = trainer.score_dataset_from_cache(
                state, caches[0], epoch=epoch)
        else:
            # Scoring uploads RGB whatever upload_format says (JAX
            # balance.py:89-90).
            indices, losses = trainer.score_dataset(
                state, device_prefetch(val_loader.epoch(0), trainer.device),
                epoch=epoch)
        classes = compute_difficulty_index(losses, cfg.number_of_classes)
        if not ctx.primary:
            return
        ctx.tb.log_figure(HISTOGRAM_TAG, difficulty_histogram_image(
            classes, cfg.number_of_classes), ctx.global_step)
        if cfg.output_image_list_path:
            write_balanced_manifest(cfg, val_loader, indices, classes)

    _run_epochs(ctx, trainer, steps, epochs, state, 0,
                step_callback=step_callback, max_steps=max_steps,
                verbose=verbose, after_epoch=score)
    return state, trainer, ctx


HISTOGRAM_SIZE = (480, 640)      # matplotlib's default figure, in pixels
HISTOGRAM_MARGIN = 40
HISTOGRAM_BAR = (31, 119, 180)   # matplotlib's first colour


def difficulty_histogram_image(classes: np.ndarray,
                               number_of_classes: int) -> np.ndarray:
    """The count of each difficulty class as an RGB uint8 bar chart: one
    bar a class on white, the tallest ``HISTOGRAM_SIZE[0] - 2 *
    HISTOGRAM_MARGIN`` pixels and the others in proportion, on black axes.
    JAX draws it with matplotlib; the pixels differ, the counts do not."""
    h, w = HISTOGRAM_SIZE
    m = HISTOGRAM_MARGIN
    counts = np.bincount(np.asarray(classes), minlength=number_of_classes)
    image = np.full((h, w, 3), 255, np.uint8)
    plot_h = h - 2 * m
    slot = (w - 2 * m) // len(counts)
    heights = np.round(plot_h * counts / max(int(counts.max()), 1))
    for i, height in enumerate(heights.astype(int)):
        x0 = m + i * slot + slot // 10
        image[h - m - height:h - m, x0:x0 + slot - slot // 5] = HISTOGRAM_BAR
    image[h - m, m:w - m] = 0
    image[m:h - m + 1, m] = 0
    return image


def write_balanced_manifest(cfg: BalanceConfig, loader: ImageLoader,
                            indices: np.ndarray, classes: np.ndarray) -> None:
    """``<path>\\t<difficulty_class>`` lines in dataset order."""
    order = np.argsort(indices)
    paths = [loader.paths[i] for i in indices[order]]
    write_image_manifest(cfg.output_image_list_path, paths, classes[order])
