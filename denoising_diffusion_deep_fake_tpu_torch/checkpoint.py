"""Step-indexed checkpoints of the trainers' states, in torch files.

Port of ``denoising_diffusion_deep_fake_tpu/checkpoint.py:54-245``. The
JAX package writes orbax/flax checkpoints, which the port cannot read;
weights cross from JAX only through ``utils/jax_weights.py``, in tests.
Layout:

    <directory>/step_<step:010d>/<name>/<part>.pt
    <directory>/step_<step:010d>/meta.json

``states`` is either the deep-fake trainer's identity dict (``{"a": ModelState,
"b": ModelState}``, one folder per identity) or a single ``ModelState`` (the
denoiser's and the balancer's), whose folder is named ``state``. Each folder
holds one ``torch.save`` file per part (``PARTS``): the model's state_dict
(params and BN buffers), the EMA shadow's where the state has one, the
optimizer's state_dict (Adam's moments and steps) and the counters
(``step``, ``ema_step``). ``meta.json`` (``{"step", "hparams", "extra"}``)
is written last, so a step without it is incomplete and ignored.

* ``save`` writes the files before it returns; with ``block=False`` it
  copies every tensor to host memory on the calling thread and writes the
  files on a background thread (the trainers update params and Adam
  moments in place, so those files must not be written from the live
  tensors); ``wait_until_finished`` joins it and raises its failure.
* ``restore`` loads every part into states built by the caller's
  function (the counterpart of JAX's ``jax.eval_shape(target_fn)``) and,
  given the trainer's ``torch.Generator``, its state. The optimizers keep
  their own implementation flags (fused, foreach, capturable).
* ``restore_partial`` reads only the files it is asked for: a swap model
  needs one identity's model (or shadow), a sixth of the bytes.
* ``reset_for_modify`` keeps weights, BN buffers and shadows and gives each
  state a fresh optimizer and ``step = 0`` (``d3f train modify``).
* ``save_rng_state`` / ``load_rng_state`` carry the trainer's generator
  (affine params and noise ratios) in ``extra``, where JAX keeps its key.
  With the steps (the noise kernel's offset) and the epoch (the loader's
  order), a resumed run draws what the uninterrupted run would have.

Under data parallelism (``parallel/``) the ranks' states and generators
are the same, so only the primary saves (``training/loop.py`` gates it)
and every rank restores the same files.
"""

from __future__ import annotations

import json
import shutil
import threading
from pathlib import Path
from typing import Callable

import torch

from denoising_diffusion_deep_fake_tpu_torch.training.optim import (
    bind_device_lr,
)

PARTS = ("model", "ema_model", "optimizer", "counters")
# Optimizer group keys that choose how the update runs, not what it is.
_IMPLEMENTATION = ("foreach", "fused", "capturable")
SINGLE = "state"


def _named(states) -> dict:
    """The identity dict as it is; a single state under ``SINGLE``."""
    return states if isinstance(states, dict) else {SINGLE: states}


def _to_host(obj):
    """``obj`` with every tensor copied to host memory."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _parts(state) -> dict:
    parts = {"model": state.model.state_dict(),
             "optimizer": state.optimizer.state_dict(),
             "counters": {"step": int(state.step),
                          "ema_step": int(state.ema_step)}}
    if state.has_ema:
        parts["ema_model"] = state.ema_model.state_dict()
    return parts


class CheckpointManager:
    """Checkpoints under ``directory``, the newest ``keep`` kept."""

    def __init__(self, directory, *, keep: int = 8):
        self.directory = Path(directory).resolve()
        self.keep = keep
        self.directory.mkdir(parents=True, exist_ok=True)
        self._pending: threading.Thread | None = None
        self._pending_error: BaseException | None = None

    def step_dir(self, step: int) -> Path:
        return self.directory / f"step_{step:010d}"

    # ------------------------------------------------------------------ save

    def save(self, step: int, states, hparams: dict,
             extra: dict | None = None, *, block: bool = True) -> Path:
        """Write ``states`` (the identity dict or one ``ModelState``) and
        ``hparams`` at ``step``. ``block=False`` copies the tensors to host
        memory before it returns and writes the files on a background
        thread (one save in flight at a time)."""
        self.wait_until_finished()
        path = self.step_dir(step)
        parts = {name: _parts(state)
                 for name, state in _named(states).items()}
        if not block:
            parts = _to_host(parts)
        meta = {"step": step, "hparams": hparams, "extra": extra or {}}

        def finish():
            shutil.rmtree(path, ignore_errors=True)
            for name, state_parts in parts.items():
                (path / name).mkdir(parents=True)
                for part, obj in state_parts.items():
                    torch.save(obj, path / name / f"{part}.pt")
            (path / "meta.json").write_text(json.dumps(meta, indent=2))
            self._apply_retention()

        if block:
            finish()
            return path

        def finish_guarded():
            try:
                finish()
            except Exception as e:  # surfaced by the next join
                self._pending_error = e

        self._pending = threading.Thread(target=finish_guarded,
                                         name="checkpoint-save", daemon=True)
        self._pending.start()
        return path

    def wait_until_finished(self) -> None:
        """Join the save in flight, if any; raise its failure. A cadence
        checkpoint that silently failed would make ``resume`` restore an
        older step than the user believes exists."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._pending_error is not None:
            error, self._pending_error = self._pending_error, None
            raise RuntimeError("async checkpoint save failed") from error

    def _apply_retention(self) -> None:
        steps = self.all_steps()
        for old in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self.step_dir(old), ignore_errors=True)

    # --------------------------------------------------------------- restore

    def all_steps(self) -> list[int]:
        # No join here: the save thread calls this through retention.
        return sorted(int(p.name.split("_")[1])
                      for p in self.directory.glob("step_*")
                      if (p / "meta.json").exists())

    def latest_step(self) -> int | None:
        self.wait_until_finished()
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _resolve(self, step: int | None) -> int:
        self.wait_until_finished()
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        return step

    def read_meta(self, step: int | None = None) -> dict:
        step = self._resolve(step)
        return json.loads((self.step_dir(step) / "meta.json").read_text())

    def restore(self, build_states: Callable[[], object],
                step: int | None = None, device=None,
                generator: torch.Generator | None = None
                ) -> tuple[object, dict]:
        """Full restore of the newest checkpoint (or ``step``): states
        built by ``build_states()`` (with shadows exactly where the
        checkpoint has them) get every part, loaded onto ``device`` and
        copied into their tensors; ``generator`` gets the saved state.
        Returns ``(states, meta)``."""
        step = self._resolve(step)
        folder = self.step_dir(step)
        states = build_states()
        for name, state in _named(states).items():
            part_dir = folder / name
            if not part_dir.is_dir():
                have = sorted(p.name for p in folder.iterdir() if p.is_dir())
                raise ValueError(f"checkpoint {folder} has no {name!r} "
                                 f"state (it has {have})")
            saved_ema = (part_dir / "ema_model.pt").exists()
            if saved_ema != state.has_ema:
                raise ValueError(
                    f"{name!r}: the checkpoint has "
                    f"{'an' if saved_ema else 'no'} EMA shadow, the state "
                    f"built for it {'has' if state.has_ema else 'has none'}")

            def load(part, location):
                return torch.load(part_dir / f"{part}.pt", weights_only=True,
                                  map_location=location)

            state.model.load_state_dict(load("model", device))
            if state.has_ema:
                state.ema_model.load_state_dict(load("ema_model", device))
            # Adam's load_state_dict moves its tensors to the params'
            # device; the fused kernel's steps stay beside the params. It
            # also puts back the saved groups' learning rates, which a CUDA
            # optimizer holds as device tensors (training/optim.py), and
            # the saved groups' implementation flags, which belong to the
            # device this run is on: a checkpoint written on the host (an
            # import, utils/torch_import.py) must not turn the card's
            # fused Adam into the CPU's loop.
            flags = [{k: g[k] for k in _IMPLEMENTATION if k in g}
                     for g in state.optimizer.param_groups]
            state.optimizer.load_state_dict(load("optimizer", "cpu"))
            for group, kept in zip(state.optimizer.param_groups, flags):
                group.update(kept)
            bind_device_lr(state.optimizer)
            counters = load("counters", "cpu")
            state.step = counters["step"]
            state.ema_step = counters["ema_step"]
        meta = self.read_meta(step)
        if generator is not None:
            load_rng_state(meta["extra"], generator)
        return states, meta

    def restore_partial(self, identity: str, parts, step: int | None = None,
                        device=None) -> dict:
        """``{part: object}`` for the chosen ``parts`` of one identity's
        state, each loaded with ``weights_only`` onto ``device``; no other
        file is opened."""
        unknown = set(parts) - set(PARTS)
        if unknown:
            raise ValueError(f"unknown checkpoint parts {sorted(unknown)}; "
                             f"have {PARTS}")
        folder = self.step_dir(self._resolve(step)) / identity
        return {part: torch.load(folder / f"{part}.pt", weights_only=True,
                                 map_location=device)
                for part in parts}


def reset_for_modify(states, make_optimizer: Callable):
    """``modify``: keep weights, BN buffers and shadows; a fresh optimizer
    (``make_optimizer(params)``) and ``step = 0`` for each state."""
    for state in _named(states).values():
        state.optimizer = make_optimizer(state.model.parameters())
        state.step = 0
    return states


def save_rng_state(extra: dict, generator: torch.Generator) -> dict:
    """``extra`` with the generator's state and device type."""
    extra = dict(extra)
    extra["rng_state"] = bytes(generator.get_state().tolist()).hex()
    extra["rng_device"] = generator.device.type
    return extra


def load_rng_state(extra: dict, generator: torch.Generator) -> bool:
    """Set ``generator`` to the state in ``extra``; False when there is
    none. A CUDA generator's state is not a CPU generator's, so a state
    saved on another device type is refused."""
    data = extra.get("rng_state")
    if data is None:
        return False
    saved = extra.get("rng_device")
    if saved != generator.device.type:
        raise ValueError(
            f"the checkpoint's generator state was saved on {saved!r}; this "
            f"trainer's generator is on {generator.device.type!r} — resume "
            "on the device type the run was trained on")
    generator.set_state(torch.tensor(list(bytes.fromhex(data)),
                                     dtype=torch.uint8))
    return True
