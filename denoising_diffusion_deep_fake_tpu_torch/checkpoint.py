"""Step-indexed checkpoints of the deep-fake trainer's states, in torch files.

The part of ``denoising_diffusion_deep_fake_tpu/checkpoint.py:54-221`` that
saving a trained pair and loading one swap model need. The JAX package
writes orbax/flax checkpoints, which the port cannot read; weights cross
from JAX only through ``utils/jax_weights.py``, in tests. Layout:

    <directory>/step_<step:010d>/<identity>/<part>.pt
    <directory>/step_<step:010d>/meta.json

with one ``torch.save`` file per identity and part (``PARTS``): the
model's state_dict (params and BN buffers), the EMA shadow's where the
state has one, the optimizer's state_dict, and the counters (``step``,
``ema_step``). ``meta.json`` (``{"step", "hparams", "extra"}``) is written
last, so a step without it is incomplete and ignored. ``restore_partial``
reads only the files it is asked for: a swap model needs one identity's
model (or shadow), a sixth of the bytes.

Not ported yet (ROADMAP A5): the full ``restore`` of trainer states, the
non-blocking save (``block=False``), ``reset_for_modify`` and the RNG
state.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import torch

PARTS = ("model", "ema_model", "optimizer", "counters")


class CheckpointManager:
    """Checkpoints under ``directory``, the newest ``keep`` kept."""

    def __init__(self, directory, *, keep: int = 8):
        self.directory = Path(directory).resolve()
        self.keep = keep
        self.directory.mkdir(parents=True, exist_ok=True)

    def step_dir(self, step: int) -> Path:
        return self.directory / f"step_{step:010d}"

    def save(self, step: int, states: dict, hparams: dict,
             extra: dict | None = None) -> Path:
        """Write ``states`` (identity -> ``training.state.ModelState``) and
        ``hparams`` at ``step``, blocking until the files are written."""
        path = self.step_dir(step)
        shutil.rmtree(path, ignore_errors=True)
        for name, state in states.items():
            parts = {"model": state.model.state_dict(),
                     "optimizer": state.optimizer.state_dict(),
                     "counters": {"step": int(state.step),
                                  "ema_step": int(state.ema_step)}}
            if state.has_ema:
                parts["ema_model"] = state.ema_model.state_dict()
            (path / name).mkdir(parents=True)
            for part, obj in parts.items():
                torch.save(obj, path / name / f"{part}.pt")
        meta = {"step": step, "hparams": hparams, "extra": extra or {}}
        (path / "meta.json").write_text(json.dumps(meta, indent=2))
        self._apply_retention()
        return path

    def _apply_retention(self) -> None:
        steps = self.all_steps()
        for old in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self.step_dir(old), ignore_errors=True)

    def all_steps(self) -> list[int]:
        return sorted(int(p.name.split("_")[1])
                      for p in self.directory.glob("step_*")
                      if (p / "meta.json").exists())

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _resolve(self, step: int | None) -> int:
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        return step

    def read_meta(self, step: int | None = None) -> dict:
        step = self._resolve(step)
        return json.loads((self.step_dir(step) / "meta.json").read_text())

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
