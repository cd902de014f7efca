"""A run with the timed path broken underneath comes out not correct, at
the CPU test size, under the cells' own limits: once for each fault the
cell can have. The harness's look for a card is skipped (the run goes
through ``run_cell``); all else is a run."""

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

import cpu_cells  # noqa: E402
from denoising_diffusion_deep_fake_tpu_torch.training import (  # noqa: E402
    denoiser, state)

TRAIN = "train_r34_448_cached_k16"


def test_sound_runs_are_correct():
    assert cpu_cells.run_small(TRAIN)["correct"]


def test_step_that_leaves_its_state_unchanged(monkeypatch):
    real = denoiser.train_one_model

    def unchanged(st, *args, **kwargs):
        before = [t.detach().clone() for t in st.model.state_dict().values()]
        out = real(st, *args, **kwargs)
        with torch.no_grad():
            for t, b in zip(st.model.state_dict().values(), before):
                t.copy_(b)
        return out

    monkeypatch.setattr(denoiser, "train_one_model", unchanged)
    assert not cpu_cells.run_small(TRAIN)["correct"]


def test_half_the_batch_left_out(monkeypatch):
    real = state.mse_ssim_loss

    def half(pred, target, **kwargs):
        b = pred.shape[0] // 2
        return real(pred[:b], target[:b], **kwargs)

    monkeypatch.setattr(state, "mse_ssim_loss", half)
    assert not cpu_cells.run_small(TRAIN)["correct"]



def test_ssim_gradient_left_out_shows_in_the_direction_readings(monkeypatch):
    """The loss's value is kept and only its gradient is wrong: at the CPU
    size, where the program meets the reference to rounding, the change's
    direction shows it. At the cells' size bf16 rounding flips a fifth to
    a third of the first update's signs, so no limit holds it there."""
    sound = cpu_cells.run_small(TRAIN)["readings"]
    real = state.mse_ssim_loss

    def mse_only(pred, target, **kwargs):
        loss = real(pred, target, **kwargs)
        half_mse = torch.mean((pred.float() - target.float()) ** 2) / 2.0
        return half_mse + (loss - half_mse).detach()

    monkeypatch.setattr(state, "mse_ssim_loss", mse_only)
    fault = cpu_cells.run_small(TRAIN)["readings"]
    assert fault["loss_gap_rms"] < 1e-6  # the forward cannot see it
    assert fault["change_diff_median"] > 30 * sound["change_diff_median"]
    assert fault["sign_flip_share"] > 30 * max(sound["sign_flip_share"],
                                               1e-4)
