"""Training from the device cache in K-step groups, as the runners drive it.

The traffic file gives ``trainer`` (``denoiser``), ``steps_per_call`` K,
``frames`` (the dataset's size) and ``traced_groups``. The program is
built through its public entry points as ``training/runners.py`` builds
it for ``data_cache: device``: an ``ImageLoader`` over a manifest whose
frames its ``decode_fn`` hands over (no image file is written), a
``DeviceDatasetCache``, the trainer, ``make_cached_super_step`` of the
trainer's K-step call; each epoch's order goes in by ``order_for_epoch``
before its first group.

Set-up makes the frames and weights from the seed, builds all that, loads
the weights and runs two groups: the first is the one the reference
checks (its losses, the weights and Adam's moments after it are kept),
the second settles the card. The window then calls groups with two in
flight until ``seconds`` have passed. Each group's losses go to
pinned memory behind an event of their own, so waiting for one group
never waits for the group launched after it, and the card always holds
the next group, as with the runners' fetching thread. The window closes
when the last group launched has been fetched, and every image of every
group counts. A traced run then profiles one warm-up group and
``traced_groups`` more.

The reference (``reference/train.py``) follows the first group's K steps
once the program's state is freed. Its numbers: each step's loss, Adam's
first moment after the group, and the weights' change over the group,
the last two by leaf both as a gap of norms and as the norm of the
difference (which sees a tensor pointing elsewhere).
"""

from __future__ import annotations

import gc
import math
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from bench_port import core, flops, inputs
from bench_port import trace as tracing
from bench_port.reference import lowp
from bench_port.reference import train as ref_train


def hparams(cell: core.Cell, seed: int, overrides: dict | None) -> dict:
    hp = dict(cell.config["hparams"])
    hp.update(overrides or {})
    hp["seed"] = int(seed)
    hp["n_frames"] = int(cell.traffic["frames"])
    return hp


def reference_hp(hp: dict) -> dict:
    return {
        "seed": hp["seed"], "batch_size": hp["batch_size"],
        "n_frames": hp["n_frames"], "learning_rate": hp["learning_rate"],
        "adam_b1": hp.get("adam_b1", 0.9), "adam_b2": hp.get("adam_b2", 0.999),
        "t_max": hp.get("cosine_scheduler_max_epoch") or hp["max_epochs"],
        "lam": hp["noise_exponential_sampling_lambda"],
        "mean": hp["mean"], "std": hp["std"],
        "aug": (hp["aug_degrees"], hp["aug_translate"], hp["aug_scale_min"],
                hp["aug_scale_max"], 1.0),
        "encoder_name": hp["encoder_name"]}


def _program_config(hp: dict, k: int, manifest: Path):
    from denoising_diffusion_deep_fake_tpu_torch.config import (
        DenoiserConfig, config_from_dict)

    keys = {f for f in DenoiserConfig.__dataclass_fields__}
    data = {k_: v for k_, v in hp.items() if k_ in keys}
    data.update(data_cache="device", steps_per_call=k,
                input_image_list_path=str(manifest))
    return config_from_dict(DenoiserConfig, data)


def _write_manifest(directory: Path, n: int) -> Path:
    path = directory / "images.txt"
    path.write_text("".join(f"frame_{i:06d}.png\n" for i in range(n)))
    return path


def _frame_index(path: str) -> int:
    return int(Path(path).stem.split("_")[1])


def run(cell: core.Cell, *, seed: int, seconds: float, trace: bool,
        device: torch.device, t_start: float, overrides: dict | None = None,
        calibrate: bool = False) -> dict:
    from denoising_diffusion_deep_fake_tpu_torch.data.device_cache import (
        DeviceDatasetCache)
    from denoising_diffusion_deep_fake_tpu_torch.data.loader import (
        ImageLoader)
    from denoising_diffusion_deep_fake_tpu_torch.training.denoiser import (
        DenoiserTrainer)
    from denoising_diffusion_deep_fake_tpu_torch.training.multi_step import (
        make_cached_super_step)

    if cell.traffic["trainer"] != "denoiser":
        raise ValueError(f"trainer {cell.traffic['trainer']!r} is not "
                         "driven by this generator")
    hp = hparams(cell, seed, overrides)
    k = int(cell.traffic["steps_per_call"])
    b, size = int(hp["batch_size"]), int(hp["image_size"])
    cuda = device.type == "cuda"

    frames_dev = inputs.make_frames(seed, hp["n_frames"], size, device)
    frames_np = frames_dev.cpu().numpy()
    del frames_dev
    weights = inputs.make_weights(hp["encoder_name"], seed, device)

    tmp = Path(tempfile.mkdtemp(prefix="bench_port_"))
    manifest = _write_manifest(tmp, hp["n_frames"])
    cfg = _program_config(hp, k, manifest)
    loader = ImageLoader(cfg.input_image_list_path, cfg.batch_size,
                         image_size=cfg.image_size, seed=cfg.seed,
                         decode_fn=lambda p: frames_np[_frame_index(p)])
    trainer = DenoiserTrainer(cfg, steps_per_epoch=loader.batches_per_epoch,
                              image_size=loader.image_size, device=device)
    cache = DeviceDatasetCache(loader, device=trainer.device,
                               limit_bytes=cfg.device_cache_limit_bytes)
    spe = cache.steps_per_epoch
    if spe % k:
        raise ValueError(f"an epoch of {spe} steps is not whole groups of "
                         f"{k}: the runner would run its tail as single "
                         "steps, which this generator does not")
    per_epoch = spe // k
    step = make_cached_super_step(trainer.make_super_step(k), [cache], spe)
    state = trainer.init_state(cfg.seed)
    state.model.load_state_dict(weights)
    groups = [0]

    def group() -> torch.Tensor:
        if groups[0] % per_epoch == 0:
            cache.order_for_epoch(groups[0] // per_epoch)
        groups[0] += 1
        return step(state)["loss"]

    ends = []  # each launched group's end on the card

    def launch():
        """Launch a group; returns what waits for its losses alone."""
        loss = group()
        if not cuda:
            return lambda: loss
        host = torch.empty(loss.shape, dtype=loss.dtype, pin_memory=True)
        host.copy_(loss, non_blocking=True)
        done = torch.cuda.Event(enable_timing=True)
        done.record()
        ends.append(done)

        def fetch() -> torch.Tensor:
            done.synchronize()
            return host
        return fetch

    first = group().cpu()
    after = {n: p.detach().cpu().clone()
             for n, p in state.model.named_parameters()}
    moments = {key: {n: state.optimizer.state[p][key].detach().cpu().clone()
                     for n, p in state.model.named_parameters()}
               for key in ("exp_avg", "exp_avg_sq")}
    losses_ok = [bool(torch.isfinite(first).all())]
    losses_ok.append(bool(torch.isfinite(group().cpu()).all()))

    def drive(until: float | None, n_groups: int | None) -> int:
        pending, done = [], 0
        while (until is None or time.perf_counter() < until) and (
                n_groups is None or done + len(pending) < n_groups):
            pending.append(launch())
            if len(pending) >= 2:
                losses_ok.append(bool(torch.isfinite(pending.pop(0)()).all()))
                done += 1
        for fetch in pending:
            losses_ok.append(bool(torch.isfinite(fetch()).all()))
            done += 1
        return done

    if cuda:
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    n_window = drive(t0 + seconds, None) if seconds > 0 else 0
    t1 = time.perf_counter()
    out = {"setup_s": setup_s, "attempted": n_window * k,
           "e2e": {"train_imgs_per_s": n_window * k * b / (t1 - t0)
                   if n_window else float("nan")}}
    # The card's time from one window group's end to the next's: a group's
    # own time while the card is never left without work (a diagnostic).
    group_ms = sorted(a.elapsed_time(e) for a, e in zip(ends[:n_window - 1],
                                                         ends[1:n_window]))

    analysis = None
    if trace:
        n_traced = int(cell.traffic.get("traced_groups", 3))
        with tracing.traced(device) as tr:
            with tracing.window(tracing.WARMUP):
                drive(None, 1)
            with tracing.window(tracing.TRACED):
                drive(None, n_traced)
        analysis = tracing.analyze(tr["events"])
        out["ctx"] = {
            "trace": analysis, "steps": n_traced * k, "batch": b,
            "image_size": size, "images": n_traced * k * b,
            "train_flops_per_image": 3 * flops.unet_forward_flops(
                hp["encoder_name"], size),
            "warp_fused_bytes": flops.warp_fused_bytes(b, size),
            "noise_f32_bytes": flops.noise_f32_bytes(b, size)}
    follow = []
    for _ in range(int(cell.traffic["follow_groups"])):
        at = state.step
        params = {n: p.detach().cpu().clone()
                  for n, p in state.model.named_parameters()}
        loss = group().cpu()
        losses_ok.append(bool(torch.isfinite(loss).all()))
        follow.append((at, params, float(loss[0])))
    out["failed"] = k * sum(not ok for ok in losses_ok[2:])
    out["memory_peak"] = (torch.cuda.max_memory_allocated(device) if cuda
                          else 0)

    del step, state, trainer, cache, loader
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    for f in tmp.iterdir():
        f.unlink()
    tmp.rmdir()

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rhp = reference_hp(hp)

    def frames(idx):
        return torch.from_numpy(frames_np[np.asarray(idx)])

    states = [(0, weights)] + [(at, params) for at, params, _ in follow]
    program = {"losses": first.tolist(), "params": after, **moments,
               "first_steps": [float(first[0])] + [f[2] for f in follow]}
    ref = ref_train.denoiser_group(weights, frames, rhp, k)
    ref["first_steps"] = ref_train.first_step_losses(states, frames, rhp,
                                                     device)
    keep = core.moving_leaves(ref["grad1"])
    out["readings"] = readings(program, ref, weights, keep)
    if group_ms:
        out["readings"].update(window_group_ms_min=group_ms[0],
                               window_group_ms_median=_median(group_ms),
                               window_group_ms_max=group_ms[-1])
    if calibrate:
        out["calibration"] = calibration(program, ref, weights, frames, rhp,
                                         k, states, device, keep)
    return out


# The control, the planted faults, and the witnesses of rounding alone.
SIDES = {"control_fp8": {"quant": lowp.fp8_quant},
         "half_batch": {"half_batch": True},
         "mse_only": {"mse_only": True},
         "mse_only_bf16": {"mse_only": True, "bf16": True},
         "witness_bf16": {"bf16": True},
         "witness_tf32": {"tf32": True}}


def calibration(program, ref, weights, frames, rhp, k, states, device,
                keep) -> dict:
    """Each of ``SIDES`` against the fp32 reference, the program and every
    other side against the bf16 witness, and the first update alone in
    bf16 against fp32."""
    out = {"left_out_leaves": sorted(set(ref["grad1"]) - keep)}
    sides = {}
    for name, kw in SIDES.items():
        side = ref_train.denoiser_group(weights, frames, rhp, k, **kw)
        side["first_steps"] = ref_train.first_step_losses(
            states, frames, rhp, device, **kw)
        out[name] = readings(side, ref, weights, keep)
        sides[name] = side
    for name, side in (("program", program), *sides.items()):
        if name != "witness_bf16":
            out[f"{name}_vs_bf16"] = readings(side, sides["witness_bf16"],
                                              weights, keep)
    one = {name: ref_train.denoiser_group(weights, frames, rhp, 1, **kw)
           for name, kw in (("fp32", {}), ("bf16", {"bf16": True}))}
    out["first_update_bf16"] = update_readings(
        one["bf16"]["params"], one["fp32"]["params"], weights, keep,
        one["fp32"]["grad1"])
    return out


def _median(values):
    return sorted(values)[len(values) // 2]


def readings(side: dict, ref: dict, weights: dict, keep) -> dict:
    """The numbers of one side (the program, or the reference in another
    precision or with a fault) against the fp32 reference: the relative
    loss gap of every group's first step (``first_steps``; the RMS) and of
    each step of the first group, and by leaf the first group's weight
    change and Adam's moments. The cell's ``limits`` name those compared."""
    rel = [abs(p - r) / abs(r) for p, r in zip(side["first_steps"],
                                               ref["first_steps"])]
    gaps = [abs(p - r) / abs(r) for p, r in zip(side["losses"],
                                                ref["losses"])]
    s_m = {n: v.cpu() for n, v in side["exp_avg"].items()}
    r_m = {n: v.cpu() for n, v in ref["exp_avg"].items()}
    moment = core.leaf_gaps(s_m, r_m, keep)
    moment_diff = core.leaf_diffs(s_m, r_m, keep)
    s_v = {n: v.cpu() for n, v in side["exp_avg_sq"].items()}
    r_v = {n: v.cpu() for n, v in ref["exp_avg_sq"].items()}
    second = core.leaf_gaps(s_v, r_v, keep)
    return {
        "loss_gap_rms": math.sqrt(sum(g * g for g in rel) / len(rel)),
        **update_readings(side["params"], ref["params"], weights, keep,
                          ref["grad1"]),
        "loss_gap_step1": rel[0],
        "loss_gap_first_steps_max": max(rel),
        "loss_gap_group_max": max(gaps),
        "adam_m_gap": max(moment.values()),
        "adam_m_gap_median": _median(moment.values()),
        "adam_m_diff_median": _median(moment_diff.values()),
        "adam_v_gap_median": _median(second.values()),
        "adam_v_gap": max(second.values()),
        "loss_gaps_first_steps": rel,
        "loss_gaps_group": gaps,
    }


def update_readings(side_params: dict, ref_params: dict, weights: dict,
                    keep, grad1: dict) -> dict:
    """The change of the weights from ``weights`` on one side against the
    reference's, by leaf: the gap of norms (``change_gap*``), the norm of
    the difference (``change_diff*``; ``change_diff_all`` over all kept
    leaves as one tensor), and the share of elements that moved the other
    way, also weighted by the size of the reference's first gradient
    (``sign_flip_share_g1``: rounding flips the small ones)."""
    w0 = {n: w.detach().cpu() for n, w in weights.items() if n in keep}
    s_d = {n: side_params[n].cpu() - w0[n] for n in w0}
    r_d = {n: ref_params[n].cpu() - w0[n] for n in w0}
    change = core.leaf_gaps(s_d, r_d, keep)
    diff = core.leaf_diffs(s_d, r_d, keep)
    flipped = {n: (s_d[n] * r_d[n]) < 0 for n in w0}
    flips = {n: float(f.double().mean()) for n, f in flipped.items()}
    g1 = {n: grad1[n].detach().cpu().double().abs() for n in w0}
    worst = max(change, key=change.get)
    sq = lambda t: float(t.double().pow(2).sum())  # noqa: E731
    return {
        "change_gap_median": _median(change.values()),
        "change_diff_median": _median(diff.values()),
        "change_diff_all": math.sqrt(sum(sq(s_d[n] - r_d[n]) for n in w0)
                                     / sum(sq(r_d[n]) for n in w0)),
        "change_gap": change[worst],
        "change_worst_leaf": worst,
        "change_worst_leaf_size": int(w0[worst].numel()),
        "change_diff_max": max(diff.values()),
        "change_diff_worst_leaf": max(diff, key=diff.get),
        "sign_flip_share": (sum(flips[n] * w0[n].numel() for n in w0)
                            / sum(w0[n].numel() for n in w0)),
        "sign_flip_share_g1": (sum(float((g1[n] * flipped[n]).sum())
                                   for n in w0)
                               / sum(float(g1[n].sum()) for n in w0)),
        "sign_flip_share_max": max(flips.values()),
        "sign_flip_worst_leaf": max(flips, key=flips.get),
    }
