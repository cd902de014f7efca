"""The port's CUDA kernels against their plain versions, on the GPU.

Every test here needs an NVIDIA GPU and skips without one. This file imports
no JAX, so it also runs on a GPU machine that has none:

    python -m pytest --noconftest -q tests/test_torch_port_cuda.py

The warp kernels and their plain versions are held to bit equality: both
round where the TPU kernels do (see ops/cuda/csrc/warp.cu). The noise
kernels' Philox words are held to bit equality with the plain version's;
their outputs to one ulp of it (CUDA's logf and sincosf in the kernel
against PyTorch's CUDA log, sin and cos in the plain version), with the
normalisation (ratio 0) exact.
"""

import ctypes
from pathlib import Path

import numpy as np
import pytest
import torch

from denoising_diffusion_deep_fake_tpu_torch.ops.cuda import noise_kernel as nk
from denoising_diffusion_deep_fake_tpu_torch.ops.cuda import warp_fused as pf
from denoising_diffusion_deep_fake_tpu_torch.ops.cuda import warp_kernel as pk
from denoising_diffusion_deep_fake_tpu_torch.ops.cuda._build import LAUNCHES

pytestmark = pytest.mark.cuda
IMAGENET = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _params(b, seed, device):
    g = torch.Generator().manual_seed(seed)

    def u(lo, hi):
        return (lo + (hi - lo) * torch.rand(b, generator=g)).to(device)

    return {"angle": u(-15, 15), "scale": u(0.8, 1.2), "tx": u(-0.2, 0.2),
            "ty": u(-0.2, 0.2),
            "apply": torch.ones(b, dtype=torch.bool, device=device)}


def _coeffs(params, h, w):
    from denoising_diffusion_deep_fake_tpu_torch.ops.augment import (
        _inverse_affine_coeffs)

    return _inverse_affine_coeffs(params, h, w)


def _fixed_params(rows, device):
    """One sample per ``(angle, scale, tx, ty)`` row."""
    cols = torch.tensor(rows, dtype=torch.float32, device=device).T
    return {"angle": cols[0], "scale": cols[1], "tx": cols[2],
            "ty": cols[3],
            "apply": torch.ones(len(rows), dtype=torch.bool, device=device)}


# The corners of AffineAugmentConfig.random_affine (ops/augment.py:46-50):
# +-15 degrees, scale 0.8 and 1.2, translate +-0.2, where sources fall off
# the edge and the zero border must land in normalised space.
EXTREMES = [(15.0, 1.2, 0.2, 0.2), (-15.0, 0.8, -0.2, -0.2),
            (15.0, 0.8, -0.2, 0.2), (-15.0, 1.2, 0.2, -0.2)]
IDENTITY = [(0.0, 1.0, 0.0, 0.0)] * 2


def _fused_vs_plain(u8, params, mean, std):
    b, h, w, c = u8.shape
    coeffs = _coeffs(params, h, w)
    before = LAUNCHES["affine_warp_fused"]
    got = pf.affine_warp_fused_coeffs(u8, coeffs, mean=mean, std=std)
    assert LAUNCHES["affine_warp_fused"] == before + 1
    want = pf.affine_warp_fused_plain(u8, coeffs,
                                      pf.norm_constants(mean, std, c))
    torch.cuda.synchronize()
    assert got.shape == (b, h, w, c) and got.dtype == torch.float32
    assert torch.equal(got, want)


@pytest.mark.parametrize("shape", [(2, 64, 64), (2, 96, 64), (2, 64, 96),
                                   (2, 384, 512), (2, 512, 512),
                                   (16, 448, 448)])
@pytest.mark.parametrize("norm", [((0.5,) * 3, (0.5,) * 3), IMAGENET])
def test_fused_kernel_matches_plain(cuda, shape, norm):
    b, h, w = shape
    u8 = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (b, h, w, 3), np.uint8)).to(cuda)
    _fused_vs_plain(u8, _params(b, 1, cuda), *norm)


@pytest.mark.parametrize("rows", [EXTREMES, IDENTITY],
                         ids=["extremes", "identity"])
@pytest.mark.parametrize("norm", [((0.5,) * 3, (0.5,) * 3), IMAGENET])
def test_fused_kernel_matches_plain_at_fixed_params(cuda, rows, norm):
    u8 = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (len(rows), 448, 448, 3), np.uint8)).to(cuda)
    _fused_vs_plain(u8, _fixed_params(rows, cuda), *norm)


def test_fused_kernel_float_input_matches_plain(cuda):
    x = torch.randn((2, 64, 64, 3), generator=torch.Generator().manual_seed(
        2)).to(cuda)
    coeffs = _coeffs(_params(2, 3, cuda), 64, 64)
    got = pf.affine_warp_fused_coeffs(x, coeffs)
    want = pf.affine_warp_fused_plain(x, coeffs, None)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("shape", [(2, 64, 64), (16, 448, 448)])
@pytest.mark.parametrize("norm", [((0.5,) * 3, (0.5,) * 3), IMAGENET])
def test_fused_kernel_fp32_input_with_norm_matches_plain(cuda, shape, norm):
    """An i420 upload's route at 448^2: fp32 RGB in [0, 255] from the
    unpack, normalised inside the fused kernel (``__fdiv_rn``), bit-equal
    to the plain version's true division, at random params and at the
    range corners."""
    from denoising_diffusion_deep_fake_tpu_torch.ops.image import (
        i420_to_rgb)

    b, h, w = shape
    packed = torch.from_numpy(np.random.default_rng(4).integers(
        0, 256, (b, h * 3 // 2, w), np.uint8)).to(cuda)
    rgb = i420_to_rgb(packed)
    assert rgb.dtype == torch.float32 and rgb.shape == (b, h, w, 3)
    _fused_vs_plain(rgb, _params(b, 5, cuda), *norm)
    _fused_vs_plain(rgb[:4], _fixed_params(EXTREMES[:min(b, 4)], cuda),
                    *norm)


def test_i420_balancer_step_noises_with_the_fp32_kernel(cuda):
    """Under ``upload_format: i420`` a balancer train step launches the
    fp32 noise kernel once and the uint8 one not at all; scoring (RGB)
    launches the uint8 kernel."""
    from denoising_diffusion_deep_fake_tpu_torch.config import (
        BalanceConfig, config_from_dict)
    from denoising_diffusion_deep_fake_tpu_torch.ops.image import (
        rgb_to_i420)
    from denoising_diffusion_deep_fake_tpu_torch.training.balance import (
        BalanceTrainer)

    cfg = config_from_dict(BalanceConfig, dict(
        data_path="x", batch_size=2, encoder_name="resnet18",
        compute_dtype="float32", image_size=64, upload_format="i420"))
    trainer = BalanceTrainer(cfg, steps_per_epoch=1, image_size=64,
                             device=cuda)
    state = trainer.init_state(seed=0)
    rgb = torch.randint(0, 256, (2, 64, 64, 3), dtype=torch.uint8,
                        device=cuda)
    LAUNCHES.clear()
    loss = trainer.train_step(state, rgb_to_i420(rgb))["loss"]
    assert torch.isfinite(loss).item()
    assert dict(LAUNCHES) == {"fused_noise_blend": 1}
    trainer.score_dataset(state, [(rgb, np.arange(2))])
    assert LAUNCHES["fused_normalise_noise_blend"] == 1


def test_fused_kernel_is_one_launch_without_scratch(cuda):
    from torch.profiler import ProfilerActivity, profile

    u8 = torch.randint(0, 256, (4, 448, 448, 3), dtype=torch.uint8,
                       device=cuda)
    coeffs = _coeffs(_params(4, 8, cuda), 448, 448)
    pf.affine_warp_fused_coeffs(u8, coeffs, mean=0.5, std=0.5)  # builds it
    torch.cuda.synchronize()
    start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = pf.affine_warp_fused_coeffs(u8, coeffs, mean=0.5, std=0.5)
        torch.cuda.synchronize()
    out_bytes = out.numel() * 4
    # The output stays; the pass scalars (a few KB) come and go; a scratch
    # batch (half the output in bf16) would show in the peak.
    assert torch.cuda.memory_allocated() - start == out_bytes
    assert torch.cuda.max_memory_allocated() - start < out_bytes + (1 << 20)
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert sum("warp_fused_kernel" in n for n in names) == 1
    assert not any("warp_rows_kernel" in n or "warp_cols_kernel" in n
                   for n in names)


def test_fused_launcher_rejects_what_the_kernel_cannot_take(cuda):
    b, h, w = 1, 64, 32
    ax, sx, ay, sy = pk.shear_factors(
        _coeffs(_params(b, 9, cuda), h, w), h, w)
    scalars = (ax.contiguous(), *pk.pass_scalars(ax, sx, w),
               ay.contiguous(), *pk.pass_scalars(ay, sy, h))
    src = torch.zeros((b, h, w, 5), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="channels"):
        pf.launch_fused(src, torch.empty(src.shape, device=cuda), *scalars,
                        None)
    # 1184 rows of 3 channels: a 232,064-byte strip plus the uint8 table.
    tall = torch.zeros((b, 1184, w, 3), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        pf.launch_fused(tall, torch.empty(tall.shape, device=cuda),
                        *scalars, None)
    with pytest.raises(TypeError):
        src = torch.zeros((b, h, w, 3), dtype=torch.float64, device=cuda)
        pf.launch_fused(src, torch.empty(src.shape, device=cuda), *scalars,
                        None)


@pytest.mark.parametrize("shape", [(2, 64, 64), (2, 96, 64), (2, 640, 640)])
def test_twopass_kernel_matches_plain(cuda, shape):
    b, h, w = shape
    x = torch.randn((b, h, w, 3), generator=torch.Generator().manual_seed(
        4)).to(cuda)
    coeffs = _coeffs(_params(b, 5, cuda), h, w)
    before = LAUNCHES["warp_axis_pass"]
    got = pk.affine_warp_twopass_coeffs(x, coeffs)
    assert LAUNCHES["warp_axis_pass"] == before + 2
    want = pf.affine_warp_fused_plain(x, coeffs, None)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("rows", [EXTREMES, IDENTITY],
                         ids=["extremes", "identity"])
@pytest.mark.parametrize("hw", [(640, 640), (96, 64)])
def test_twopass_kernel_matches_plain_at_fixed_params(cuda, rows, hw):
    h, w = hw
    x = torch.randn((len(rows), h, w, 3),
                    generator=torch.Generator().manual_seed(13)).to(cuda)
    coeffs = _coeffs(_fixed_params(rows, cuda), h, w)
    got = pk.affine_warp_twopass_coeffs(x, coeffs)
    assert torch.equal(got, pk.affine_warp_twopass_plain(x, coeffs))


def _shift_scale_rotate_params(b, seed, device):
    """The deep-fake trainer's draws (p = 0.7), some samples unwarped."""
    from denoising_diffusion_deep_fake_tpu_torch.ops.augment import (
        AffineAugmentConfig, sample_affine_params)

    params = sample_affine_params(
        b, AffineAugmentConfig.shift_scale_rotate(),
        generator=torch.Generator().manual_seed(seed))
    assert 0 < int(params["apply"].sum()) < b
    return {k: v.to(device) for k, v in params.items()}


@pytest.mark.parametrize("route,shape,seed", [
    ("fused", (16, 448, 448), 0), ("fused", (2, 64, 64), 3),
    ("twopass", (4, 640, 640), 0), ("twopass", (2, 96, 64), 3)])
def test_warp_kernels_match_plain_with_unwarped_samples(cuda, route, shape,
                                                        seed):
    b, h, w = shape
    params = _shift_scale_rotate_params(b, seed, cuda)
    if route == "fused":
        u8 = torch.from_numpy(np.random.default_rng(seed).integers(
            0, 256, (b, h, w, 3), np.uint8)).to(cuda)
        _fused_vs_plain(u8, params, *IMAGENET)
    else:
        x = torch.randn((b, h, w, 3), generator=torch.Generator().manual_seed(
            seed)).to(cuda)
        coeffs = _coeffs(params, h, w)
        got = pk.affine_warp_twopass_coeffs(x, coeffs)
        assert torch.equal(got, pk.affine_warp_twopass_plain(x, coeffs))


def test_twopass_route_is_one_row_and_one_column_launch(cuda):
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn((4, 640, 640, 3), device=cuda)
    coeffs = _coeffs(_params(4, 14, cuda), 640, 640)
    pk.affine_warp_twopass_coeffs(x, coeffs)  # builds it
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        pk.affine_warp_twopass_coeffs(x, coeffs)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert sum("warp_rows_kernel" in n for n in names) == 1
    assert sum("warp_cols_kernel" in n for n in names) == 1


def _pass_case(layout, b, lines, n, c, device):
    """``(src, dst)`` fp32 ``(B, L, C, N)`` views: the x-pass (NHWC source,
    planar destination), the y-pass (planar source, NHWC destination), a
    contiguous ``(B, H, C, W)`` batch, and a sliced source that is
    contiguous along no axis."""
    g = torch.Generator().manual_seed(lines * n + c)
    if layout == "x-pass":
        src = torch.randn((b, lines, n, c), generator=g).to(device)
        return (src.permute(0, 1, 3, 2), torch.empty(
            (b, c, lines, n), device=device).permute(0, 2, 1, 3))
    if layout == "y-pass":
        src = torch.randn((b, c, n, lines), generator=g).to(device)
        return (src.permute(0, 3, 1, 2), torch.empty(
            (b, n, lines, c), device=device).permute(0, 2, 3, 1))
    dst = torch.empty((b, lines, c, n), device=device)
    if layout == "bhcw":
        return torch.randn((b, lines, c, n), generator=g).to(device), dst
    src = torch.randn((b, lines + 3, c + 2, 2 * n + 5), generator=g)
    return src.to(device)[:, 1:lines + 1, 1:c + 1, 3:2 * n + 3:2], dst


def _pass_scalars(b, lines, n, device, lo=0.8, hi=1.25, seed=15):
    g = torch.Generator().manual_seed(seed)
    alpha = lo + (hi - lo) * torch.rand(b, generator=g)
    shift = (20 * torch.rand(b, 1, generator=g) - 10
             + 0.2 * torch.arange(lines)[None])
    return alpha.to(device), shift.to(device)


@pytest.mark.parametrize("kernel", ["rows", "cols"])
@pytest.mark.parametrize("layout", ["x-pass", "y-pass", "bhcw", "sliced"])
@pytest.mark.parametrize("shape", [(4, 640, 640, 3), (2, 96, 64, 3),
                                   (2, 64, 96, 1), (2, 64, 45, 4),
                                   (2, 32, 100, 5), (2, 64, 70, 3)],
                         ids=lambda s: "x".join(map(str, s)))
def test_each_pass_kernel_matches_plain_on_each_layout(cuda, kernel, layout,
                                                       shape):
    b, lines, n, c = shape
    src, dst = _pass_case(layout, b, lines, n, c, cuda)
    assert src.shape == dst.shape == (b, lines, c, n)
    alpha, shift = _pass_scalars(b, lines, n, cuda)
    base, resid = pk.pass_scalars(alpha, shift, n)
    dst.fill_(float("nan"))
    pk.launch_pass(src, dst, alpha, base, resid, kernel=kernel)
    want = pk.warp_axis_pass_plain(src, alpha, shift)
    torch.cuda.synchronize()
    assert torch.equal(dst, want)


@pytest.mark.parametrize("alpha_range", [(2.0, 3.0), (-1.3, -0.7),
                                         (0.1, 0.3)])
@pytest.mark.parametrize("seg", [10, 40, 96])
def test_column_kernel_windows_match_plain(cuda, alpha_range, seg):
    # Segments shorter than the line; alpha beyond the strip's room (the
    # direct reads), negative, and small.
    b, lines, n, c = 2, 64, 96, 3
    src, dst = _pass_case("y-pass", b, lines, n, c, cuda)
    alpha, shift = _pass_scalars(b, lines, n, cuda, *alpha_range)
    base, resid = pk.pass_scalars(alpha, shift, n)
    dst.fill_(float("nan"))
    pk.launch_pass(src, dst, alpha, base, resid, kernel="cols", seg=seg)
    assert torch.equal(dst, pk.warp_axis_pass_plain(src, alpha, shift))


def test_pass_launcher_raises_before_any_launch(cuda):
    # One segment of 2400 outputs: a 470,400-byte strip at C = 3.
    src, dst = _pass_case("y-pass", 1, 32, 2400, 3, cuda)
    alpha, shift = _pass_scalars(1, 32, 2400, cuda)
    base, resid = pk.pass_scalars(alpha, shift, 2400)
    dst.fill_(float("nan"))
    with pytest.raises(ValueError, match="shared memory"):
        pk.launch_pass(src, dst, alpha, base, resid, kernel="cols",
                       seg=2400)
    torch.cuda.synchronize()
    assert dst.isnan().all()
    # The default segments take the same line.
    pk.launch_pass(src, dst, alpha, base, resid)
    assert torch.equal(dst, pk.warp_axis_pass_plain(src, alpha, shift))


def test_axis_pass_kernel_matches_plain(cuda):
    g = torch.Generator().manual_seed(6)
    img = torch.randn((2, 64, 3, 96), generator=g).to(cuda)
    alpha = (0.8 + 0.45 * torch.rand(2, generator=g)).to(cuda)
    shift = (20 * torch.rand(2, 1, generator=g) - 10
             + 0.2 * torch.arange(64)[None]).to(cuda)
    got = pk.warp_axis_pass(img, alpha, shift)
    want = pk.warp_axis_pass_plain(img, alpha, shift)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_launcher_rejects_bad_operands(cuda):
    x = torch.zeros((1, 32, 3, 64), device=cuda, dtype=torch.float64)
    alpha = torch.ones(1, device=cuda)
    base = torch.zeros((1, 1), dtype=torch.int32, device=cuda)
    resid = torch.zeros((1, 32), device=cuda)
    with pytest.raises(TypeError):
        pk.launch_pass(x, torch.empty_like(x), alpha, base, resid)
    with pytest.raises(ValueError):
        pk.launch_pass(x.float(), torch.empty_like(x.float()), alpha.cpu(),
                       base, resid)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_step_on_gpu(cuda, dtype):
    from denoising_diffusion_deep_fake_tpu_torch.config import (
        DenoiserConfig, config_from_dict)
    from denoising_diffusion_deep_fake_tpu_torch.training.denoiser import (
        DenoiserTrainer)

    cfg = config_from_dict(DenoiserConfig, dict(
        input_image_list_path="unused", batch_size=2, learning_rate=1e-3,
        encoder_name="resnet18", compute_dtype=dtype,
        warp_method="pallas_fused"))
    trainer = DenoiserTrainer(cfg, steps_per_epoch=4, image_size=64)
    state = trainer.init_state(seed=0)
    u8 = torch.randint(0, 256, (2, 64, 64, 3), dtype=torch.uint8,
                       generator=torch.Generator().manual_seed(7))
    losses = [float(trainer.train_step(state, u8)["loss"]) for _ in range(2)]
    assert np.isfinite(losses).all() and state.step == 2
    out = trainer.make_denoise_fn()(state, u8.float().to(cuda) / 127.5 - 1)
    assert out.shape == (2, 64, 64, 3) and out.dtype == torch.float32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_deep_fake_steps_on_gpu(cuda, dtype):
    """Denoise, the flip, and swap: finite losses, two fused warps and two
    noise launches a step, shadows that copy and then blend."""
    import dataclasses

    from denoising_diffusion_deep_fake_tpu_torch.config import (
        DeepFakeConfig, config_from_dict, overlay_config)
    from denoising_diffusion_deep_fake_tpu_torch.training.deep_fake import (
        DeepFakeTrainer)
    from denoising_diffusion_deep_fake_tpu_torch.training.state import (
        shadow_tensors)

    cfg = config_from_dict(DeepFakeConfig, dict(
        data_path_a="a", data_path_b="b", batch_size=2, learning_rate=1e-3,
        encoder_name="resnet18", compute_dtype=dtype,
        warp_method="pallas_fused"))
    trainer = DeepFakeTrainer(cfg, steps_per_epoch=4, image_size=64)
    states = trainer.init_states(seed=0)
    gen = torch.Generator().manual_seed(9)
    u8 = torch.randint(0, 256, (2, 2, 64, 64, 3), dtype=torch.uint8,
                       generator=gen)
    before = dict(LAUNCHES)
    m = trainer.train_step(states, u8[0], u8[1])
    assert np.isfinite([float(m[f"loss_denoise/train_{n}"])
                        for n in "ab"]).all()
    swap = DeepFakeTrainer(overlay_config(
        DeepFakeConfig, dataclasses.asdict(cfg),
        dict(mode="swap", ema_update_after_step=0)),
        steps_per_epoch=4, image_size=64)
    swap.ensure_ema(states)
    assert all(s.model.encoder.conv1.weight.is_contiguous(
        memory_format=torch.channels_last) for s in states.values())
    assert all(s.ema_model.encoder.conv1.weight.is_contiguous(
        memory_format=torch.channels_last) for s in states.values())
    for _ in range(3):
        m = swap.train_step(states, u8[0], u8[1])
    for key in ("loss_swap/train_a", "loss_swap/train_b",
                "swap_difference/a", "swap_difference/b"):
        assert np.isfinite(float(m[key])), key
    for name in ("affine_warp_fused", "fused_noise_blend"):
        assert LAUNCHES[name] == before.get(name, 0) + 8, name
    for s in states.values():
        assert s.step == 4 and s.ema_step == 3
        # ema_step 2 blended (decay > 0): the shadow is off the model.
        assert not all(torch.equal(e, p) for e, p in zip(
            shadow_tensors(s.ema_model), shadow_tensors(s.model)))
    for use_ema in (False, True):
        out = swap.make_predict_fake(use_ema=use_ema)(
            states["a"], torch.rand((2, 64, 64, 3), device=cuda) * 2 - 1)
        assert out.dtype == torch.float32 and torch.isfinite(out).all()


def _within_one_ulp(got, want):
    ulp = (torch.nextafter(want.abs(), torch.tensor(float("inf"),
                                                    device=want.device))
           - want.abs())
    return bool(((got - want).abs() <= ulp).all())


@pytest.mark.parametrize("seed,offset", [(0, 0), (0x299f31d0a4093822, 7),
                                         (5, (3 << 32) + 11)])
def test_philox_words_match_plain(cuda, seed, offset):
    got = nk.philox_words(1000, seed=seed, offset=offset, device=cuda)
    want = nk.philox_words_plain(1000, seed=seed, offset=offset, device=cuda)
    assert torch.equal(got, want)
    if (seed, offset) == (0, 0):
        assert got[0].tolist() == [0x6627e8d5, 0xe169c58d, 0xbc57ac4c,
                                   0x9b00dbd8]


@pytest.mark.parametrize("shape", [(12, 64, 64, 3), (3, 64, 64, 3),
                                   (3, 5, 7, 3), (1, 1, 1, 1)])
@pytest.mark.parametrize("norm", [((0.5,) * 3, (0.5,) * 3), IMAGENET])
def test_normalise_noise_kernel_matches_plain(cuda, shape, norm):
    b, c = shape[0], shape[-1]
    mean, std = (norm[0][:c], norm[1][:c])
    u8 = torch.from_numpy(np.random.default_rng(8).integers(
        0, 256, shape, np.uint8)).to(cuda)
    ratios = torch.linspace(0, 1, b, device=cuda)
    before = LAUNCHES["fused_normalise_noise_blend"]
    got = nk.fused_normalise_noise_blend(u8, ratios, mean, std, seed=3,
                                         offset=4)
    assert LAUNCHES["fused_normalise_noise_blend"] == before + 1
    want = nk.fused_normalise_noise_blend_plain(
        u8, ratios, nk.noise_constants(mean, std, c), seed=3, offset=4)
    torch.cuda.synchronize()
    assert got.shape == shape and got.dtype == torch.float32
    assert _within_one_ulp(got, want)
    zero = nk.fused_normalise_noise_blend(u8, torch.zeros(b, device=cuda),
                                          mean, std, seed=3, offset=4)
    assert torch.equal(zero, nk.fused_normalise_noise_blend_plain(
        u8, torch.zeros(b, device=cuda), nk.noise_constants(mean, std, c),
        seed=3))


# C = 1..4; samples whose size is not a multiple of 4 ((3, 5, 7, 3)) or
# below 4 ((8, 1, 1, 1), (6, 1, 1, 2)), so groups of 4 straddle them; and
# samples that straddle some of the uint8 kernel's blocks and not others.
@pytest.mark.parametrize("shape", [(8, 1, 1, 1), (6, 1, 1, 2), (3, 5, 7, 3),
                                   (5, 9, 13, 4), (3, 64, 64, 1),
                                   (4, 33, 31, 2), (3, 100, 100, 3),
                                   (2, 64, 70, 4)])
@pytest.mark.parametrize("offset", [4, (3 << 32) + 11])
def test_normalise_noise_kernel_channels_and_straddles(cuda, shape, offset):
    b, c = shape[0], shape[-1]
    mean, std = (IMAGENET[0] + (0.5,))[:c], (IMAGENET[1] + (0.25,))[:c]
    norm = nk.noise_constants(mean, std, c)
    rng = np.random.default_rng(13)
    flat = torch.from_numpy(rng.integers(0, 256, int(np.prod(shape)) + 1,
                                         np.uint8)).to(cuda)
    # Distinct per-sample ratios, 0 and 1 among them, not in order.
    ratios = torch.from_numpy(rng.permutation(
        np.linspace(0, 1, b, dtype=np.float32))).to(cuda)
    zeros = torch.zeros(b, device=cuda)
    # An aligned batch, then an unaligned view (the scalar path).
    for u8 in (flat[:-1].view(shape), flat[1:].view(shape)):
        got = nk.fused_normalise_noise_blend(u8, ratios, mean, std, seed=3,
                                             offset=offset)
        want = nk.fused_normalise_noise_blend_plain(u8, ratios, norm, seed=3,
                                                    offset=offset)
        torch.cuda.synchronize()
        assert _within_one_ulp(got, want)
        assert torch.equal(
            nk.fused_normalise_noise_blend(u8, zeros, mean, std, seed=3,
                                           offset=offset),
            nk.fused_normalise_noise_blend_plain(u8, zeros, norm, seed=3,
                                                 offset=offset))


def test_uint8_noise_refuses_two_to_the_31_elements_before_a_launch(cuda):
    n = 1 << 31
    norm = (ctypes.c_float * 8)(*([0.0] * 4 + [1.0] * 4))
    # Null pointers: a launch would fault, so a return code of
    # cudaErrorInvalidValue (1) shows the entry refused first.
    assert nk._noise_lib().d3f_noise_blend(2, None, None, n, n // 4, 4, None,
                                           norm, 0, 0, 0, n, 0, None) == 1
    torch.cuda.synchronize()
    # The wrapper says why, before it looks at the output.
    x = torch.zeros((1, 1, 1, 1), dtype=torch.uint8, device=cuda).expand(
        2 ** 11, 2 ** 10, 2 ** 10, 1)
    with pytest.raises(ValueError, match="32 bits"):
        nk.launch_blend(x, torch.empty(1, device=cuda),
                        torch.zeros(2 ** 11, device=cuda), [0.0, 1.0],
                        seed=0, offset=0)


@pytest.mark.parametrize("shape", [(16, 64, 64, 3), (3, 5, 7, 3)])
def test_noise_blend_kernel_matches_plain(cuda, shape):
    x = torch.randn(shape, generator=torch.Generator().manual_seed(9)).to(
        cuda)
    ratios = torch.rand(shape[0], generator=torch.Generator().manual_seed(
        10)).to(cuda)
    before = LAUNCHES["fused_noise_blend"]
    got = nk.fused_noise_blend(x, ratios, seed=1, offset=2)
    assert LAUNCHES["fused_noise_blend"] == before + 1
    want = nk.fused_noise_blend_plain(x, ratios, seed=1, offset=2)
    assert _within_one_ulp(got, want)
    # An unaligned view takes the kernel's scalar path.
    flat = torch.cat([torch.zeros(1, device=cuda), x.reshape(-1)])
    view = flat[1:].view(shape)
    assert torch.equal(nk.fused_noise_blend(view, ratios, seed=1, offset=2),
                       got)


def test_noise_kernel_statistics_and_determinism(cuda):
    x = torch.zeros((16, 128, 128, 3), device=cuda)
    ones = torch.ones(16, device=cuda)
    eps = nk.fused_noise_blend(x, ones, seed=11, offset=0)
    assert abs(float(eps.mean())) < 0.005
    assert abs(float(eps.var()) - 1.0) < 0.005
    assert float(eps.abs().max()) <= 5.9
    corr = torch.corrcoef(eps[:2].reshape(2, -1))[0, 1]
    assert abs(float(corr)) < 0.01
    assert torch.equal(eps, nk.fused_noise_blend(x, ones, seed=11, offset=0))
    assert not torch.equal(eps, nk.fused_noise_blend(x, ones, seed=11,
                                                     offset=1))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_balancer_step_on_gpu(cuda, dtype):
    from denoising_diffusion_deep_fake_tpu_torch.config import (
        BalanceConfig, config_from_dict)
    from denoising_diffusion_deep_fake_tpu_torch.training.balance import (
        BalanceTrainer)

    cfg = config_from_dict(BalanceConfig, dict(
        data_path="unused", batch_size=3, learning_rate=1e-3,
        encoder_name="resnet18", compute_dtype=dtype))
    trainer = BalanceTrainer(cfg, steps_per_epoch=4, image_size=64)
    state = trainer.init_state(seed=0)
    u8 = torch.randint(0, 256, (5, 64, 64, 3), dtype=torch.uint8,
                       generator=torch.Generator().manual_seed(12))
    before = LAUNCHES["fused_normalise_noise_blend"]
    loss = float(trainer.train_step(state, u8[:3])["loss"])
    assert np.isfinite(loss) and state.step == 1
    idx, losses = trainer.score_dataset(
        state, [(u8[:3], np.arange(3)), (u8[3:], np.arange(3, 5))])
    assert LAUNCHES["fused_normalise_noise_blend"] == before + 3
    assert losses.shape == (5,) and np.isfinite(losses).all()


def test_noise_launcher_rejects_bad_operands(cuda):
    x = torch.zeros((2, 4, 4, 3), device=cuda)
    ratios = torch.zeros(2, device=cuda)
    with pytest.raises(ValueError, match="out"):
        nk.launch_blend(x, torch.empty((2, 4, 4, 3), device=cuda,
                                       dtype=torch.float64), ratios, None,
                        seed=0, offset=0)
    with pytest.raises(ValueError, match="ratios"):
        nk.launch_blend(x, torch.empty_like(x), ratios[:1], None, seed=0,
                        offset=0)
    with pytest.raises(TypeError):
        nk.launch_blend(x, torch.empty_like(x), ratios, [0.0] * 6, seed=0,
                        offset=0)


# ------------------------------------------------------------ serving slice


def _swap_checkpoint(tmp_path, device, *, dtype="float32", size=64):
    """A swap-mode resnet18 pair (with shadows apart from their models)
    saved by the port's manager; returns the directory and the states."""
    import dataclasses

    from denoising_diffusion_deep_fake_tpu_torch.checkpoint import (
        CheckpointManager)
    from denoising_diffusion_deep_fake_tpu_torch.config import (
        DeepFakeConfig, config_from_dict)
    from denoising_diffusion_deep_fake_tpu_torch.training.deep_fake import (
        DeepFakeTrainer)
    from denoising_diffusion_deep_fake_tpu_torch.training.state import (
        create_model_state)

    cfg = config_from_dict(DeepFakeConfig, dict(
        mode="swap", data_path_a="a", data_path_b="b", batch_size=2,
        encoder_name="resnet18", compute_dtype=dtype, image_size=size,
        mean_a=IMAGENET[0], std_a=IMAGENET[1]))
    trainer = DeepFakeTrainer(cfg, steps_per_epoch=1, image_size=size,
                              device=device)
    states = trainer.init_states(seed=3)
    for i, state in enumerate(states.values()):
        apart = create_model_state(cfg, trainer.dtype, torch.device(device),
                                   seed=30 + i)
        state.ema_model.load_state_dict(apart.model.state_dict())
    CheckpointManager(tmp_path).save(2, states, dataclasses.asdict(cfg))
    return tmp_path, states


def test_checkpoint_round_trip_on_gpu(cuda, tmp_path):
    from denoising_diffusion_deep_fake_tpu_torch.inference import (
        load_swap_model)

    path, states = _swap_checkpoint(tmp_path, cuda, dtype="bfloat16")
    for name, state in states.items():
        for use_ema, module in ((False, state.model),
                                (True, state.ema_model)):
            model = load_swap_model(path, name, use_ema=use_ema)
            assert model.device.type == "cuda" and not model.model.training
            got, want = model.model.state_dict(), module.state_dict()
            assert got.keys() == want.keys()
            assert all(torch.equal(got[k], want[k]) for k in want)
            conv = model.model.encoder.conv1.weight
            assert conv.is_contiguous(memory_format=torch.channels_last)


def test_swap_pipeline_gpu_matches_cpu(cuda, tmp_path):
    """fp32 64^2: single-pass uint8 within 1 LSB; DDIM at 3 steps with
    injected noise within 1e-4 of the largest magnitude."""
    from denoising_diffusion_deep_fake_tpu_torch.inference import (
        load_swap_model, make_device_pipeline)
    from denoising_diffusion_deep_fake_tpu_torch.ops.augment import (
        normalise_batch)
    from denoising_diffusion_deep_fake_tpu_torch.ops.sampler import (
        swap_refine)

    path, _ = _swap_checkpoint(tmp_path, "cpu")
    frames = torch.randint(0, 256, (3, 64, 64, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(4))
    noise = torch.randn((3, 64, 64, 3),
                        generator=torch.Generator().manual_seed(5))
    out, refined = {}, {}
    for name, dev in (("cpu", "cpu"), ("gpu", cuda)):
        model = load_swap_model(path, "b", device=dev)
        out[name] = make_device_pipeline(model)(frames.to(dev), 0).cpu()
        x = normalise_batch(frames.to(dev), model.mean, model.std)
        refined[name] = swap_refine(model.predict, x, steps=3, seed=0,
                                    offset=0, noise=noise.to(dev)).cpu()
    diff = (out["gpu"].int() - out["cpu"].int()).abs()
    assert int(diff.max()) <= 1
    err = (refined["gpu"] - refined["cpu"]).abs().max()
    assert float(err) <= 1e-4 * float(refined["cpu"].abs().max())


def test_fp32_predict_is_fp32_whatever_the_tf32_flags(cuda, tmp_path):
    """An fp32 swap model's own forward, with no pipeline built and TF32
    switched on by the caller, stays within 1e-4 of the CPU's; the
    caller's flags are back afterwards."""
    from denoising_diffusion_deep_fake_tpu_torch.inference import (
        load_swap_model)

    path, _ = _swap_checkpoint(tmp_path, "cpu")
    x = torch.randn((3, 64, 64, 3), generator=torch.Generator().manual_seed(6))
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    try:
        cudnn.allow_tf32 = matmul.allow_tf32 = True
        want = load_swap_model(path, "a", device="cpu").predict(x)
        got = load_swap_model(path, "a", device=cuda).predict(
            x.to(cuda)).cpu()
        assert cudnn.allow_tf32 and matmul.allow_tf32
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved
    err = (got.float() - want.float()).abs().max()
    assert float(err) <= 1e-4 * float(want.abs().max())


def test_ddim_pipeline_one_noise_launch_a_batch(cuda, tmp_path):
    from denoising_diffusion_deep_fake_tpu_torch.inference import (
        load_swap_model, make_device_pipeline)

    path, _ = _swap_checkpoint(tmp_path, cuda, dtype="bfloat16")
    model = load_swap_model(path, "a", use_ema=True)
    frames = torch.randint(0, 256, (4, 64, 64, 3), dtype=torch.uint8,
                           device=cuda)
    ddim = make_device_pipeline(model, sampler_steps=4, seed=1)
    before = dict(LAUNCHES)
    first = ddim(frames, 0)
    again = ddim(frames, 0)
    other = ddim(frames, 1)
    assert LAUNCHES["fused_noise_blend"] == before.get(
        "fused_noise_blend", 0) + 3
    assert torch.equal(first, again) and not torch.equal(first, other)
    single = make_device_pipeline(model)
    before = dict(LAUNCHES)
    assert single(frames, 0).dtype == torch.uint8
    assert dict(LAUNCHES) == before


def test_fit_denoiser_on_gpu_and_restore(cuda, tmp_path):
    """The runner on the card from .npy frames (no cv2 there): two epochs
    of 2 steps through the hybrid warp (64^2's route, plain PyTorch) and
    the fp32 noise kernel, then
    the final checkpoint restored bit for bit, fused Adam's steps on the
    card, and the generator's state."""
    from denoising_diffusion_deep_fake_tpu_torch.checkpoint import (
        CheckpointManager)
    from denoising_diffusion_deep_fake_tpu_torch.config import (
        DenoiserConfig, config_from_dict)
    from denoising_diffusion_deep_fake_tpu_torch.data.manifest import (
        write_image_manifest)
    from denoising_diffusion_deep_fake_tpu_torch.training.runners import (
        fit_denoiser)

    rng = np.random.default_rng(0)
    paths = [tmp_path / f"{i}.npy" for i in range(8)]
    for p in paths:
        np.save(p, rng.integers(0, 256, (64, 64, 3), np.uint8))
    write_image_manifest(tmp_path / "images.txt", paths)
    cfg = config_from_dict(DenoiserConfig, dict(
        input_image_list_path=str(tmp_path / "images.txt"), batch_size=4,
        encoder_name="resnet18", compute_dtype="float32", image_size=64,
        max_epochs=2, log_dir=str(tmp_path / "runs"),
        checkpoint_dir=str(tmp_path / "ckpt")))
    LAUNCHES.clear()
    state, trainer, ctx = fit_denoiser(cfg, verbose=False, decode_fn=np.load)
    torch.cuda.synchronize()
    assert trainer.device.type == "cuda" and ctx.global_step == 4
    assert LAUNCHES["warp_axis_pass"] == 0
    assert LAUNCHES["fused_noise_blend"] == 4
    generator = torch.Generator(device="cuda")
    restored, meta = CheckpointManager(cfg.checkpoint_dir).restore(
        lambda: trainer.init_state(1), generator=generator)
    assert meta["step"] == restored.step == 4
    assert torch.equal(generator.get_state(), trainer.generator.get_state())
    for got, want in ((restored.model.state_dict(), state.model.state_dict()),
                      *zip(restored.optimizer.state_dict()["state"].values(),
                           state.optimizer.state_dict()["state"].values())):
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].device == want[k].device, k
            assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("offset", [5, 2 ** 32 + 3])
def test_noise_device_offset_launch_matches_by_value(cuda, offset):
    """The form a K-step graph replays reads its offset from a device
    int64: the same Philox words and outputs as the by-value launch."""
    gen = torch.Generator().manual_seed(4)
    at = torch.tensor(offset, dtype=torch.int64, device=cuda)
    assert torch.equal(nk.philox_words(1000, seed=9, offset=at, device=cuda),
                       nk.philox_words(1000, seed=9, offset=offset,
                                       device=cuda))
    u8 = torch.randint(0, 256, (3, 32, 32, 3), dtype=torch.uint8,
                       generator=gen).to(cuda)
    x = torch.randn((3, 32, 32, 3), generator=gen).to(cuda)
    r = torch.rand(3, generator=gen).to(cuda)
    assert torch.equal(
        nk.fused_normalise_noise_blend(u8, r, *IMAGENET, seed=9, offset=at),
        nk.fused_normalise_noise_blend(u8, r, *IMAGENET, seed=9,
                                       offset=offset))
    assert torch.equal(nk.fused_noise_blend(x, r, seed=9, offset=at),
                       nk.fused_noise_blend(x, r, seed=9, offset=offset))
    with pytest.raises(ValueError):
        nk.fused_noise_blend(x, r, seed=9, offset=at.to(torch.int32))


@pytest.mark.parametrize("mode", ["denoiser", "denoiser_i420", "swap",
                                  "denoiser_remat_jitter"])
def test_k_step_graph_matches_eager_steps(cuda, mode):
    """Two replays of a K = 3 graph against 6 eager steps, fp32 under
    cudnn.deterministic: every tensor, loss, counter and the generator
    bit-equal, the launches counted per replay; a restored optimizer makes
    the next call capture a new graph. ``denoiser_remat_jitter``: with
    ``remat: dots`` (the checkpoint's saved-tensor hooks captured) and the
    color jitter on (its factors drawn on the card inside the graph)."""
    import io

    from denoising_diffusion_deep_fake_tpu_torch.config import (
        DeepFakeConfig, DenoiserConfig, config_from_dict)
    from denoising_diffusion_deep_fake_tpu_torch.training.deep_fake import (
        DeepFakeTrainer)
    from denoising_diffusion_deep_fake_tpu_torch.training.denoiser import (
        DenoiserTrainer)
    from denoising_diffusion_deep_fake_tpu_torch.training.optim import (
        bind_device_lr)

    def make():
        if mode.startswith("denoiser"):
            cfg = config_from_dict(DenoiserConfig, dict(
                input_image_list_path="x", batch_size=2,
                encoder_name="resnet18", compute_dtype="float32",
                upload_format="i420" if mode.endswith("i420") else "rgb",
                **(dict(remat="dots", color_jitter=(0.2, 0.2, 0.2, 0.05))
                   if mode.endswith("jitter") else {})))
            t = DenoiserTrainer(cfg, steps_per_epoch=1, image_size=64)
            return t, t.init_state(seed=0), 1
        cfg = config_from_dict(DeepFakeConfig, dict(
            data_path_a="a", data_path_b="b", batch_size=2, mode="swap",
            encoder_name="resnet18", compute_dtype="float32",
            ema_update_after_step=2))
        t = DeepFakeTrainer(cfg, steps_per_epoch=1, image_size=64)
        return t, t.init_states(seed=0), 2

    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic
    cudnn.deterministic = True
    try:
        (eager_t, eager_s, n), (graph_t, graph_s, _) = make(), make()
        gen = torch.Generator().manual_seed(3)
        shape = (2, 96, 64) if mode.endswith("i420") else (2, 64, 64, 3)
        steps = [[torch.randint(0, 256, shape, dtype=torch.uint8,
                                generator=gen).to(cuda) for _ in range(n)]
                 for _ in range(9)]
        eager = [eager_t.train_step(eager_s, *b) for b in steps]
        step = graph_t.make_super_step(3)
        before = dict(LAUNCHES)
        groups = [step(graph_s, *[x for pos in zip(*steps[i:i + 3])
                                  for x in pos]) for i in (0, 3)]
        per_replay = {k: v - before.get(k, 0) for k, v in LAUNCHES.items()
                      if v != before.get(k, 0)}
        assert per_replay == {"fused_noise_blend": 6 * n}
        assert step.captures == 1
        for st in (graph_s.values() if mode == "swap" else [graph_s]):
            buf = io.BytesIO()
            torch.save(st.optimizer.state_dict(), buf)
            buf.seek(0)
            st.optimizer.load_state_dict(torch.load(buf, weights_only=True))
            bind_device_lr(st.optimizer)
        groups.append(step(graph_s, *[x for pos in zip(*steps[6:])
                                      for x in pos]))
        assert step.captures == 2
    finally:
        cudnn.deterministic = saved
    pairs = ([(graph_s[n], eager_s[n]) for n in "ab"] if mode == "swap"
             else [(graph_s, eager_s)])
    for g, w in pairs:
        assert (g.step, g.ema_step) == (w.step, w.ema_step)
        for a, b in zip(list(g.model.state_dict().values())
                        + (list(g.ema_model.state_dict().values())
                           if g.has_ema else []),
                        list(w.model.state_dict().values())
                        + (list(w.ema_model.state_dict().values())
                           if w.has_ema else [])):
            assert torch.equal(a, b)
        gs, ws = (s.optimizer.state_dict()["state"] for s in (g, w))
        assert all(torch.equal(gs[i][k], ws[i][k]) for i in ws
                   for k in ws[i])
    assert torch.equal(graph_t.generator.get_state(),
                       eager_t.generator.get_state())
    for key in groups[0]:
        got = [float(v) for g in groups for v in g[key]]
        assert got == [float(m[key]) for m in eager], key


def _npy_frames(root, n, size, seed):
    from denoising_diffusion_deep_fake_tpu_torch.data.manifest import (
        write_image_manifest)

    rng = np.random.default_rng(seed)
    root.mkdir(parents=True)
    paths = [root / f"{i}.npy" for i in range(n)]
    for p in paths:
        np.save(p, rng.integers(0, 256, (size, size, 3), np.uint8))
    write_image_manifest(root / "images.txt", paths)
    return root / "images.txt"


def test_cached_k_step_fit_denoiser_matches_host(cuda, tmp_path,
                                                 monkeypatch):
    """``data_cache: device`` with K = 3 against the host loader with K =
    3, 64^2 fp32 under cudnn.deterministic, 2 epochs of 4 steps (a group
    and the tail single each): every tensor, loss and the generator
    bit-equal, and one graph captured across both epochs."""
    from denoising_diffusion_deep_fake_tpu_torch.config import (
        DenoiserConfig, config_from_dict)
    from denoising_diffusion_deep_fake_tpu_torch.training import multi_step
    from denoising_diffusion_deep_fake_tpu_torch.training.runners import (
        fit_denoiser)

    manifest = _npy_frames(tmp_path / "data", 8, 64, 5)
    captures = []

    class Counted(multi_step._Graph):
        def __init__(self, *args, **kwargs):
            captures.append(1)
            super().__init__(*args, **kwargs)

    monkeypatch.setattr(multi_step, "_Graph", Counted)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    runs = {}
    for cache in ("host", "device"):
        captures.clear()
        cfg = config_from_dict(DenoiserConfig, dict(
            input_image_list_path=str(manifest), batch_size=2,
            encoder_name="resnet18", compute_dtype="float32", image_size=64,
            max_epochs=2, steps_per_call=3, log_images=False,
            data_cache=cache, log_dir=str(tmp_path / cache / "runs"),
            checkpoint_dir=str(tmp_path / cache / "ckpt")))
        losses = []
        state, trainer, ctx = fit_denoiser(
            cfg, verbose=False, decode_fn=np.load,
            step_callback=lambda step, s, m: losses.extend(
                torch.atleast_1d(m["loss"]).tolist()))
        torch.cuda.synchronize()
        assert ctx.global_step == 8 and len(captures) == 1
        runs[cache] = state, trainer, losses
    (got, got_t, got_l), (want, want_t, want_l) = runs["device"], runs["host"]
    assert got_l == want_l
    assert torch.equal(got_t.generator.get_state(),
                       want_t.generator.get_state())
    for a, b in ((got.model.state_dict(), want.model.state_dict()),
                 *zip(got.optimizer.state_dict()["state"].values(),
                      want.optimizer.state_dict()["state"].values())):
        assert all(torch.equal(a[k], b[k]) for k in b)


def test_scoring_from_the_cache_matches_host_scoring(cuda, tmp_path):
    """The balancer's scoring from the dataset on the card against its
    scoring of the host loader's uploads, 5 images in batches of 2 (the
    tail padded): the same losses bit for bit."""
    from denoising_diffusion_deep_fake_tpu_torch.config import (
        BalanceConfig, config_from_dict)
    from denoising_diffusion_deep_fake_tpu_torch.data.device_cache import (
        DeviceDatasetCache)
    from denoising_diffusion_deep_fake_tpu_torch.data.loader import (
        ImageLoader, device_prefetch)
    from denoising_diffusion_deep_fake_tpu_torch.training.balance import (
        BalanceTrainer)

    manifest = _npy_frames(tmp_path / "data", 5, 64, 6)
    cfg = config_from_dict(BalanceConfig, dict(
        data_path=str(manifest), batch_size=2, encoder_name="resnet18",
        compute_dtype="float32", image_size=64))
    trainer = BalanceTrainer(cfg, steps_per_epoch=2, image_size=64)
    state = trainer.init_state(0)
    val = ImageLoader(manifest, 2, shuffle=False, drop_remainder=False,
                      decode_fn=np.load)
    LAUNCHES.clear()
    want_idx, want = trainer.score_dataset(
        state, device_prefetch(val.epoch(0), cuda), epoch=1)
    cache = DeviceDatasetCache(ImageLoader(manifest, 2, decode_fn=np.load),
                               device=cuda)
    got_idx, got = trainer.score_dataset_from_cache(state, cache, epoch=1)
    assert LAUNCHES["fused_normalise_noise_blend"] == 6
    np.testing.assert_array_equal(got_idx, want_idx)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("encoder", ["resnet50", "resnext50_32x4d",
                                     "wide_resnet50_2"])
def test_bottleneck_family_step_gpu_matches_cpu(cuda, encoder):
    """A 64^2 fp32 denoiser step of each Bottleneck geometry on the card
    against the CPU, from the same weights and injected randomness: the
    loss within 1e-4 relative (cuDNN and the CPU sum convolutions in
    other orders), one fused warp launch (the injected noise is blended
    without the noise kernel)."""
    from denoising_diffusion_deep_fake_tpu_torch.config import (
        DenoiserConfig, config_from_dict)
    from denoising_diffusion_deep_fake_tpu_torch.ops.augment import (
        AffineAugmentConfig, sample_affine_params)
    from denoising_diffusion_deep_fake_tpu_torch.training.denoiser import (
        DenoiserTrainer)

    cfg = config_from_dict(DenoiserConfig, dict(
        input_image_list_path="unused", batch_size=2, learning_rate=1e-3,
        encoder_name=encoder, compute_dtype="float32",
        warp_method="pallas_fused"))
    rng = np.random.default_rng(1)
    u8 = torch.from_numpy(rng.integers(0, 256, (2, 64, 64, 3), np.uint8))
    params = sample_affine_params(2, AffineAugmentConfig.random_affine(),
                                  generator=torch.Generator().manual_seed(5))
    ratios = torch.from_numpy(rng.uniform(0, 0.5, 2).astype(np.float32))
    noise = torch.from_numpy(rng.standard_normal((2, 64, 64, 3)).astype(
        np.float32))
    losses = {}
    for device in ("cpu", cuda):
        trainer = DenoiserTrainer(cfg, steps_per_epoch=4, image_size=64,
                                  device=device)
        state = trainer.init_state(seed=7)
        on = torch.device(device)
        LAUNCHES.clear()
        losses[on.type] = float(trainer.train_step(
            state, u8, affine_params={k: v.to(on) for k, v in
                                      params.items()},
            ratios=ratios.to(on), noise=noise.to(on))["loss"])
    assert LAUNCHES["affine_warp_fused"] == 1
    assert abs(losses["cuda"] - losses["cpu"]) <= 1e-4 * abs(losses["cpu"])


def _reference_ckpt(path, data, **hparams):
    """A reference Lightning .ckpt of a resnet18 pair in swap mode, in the
    reference's layout (smp keys with num_batches_tracked, the EMA's
    buffers, criterion.*), from the port's own U-Nets: this file imports
    no JAX."""
    from denoising_diffusion_deep_fake_tpu_torch.models.unet import (
        create_unet, init_unet_)

    sd = {}
    for i, name in enumerate(("model_a", "model_b", "ema_model_a",
                              "ema_model_b")):
        model = init_unet_(create_unet("resnet18"),
                           torch.Generator().manual_seed(i))
        prefix = name + ("." if name.startswith("model") else ".ema_model.")
        for key, value in model.state_dict().items():
            sd[prefix + key] = value
            if key.endswith("running_mean"):
                sd[prefix + key[:-len("running_mean")]
                   + "num_batches_tracked"] = torch.tensor(7)
        if not name.startswith("model"):
            sd[f"{name}.initted"] = torch.tensor(True)
            sd[f"{name}.step"] = torch.tensor(7)
    sd["criterion.ssim.kernel"] = torch.zeros(1, 11)
    torch.save({"state_dict": sd, "epoch": 5, "global_step": 70,
                "hyper_parameters": dict(
                    mode="swap", data_path_a=str(data["a"]),
                    data_path_b=str(data["b"]), batch_size=2,
                    encoder_name="resnet18", max_epochs=20, **hparams)},
               path)
    return sd


@pytest.mark.parametrize("k", [1, 2])
def test_import_resume_export_on_gpu(cuda, tmp_path, k):
    """A reference .ckpt imported, its shadow's swap batch on the card
    equal to the .ckpt's weights loaded straight, then resumed on the
    card for 2 steps (eager, or one K = 2 graph captured on the imported
    fresh Adam), exported and imported again bit-equal to the resumed
    states."""
    from denoising_diffusion_deep_fake_tpu_torch.checkpoint import (
        CheckpointManager)
    from denoising_diffusion_deep_fake_tpu_torch.config import (
        DeepFakeConfig, config_from_dict)
    from denoising_diffusion_deep_fake_tpu_torch.data.manifest import (
        write_image_manifest)
    from denoising_diffusion_deep_fake_tpu_torch.inference import (
        load_swap_model, make_device_pipeline)
    from denoising_diffusion_deep_fake_tpu_torch.models.unet import (
        create_unet)
    from denoising_diffusion_deep_fake_tpu_torch.training.runners import (
        fit_deep_fake)
    from denoising_diffusion_deep_fake_tpu_torch.utils.torch_export import (
        export_reference_checkpoint)
    from denoising_diffusion_deep_fake_tpu_torch.utils.torch_import import (
        import_reference_checkpoint)

    rng = np.random.default_rng(2)
    data = {}
    for n in "ab":
        paths = [tmp_path / n / f"{i}.npy" for i in range(4)]
        paths[0].parent.mkdir()
        for p in paths:
            np.save(p, rng.integers(0, 256, (64, 64, 3), np.uint8))
        data[n] = tmp_path / n / "images.txt"
        write_image_manifest(data[n], paths)
    sd = _reference_ckpt(tmp_path / "ref.ckpt", data)
    imported = import_reference_checkpoint(tmp_path / "ref.ckpt",
                                           tmp_path / "imported").parent

    swap = load_swap_model(imported, "a", use_ema=True)
    frames = torch.randint(0, 256, (2, 64, 64, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(3))
    got = make_device_pipeline(swap)(frames.to(cuda), 0)
    straight = create_unet("resnet18", dtype=swap.model.dtype)
    prefix = "ema_model_a.ema_model."
    straight.load_state_dict({
        key[len(prefix):]: v for key, v in sd.items()
        if key.startswith(prefix) and "num_batches" not in key})
    swap.model = straight.to(cuda).to(
        memory_format=torch.channels_last).eval()
    assert torch.equal(got, make_device_pipeline(swap)(frames.to(cuda), 0))

    meta = CheckpointManager(imported).read_meta()
    cfg = config_from_dict(DeepFakeConfig, dict(
        meta["hparams"], compute_dtype="float32", image_size=64,
        steps_per_call=k, log_images=False, log_dir=str(tmp_path / "runs"),
        checkpoint_dir=str(tmp_path / "ckpt")))
    LAUNCHES.clear()
    states, _, ctx = fit_deep_fake(cfg, resume_from=str(imported),
                                   max_steps=72, verbose=False,
                                   decode_fn=np.load)
    torch.cuda.synchronize()
    assert ctx.global_step == 72 and ctx.epoch == 6
    assert LAUNCHES["warp_axis_pass"] == 0
    assert LAUNCHES["fused_noise_blend"] == 4
    for state in states.values():
        assert state.step == state.ema_step == 2
        assert all(g["fused"] for g in state.optimizer.param_groups)
        assert {float(s["step"]) for s in
                state.optimizer.state_dict()["state"].values()} == {2.0}
    export_reference_checkpoint(tmp_path / "ckpt", tmp_path / "out.ckpt")
    again = CheckpointManager(import_reference_checkpoint(
        tmp_path / "out.ckpt", tmp_path / "again").parent)
    for name, state in states.items():
        parts = again.restore_partial(name, ["model", "ema_model"])
        for part, module in (("model", state.model),
                             ("ema_model", state.ema_model)):
            want = module.state_dict()
            assert parts[part].keys() == want.keys()
            for key in want:
                assert torch.equal(parts[part][key].cpu(), want[key].cpu())


# ----------------------------------------------------------- nvJPEG codec

CODEC_FIXTURES = Path(__file__).resolve().parent / "data" / "codec"
# nvJPEG against cv2's decode of the committed fixtures, max and mean LSB:
# the figures chip_smoke.py phase 15b measured on the H100 plus a margin
# (its NVJPEG_BOUNDS).
NVJPEG_FIXTURE_BOUNDS = {"baseline_420.jpg": (32, 5.70), "gray.jpg": (5, 0.66),
                         "nonsquare_40x24.jpg": (28, 6.39),
                         "progressive.jpg": (32, 5.70),
                         "yuv444.jpg": (5, 0.76)}


@pytest.mark.parametrize("name", sorted(NVJPEG_FIXTURE_BOUNDS))
def test_nvjpeg_decodes_the_fixtures(cuda, name):
    from denoising_diffusion_deep_fake_tpu_torch.data import nvjpeg

    path = CODEC_FIXTURES / name
    want = np.load(path.with_suffix(".npy"))
    frames = nvjpeg.codec().decode_batch([path.read_bytes()] * 2)
    assert frames.device.type == "cuda" and frames.dtype == torch.uint8
    got = frames.cpu().numpy()
    assert got.shape == (2,) + want.shape
    np.testing.assert_array_equal(got[0], got[1])
    diff = np.abs(got[0].astype(np.int16) - want)
    top, mean = NVJPEG_FIXTURE_BOUNDS[name]
    assert diff.max() <= top and diff.mean() <= mean, (diff.max(),
                                                       diff.mean())


def test_nvjpeg_mixed_sizes_and_round_trip(cuda):
    from denoising_diffusion_deep_fake_tpu_torch.data import nvjpeg

    blobs = [(CODEC_FIXTURES / n).read_bytes()
             for n in ("nonsquare_40x24.jpg", "baseline_420.jpg")]
    frames = nvjpeg.codec().decode_batch(blobs)
    assert [tuple(f.shape) for f in frames] == [(24, 40, 3), (48, 48, 3)]
    host = nvjpeg.decode_to_host(blobs)
    for f, h in zip(frames, host):
        np.testing.assert_array_equal(f.cpu().numpy(), h)
    source = np.load(CODEC_FIXTURES / "source.npy")
    blob = nvjpeg.codec().encode(source, 95)
    assert blob[:3] == b"\xff\xd8\xff"
    assert blob == nvjpeg.codec().encode(torch.from_numpy(source).to(cuda),
                                         95)
    back = nvjpeg.decode_to_host([blob])[0]
    # nvJPEG's q95 round trip of this 48^2 source: mean 5.91 LSB (PSNR
    # 30.22 dB) on NVIDIA H100 80GB HBM3, 700.00 W, its 4:2:0 chroma
    # upsampling (ROADMAP C); cv2's round trip is 38.78 dB.
    assert np.abs(back.astype(np.int16) - source).mean() < 6.5
    with pytest.raises(RuntimeError, match="nvJPEG"):
        nvjpeg.codec().decode_batch([b"\xff\xd8\xff" + b"\x00" * 64])


def test_loader_decodes_jpeg_with_nvjpeg_without_cv2(cuda, tmp_path,
                                                     monkeypatch):
    import sys

    from denoising_diffusion_deep_fake_tpu_torch.data import loader, nvjpeg
    from denoising_diffusion_deep_fake_tpu_torch.ops.image import (
        resize_cubic)

    monkeypatch.setitem(sys.modules, "cv2", None)
    names = ["baseline_420.jpg", "nonsquare_40x24.jpg", "rgb_filters.png",
             "progressive.jpg"]
    (tmp_path / "images.txt").write_text(
        "".join(f"{CODEC_FIXTURES / n}\n" for n in names))
    ld = loader.ImageLoader(tmp_path / "images.txt", 4, image_size=48,
                            shuffle=False)
    assert ld.decoder == "nvjpeg"
    (batch, idx), = list(ld.epoch(0))
    blobs = [(CODEC_FIXTURES / n).read_bytes() for n in names]
    want = [nvjpeg.decode_to_host([blobs[0]])[0],
            resize_cubic(nvjpeg.decode_to_host([blobs[1]])[0], (48, 48)),
            np.load(CODEC_FIXTURES / "rgb_filters.npy"),
            nvjpeg.decode_to_host([blobs[3]])[0]]
    np.testing.assert_array_equal(batch, np.stack(want))
    np.testing.assert_array_equal(idx, np.arange(4))
