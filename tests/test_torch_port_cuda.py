"""The port's CUDA kernels against their plain versions, on the GPU.

Every test here needs an NVIDIA GPU and skips without one. This file imports
no JAX, so it also runs on a GPU machine that has none:

    python -m pytest --noconftest -q tests/test_torch_port_cuda.py

The warp kernels and their plain versions are held to bit equality: both
round where the TPU kernels do (see ops/cuda/csrc/warp.cu). The noise
kernels' Philox words are held to bit equality with the plain version's;
their outputs to one ulp of it (CUDA's logf, sinf and cosf in the kernel
against PyTorch's CUDA log, sin and cos in the plain version), with the
normalisation (ratio 0) exact.
"""

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
