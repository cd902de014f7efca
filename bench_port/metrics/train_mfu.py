"""Model FLOPs of the images trained in the traced window (three U-Net
forwards an image, counted on the benchmark's reference model) over the
window, as a share of one H100's dense bf16 peak."""

from bench_port.flops import H100_BF16_FLOPS


def read(ctx):
    t = ctx.get("trace")
    if not t or t["window_s"] <= 0:
        return None
    flops = ctx["images"] * ctx["train_flops_per_image"]
    return 100.0 * flops / t["window_s"] / H100_BF16_FLOPS
