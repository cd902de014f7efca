"""The fp32 noise blend's least time (fp32 in and out, each byte once, at
3.35 TB/s) over its device time a launch, in percent."""

from bench_port.flops import H100_HBM_BYTES_PER_S

KERNEL = "noise_blend_f32_kernel"


def read(ctx):
    t = ctx.get("trace")
    if not t:
        return None
    rows = [v for k, v in t["ops"].items() if KERNEL in k]
    seconds, launches = sum(r[0] for r in rows), sum(r[1] for r in rows)
    if not launches or seconds <= 0:
        return None
    return 100.0 * ctx["noise_f32_bytes"] / H100_HBM_BYTES_PER_S / (
        seconds / launches)
