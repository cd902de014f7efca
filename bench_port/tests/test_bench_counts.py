"""FLOP and byte counts against values worked out by hand."""

from bench_port import flops


def _conv(cout, cin, k, side):
    return 2 * cout * cin * k * k * side * side


def test_resnet34_unet_forward_flops_at_448():
    enc = _conv(64, 3, 7, 224)                                  # stem
    enc += 6 * _conv(64, 64, 3, 112)                            # layer1
    enc += (_conv(128, 64, 3, 56) + _conv(128, 64, 1, 56)       # layer2
            + 7 * _conv(128, 128, 3, 56))
    enc += (_conv(256, 128, 3, 28) + _conv(256, 128, 1, 28)     # layer3
            + 11 * _conv(256, 256, 3, 28))
    enc += (_conv(512, 256, 3, 14) + _conv(512, 256, 1, 14)     # layer4
            + 5 * _conv(512, 512, 3, 14))
    dec = (_conv(256, 512 + 256, 3, 28) + _conv(256, 256, 3, 28)
           + _conv(128, 256 + 128, 3, 56) + _conv(128, 128, 3, 56)
           + _conv(64, 128 + 64, 3, 112) + _conv(64, 64, 3, 112)
           + _conv(32, 64 + 64, 3, 224) + _conv(32, 32, 3, 224)
           + _conv(16, 32, 3, 448) + _conv(16, 16, 3, 448))
    head = _conv(3, 16, 3, 448)
    assert enc + dec + head == 47_976_284_160
    assert flops.unet_forward_flops("resnet34", 448) == enc + dec + head


def test_resnext50_grouped_convolutions_count_their_groups():
    # Each grouped 3x3 of width w in 32 groups does w * (w / 32) * 9 MACs
    # a pixel; the whole forward is 66.37 GFLOP at 448^2.
    assert flops.unet_forward_flops("resnext50_32x4d", 448) == 66_370_404_352


def test_kernel_bytes_at_448_batch_16():
    n = 16 * 448 * 448 * 3
    assert flops.warp_fused_bytes(16, 448) == n * 5 == 48_168_960
    assert flops.noise_f32_bytes(16, 448) == n * 8 == 77_070_336
