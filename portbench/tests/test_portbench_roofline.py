"""The operation and byte counts against counts made by hand."""

import math

import pytest

from portbench import roofline


def test_k1_bytes_at_the_serving_block():
    # 16 x 2^20 float32 samples in, 16 x 10,484 x 101 float32 bins out
    assert roofline.stft_frames(1 << 20) == 10_484
    assert roofline.k1_bytes(16, 1 << 20) == 134_877_440


def test_k1_flops_and_bound():
    per_frame = 200 + 2.5 * 200 * math.log2(200) + 4 * 101
    assert roofline.k1_flops(16, 1 << 20) == pytest.approx(
        16 * 10_484 * per_frame)
    # bytes bound: 134,877,440 B at 3.35 TB/s = 0.0403 ms
    assert roofline.k1_bound_s(16, 1 << 20) == pytest.approx(
        134_877_440 / 3.35e12)


# multiply-adds a window, by hand: conv1 8x5x50 outputs x 8 taps, conv2
# 8x6x25 x 64, conv3 8x7x12 x 64, attention 1x7x12 x 18, linear 84 x 9;
# the decoder mirrors them, its first transposed convolution 84 x 8 x 9
DAS_ENC = 16_000 + 76_800 + 43_008 + 1_512 + 756
DAS_DEC = 756 + 6_048 + 43_008 + 76_800 + 16_000
# (87, 100): conv outputs (88, 50), (89, 25), (90, 12)
RIS_ENC = (8 * 88 * 50 * 8 + 8 * 89 * 25 * 64 + 8 * 90 * 12 * 64
           + 90 * 12 * 18 + 1080 * 9)
RIS_DEC = (1080 * 9 + 1080 * 8 * 9 + 8 * 90 * 12 * 64 + 8 * 89 * 25 * 64
           + 8 * 88 * 50 * 8)


@pytest.mark.parametrize("hw,enc,dec,conv1", [
    ((4, 101), DAS_ENC, DAS_DEC, 16_000),
    ((87, 100), RIS_ENC, RIS_DEC, 8 * 88 * 50 * 8),
])
def test_model_flops(hw, enc, dec, conv1):
    assert roofline.encoder_flops(hw) == 2 * enc
    assert roofline.forward_flops(hw) == 2 * (enc + dec)
    assert roofline.forward_flops(hw, 5) == 2 * (enc + dec) + 3 * 5 * 9
    assert roofline.train_flops(hw) == 3 * 2 * (enc + dec) - 2 * conv1


def test_train_flops_per_sample_magnitudes():
    assert 1.6e6 < roofline.train_flops((4, 101)) < 1.8e6
    assert 2.3e7 < roofline.train_flops((87, 100)) < 2.5e7
