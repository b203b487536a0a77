"""The whole training window's share of the card's float32 peak: the
useful operations of every sample stepped, every validation forward and
every DEC refresh forward (`roofline.train_flops`, `forward_flops`), over
the window's seconds times 67 TFLOP/s. The convolutions run outside the
tensor cores (TF32 off), so that peak is the ceiling."""

from portbench import roofline


def read(data):
    if not data.get("window_s") or "flops" not in data:
        return None
    return 100.0 * data["flops"] / (data["window_s"] * roofline.FP32_PEAK)
