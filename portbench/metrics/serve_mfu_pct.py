"""The serving window's share of the card's peak: the useful operations
of every request answered (K1's FFT count and the encoder with the
Student-t over its windows, `drivers/serve.py` `request_flops`), over the
window's seconds times 67 TFLOP/s (float64 tensor cores and float32
outside them alike)."""

from portbench import roofline


def read(data):
    if not data.get("window_s") or "flops" not in data:
        return None
    return 100.0 * data["flops"] / (data["window_s"] * roofline.FP32_PEAK)
