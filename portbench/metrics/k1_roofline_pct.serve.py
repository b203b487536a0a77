"""K1's share of its roofline in the traced serving window: the least
time the card could take for each launch (the larger of its bytes over
HBM bandwidth and its FFT operations over the FP64 tensor-core peak,
`roofline.k1_bound_s`, from the request's shape) summed over the
window's frontend calls, over the device time of the window's
`stft_f64_kernel` launches. Each request of the mix is one launch (none
is longer than the frontend's chunk); where the counts differ the share
is not read."""

from portbench import roofline, trace


def read(data):
    summary = (data.get("slice") or {}).get("summary")
    calls = data.get("frontend_calls") or []
    if not summary or not calls:
        return None
    n, seconds = trace.kernel_seconds(summary, roofline.K1_KERNEL)
    if n != len(calls) or seconds <= 0:
        return None
    s = data["stft"]
    bound = sum(roofline.k1_bound_s(1 if len(shape) == 1 else shape[0],
                                    shape[-1], s["nperseg"], s["hop"])
                for shape, _ in calls)
    return 100.0 * bound / seconds
