"""CUDA kernels launched in the traced slice (one whole training call of
one epoch after the window, its validation pass and snapshot included),
over the training samples it stepped."""


def read(data):
    sl = data.get("slice") or {}
    if not sl.get("summary") or not sl.get("samples"):
        return None
    return sl["summary"]["kernel_count"] / sl["samples"]
