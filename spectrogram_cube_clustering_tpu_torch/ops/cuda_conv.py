"""The AEC/DEC encoder's three Conv2d -> ReLU pairs in one hand-written CUDA
launch (`csrc/conv_enc.cu`), for `models.aec.Encoder`.

The kernel replaces no TPU kernel (the JAX package leaves these layers to
XLA); on the card it takes the place of cuDNN's three 8-channel
convolutions, their layout conversions and the three ReLU launches after
them. `csrc/conv_enc.cu` gives its bound and design.

`conv_relu_chain` is the entry point: x (B, 1, H, W) through the three
layers, relu(F.conv2d(...)) each, with kernel (2, 4), stride (1, 2),
padding (1, 1) and 1 -> 8 -> 8 -> 8 channels. Its forward runs the kernel
(`conv_relu_chain_cuda`) on a CUDA tensor and the plain version
(`conv_relu_chain_plain`: `F.conv2d`, then `torch.relu`, three times) on a
CPU tensor, and only there. Where autograd records, one
`torch.autograd.Function` node for the chain has the kernel write the
three outputs, saves the tensors autograd keeps for the modules (x, the
weights, each ReLU's output) and makes the backward calls autograd makes
for them (`threshold_backward`, then `convolution_backward`), so gradients
come from the same kernels as before; elsewhere the kernel writes the last
output alone. The kernel sums in cuDNN's order, and its outputs are
channels-last, as cuDNN's were, so the steps after it run the kernels they
ran before on the same values (PERF.md, E1).
Under autocast x, the weights and the biases are cast as autocast casts
`conv2d`. `LAUNCHES` counts kernel launches.
"""

from __future__ import annotations

import functools
import threading

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from spectrogram_cube_clustering_tpu_torch.ops import _build
from spectrogram_cube_clustering_tpu_torch.ops.cuda_convt import (
    _autocast,
    _pair,
)

#: kernel launches in this process
LAUNCHES = 0
_lock = threading.Lock()  # guards LAUNCHES (server threads)

#: the layers the kernel computes: channels in and out, kernel, stride and
#: padding of each
LAYERS = ((1, 8), (8, 8), (8, 8))
KERNEL, STRIDE, PADDING = (2, 4), (1, 2), (1, 1)
#: the widest x the kernel takes (its strips fill an SM's shared memory)
MAX_WIDTH = 512
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def check_geometry(x_shape, layer_shapes):
    """Raise ValueError unless the kernel takes x of `x_shape` through
    layers of `layer_shapes`, (weight shape, bias shape or None, stride,
    padding) each; returns the three outputs' (H, W)."""
    return [s[2:] for s in _plan(tuple(x_shape), tuple(
        (tuple(w), None if b is None else tuple(b), _pair(s), _pair(p))
        for w, b, s, p in layer_shapes))]


@functools.lru_cache(maxsize=256)
def _plan(x_shape, layer_shapes):
    """check_geometry's checks, then the outputs' shapes; cached, so a
    forward's later calls skip them."""
    if len(x_shape) != 4 or x_shape[1] != 1:
        raise ValueError(
            f"the encoder's convolution kernel takes NCHW x with one "
            f"channel, got {x_shape}")
    if len(layer_shapes) != len(LAYERS):
        raise ValueError(
            f"the encoder's convolution kernel computes {len(LAYERS)} "
            f"layers, got {len(layer_shapes)}")
    for (cin, cout), (w, b, stride, padding) in zip(LAYERS, layer_shapes):
        if w != (cout, cin, *KERNEL) or stride != STRIDE or (
                padding != PADDING):
            raise ValueError(
                f"the encoder's convolution kernel is built for weights "
                f"{(cout, cin, *KERNEL)}, stride {STRIDE} and padding "
                f"{PADDING}, not {w}, {stride} and {padding}")
        if b is not None and b != (cout,):
            raise ValueError(f"bias {b} for {cout} output channels")
    b, _, h, w = x_shape
    if not 8 <= w <= MAX_WIDTH or h < 1:
        raise ValueError(
            f"the encoder's convolution kernel takes 1 <= H and 8 <= W <= "
            f"{MAX_WIDTH}, got {(h, w)}")
    shapes = []
    for _, cout in LAYERS:
        h, w = h + 1, (w - 2) // 2 + 1
        shapes.append((b, cout, h, w))
    return tuple(shapes)


def _layer_shapes(layers):
    return tuple((tuple(w.shape), None if b is None else tuple(b.shape),
                  _pair(s), _pair(p)) for w, b, s, p in layers)


def conv_relu_chain_cuda(x, layers, save=False):
    """Launch the kernel: contiguous CUDA x (B, 1, H, W) through `layers`,
    (weight, bias or None, stride, padding) each, all float32 or all
    bfloat16; returns (a1, a2, a3) with `save`, else (a3,), each
    (B, 8, H_k, W_k) channels-last."""
    global LAUNCHES
    shapes = _plan(tuple(x.shape), _layer_shapes(layers))
    device, dtype = x.device, x.dtype
    tensors = [t for w, b, *_ in layers for t in (w, b) if t is not None]
    if device.type != "cuda" or any(t.device != device for t in tensors):
        raise ValueError(
            f"the encoder's convolution kernel needs every tensor on one "
            f"CUDA device, got x on {device}, the parameters on "
            f"{sorted({str(t.device) for t in tensors})}")
    if dtype not in _DTYPES or any(t.dtype != dtype for t in tensors):
        raise TypeError(
            f"the encoder's convolution kernel takes float32 or bfloat16 "
            f"throughout, got x {dtype}, the parameters "
            f"{sorted({str(t.dtype) for t in tensors})}")
    if not (x.is_contiguous() and all(t.is_contiguous() for t in tensors)):
        raise ValueError(
            f"the encoder's convolution kernel takes contiguous tensors, got "
            f"strides x {x.stride()}, weights "
            f"{[tuple(w.stride()) for w, *_ in layers]}")
    outs = [torch.empty(s, dtype=dtype, device=device,
                        memory_format=torch.channels_last)
            if save or i == len(shapes) - 1 else None
            for i, s in enumerate(shapes)]
    if x.shape[0] == 0:
        return tuple(outs) if save else (outs[-1],)
    lib = _build.load_library()
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    args = (ptr(x), *(ptr(t) for w, b, *_ in layers for t in (w, b)),
            *(ptr(t) for t in outs), x.shape[0], x.shape[2], x.shape[3],
            _DTYPES[dtype], int(save),
            torch._C._cuda_getCurrentRawStream(device.index))
    if device.index == torch.cuda.current_device():
        err = lib.scc_conv_relu3_launch(*args)
    else:
        with torch.cuda.device(device):
            err = lib.scc_conv_relu3_launch(*args)
    if err:
        raise RuntimeError(
            f"encoder convolution launch failed: "
            f"{lib.scc_cuda_error_string(err).decode()} (x {tuple(x.shape)}, "
            f"{dtype})")
    with _lock:
        LAUNCHES += 1
    return tuple(outs) if save else (outs[-1],)


def conv_relu_chain_plain(x, layers, save=False):
    """The plain version: `F.conv2d`, then `torch.relu`, for each layer;
    returns (a1, a2, a3) with `save`, else (a3,), each input freed once
    the next output exists."""
    outs = []
    for w, b, stride, padding in layers:
        x = torch.relu(F.conv2d(x, w, b, stride, padding))
        if save:
            outs.append(x)
    return tuple(outs) if save else (x,)


def _forward(x, layers, save):
    """The kernel on a CUDA tensor, the plain version on a CPU tensor."""
    if x.device.type == "cuda":
        return conv_relu_chain_cuda(x.contiguous(), layers, save)
    if x.device.type == "cpu":
        return conv_relu_chain_plain(x, layers, save)
    raise ValueError(f"no encoder convolution for {x.device}")


class _ConvReLUChain(torch.autograd.Function):
    """Forward: the three relu(conv2d(...)) layers, the kernel on a CUDA
    tensor, the plain version on a CPU tensor, keeping each output.
    Backward: for each layer from the last, `threshold_backward` against
    its output, then `convolution_backward`: the calls autograd makes for
    the Conv2d and ReLU modules, so the gradients are theirs bit for bit.
    The node saves what the modules' nodes saved, x, the weights and each
    layer's output, and each inner ReLU's threshold runs in place on the
    gradient `convolution_backward` returned, where the modules' ReLU node
    allocated a new one. No gradient is formed for x unless it needs
    one."""

    @staticmethod
    def forward(ctx, x, geometry, *params):
        n = len(geometry)
        weights, biases = params[:n], params[n:]
        outs = _forward(x, [(w, b, *g) for w, b, g in
                            zip(weights, biases, geometry)], True)
        ctx.save_for_backward(x, *weights, *outs)
        ctx.geometry = geometry
        ctx.bias_sizes = [None if b is None else [b.shape[0]]
                          for b in biases]
        return outs[-1]

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        n = len(ctx.geometry)
        x, *saved = ctx.saved_tensors
        weights, outs = saved[:n], saved[n:]
        needs = ctx.needs_input_grad
        grads_w, grads_b = [None] * n, [None] * n
        g = torch.ops.aten.threshold_backward(grad, outs[-1], 0)
        for i in reversed(range(n)):
            xi = outs[i - 1] if i else x
            stride, padding = ctx.geometry[i]
            g, grads_w[i], grads_b[i] = torch.ops.aten.convolution_backward(
                g, xi, weights[i], ctx.bias_sizes[i], stride, padding,
                [1, 1], False, [0, 0], 1,
                [i > 0 or needs[0], needs[2 + i],
                 ctx.bias_sizes[i] is not None and needs[2 + n + i]])
            if i:  # the ReLU before, in place on the gradient just made
                torch.ops.aten.threshold_backward.grad_input(
                    g, xi, 0, grad_input=g)
        return (g, None, *grads_w, *grads_b)


def conv_relu_chain(x, layers):
    """x (B, 1, H, W) through each of `layers`, (weight, bias or None,
    stride, padding) tuples, as relu(F.conv2d(...)) with dilation 1 and
    one group, differentiable; returns the last output. Under autocast x,
    the weights and the biases are cast as autocast casts `conv2d`. Where
    autograd records nothing (no grad mode, or nothing requires a
    gradient), it calls the forward without the node, which keeps only
    the last output."""
    layers = [(w, b, _pair(s), _pair(p)) for w, b, s, p in layers]
    device = x.device.type
    if device in ("cpu", "cuda") and torch.is_autocast_enabled(device):
        dtype = torch.get_autocast_dtype(device)
        with torch.autocast(device, enabled=False):
            return conv_relu_chain(
                _autocast(x, dtype),
                [(_autocast(w, dtype), _autocast(b, dtype), *g)
                 for w, b, *g in layers])
    if not torch.is_grad_enabled() or not (x.requires_grad or any(
            w.requires_grad or (b is not None and b.requires_grad)
            for w, b, *_ in layers)):
        return _forward(x, layers, False)[-1]
    return _ConvReLUChain.apply(
        x, tuple(tuple(g) for _, _, *g in layers),
        *(w for w, *_ in layers), *(b for _, b, *_ in layers))
