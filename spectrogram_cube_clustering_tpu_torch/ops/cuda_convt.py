"""Transposed convolution, bias and ReLU in one hand-written CUDA kernel
(`csrc/convt.cu`): the forward pass of the AEC/DEC decoder's
`ConvTranspose2d` -> `ReLU` pairs (`models.aec.Decoder`).

The kernel replaces no TPU kernel (the JAX package leaves these layers to
XLA); on the card it takes the place of cuDNN's transposed convolution,
which ran it as a dgrad implicit GEMM over nearly empty 8-channel tiles, and
of the ReLU launch after it. It is bound by bytes; `csrc/convt.cu` gives the
bound and the design.

`conv_transpose_relu_chain` is the entry point: x through a chain of
such layers, as the decoder runs its four (`conv_transpose_relu` is a
chain of one). Its forward runs the kernel on a CUDA tensor and the plain
version (`convt_relu_plain`: `F.conv_transpose2d`, then `torch.relu`) on a
CPU tensor, and only there. One `torch.autograd.Function` node for the
chain saves the tensors autograd keeps for the modules (x, the weights,
each ReLU's output) and makes the backward calls autograd makes for them
(`threshold_backward`, then `convolution_backward` with
`transposed=True`), so gradients come from the same kernels as before;
it frees each output as the modules' nodes did, and costs the host less
than their eight nodes.
Under autocast x, the weights and the biases are cast as autocast casts
`conv_transpose2d`. `LAUNCHES` counts kernel launches.
"""

from __future__ import annotations

import functools
import threading

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from spectrogram_cube_clustering_tpu_torch.ops import _build

#: kernel launches in this process
LAUNCHES = 0
_lock = threading.Lock()  # guards LAUNCHES (server threads)

#: (C_in, C_out, kernel, stride) of the kernel's instances: the decoder's
#: first layer and its three (2, 4) / (1, 2) layers
GEOMETRIES = frozenset({
    (1, 8, (3, 3), (1, 1)),
    (8, 8, (2, 4), (1, 2)),
    (8, 1, (2, 4), (1, 2)),
})
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _pair(v) -> tuple:
    return (v, v) if isinstance(v, int) else tuple(v)


def check_geometry(x_shape, w_shape, stride, padding, output_padding,
                   b_shape=None):
    """Raise ValueError unless the kernel takes this layer; returns
    (H_out, W_out)."""
    return _plan(tuple(x_shape), tuple(w_shape),
                 None if b_shape is None else tuple(b_shape), _pair(stride),
                 _pair(padding), _pair(output_padding))[0][2:]


@functools.lru_cache(maxsize=256)
def _plan(x_shape, w_shape, b_shape, stride, padding, output_padding):
    """check_geometry's checks, then the output's shape and the launch's
    integer arguments; cached, so a layer's later calls skip them."""
    if len(x_shape) != 4 or len(w_shape) != 4:
        raise ValueError(
            f"the transposed-convolution kernel takes NCHW x and a (C_in, "
            f"C_out, kh, kw) weight, got {x_shape} and {w_shape}")
    cin, cout, kh, kw = w_shape
    key = (cin, cout, (kh, kw), stride)
    if key not in GEOMETRIES:
        raise ValueError(
            f"the transposed-convolution kernel is built for (C_in, C_out, "
            f"kernel, stride) in {sorted(GEOMETRIES)}, not {key}")
    if x_shape[1] != cin:
        raise ValueError(f"x has {x_shape[1]} channels, the weight {cin}")
    if b_shape is not None and b_shape != (cout,):
        raise ValueError(f"bias {b_shape} for {cout} output channels")
    if any(p < 0 for p in padding) or not all(
            0 <= op < s for op, s in zip(output_padding, stride)):
        raise ValueError(
            f"padding {padding} and output padding {output_padding} must be "
            f">= 0, the output padding below the stride {stride}")
    b, _, h, w = x_shape
    h_out, w_out = (
        (n - 1) * s - 2 * p + k + op for n, k, s, p, op in zip(
            (h, w), (kh, kw), stride, padding, output_padding))
    if min(h_out, w_out, h, w) < 1:
        raise ValueError(f"no output for input {x_shape}: {(h_out, w_out)}")
    return ((b, cout, h_out, w_out),
            (b, cin, h, w, cout, h_out, w_out, kh, kw, *stride, *padding))


def convt_relu_cuda(x, weight, bias, stride, padding, output_padding):
    """Launch the kernel: contiguous CUDA x (B, C_in, H, W), weight
    (C_in, C_out, kh, kw) and bias (C_out) or None, all float32 or all
    bfloat16; returns relu(conv_transpose2d(...)) (B, C_out, H_out, W_out).
    The checks are a few attribute reads and one cache lookup, since the
    decoder makes four such calls a forward on a host that may set the
    step's pace."""
    global LAUNCHES
    out_shape, ints = _plan(
        tuple(x.shape), tuple(weight.shape),
        None if bias is None else tuple(bias.shape), _pair(stride),
        _pair(padding), _pair(output_padding))
    device, dtype = x.device, x.dtype
    if device.type != "cuda" or weight.device != device or (
            bias is not None and bias.device != device):
        raise ValueError(
            f"the transposed-convolution kernel needs every tensor on one "
            f"CUDA device, got x on {device}, the weight on {weight.device}"
            f"{'' if bias is None else f', the bias on {bias.device}'}")
    if dtype not in _DTYPES or weight.dtype != dtype or (
            bias is not None and bias.dtype != dtype):
        raise TypeError(
            f"the transposed-convolution kernel takes float32 or bfloat16 "
            f"throughout, got x {dtype}, the weight {weight.dtype}"
            f"{'' if bias is None else f', the bias {bias.dtype}'}")
    if not (x.is_contiguous() and weight.is_contiguous()
            and (bias is None or bias.is_contiguous())):
        raise ValueError(
            f"the transposed-convolution kernel takes contiguous tensors, "
            f"got strides x {x.stride()}, weight {weight.stride()}")
    y = torch.empty(out_shape, dtype=dtype, device=device)
    if out_shape[0] == 0:
        return y
    lib = _build.load_library()
    args = (x.data_ptr(), weight.data_ptr(),
            None if bias is None else bias.data_ptr(), y.data_ptr(), *ints,
            _DTYPES[dtype], torch._C._cuda_getCurrentRawStream(device.index))
    if device.index == torch.cuda.current_device():
        err = lib.scc_convt_relu_launch(*args)
    else:
        with torch.cuda.device(device):
            err = lib.scc_convt_relu_launch(*args)
    if err:
        raise RuntimeError(
            f"transposed-convolution launch failed: "
            f"{lib.scc_cuda_error_string(err).decode()} (x {tuple(x.shape)}, "
            f"weight {tuple(weight.shape)}, stride {stride}, padding "
            f"{padding}, output padding {output_padding})")
    with _lock:
        LAUNCHES += 1
    return y


def convt_relu_plain(x, weight, bias, stride, padding, output_padding):
    """The plain version: `F.conv_transpose2d`, then `torch.relu`."""
    return torch.relu(F.conv_transpose2d(x, weight, bias, stride, padding,
                                         output_padding))


def _forward(x, weight, bias, stride, padding, output_padding):
    """The kernel on a CUDA tensor, the plain version on a CPU tensor."""
    if x.device.type == "cuda":
        return convt_relu_cuda(x, weight, bias, stride, padding,
                               output_padding)
    if x.device.type == "cpu":
        return convt_relu_plain(x, weight, bias, stride, padding,
                                output_padding)
    raise ValueError(f"no transposed convolution for {x.device}")


class _ConvTransposeReLUChain(torch.autograd.Function):
    """Forward: the layers' relu(conv_transpose2d(...)) in turn, the kernel
    on a CUDA tensor, the plain version on a CPU tensor. Backward: for each
    layer from the last, `threshold_backward` against its output, then
    `convolution_backward` with `transposed=True`: the calls autograd makes
    for the ConvTranspose2d and ReLU modules, so the gradients are theirs
    bit for bit.

    One node for the whole chain, not two a layer: a Python node costs the
    host more than a native one, and the host paces the decoder's steps.
    The node saves what the modules' nodes saved, x, the weights and each
    layer's output, and holds them until its backward ends; in return each
    inner ReLU's threshold runs in place on the gradient
    `convolution_backward` returned, where the modules' ReLU node
    allocated a new one, so no backward step holds more than theirs."""

    @staticmethod
    def forward(ctx, x, geometry, *params):
        n = len(geometry)
        weights, biases = params[:n], params[n:]
        layers = [(w, b, *g) for w, b, g in zip(weights, biases, geometry)]
        outs = []
        for layer in layers:
            outs.append(_forward(outs[-1] if outs else x, *layer))
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
            stride, padding, output_padding = ctx.geometry[i]
            g, grads_w[i], grads_b[i] = torch.ops.aten.convolution_backward(
                g, xi, weights[i], ctx.bias_sizes[i], stride, padding,
                [1, 1], True, output_padding, 1,
                [i > 0 or needs[0], needs[2 + i],
                 ctx.bias_sizes[i] is not None and needs[2 + n + i]])
            if i:  # the ReLU before, in place on the gradient just made
                torch.ops.aten.threshold_backward.grad_input(
                    g, xi, 0, grad_input=g)
        return (g, None, *grads_w, *grads_b)


def _autocast(t, dtype):
    """`t` as autocast casts an argument: floating point, not float64."""
    if t is None or not t.is_floating_point() or t.dtype == torch.float64:
        return t
    return t.to(dtype)


def conv_transpose_relu_chain(x, layers):
    """x through each of `layers`, (weight, bias or None, stride, padding,
    output_padding) tuples, as relu(F.conv_transpose2d(...)) with dilation
    1 and one group, differentiable. Under autocast x, the weights and the
    biases are cast as autocast casts `conv_transpose2d`. Where autograd
    records nothing (no grad mode, or nothing requires a gradient), it
    calls the forward without the node."""
    layers = [(w, b, _pair(s), _pair(p), _pair(op))
              for w, b, s, p, op in layers]
    device = x.device.type
    if device in ("cpu", "cuda") and torch.is_autocast_enabled(device):
        dtype = torch.get_autocast_dtype(device)
        with torch.autocast(device, enabled=False):
            return conv_transpose_relu_chain(
                _autocast(x, dtype),
                [(_autocast(w, dtype), _autocast(b, dtype), *g)
                 for w, b, *g in layers])
    if not torch.is_grad_enabled() or not (x.requires_grad or any(
            w.requires_grad or (b is not None and b.requires_grad)
            for w, b, *_ in layers)):
        for layer in layers:  # each input freed once the next is made
            x = _forward(x, *layer)
        return x
    return _ConvTransposeReLUChain.apply(
        x, tuple(tuple(g) for _, _, *g in layers),
        *(w for w, *_ in layers), *(b for _, b, *_ in layers))


def conv_transpose_relu(x, weight, bias=None, stride=1, padding=0,
                        output_padding=0):
    """relu(F.conv_transpose2d(x, weight, bias, stride, padding,
    output_padding)): `conv_transpose_relu_chain` of one layer."""
    return conv_transpose_relu_chain(
        x, [(weight, bias, stride, padding, output_padding)])
