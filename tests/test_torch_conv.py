"""The encoder's three Conv2d -> ReLU pairs through `ops.cuda_conv`.

On the CPU the chain runs its plain version (`F.conv2d`, then
`torch.relu`, three times) and its autograd node makes autograd's own
backward calls, so everything there is held bit for bit to the
`nn.Conv2d` -> `nn.ReLU` modules the encoder ran before: the forward, the
gradients, the same under bfloat16 autocast, and whole AEC and DEC
training steps; and the wrapper's refusals. The tests marked `cuda` run
the kernel on a card and skip without one; the file imports neither jax
nor the JAX package, so on a machine with a card and without jax

    python -m pytest --noconftest -q -m cuda tests/test_torch_conv.py
"""

import io
from collections import Counter

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from spectrogram_cube_clustering_tpu_torch import models, serve, train
from spectrogram_cube_clustering_tpu_torch.models.aec import (
    encoder_conv_shapes,
)
from spectrogram_cube_clustering_tpu_torch.ops import _build, cuda_conv
from spectrogram_cube_clustering_tpu_torch.ops.cuda_conv import (
    conv_relu_chain,
    conv_relu_chain_plain,
)

GEOMETRIES = [(4, 101), (87, 100)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _aec(hw, seed=0):
    return models.AEC(input_hw=hw,
                      generator=torch.Generator().manual_seed(seed))


def _windows(rows, hw, seed=1, device="cpu"):
    """Seeded NHWC windows, centred, so each ReLU cuts some outputs."""
    g = torch.Generator().manual_seed(seed)
    return torch.randn((rows, *hw, 1), generator=g).to(device)


def _layers(encoder):
    return [(m.weight, m.bias, m.stride, m.padding)
            for m in encoder.encoder[0:6:2]]


def _sequential(encoder, x):
    """The encoder as it ran before: its `nn.Sequential`, module by
    module."""
    return encoder.encoder(x.permute(0, 3, 1, 2))


def _modules_chain(encoder, x):
    """The three pairs' outputs through the modules."""
    outs, h = [], x.permute(0, 3, 1, 2)
    for m in encoder.encoder[:6]:
        h = m(h)
        if isinstance(m, nn.ReLU):
            outs.append(h)
    return outs


@pytest.mark.parametrize("hw", GEOMETRIES)
@pytest.mark.parametrize("save", [False, True])
def test_plain_chain_equals_the_modules_bit_for_bit(hw, save):
    enc = _aec(hw).encoder
    x = _windows(5, hw)
    with torch.no_grad():
        got = conv_relu_chain_plain(x.permute(0, 3, 1, 2), _layers(enc),
                                    save)
        want = _modules_chain(enc, x)
    assert len(got) == (3 if save else 1)
    for g, w in zip(got, want[-len(got):]):
        assert torch.equal(g, w)
    assert [tuple(a.shape[2:]) for a in want] == encoder_conv_shapes(hw)[1:]


@pytest.mark.parametrize("hw", GEOMETRIES)
def test_encoder_forward_equals_sequential_bit_for_bit(hw):
    enc = _aec(hw).encoder
    x = _windows(6, hw)
    want = _sequential(enc, x)
    got = enc(x)
    assert got.shape == (6, 9)
    assert torch.equal(got, want)
    with torch.no_grad():
        assert torch.equal(enc(x), want)


def test_no_grad_route_makes_no_node():
    """Where autograd records nothing, the chain is not a node: under
    no_grad, and where neither x nor a parameter requires a gradient."""
    enc = _aec((4, 101)).encoder
    x = _windows(3, (4, 101)).permute(0, 3, 1, 2)
    with torch.no_grad():
        assert conv_relu_chain(x, _layers(enc)).grad_fn is None
    enc.requires_grad_(False)
    assert conv_relu_chain(x, _layers(enc)).grad_fn is None
    enc.requires_grad_(True)
    y = conv_relu_chain(x, _layers(enc))
    assert type(y.grad_fn).__name__ == "_ConvReLUChainBackward"


def test_state_dict_keys_unchanged_and_reference_layout_loads():
    """The module tree is as before: the reference's `encoder.encoder.<i>`
    keys, and a state dict saved in that layout loads strictly."""
    aec = _aec((87, 100))
    keys = [k for k in aec.state_dict() if k.startswith("encoder.")]
    assert keys == [
        "encoder.encoder.0.weight", "encoder.encoder.0.bias",
        "encoder.encoder.2.weight", "encoder.encoder.2.bias",
        "encoder.encoder.4.weight", "encoder.encoder.4.bias",
        "encoder.encoder.6.conv.weight",
        "encoder.encoder.8.weight", "encoder.encoder.8.bias",
    ]
    types = [type(m) for m in aec.encoder.encoder]
    assert types == [nn.Conv2d, nn.ReLU] * 3 + [
        models.layers.SpatialAttention, nn.Flatten, nn.Linear, nn.ReLU]
    buf = io.BytesIO()
    torch.save(_aec((87, 100), seed=3).state_dict(), buf)
    buf.seek(0)
    assert aec.load_state_dict(torch.load(buf)) is not None
    x = _windows(2, (87, 100))
    assert torch.equal(aec.encoder(x), _aec((87, 100), seed=3).encoder(x))


def _graph(encoder, x):
    """(the backward nodes from the output down to the first convolution,
    the shapes of the tensors the graph saves) of one forward."""
    shapes = []

    def pack(t):
        shapes.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        node = encoder(x).grad_fn
    names = []
    while node is not None:
        names.append(type(node).__name__)
        node = next((f for f, _ in node.next_functions if f is not None
                     and type(f).__name__ != "AccumulateGrad"), None)
    return names, sorted(shapes)


def test_graph_keeps_the_modules_saved_tensors(monkeypatch):
    """One node for the three Conv2d -> ReLU pairs where the modules had
    six, saving the tensors the modules' nodes saved (x, the weights, each
    ReLU's output), each once where the modules saved a1 and a2 twice (as a
    ReLU's output and the next convolution's input)."""
    enc = _aec((87, 100)).encoder
    x = _windows(2, (87, 100))
    names, shapes = _graph(enc, x)
    monkeypatch.setattr(models.aec.Encoder, "forward", _sequential)
    old_names, old_shapes = _graph(enc, x)
    assert old_names[-6:] == ["ReluBackward0", "ConvolutionBackward0"] * 3
    assert names == old_names[:-6] + ["_ConvReLUChainBackward"]
    assert set(shapes) == set(old_shapes)
    assert not Counter(shapes) - Counter(old_shapes)
    assert len(old_shapes) - len(shapes) == 2


@pytest.mark.parametrize("hw", GEOMETRIES)
@pytest.mark.parametrize("x_grad", [False, True])
def test_node_gradients_equal_the_modules(hw, x_grad):
    """The encoder's output and every gradient, x's where it needs one,
    equal the modules' bit for bit (the same backward calls)."""
    enc = _aec(hw).encoder
    x = _windows(4, hw)
    out = []
    for route in ("modules", "node"):
        xi = x.clone().requires_grad_(x_grad)
        enc.zero_grad(set_to_none=True)
        y = _sequential(enc, xi) if route == "modules" else enc(xi)
        g = torch.randn(y.shape, generator=torch.Generator().manual_seed(9))
        y.backward(g)
        out.append([y, xi.grad] + [p.grad for p in enc.parameters()])
    assert (out[1][1] is None) == (not x_grad)
    for got, want in zip(out[1], out[0]):
        assert (got is None and want is None) or torch.equal(got, want)


def test_chain_leaves_the_incoming_gradient_and_keeps_a_retained_graph():
    """The inner ReLUs' thresholds run in place on gradients the node made,
    never on the one it was given; with `retain_graph` a second backward
    adds the same gradients again."""
    enc = _aec((87, 100)).encoder
    x = _windows(3, (87, 100)).permute(0, 3, 1, 2)
    y = conv_relu_chain(x, _layers(enc))
    g = torch.randn(y.shape, generator=torch.Generator().manual_seed(7))
    given = g.clone()
    y.backward(g, retain_graph=True)
    assert torch.equal(g, given)
    first = [p.grad.clone() for p in enc.parameters() if p.grad is not None]
    y.backward(g)
    again = [p.grad for p in enc.parameters() if p.grad is not None]
    assert len(first) == 6
    for a, b in zip(first, again):
        assert torch.equal(b, a + a)


@pytest.mark.parametrize("hw", GEOMETRIES)
def test_chain_under_bf16_autocast_equals_the_modules(hw):
    """Under autocast x, the weights and the biases are cast as autocast
    casts `conv2d`: the output is bfloat16, and it and the float32
    gradients equal the modules' under the same autocast."""
    enc = _aec(hw).encoder
    x = _windows(3, hw)
    out = []
    for route in ("modules", "chain"):
        enc.zero_grad(set_to_none=True)
        with torch.autocast("cpu", dtype=torch.bfloat16):
            y = (_modules_chain(enc, x)[-1] if route == "modules"
                 else conv_relu_chain(x.permute(0, 3, 1, 2), _layers(enc)))
        y.float().sum().backward()
        out.append([y] + [p.grad for p in enc.encoder[0:6:2].parameters()])
    assert out[1][0].dtype == torch.bfloat16
    assert all(g.dtype == torch.float32 for g in out[1][1:])
    for got, want in zip(out[1], out[0]):
        assert torch.equal(got, want)


def test_gradcheck_in_float64():
    g = torch.Generator().manual_seed(4)
    x = torch.randn((2, 1, 3, 9), generator=g, dtype=torch.float64,
                    requires_grad=True)
    params = []
    for cin, cout in cuda_conv.LAYERS:
        params.append(torch.randn((cout, cin, 2, 4), generator=g,
                                  dtype=torch.float64, requires_grad=True))
        params.append(torch.randn((cout,), generator=g, dtype=torch.float64,
                                  requires_grad=True))

    def chain(x, w1, b1, w2, b2, w3):
        return conv_relu_chain(x, [(w1, b1, (1, 2), 1), (w2, b2, (1, 2), 1),
                                   (w3, None, (1, 2), 1)])

    assert torch.autograd.gradcheck(chain, (x, *params[:-1]))


@pytest.mark.parametrize("model", ["AEC", "DEC"])
def test_training_step_equals_the_sequential_encoder(model, monkeypatch):
    """One AEC and one DEC step at (87, 100) from the same weights: the
    losses and parameters after it equal those of the encoder's old
    module-by-module forward."""
    hw = (87, 100)
    x = _windows(8, hw, seed=5)
    sd = (_aec(hw) if model == "AEC"
          else models.DEC(5, input_hw=hw)).state_dict()
    results = []
    for route in ("sequential", "chain"):
        if route == "sequential":
            monkeypatch.setattr(models.aec.Encoder, "forward", _sequential)
        else:
            monkeypatch.undo()
        m = getattr(models, model)(*(() if model == "AEC" else (5,)),
                                   input_hw=hw)
        m.load_state_dict(sd)
        state = train.create_train_state(m, 1e-3)
        if model == "AEC":
            x_rec, _ = m(x)
            loss = torch.mean((x_rec - x) ** 2)
        else:
            q, x_rec, _ = m(x)
            loss = torch.mean((x_rec - x) ** 2) + q.max(1).values.mean()
        loss.backward()
        state.apply_gradients()
        results.append((loss.detach(), {k: v.clone() for k, v in
                                        m.state_dict().items()}))
    assert torch.equal(results[0][0], results[1][0])
    for k, v in results[0][1].items():
        assert torch.equal(results[1][1][k], v), k


def test_cpu_route_never_loads_the_kernel(monkeypatch):
    def refuse():
        raise AssertionError("the CPU route loaded the CUDA library")

    monkeypatch.setattr(_build, "load_library", refuse)
    before = cuda_conv.LAUNCHES
    aec = _aec((4, 101))
    aec(_windows(3, (4, 101)))[0].sum().backward()
    with torch.no_grad():
        aec.encoder(_windows(3, (4, 101)))
    assert cuda_conv.LAUNCHES == before


_W1, _W8 = (8, 1, 2, 4), (8, 8, 2, 4)


def _shapes(w1=_W1, w2=_W8, w3=_W8, stride=(1, 2), padding=(1, 1),
            bias=(8,)):
    return [(w1, bias, stride, padding), (w2, bias, stride, padding),
            (w3, bias, stride, padding)]


@pytest.mark.parametrize("x_shape,layers,match", [
    ((2, 1, 87, 100), _shapes(w1=(8, 1, 3, 3)), "built for"),
    ((2, 1, 87, 100), _shapes(w2=(8, 4, 2, 4)), "built for"),
    ((2, 1, 87, 100), _shapes(w3=(4, 8, 2, 4)), "built for"),
    ((2, 1, 87, 100), _shapes(stride=(2, 2)), "built for"),
    ((2, 1, 87, 100), _shapes(padding=(0, 1)), "built for"),
    ((2, 1, 87, 100), _shapes(bias=(4,)), "bias"),
    ((2, 1, 87, 100), _shapes()[:2], "3 layers"),
    ((2, 2, 87, 100), _shapes(), "one channel"),
    ((2, 87, 100), _shapes(), "one channel"),
    ((2, 1, 87, 7), _shapes(), "8 <= W"),
    ((2, 1, 4, 513), _shapes(), "8 <= W"),
    ((2, 1, 0, 100), _shapes(), "1 <= H"),
])
def test_check_geometry_raises_on_what_the_kernel_does_not_take(
        x_shape, layers, match):
    with pytest.raises(ValueError, match=match):
        cuda_conv.check_geometry(x_shape, layers)
    x = torch.zeros(x_shape)
    tensors = [(torch.zeros(w), None if b is None else torch.zeros(b), s, p)
               for w, b, s, p in layers]
    with pytest.raises(ValueError, match=match):
        cuda_conv.conv_relu_chain_cuda(x, tensors)


def test_wrapper_refuses_a_cpu_tensor_and_other_devices():
    enc = _aec((4, 101)).encoder
    x = _windows(2, (4, 101)).permute(0, 3, 1, 2)
    layers = [(w.detach(), b.detach(), s, p) for w, b, s, p in _layers(enc)]
    with pytest.raises(ValueError, match="CUDA device"):
        cuda_conv.conv_relu_chain_cuda(x, layers)
    with pytest.raises(ValueError, match="no encoder convolution"):
        conv_relu_chain(x.to("meta"), [
            (w.to("meta"), b.to("meta"), s, p) for w, b, s, p in layers])


@pytest.mark.parametrize("hw", GEOMETRIES + [(13, 37), (1, 8), (3, 512)])
def test_output_hw_matches_the_modules(hw):
    enc = _aec(hw).encoder
    shapes = cuda_conv.check_geometry(
        (2, 1, *hw), [(w.shape, b.shape, s, p)
                      for w, b, s, p in _layers(enc)])
    assert shapes == encoder_conv_shapes(hw)[1:]
    with torch.no_grad():
        want = _modules_chain(enc, torch.zeros((2, *hw, 1)))
    assert shapes == [tuple(a.shape[2:]) for a in want]


# ------------------------------------------------------------- on a card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA convolution kernel has no "
                    "CPU mode")
    from spectrogram_cube_clustering_tpu_torch.core import fp32_policy

    fp32_policy()
    return torch.device("cuda")


def _card_chain(hw, rows, device, seed=0, dtype=torch.float32):
    """(x (rows, 1, H, W), the seeded encoder's three layers) on the card."""
    enc = _aec(hw, seed).encoder.to(device)
    x = _windows(rows, hw, seed + 1, device).permute(0, 3, 1, 2).to(dtype)
    return x.contiguous(), [(w.detach().to(dtype), b.detach().to(dtype), s, p)
                            for w, b, s, p in _layers(enc)]


#: (H, W) and rows on the card: the RIS step and eval chunk, the DAS step,
#: an odd shape over two strips, one row, the widest x
CARD_SHAPES = [((87, 100), 2048), ((87, 100), 4096), ((4, 101), 64),
               ((13, 37), 5), ((87, 100), 1), ((3, 512), 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("hw,rows", CARD_SHAPES)
def test_conv_kernel_matches_plain_in_float32(cuda_device, hw, rows):
    """The kernel against the plain chain (cuDNN with TF32 off, then relu)
    and against the chain in float64, both routes. Each output sums at
    most 64 float32 products, 8 for a1, in another order than cuDNN's
    (error under 72 * 2^-24 of the sum of their magnitudes, ~4.3e-6), and
    a layer's error carries into the next, so within rtol 1e-5 and 1e-5
    of the largest output. The route that saves a1 and a2 writes the same
    a3 bit for bit, and its a1 and a2 match the plain ones likewise."""
    x, layers = _card_chain(hw, rows, cuda_device)
    before = cuda_conv.LAUNCHES
    saved = cuda_conv.conv_relu_chain_cuda(x, layers, save=True)
    (alone,) = cuda_conv.conv_relu_chain_cuda(x, layers)
    assert cuda_conv.LAUNCHES == before + 2
    with torch.no_grad():
        want = conv_relu_chain_plain(x, layers, save=True)
        exact = conv_relu_chain_plain(x.double(), [
            (w.double(), b.double(), s, p) for w, b, s, p in layers],
            save=True)
    assert torch.equal(alone, saved[-1])
    for got, plain, f64 in zip(saved, want, exact):
        assert got.shape == plain.shape and got.dtype == torch.float32
        assert got.is_contiguous(memory_format=torch.channels_last)
        scale = float(f64.abs().max())
        assert scale > 0
        assert bool((got == 0).any()) and bool((got > 0).any())
        torch.testing.assert_close(got, plain, rtol=1e-5, atol=1e-5 * scale)
        torch.testing.assert_close(got.double(), f64, rtol=1e-5,
                                   atol=1e-5 * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("hw,rows", CARD_SHAPES[:3])
def test_conv_kernel_equals_cudnn_bit_for_bit(cuda_device, hw, rows):
    """At the benchmark's and the DAS steps' shapes the kernel sums in the
    order of cuDNN's float32 convolution (TF32 off) and adds the bias
    after, as the modules did: a1, a2 and a3 equal the modules' outputs on
    the encoder's channels-last view of the windows bit for bit, so the
    steps after the chain see the values they saw before."""
    enc = _aec(hw).encoder.to(cuda_device)
    x = _windows(rows, hw, 1, cuda_device)
    with torch.no_grad():
        got = cuda_conv.conv_relu_chain_cuda(
            x.permute(0, 3, 1, 2).contiguous(), _layers(enc), save=True)
        want = _modules_chain(enc, x)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _bf16_layer(inp, w, b):
    """(relu(conv2d) of bfloat16 values as the kernel rounds it: the
    float64 sum rounded to bfloat16, the bias added and rounded again; the
    inputs within whose reach the sum's first rounding may fall the other
    way; one step of the sum)."""
    inp, w = inp.double(), w.double()
    unbiased = F.conv2d(inp, w, None, cuda_conv.STRIDE, cuda_conv.PADDING)
    slack = 72 * 2.0**-24 * F.conv2d(inp.abs(), w.abs(), None,
                                     cuda_conv.STRIDE, cuda_conv.PADDING)
    first = unbiased.bfloat16().double()
    step = torch.ldexp(torch.ones_like(first), torch.frexp(unbiased)[1] - 8)
    near = 0.5 * step - (unbiased - first).abs() <= slack
    out = (first + b.double()[:, None, None]).bfloat16().double().relu()
    return out, near, slack + step


@pytest.mark.cuda
@pytest.mark.parametrize("hw,rows", CARD_SHAPES[:4])
def test_conv_kernel_matches_plain_in_bfloat16(cuda_device, hw, rows):
    """bfloat16 throughout: each layer, from the kernel's own input to it
    (x, then its saved a1 and a2), equals the float64 sum rounded to
    bfloat16 before the bias and after, bit for bit, wherever a float32 sum
    of at most 64 products (error under 72 * 2^-24 of the sum of their
    magnitudes) cannot reach the midpoint its first rounding turns on; at
    the rest within that error, one step of the sum and one of the output.
    Both routes give the same a3, and it lies within a few steps of the
    plain chain under autocast (cuDNN), whose roundings may fall the other
    way and carry through the layers."""
    x, layers = _card_chain(hw, rows, cuda_device, dtype=torch.bfloat16)
    saved = cuda_conv.conv_relu_chain_cuda(x, layers, save=True)
    (alone,) = cuda_conv.conv_relu_chain_cuda(x, layers)
    assert torch.equal(alone, saved[-1])
    with torch.no_grad():
        for inp, got, (w, b, *_) in zip((x,) + saved[:2], saved, layers):
            assert got.dtype == torch.bfloat16
            exact, near, tol = _bf16_layer(inp, w, b)
            assert float(near.double().mean()) < 0.1
            assert torch.equal(got.double()[~near], exact[~near])
            tol = tol + 2.0**-7 * torch.maximum(got.double().abs(),
                                                exact.abs())
            assert bool(((got.double() - exact).abs() <= tol).all())
        want = conv_relu_chain_plain(x, layers)[0]
    scale = float(want.float().abs().max())
    torch.testing.assert_close(saved[-1].float(), want.float(), rtol=2**-6,
                               atol=2**-6 * scale)


@pytest.mark.cuda
def test_conv_kernel_is_deterministic_and_keeps_a_nan(cuda_device):
    x, layers = _card_chain((87, 100), 512, cuda_device)
    first = cuda_conv.conv_relu_chain_cuda(x, layers, save=True)
    for _ in range(3):
        again = cuda_conv.conv_relu_chain_cuda(x, layers, save=True)
        assert all(torch.equal(a, b) for a, b in zip(again, first))
    x[3, 0, 40, 50] = float("nan")
    a1, a2, a3 = cuda_conv.conv_relu_chain_cuda(x, layers, save=True)
    with torch.no_grad():
        want = conv_relu_chain_plain(x, layers, save=True)
    for got, plain in zip((a1, a2, a3), want):
        assert torch.equal(torch.isnan(got), torch.isnan(plain))
        assert bool(torch.isnan(got[3]).any())
        assert not bool(torch.isnan(got[:3]).any())
    (alone,) = cuda_conv.conv_relu_chain_cuda(x, layers)
    assert torch.equal(torch.isnan(alone), torch.isnan(a3))


def _step_grads(model, x, name, encoder=None):
    """(loss, {leaf: gradient}) of one AEC or DEC step's loss at x, the
    encoder run by `encoder` (the model's own by default)."""
    model.zero_grad(set_to_none=True)
    z = (encoder or model.encoder)(x)
    loss = torch.mean((model.decoder(z) - x) ** 2)
    if name == "DEC":
        loss = loss + model.soft_assign(z).max(1).values.mean()
    loss.backward()
    return loss.item(), {n: p.grad.clone() for n, p in
                         model.named_parameters() if p.grad is not None}


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["AEC", "DEC"])
@pytest.mark.parametrize("hw", GEOMETRIES)
def test_encoder_gradients_on_card_match_the_modules(cuda_device, name, hw):
    """One step's loss and gradients from the same weights and windows on
    the card, through the chain and through the modules (cuDNN's forward),
    each against the same step in float64 on the CPU, leaf by leaf by
    norm. Where a ReLU's input lies within float32 rounding of zero, a
    float32 step may take the other side of it, and that moves a leaf's
    gradient by up to ~2e-3 of its norm in either route at 256 rows (both
    routes read 1e-6 to 2.2e-3 from float64 over three seeds on an H100),
    so the routes lie within 1e-2 of float64 and of each other, and the
    loss within 1e-5; a wrong output or a lost gradient moves a leaf by
    its whole norm."""
    import copy

    model = (_aec(hw) if name == "AEC"
             else models.DEC(5, input_hw=hw)).to(cuda_device)
    x = _windows(256, hw, device=cuda_device)
    before = cuda_conv.LAUNCHES
    got_loss, got = _step_grads(model, x, name)
    assert cuda_conv.LAUNCHES == before + 1
    want_loss, want = _step_grads(
        model, x, name, lambda v: _sequential(model.encoder, v))
    assert cuda_conv.LAUNCHES == before + 1
    ref = copy.deepcopy(model).double().cpu()
    exact_loss, exact = _step_grads(ref, x.double().cpu(), name)
    assert got.keys() == want.keys() == exact.keys()
    assert got_loss == pytest.approx(exact_loss, rel=1e-5)
    assert want_loss == pytest.approx(exact_loss, rel=1e-5)
    for n, g64 in exact.items():
        chain, modules = got[n].double().cpu(), want[n].double().cpu()
        norm = float(g64.norm())
        for what, a, b in (("chain", chain, g64), ("modules", modules, g64),
                           ("chain to modules", chain, modules)):
            gap = float((a - b).norm()) / norm
            assert gap <= 1e-2, (n, what, gap)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["AEC", "DEC"])
def test_train_step_peak_on_card_no_higher_than_the_modules(cuda_device,
                                                            name):
    """`max_memory_allocated` over one 2,048-row step at (87, 100): the
    chain's node saves what the modules' nodes saved, without the
    convolutions' outputs before each ReLU."""
    model = (_aec((87, 100)) if name == "AEC"
             else models.DEC(5, input_hw=(87, 100))).to(cuda_device)
    x = _windows(2048, (87, 100), device=cuda_device)

    def step():
        out = model(x)
        x_rec = out[0] if name == "AEC" else out[1]
        loss = torch.mean((x_rec - x) ** 2)
        if name == "DEC":
            loss = loss + out[0].max(1).values.mean()
        loss.backward()
        model.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated()

    peaks = {}
    for route in ("chain", "modules", "chain"):
        forward = (models.aec.Encoder.forward if route == "chain"
                   else _sequential)
        model.encoder.forward = forward.__get__(model.encoder)
        step()
        torch.cuda.reset_peak_memory_stats()
        peaks[route] = step()
    assert peaks["chain"] <= peaks["modules"], peaks


def _catalog(rows, device):
    return train.make_batched_data(_windows(rows, (87, 100), device=device),
                                   rows)


@pytest.mark.cuda
def test_launches_rise_in_each_route_through_the_encoder(cuda_device):
    """The counter rises by one a forward in an AEC step, a DEC step,
    DEC's full eval (one a 4,096-row chunk) and a DECPredictor call."""
    aec = _aec((87, 100)).to(cuda_device)
    data = _catalog(512, cuda_device)
    before = cuda_conv.LAUNCHES
    train.aec.train_epoch(train.create_train_state(aec, 1e-3), data)
    assert cuda_conv.LAUNCHES == before + 1  # one batch, one step

    dec = models.DEC(5, input_hw=(87, 100)).to(cuda_device)
    step, _ = train.make_stream_fns(dec, 1e-3)
    p = torch.full((512, 5), 0.2, device=cuda_device)
    before = cuda_conv.LAUNCHES
    step(train.create_train_state(dec, 5e-4), data.x[0], p, 512)
    assert cuda_conv.LAUNCHES == before + 1

    before = cuda_conv.LAUNCHES
    q, labels, z = train.full_eval(dec, _catalog(5000, cuda_device))
    assert q.shape == (5000, 5)
    assert cuda_conv.LAUNCHES == before + 2

    predictor = serve.DECPredictor(dec.state_dict(), 5, input_hw=(87, 100),
                                   max_batch=1024, device=cuda_device)
    before = cuda_conv.LAUNCHES
    got = predictor(np.random.default_rng(0).standard_normal(
        (300, 87, 100, 1)).astype(np.float32))
    assert got["q"].shape == (300, 5)
    assert cuda_conv.LAUNCHES > before


@pytest.mark.cuda
def test_conv_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    x, layers = _card_chain((4, 101), 8, cuda_device)
    strided = x.transpose(2, 3).contiguous().transpose(2, 3)
    assert not strided.is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        cuda_conv.conv_relu_chain_cuda(strided, layers)
    bad = [(w.transpose(2, 3).contiguous().transpose(2, 3), b, s, p)
           for w, b, s, p in layers]
    with pytest.raises(ValueError, match="contiguous"):
        cuda_conv.conv_relu_chain_cuda(x, bad)
    for dtype in (torch.float64, torch.float16):
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            cuda_conv.conv_relu_chain_cuda(x.to(dtype), [
                (w.to(dtype), b.to(dtype), s, p) for w, b, s, p in layers])
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        cuda_conv.conv_relu_chain_cuda(x.bfloat16(), layers)
    with pytest.raises(ValueError, match="CUDA device"):
        cuda_conv.conv_relu_chain_cuda(x, [(w.cpu(), b, s, p)
                                           for w, b, s, p in layers])
    # a strided x through the entry point is made contiguous first
    enc = _aec((4, 101)).encoder.to(cuda_device)
    xs = _windows(8, (4, 101), device=cuda_device)
    wide = torch.zeros((8, 4, 101, 2), device=cuda_device)
    wide[..., :1] = xs
    with torch.no_grad():
        assert torch.equal(enc(wide[..., :1]), enc(xs))
