"""The decoder's transposed convolutions through `ops.cuda_convt` on the CPU.

On the CPU the Function runs its plain version (`F.conv_transpose2d`, then
`torch.relu`) and makes autograd's own backward calls, so everything here
is held bit for bit to the `nn.ConvTranspose2d` -> `nn.ReLU` modules the
decoder ran before: its forward, its gradients, the same under bfloat16
autocast, and whole AEC and DEC training steps. The kernel itself runs on
the card only (`tests/test_torch_cuda.py`); here its wrapper's refusals.
"""

import io
from collections import Counter

import pytest
import torch
from torch import nn

from spectrogram_cube_clustering_tpu_torch import models, train
from spectrogram_cube_clustering_tpu_torch.ops import _build, cuda_convt
from spectrogram_cube_clustering_tpu_torch.ops.cuda_convt import (
    conv_transpose_relu,
)

GEOMETRIES = [(4, 101), (87, 100)]
#: the decoder's four layers at each geometry: (hw, index of the layer)
LAYERS = [(hw, i) for hw in GEOMETRIES for i in range(4)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _aec(hw, seed=0):
    return models.AEC(input_hw=hw,
                      generator=torch.Generator().manual_seed(seed))


def _sequential(decoder, z):
    """The decoder as it ran before: its `nn.Sequential`, module by module."""
    return decoder.decoder(z).permute(0, 2, 3, 1)


def _layer(hw, i, seed=0):
    """(the i-th ConvTranspose2d of the decoder at `hw`, an input for it)."""
    dec = _aec(hw, seed).decoder
    convs = [m for m in dec.decoder if isinstance(m, nn.ConvTranspose2d)]
    g = torch.Generator().manual_seed(seed + 1)
    h = dec.decoder[:3](torch.rand((3, 9), generator=g))
    for m in convs[:i]:
        h = torch.relu(m(h))
    return convs[i], (h + 0.1 * torch.randn(h.shape, generator=g)).detach()


def _args(m):
    return (m.weight, m.bias, m.stride, m.padding, m.output_padding)


@pytest.mark.parametrize("hw", GEOMETRIES)
def test_decoder_forward_equals_sequential_bit_for_bit(hw):
    aec = _aec(hw)
    z = aec.encoder(torch.randn((6, *hw, 1),
                                generator=torch.Generator().manual_seed(2)))
    got = aec.decoder(z)
    want = _sequential(aec.decoder, z)
    assert got.shape == (6, *hw, 1)
    assert torch.equal(got, want)
    with torch.no_grad():
        assert torch.equal(aec.decoder(z), want)


def test_state_dict_keys_unchanged_and_reference_layout_loads():
    """The module tree is as before: the reference's `decoder.decoder.<i>`
    keys, and a state dict saved in that layout loads strictly."""
    aec = _aec((87, 100))
    keys = [k for k in aec.state_dict() if k.startswith("decoder.")]
    assert keys == [
        "decoder.decoder.0.weight", "decoder.decoder.0.bias",
        "decoder.decoder.3.weight",
        "decoder.decoder.5.weight", "decoder.decoder.5.bias",
        "decoder.decoder.7.weight", "decoder.decoder.7.bias",
        "decoder.decoder.9.weight", "decoder.decoder.9.bias",
    ]
    types = [type(m) for m in aec.decoder.decoder]
    assert types == [nn.Linear, nn.ReLU, nn.Unflatten] + [
        nn.ConvTranspose2d, nn.ReLU] * 4
    buf = io.BytesIO()
    torch.save(_aec((87, 100), seed=3).state_dict(), buf)
    buf.seek(0)
    assert aec.load_state_dict(torch.load(buf)) is not None
    want = _aec((87, 100), seed=3)
    z = torch.rand((2, 9))
    assert torch.equal(aec.decoder(z), want.decoder(z))


def _graph(decoder, z):
    """(the backward nodes from the output down the decoder, the shapes of
    the tensors the graph saves) of one forward."""
    shapes = []

    def pack(t):
        shapes.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        node = decoder(z).grad_fn
    names = []
    while node is not None:
        names.append(type(node).__name__)
        node = next((f for f, _ in node.next_functions if f is not None
                     and type(f).__name__ != "AccumulateGrad"), None)
    return names, sorted(shapes)


def test_graph_keeps_the_modules_nodes_and_saved_tensors(monkeypatch):
    """One node for the four ConvTranspose2d -> ReLU pairs where the
    modules had eight, saving the tensors the modules' nodes saved (x, the
    weights, each ReLU's output), each once where the modules saved the
    inner outputs twice (as a ReLU's output and the next layer's input),
    so that a step's peak stays."""
    dec = _aec((87, 100)).decoder
    z = torch.rand((2, 9), requires_grad=True)
    names, shapes = _graph(dec, z)
    monkeypatch.setattr(models.Decoder, "forward", _sequential)
    old_names, old_shapes = _graph(dec, z)
    assert names == (["PermuteBackward0", "_ConvTransposeReLUChainBackward"]
                     + old_names[9:])
    assert old_names[:9] == ["PermuteBackward0"] + [
        "ReluBackward0", "ConvolutionBackward0"] * 4
    assert set(shapes) == set(old_shapes)
    assert not Counter(shapes) - Counter(old_shapes)
    assert len(old_shapes) - len(shapes) == 3


def test_chain_leaves_the_incoming_gradient_and_keeps_a_retained_graph():
    """The inner ReLUs' thresholds run in place on gradients the node made,
    never on the one it was given; with `retain_graph` a second backward
    adds the same gradients again."""
    dec = _aec((87, 100)).decoder
    z = torch.rand((3, 9), generator=torch.Generator().manual_seed(6),
                   requires_grad=True)
    y = dec(z)
    g = torch.randn(y.shape, generator=torch.Generator().manual_seed(7))
    given = g.clone()
    y.backward(g, retain_graph=True)
    assert torch.equal(g, given)
    first = [z.grad.clone()] + [p.grad.clone() for p in dec.parameters()]
    y.backward(g)
    again = [z.grad] + [p.grad for p in dec.parameters()]
    for a, b in zip(first, again):
        assert torch.equal(b, a + a)


@pytest.mark.parametrize("hw,i", LAYERS)
def test_function_gradients_equal_the_modules(hw, i):
    """Forward and every gradient of one layer equal the ConvTranspose2d ->
    ReLU modules' bit for bit (the same backward calls)."""
    m, x = _layer(hw, i)
    grads = []
    for route in ("modules", "function"):
        xi = x.clone().requires_grad_(True)
        m.zero_grad(set_to_none=True)
        y = (torch.relu(m(xi)) if route == "modules"
             else conv_transpose_relu(xi, *_args(m)))
        g = torch.randn(y.shape, generator=torch.Generator().manual_seed(9))
        y.backward(g)
        grads.append([y, xi.grad, m.weight.grad]
                     + ([] if m.bias is None else [m.bias.grad]))
    for got, want in zip(grads[1], grads[0]):
        assert torch.equal(got, want)


@pytest.mark.parametrize("hw,i", [((4, 101), i) for i in range(4)])
def test_function_under_bf16_autocast_equals_the_modules(hw, i):
    """Under autocast x, the weight and the bias are cast as autocast casts
    `conv_transpose2d`: the output is bfloat16 and it and the float32
    gradients equal the modules' under the same autocast."""
    m, x = _layer(hw, i)
    out = []
    for route in ("modules", "function"):
        xi = x.clone().requires_grad_(True)
        m.zero_grad(set_to_none=True)
        with torch.autocast("cpu", dtype=torch.bfloat16):
            y = (torch.relu(m(xi)) if route == "modules"
                 else conv_transpose_relu(xi, *_args(m)))
        y.float().sum().backward()
        out.append([y, xi.grad, m.weight.grad]
                   + ([] if m.bias is None else [m.bias.grad]))
    assert out[1][0].dtype == torch.bfloat16
    assert out[1][2].dtype == torch.float32
    for got, want in zip(out[1], out[0]):
        assert torch.equal(got, want)


@pytest.mark.parametrize("geometry", sorted(cuda_convt.GEOMETRIES))
def test_gradcheck_in_float64(geometry):
    cin, cout, kernel, stride = geometry
    g = torch.Generator().manual_seed(4)
    x = torch.randn((2, cin, 3, 4), generator=g, dtype=torch.float64,
                    requires_grad=True)
    w = torch.randn((cin, cout, *kernel), generator=g, dtype=torch.float64,
                    requires_grad=True)
    b = torch.randn((cout,), generator=g, dtype=torch.float64,
                    requires_grad=True)
    op = (0, 1) if stride == (1, 2) else (0, 0)
    for bias in (b, None):
        assert torch.autograd.gradcheck(
            lambda *t: conv_transpose_relu(*t, stride, (1, 1), op),
            (x, w, bias))


@pytest.mark.parametrize("model", ["AEC", "DEC"])
def test_training_step_equals_the_sequential_decoder(model, monkeypatch):
    """One AEC and one DEC step at (87, 100) from the same weights: the
    losses and parameters after it equal those of the decoder's old
    module-by-module forward."""
    hw = (87, 100)
    x = torch.randn((8, *hw, 1), generator=torch.Generator().manual_seed(5))
    sd = (_aec(hw) if model == "AEC"
          else models.DEC(5, input_hw=hw)).state_dict()
    results = []
    for route in ("sequential", "function"):
        if route == "sequential":
            monkeypatch.setattr(models.Decoder, "forward", _sequential)
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
    before = cuda_convt.LAUNCHES
    aec = _aec((4, 101))
    aec(torch.randn((3, 4, 101, 1)))[0].sum().backward()
    assert cuda_convt.LAUNCHES == before


@pytest.mark.parametrize("x_shape,w_shape,stride,padding,op,match", [
    ((2, 2, 3, 4), (2, 8, 3, 3), (1, 1), (1, 1), (0, 0), "built for"),
    ((2, 8, 3, 4), (8, 8, 3, 3), (1, 1), (1, 1), (0, 0), "built for"),
    ((2, 8, 3, 4), (8, 8, 2, 4), (2, 2), (1, 1), (0, 0), "built for"),
    ((2, 8, 3, 4), (8, 4, 2, 4), (1, 2), (1, 1), (0, 0), "built for"),
    ((2, 4, 3, 4), (8, 8, 2, 4), (1, 2), (1, 1), (0, 0), "channels"),
    ((2, 8, 3, 4), (8, 8, 2, 4), (1, 2), (1, 1), (0, 2), "output padding"),
    ((2, 8, 3, 4), (8, 8, 2, 4), (1, 2), (1, 1), (1, 0), "output padding"),
    ((2, 8, 3, 4), (8, 8, 2, 4), (1, 2), (-1, 1), (0, 0), "output padding"),
    ((2, 8, 1, 1), (8, 8, 2, 4), (1, 2), (3, 1), (0, 0), "no output"),
    ((8, 3, 4), (8, 8, 2, 4), (1, 2), (1, 1), (0, 0), "NCHW"),
])
def test_wrapper_raises_on_unsupported_geometry(x_shape, w_shape, stride,
                                                padding, op, match):
    x, w = torch.zeros(x_shape), torch.zeros(w_shape)
    with pytest.raises(ValueError, match=match):
        cuda_convt.convt_relu_cuda(x, w, None, stride, padding, op)


def test_wrapper_refuses_a_cpu_tensor_and_other_devices():
    m, x = _layer((4, 101), 1)
    with pytest.raises(ValueError, match="CUDA device"):
        cuda_convt.convt_relu_cuda(x, m.weight.detach(), m.bias.detach(),
                                   m.stride, m.padding, m.output_padding)
    with pytest.raises(ValueError, match="no transposed convolution"):
        conv_transpose_relu(x.to("meta"), *(
            t.to("meta") for t in (m.weight, m.bias)),
            m.stride, m.padding, m.output_padding)


@pytest.mark.parametrize("hw", GEOMETRIES)
def test_output_hw_matches_the_modules(hw):
    dec = _aec(hw).decoder
    shape = tuple(dec.decoder[2].unflattened_size[1:])
    for m in dec.decoder:
        if isinstance(m, nn.ConvTranspose2d):
            x = torch.zeros((1, m.in_channels, *shape))
            want = tuple(m(x).shape[2:])
            assert cuda_convt.check_geometry(
                x.shape, m.weight.shape, m.stride, m.padding,
                m.output_padding) == want
            shape = want
    assert shape == hw
