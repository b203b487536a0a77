"""The port's packed and UNet architectures against the JAX package's, with
the same weights carried across by `utils.weights.state_dict_from_jax_params`.

Tolerances: modules at rtol 1e-4 / atol 1e-5 (as tests/test_torch_models.py:
float32 convs and matmuls summed in other orders); the packing functions
bit-equal (pure index moves); the SAME transposed-conv helper at the module
tolerance against flax `nn.ConvTranspose`. JAX dots run at float32
precision. The JAX UNet compiles slowly on the CPU, so its outputs are
computed once for the module.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectrogram_cube_clustering_tpu import models as jmodels
from spectrogram_cube_clustering_tpu.models import packed as jpacked
from spectrogram_cube_clustering_tpu_torch import models
from spectrogram_cube_clustering_tpu_torch.models import packed
from spectrogram_cube_clustering_tpu_torch.utils import weights

TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _windows(n=6, seed=0):
    return np.random.default_rng(seed).normal(
        size=(n, 4, 101, 1)).astype(np.float32)


def _jax_apply(model, params, x, **kw):
    with jax.default_matmul_precision("float32"):
        return jax.tree.map(np.asarray, jax.jit(
            lambda p, v: model.apply({"params": p}, v, **kw))(
                params, jnp.asarray(x)))


def _init(model, seed, x):
    """Numpy params of a JAX model (a jitted init: eager flax inits take
    seconds each on the CPU)."""
    return jax.device_get(jax.jit(model.init)(
        jax.random.key(seed), jnp.asarray(x))["params"])


@pytest.fixture(scope="module")
def unet_case():
    """A JAX UNet's params, inputs and outputs, computed once."""
    x = _windows(4, seed=1)
    jm = jmodels.UNet()
    params = _init(jm, 6, x[:1])
    return params, x, _jax_apply(jm, params, x)


def test_space_to_depth_bit_equal_and_round_trip():
    x = _windows(3)
    got = packed._space_to_depth(torch.from_numpy(x))
    want = np.asarray(jpacked._space_to_depth(jnp.asarray(x)))
    assert got.shape == (3, 2, 52, 4)
    np.testing.assert_array_equal(got.numpy(), want)
    back = packed._depth_to_space(got)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jpacked._depth_to_space(jnp.asarray(want))))
    np.testing.assert_array_equal(back.numpy(), x)


@pytest.mark.parametrize("w,cout", [(7, 32), (14, 32), (28, 4)])
def test_same_conv_transpose_matches_flax(w, cout):
    """The packed decoder's three transposed convs, (2, w) -> (2, 2w)."""
    x = np.random.default_rng(w).normal(size=(3, 2, w, 32)).astype(np.float32)
    layer = fnn.ConvTranspose(cout, (2, 4), (1, 2), padding="SAME")
    params = _init(layer, w, x)
    want = _jax_apply(layer, params, x)
    tm = models.SameConvTranspose2d(32, cout, (2, 4), (1, 2))
    tm.load_state_dict({
        "weight": torch.from_numpy(np.ascontiguousarray(
            weights._same_convt(params["kernel"]))),
        "bias": torch.from_numpy(np.array(params["bias"]))})
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.shape == want.shape == (3, 2, 2 * w, cout)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_packed_aec_matches_jax_with_carried_weights():
    x = _windows()
    jm = jmodels.PackedAEC()
    params = _init(jm, 1, x[:1])
    want_rec, want_z = _jax_apply(jm, params, x)
    tm = models.PackedAEC()
    tm.load_state_dict(weights.state_dict_from_jax_params(params))
    with torch.no_grad():
        rec, z = tm(torch.from_numpy(x))
        z_only = tm.encode(torch.from_numpy(x))
    assert rec.shape == (6, 4, 101, 1) and z.shape == (6, 9)
    np.testing.assert_allclose(z.numpy(), want_z, **TOL)
    np.testing.assert_allclose(rec.numpy(), want_rec, **TOL)
    np.testing.assert_array_equal(z_only.numpy(), z.numpy())


def test_packed_dec_matches_jax_with_carried_weights():
    x = _windows(seed=2)
    jm = jmodels.PackedDEC(n_clusters=4)
    params = _init(jm, 2, x[:1])
    # centroids near the latents, so q is far from uniform
    z0 = _jax_apply(jm, params, x, method="encode")
    params = jmodels.replace_centroids(params, z0[:4] + 0.05)
    want_q, want_rec, want_z = _jax_apply(jm, params, x)
    tm = models.PackedDEC(4)
    tm.load_state_dict(weights.state_dict_from_jax_params(params))
    with torch.no_grad():
        q, rec, z = tm(torch.from_numpy(x))
    np.testing.assert_allclose(z.numpy(), want_z, **TOL)
    np.testing.assert_allclose(q.numpy(), want_q, **TOL)
    np.testing.assert_allclose(rec.numpy(), want_rec, **TOL)


def test_unet_matches_jax_with_carried_weights(unet_case):
    params, x, (want_rec, want_z) = unet_case
    tm = models.UNet()
    tm.load_state_dict(weights.state_dict_from_jax_params(params))
    with torch.no_grad():
        rec, z = tm(torch.from_numpy(x))
    assert rec.shape == (4, 4, 101, 1) and z.shape == (4, 16)
    np.testing.assert_allclose(z.numpy(), want_z, **TOL)
    np.testing.assert_allclose(rec.numpy(), want_rec, **TOL)


def test_unet_latent_dim_is_live():
    """latent_dim sets the innermost layer of both chains, as in the JAX
    UNet (tests/test_models.py:110-117); the latent is sigmoid-gated."""
    tm = models.UNet(latent_dim=32, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        rec, z = tm(torch.from_numpy(_windows(3)))
    assert z.shape == (3, 32) and rec.shape == (3, 4, 101, 1)
    assert bool(((z > 0) & (z < 1)).all())
    assert models.UNET_LATENT_DIM == models.UNet().latent_dim == 16


def test_arch_is_read_from_the_tree(unet_case):
    """`jax_arch` tells the three trees apart, and the keys of the carried
    state_dict equal each port model's own."""
    trees = {
        "AEC": _init(jmodels.AEC(), 0, np.zeros((1, 4, 101, 1))),
        "packed": _init(jmodels.PackedDEC(3), 0, np.zeros((1, 4, 101, 1))),
        "UNet": unet_case[0],
    }
    ports = {"AEC": models.AEC(), "packed": models.PackedDEC(3),
             "UNet": models.UNet()}
    for arch, tree in trees.items():
        assert weights.jax_arch(tree) == arch
        sd = weights.state_dict_from_jax_params(tree)
        assert set(sd) == set(ports[arch].state_dict())
    with pytest.raises(ValueError, match="param tree"):
        weights.jax_arch({"centroids": np.zeros((3, 9))})


def test_packed_dec_takes_a_packed_aec_and_refuses_a_parity_one():
    aec = models.PackedAEC(generator=torch.Generator().manual_seed(3))
    dec = models.PackedDEC(3, generator=torch.Generator().manual_seed(4))
    assert models.load_encoder_decoder_from_aec(dec, aec) is dec
    for k, v in aec.state_dict().items():
        assert torch.equal(dec.state_dict()[k], v)
    with pytest.raises(ValueError, match="packed"):
        models.load_encoder_decoder_from_aec(dec, models.AEC())
    with pytest.raises(ValueError, match="packed"):
        models.load_encoder_decoder_from_aec(models.DEC(3), aec)
