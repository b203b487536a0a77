"""The torch port's normalizers and Student-t ops against the JAX package's,
on the same numpy inputs, at rtol/atol 1e-6 (float32 elementwise math and
short reductions; the two frameworks sum in different orders)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectrogram_cube_clustering_tpu.ops import normalize as jnorm
from spectrogram_cube_clustering_tpu.ops import student_t as jst
from spectrogram_cube_clustering_tpu_torch.ops import normalize, student_t

TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize(
    "name", ["sample_normalization", "sample_norm_cent", "vec_norm"]
)
@pytest.mark.parametrize(
    "shape", [(7, 4, 101), (7, 4, 101, 1), (2, 3, 4, 101, 1), (5, 87, 100)]
)
def test_normalizers_match_jax(rng, name, shape):
    x = (rng.lognormal(size=shape) * rng.choice([-1, 1], size=shape)).astype(
        np.float32
    )
    want = np.asarray(jnorm.make_normalizer(name)(jnp.asarray(x)))
    got = normalize.make_normalizer(name)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_trailing_singleton_is_part_of_the_window(rng):
    """(N, H, W, 1) takes stats over (H, W), not over (W, 1)."""
    x = rng.normal(size=(3, 4, 101, 1)).astype(np.float32)
    got = normalize.sample_norm_cent(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got.mean(axis=(1, 2, 3)), 0.0, atol=1e-6)
    flat = normalize.sample_norm_cent(torch.from_numpy(x[..., 0])).numpy()
    np.testing.assert_allclose(got[..., 0], flat, **TOL)


def test_make_normalizer_identity_and_unknown():
    x = torch.arange(6.0).reshape(1, 2, 3)
    assert normalize.make_normalizer(None)(x) is x
    with pytest.raises(ValueError, match="unknown transform 'sample_norm'"):
        normalize.make_normalizer("sample_norm")


@pytest.fixture
def latents(rng):
    z = rng.normal(size=(257, 9)).astype(np.float32)
    mu = rng.normal(size=(6, 9)).astype(np.float32)
    return z, mu


def test_pairwise_sqdist_matches_jax(latents):
    z, mu = latents
    want = np.asarray(jst.pairwise_sqdist(jnp.asarray(z), jnp.asarray(mu)))
    got = student_t.pairwise_sqdist(torch.from_numpy(z), torch.from_numpy(mu))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_pairwise_sqdist_no_cancellation():
    """Far-from-origin points a small step apart: the difference form keeps
    the 1e-4 distance that the matmul expansion loses in float32."""
    z = torch.full((1, 9), 1e3)
    mu = z + torch.tensor([[1e-2] + [0.0] * 8])
    assert student_t.pairwise_sqdist(z, mu).item() == pytest.approx(
        1e-4, rel=1e-2
    )


@pytest.mark.parametrize("alpha", [1.0, 2.5])
def test_student_t_assignment_matches_jax(latents, alpha):
    z, mu = latents
    want = np.asarray(
        jst.student_t_assignment(jnp.asarray(z), jnp.asarray(mu), alpha)
    )
    got = student_t.student_t_assignment(
        torch.from_numpy(z), torch.from_numpy(mu), alpha
    ).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got.sum(axis=1), 1.0, atol=1e-6)


def test_target_distribution_matches_jax(latents):
    z, mu = latents
    q = np.asarray(jst.student_t_assignment(jnp.asarray(z), jnp.asarray(mu)))
    want = np.asarray(jst.target_distribution(jnp.asarray(q), None))
    got = student_t.target_distribution(torch.from_numpy(q.copy()), None)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_target_distribution_rounding_matches_jax(latents):
    """Rounded to 5 decimals, the two agree at 1e-6 except where the
    unrounded value lies within that tolerance of a rounding boundary:
    there one step of 1e-5 separates them."""
    z, mu = latents
    q = np.asarray(jst.student_t_assignment(jnp.asarray(z), jnp.asarray(mu)))
    raw = np.asarray(jst.target_distribution(jnp.asarray(q), None))
    want = np.asarray(jst.target_distribution(jnp.asarray(q), 5))
    got = student_t.target_distribution(torch.from_numpy(q.copy()), 5).numpy()
    np.testing.assert_array_equal(got, np.round(got, 5))
    differ = ~np.isclose(got, want, **TOL)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * (1 + 1e-3))
    to_boundary = np.abs(np.abs(raw * 1e5 % 1.0) - 0.5) * 1e-5
    assert (to_boundary[differ] <= 1e-6).all()


def test_rounding_flip_bound_for_dec(rng):
    """The bound DEC training relies on (ROADMAP Queue 3): where the two
    `target_distribution(q, 5)` differ, they differ by exactly one step
    of 1e-5, and no argmax moves where the top-two gap exceeds 1e-4 —
    neither the labels of each side's own rounded q nor those of p."""
    z = rng.normal(size=(20_000, 9)).astype(np.float32)
    mu = rng.normal(size=(5, 9)).astype(np.float32)
    jq = np.asarray(jst.student_t_assignment(jnp.asarray(z), jnp.asarray(mu)))
    tq = student_t.student_t_assignment(
        torch.from_numpy(z), torch.from_numpy(mu)
    ).numpy()
    want = np.asarray(jst.target_distribution(jnp.asarray(jq), 5))
    got = student_t.target_distribution(torch.from_numpy(jq.copy()), 5).numpy()
    # one step, up to float32's spacing of values below 1 (1.19e-7)
    ulp = float(np.spacing(np.float32(1.0)))
    gap = np.abs(got.astype(np.float64) - want)
    flipped = gap > 0.5e-5
    assert flipped.sum() > 0  # the fault shows at this size
    np.testing.assert_allclose(gap[flipped], 1e-5, rtol=0, atol=ulp)
    assert gap[~flipped].max() <= ulp

    def clear(a):
        top2 = np.sort(a, axis=1)[:, -2:]
        return top2[:, 1] - top2[:, 0] > 1e-4

    q_clear = clear(jq)
    labels_j = np.argmax(np.round(jq, 5), axis=1)
    labels_t = np.argmax(np.round(tq, 5), axis=1)
    np.testing.assert_array_equal(labels_t[q_clear], labels_j[q_clear])
    p_clear = clear(want)
    np.testing.assert_array_equal(
        np.argmax(got, axis=1)[p_clear], np.argmax(want, axis=1)[p_clear]
    )
