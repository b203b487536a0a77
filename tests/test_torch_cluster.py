"""The port's k-means and GMM against the JAX package's on the CPU, on the
same numpy latents.

Seeding draws from different generators (torch against JAX's PRNG), so
whole fits agree statistically: NMI >= 0.99 against the JAX functions and
against sklearn on separable blobs, as tests/test_cluster.py holds the JAX
package. From the same initial centres, Lloyd gives equal labels and
centres within 1e-5; from the same initial weights and means, EM gives
equal n_iter and labels, means within 1e-4 and a lower bound within 1e-5
(float32 sums in different orders). JAX dots run at float32 precision.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.cluster import KMeans as SKKMeans
from sklearn.datasets import make_blobs
from sklearn.metrics import normalized_mutual_info_score as nmi
from sklearn.mixture import GaussianMixture

from spectrogram_cube_clustering_tpu import cluster as jcluster
from spectrogram_cube_clustering_tpu_torch import cluster
from torch_train_common import one_torch_thread  # noqa: F401 (fixture)

# the modules, which each package's `kmeans` function shadows
jkmeans = importlib.import_module(
    "spectrogram_cube_clustering_tpu.cluster.kmeans"
)
tkmeans = importlib.import_module(
    "spectrogram_cube_clustering_tpu_torch.cluster.kmeans"
)


@pytest.fixture(scope="module")
def blobs():
    # 9-D latent-like blobs, 5 clusters (the reference's K default)
    x, y = make_blobs(n_samples=1200, n_features=9, centers=5,
                      cluster_std=1.0, random_state=2009)
    return x.astype(np.float32), y


def _f32():
    return jax.default_matmul_precision("float32")


@pytest.mark.parametrize("case", ["converges", "max_iter", "empty_cluster"])
def test_lloyd_from_given_centres_matches_jax(blobs, case):
    x, _ = blobs
    rng = np.random.default_rng(3)
    init = x[rng.choice(len(x), 5, replace=False)]
    max_iter, tol_abs = 100, 1e-4 * float(np.var(x, axis=0).mean())
    if case == "max_iter":
        max_iter = 2
    if case == "empty_cluster":
        init[4] = 1e3  # far from every sample: no member, keeps its centre
    with _f32():
        want_c, want_l, want_i, want_n = jax.tree.map(
            np.asarray,
            jkmeans._lloyd_single(jnp.asarray(x), jnp.asarray(init),
                                  max_iter, tol_abs),
        )
    got_c, got_l, got_i, got_n = cluster.lloyd(
        torch.from_numpy(x), torch.from_numpy(init), max_iter, tol_abs
    )
    assert int(got_n) == int(want_n)
    np.testing.assert_array_equal(got_l.numpy(), want_l)
    np.testing.assert_allclose(got_c.numpy(), want_c, rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(got_i), float(want_i), rtol=1e-5)
    if case == "empty_cluster":
        np.testing.assert_array_equal(got_c[4].numpy(), init[4])
    if case == "max_iter":
        assert int(got_n) == 2


def test_lloyd_batched_restarts_equal_single_runs(blobs):
    """Restarts in one batch freeze independently: each takes the steps of
    its own single run (centres within 1e-5: batched sums run in another
    order)."""
    x, _ = blobs
    z = torch.from_numpy(x)
    gen = torch.Generator().manual_seed(0)
    inits = tkmeans.plus_plus_init(z, 5, 6, gen)
    tol_abs = 1e-4 * float(np.var(x, axis=0).mean())
    c, lab, inertia, n = cluster.lloyd(z, inits, 300, tol_abs)
    for r in range(6):
        c1, l1, i1, n1 = cluster.lloyd(z, inits[r], 300, tol_abs)
        assert int(n[r]) == int(n1)
        torch.testing.assert_close(c[r], c1, rtol=0, atol=1e-5)
        assert torch.equal(lab[r], l1)


def test_tol_uses_population_variance(blobs):
    """tol_abs = tol * mean of the per-feature population variance (ddof
    0), as sklearn and the JAX package compute it."""
    x, _ = blobs
    z = torch.from_numpy(x)
    want = 1e-4 * float(jnp.mean(jnp.var(jnp.asarray(x), axis=0)))
    got = 1e-4 * float(torch.mean(torch.var(z, dim=0, correction=0)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_kmeans_matches_jax_and_sklearn(blobs):
    x, y = blobs
    labels, centers = cluster.kmeans(x, 5, n_init=10, max_iter=100,
                                     device="cpu")
    assert labels.dtype == torch.int32 and centers.shape == (5, 9)
    labels = labels.numpy()
    with _f32():
        jl, _ = jcluster.kmeans(x, 5, n_init=10, max_iter=100)
    assert nmi(y, labels) >= 0.99
    assert nmi(np.asarray(jl), labels) >= 0.99
    sk = SKKMeans(n_clusters=5, n_init=10, random_state=2009).fit(x)
    assert nmi(sk.labels_, labels) >= 0.99
    d = np.linalg.norm(centers.numpy()[:, None] - sk.cluster_centers_[None],
                       axis=-1)
    assert d.min(axis=1).max() < 0.15


def test_kmeans_deterministic_and_inertia(blobs):
    x, _ = blobs
    l1, c1, inertia = cluster.kmeans(x, 5, n_init=4, max_iter=50, seed=7,
                                     return_inertia=True, device="cpu")
    l2, c2 = cluster.kmeans(x, 5, n_init=4, max_iter=50, seed=7,
                            device="cpu")
    assert torch.equal(l1, l2) and torch.equal(c1, c2)
    d2 = ((x[:, None] - c1.numpy()[None]) ** 2).sum(-1)
    np.testing.assert_allclose(float(inertia), d2.min(axis=1).sum(),
                               rtol=1e-5)


@pytest.mark.parametrize("k", [5, 7])
def test_gmm_em_from_given_init_matches_jax(blobs, k):
    """k = 7 on five blobs leaves components nearly empty: the nk + 10 eps
    guard keeps every value finite on both sides."""
    x, _ = blobs
    rng = np.random.default_rng(4)
    means0 = x[rng.choice(len(x), k, replace=False)]
    weights0 = np.full(k, 1.0 / k, np.float32)
    with _f32():
        jl, js = jcluster.gmm_em(x, weights0, means0)
    labels, state = cluster.gmm_em(x, weights0, means0, device="cpu")
    assert labels.dtype == torch.int32
    assert state.n_iter == int(js.n_iter)
    assert state.converged == bool(js.converged)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jl))
    np.testing.assert_allclose(state.means.numpy(), np.asarray(js.means),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(float(state.lower_bound),
                               float(js.lower_bound), rtol=0, atol=1e-5)
    np.testing.assert_allclose(state.weights.numpy(), np.asarray(js.weights),
                               rtol=0, atol=1e-5)
    assert all(bool(torch.isfinite(t).all()) for t in state[:4])


def test_gmm_matches_jax_and_sklearn(blobs):
    x, y = blobs
    labels, means = cluster.gmm(x, 5, n_init=10, kmeans_max_iter=100,
                                device="cpu")
    assert means.shape == (5, 9)
    labels = labels.numpy()
    with _f32():
        jl, _ = jcluster.gmm(x, 5, n_init=10, kmeans_max_iter=100)
    assert nmi(y, labels) >= 0.99
    assert nmi(np.asarray(jl), labels) >= 0.99
    sk = GaussianMixture(5, covariance_type="full", random_state=2009).fit(x)
    assert nmi(sk.predict(x), labels) >= 0.99


def test_gmm_predict_matches_fit_labels(blobs):
    x, _ = blobs
    rng = np.random.default_rng(5)
    labels, state = cluster.gmm_em(
        x, np.full(5, 0.2, np.float32), x[rng.choice(len(x), 5, replace=False)],
        device="cpu")
    assert torch.equal(cluster.gmm_predict(x, state), labels)


@pytest.mark.parametrize("dtype,want", [(np.float64, torch.float64),
                                        (np.int32, torch.float32)])
def test_latent_dtypes(blobs, dtype, want):
    """Float64 latents stay float64; anything else becomes float32."""
    x = (blobs[0] * 10).astype(dtype)
    _, centers = cluster.kmeans(x, 5, n_init=2, max_iter=20, device="cpu")
    assert centers.dtype == want


def test_numpy_latents_go_to_the_default_device(blobs):
    """A numpy input goes to the default device, the card: with none it
    raises (no silent CPU run), and it lands on the CPU only when asked;
    a tensor stays where it is."""
    from spectrogram_cube_clustering_tpu_torch.cluster.kmeans import (
        as_latents,
    )

    if torch.cuda.is_available():
        assert as_latents(blobs[0]).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            as_latents(blobs[0])
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cluster.kmeans(blobs[0], 5, n_init=2, max_iter=20)
    z = as_latents(blobs[0], device="cpu")
    assert z.device.type == "cpu" and z.dtype == torch.float32
    t = torch.from_numpy(blobs[0])
    assert as_latents(t).device == t.device


def test_explicit_cpu_device_still_works(blobs):
    from spectrogram_cube_clustering_tpu_torch.cluster.kmeans import (
        as_latents,
    )

    assert as_latents(blobs[0], device="cpu").device.type == "cpu"
    labels, centers = cluster.kmeans(blobs[0], 5, n_init=2, max_iter=20,
                                     device="cpu")
    assert labels.device.type == centers.device.type == "cpu"
    labels, means = cluster.gmm(blobs[0], 5, n_init=2, device="cpu")
    assert labels.device.type == means.device.type == "cpu"


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_nmi_matches_sklearn(seed):
    """`cluster.nmi` (numpy: the card's machine has no sklearn) against
    sklearn's default normalization, noisy and degenerate label sets."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 5, 3_000)
    b = np.where(rng.random(3_000) < 0.7, a, rng.integers(0, 6, 3_000))
    zeros = np.zeros_like(a)
    for u, v in ((a, b), (a, a), (a, zeros), (zeros, a), (zeros, zeros)):
        assert cluster.nmi(u, v) == pytest.approx(nmi(u, v), abs=1e-12)
