"""The port's t-SNE (`cluster/tsne_torch.py`, `cluster/tsne.py`) against
the JAX package's (`cluster/tsne_jax.py`, `cluster/tsne.py`) on the CPU,
from the same seeded numpy inputs, JAX dots at float32 precision.

Tolerances, each stated at its test: squared distances and P within
rtol 1e-5 / atol 1e-12 with pad rows exactly 0 (float32 sums in another
order); the optimiser from the JAX package's P and y0, 5 iterations
from iteration 0 and from iteration 248 (across the switch of
exaggeration and momentum at 250), y within rtol 1e-3 / atol 1e-6 and
the KL within rtol 1e-3 (the JAX package's own chunked-against-dense
tolerances, tests/test_cluster.py); the k-NN placement within atol 1e-5
with the same landmark indices; the blobs' structure at NMI > 0.95; the
sklearn backend bit for bit.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.cluster import KMeans
from sklearn.metrics import normalized_mutual_info_score as nmi

from spectrogram_cube_clustering_tpu_torch import cluster
from torch_train_common import (  # noqa: F401 (fixtures)
    one_openmp_thread,
    one_torch_thread,
)

# the modules, not the functions of the same names that the cluster
# packages export
J = importlib.import_module("spectrogram_cube_clustering_tpu.cluster.tsne_jax")
jtsne = importlib.import_module("spectrogram_cube_clustering_tpu.cluster.tsne")
T = importlib.import_module(
    "spectrogram_cube_clustering_tpu_torch.cluster.tsne_torch")
ttsne = importlib.import_module(
    "spectrogram_cube_clustering_tpu_torch.cluster.tsne")

CPU = torch.device("cpu")
M, D = 150, 6  # not a multiple of either chunk: exercises the padding
SHARP = dict(rtol=1e-5, atol=1e-12)
TRAJ = dict(rtol=1e-3, atol=1e-6)


def _f32():
    return jax.default_matmul_precision("float32")


def _x(seed=0, m=M, d=D):
    return np.random.default_rng(seed).normal(size=(m, d)).astype(np.float32)


def _blobs(rng, m, k=4, d=10):
    """tests/test_cluster.py's blobs: k centres 8 apart in d dimensions."""
    centers = rng.normal(size=(k, d)) * 8
    y = rng.integers(0, k, m)
    return (centers[y] + rng.normal(size=(m, d))).astype(np.float32), y


def _jax_p(x, chunk):
    with _f32():
        return np.array(J._joint_p(jnp.asarray(x), jnp.float32(5.0),
                                   chunk=chunk))


def test_pairwise_sq_matches_jax():
    x = _x()
    with _f32():
        want = np.asarray(J._pairwise_sq(jnp.asarray(x)))
    got = T._pairwise_sq(torch.from_numpy(x)).numpy()
    off = ~np.eye(M, dtype=bool)
    np.testing.assert_allclose(got[off], want[off], **SHARP)
    # the diagonal is |x|^2 - 2 x.x + |x|^2: cancellation, whose residue is
    # a few float32 ulps of |x|^2 on either side (the callers overwrite
    # it: +inf in P's rows, 0 in the Student-t numerators)
    ulp = np.spacing(np.float32(np.max(np.sum(x * x, axis=1))))
    np.testing.assert_allclose(np.diag(got), np.diag(want), rtol=0,
                               atol=4 * ulp)


@pytest.mark.parametrize("chunk", [64, 256])
def test_joint_p_matches_jax(chunk):
    """P row-padded to the chunk, pad rows exactly 0, within rtol 1e-5."""
    x = _x()
    want = _jax_p(x, chunk)
    got = T._joint_p(torch.from_numpy(x), 5.0, chunk=chunk).numpy()
    assert got.shape == want.shape == (-(-M // chunk) * chunk, M)
    np.testing.assert_array_equal(got[M:], 0.0)
    np.testing.assert_allclose(got, want, **SHARP)
    np.testing.assert_array_equal(got[:M], got[:M].T)  # symmetric


def _jax_carry(p, y0, n, iter0=0, carry=None):
    carry = carry or (jnp.asarray(y0), jnp.zeros_like(jnp.asarray(y0)),
                      jnp.ones_like(jnp.asarray(y0)))
    with _f32():
        out, kls = J._optimize_segment(
            jnp.asarray(p), carry, jnp.int32(iter0), jnp.float32(10.0),
            jnp.float32(12.0), n, chunk=64)
    return out, np.asarray(kls)


@pytest.mark.parametrize("iter0", [0, 248])
def test_optimize_matches_jax(iter0):
    """5 iterations from the JAX package's P and y0; from 248 they start
    from JAX's carry after 5 iterations and cross iteration 250, where the
    exaggeration ends and the momentum goes from 0.5 to 0.8."""
    p = _jax_p(_x(), 64)
    with _f32():
        y0 = np.asarray(1e-4 * jax.random.normal(jax.random.key(0), (M, 2),
                                                 jnp.float32))
    start = None
    if iter0:
        start, _ = _jax_carry(p, y0, 5)
    want, want_kl = _jax_carry(p, y0, 5, iter0, start)
    carry = tuple(torch.from_numpy(np.array(c)) for c in (
        start or (y0, np.zeros_like(y0), np.ones_like(y0))))
    got, got_kl = T._optimize(torch.from_numpy(p), carry, iter0, 10.0, 12.0,
                              5, chunk=64, with_kl=True)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TRAJ)
    np.testing.assert_allclose(got_kl.numpy(), want_kl, rtol=1e-3)
    if iter0:  # the KL drops once the exaggeration of P ends
        assert got_kl[2] < 0.5 * got_kl[1]
    # y does not depend on whether the KL is computed
    same, kl = T._optimize(torch.from_numpy(p), carry, iter0, 10.0, 12.0, 5,
                           chunk=64)
    assert kl is None
    np.testing.assert_array_equal(same[0].numpy(), got[0].numpy())


def test_tsne_torch_matches_tsne_jax_from_the_same_y0(monkeypatch):
    """The whole exact path (defaults, chunk rule, P, 5 iterations) from
    the JAX package's y0: the one difference between the two functions is
    where y0 comes from."""
    x = _x(1)
    with _f32():
        y0 = 1e-4 * jax.random.normal(jax.random.key(7), (M, 2), jnp.float32)
        want = J.tsne_jax(x, n_iter=5, seed=7)
    monkeypatch.setattr(T, "initial_embedding",
                        lambda m, seed, device: torch.from_numpy(
                            np.array(y0)).to(device))
    got = T.tsne_torch(x, n_iter=5, seed=7, device=CPU)
    np.testing.assert_allclose(got, want, **TRAJ)
    assert T.chunk_rows(M) == 256 and T.chunk_rows(30000) == 4096
    assert T.default_hyperparameters(M) == (2.0, 12.5)
    assert T.default_hyperparameters(30000) == (300.0, 2500.0)


def test_initial_embedding_is_seeded_on_the_cpu():
    y0 = T.initial_embedding(100, 2009, CPU)
    assert y0.dtype == torch.float32 and y0.shape == (100, 2)
    want = 1e-4 * torch.randn((100, 2),
                              generator=torch.Generator().manual_seed(2009))
    torch.testing.assert_close(y0, want, rtol=0, atol=0)


def test_knn_interp_chunk_matches_jax():
    rng = np.random.default_rng(3)
    x_chunk = rng.normal(size=(300, D)).astype(np.float32)
    land = rng.normal(size=(60, D)).astype(np.float32)
    y_land = rng.normal(size=(60, 2)).astype(np.float32)
    with _f32():
        want = np.asarray(J._knn_interp_chunk(
            jnp.asarray(x_chunk), jnp.asarray(land), jnp.asarray(y_land), 10))
    got = T._knn_interp_chunk(torch.from_numpy(x_chunk),
                              torch.from_numpy(land),
                              torch.from_numpy(y_land), 10).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_landmark_indices_and_placement_match_jax(monkeypatch):
    """Both landmark paths pick the same seeded subsample and place the
    other points alike, given the same landmark embedding (a stand-in for
    the exact t-SNE on both sides)."""
    x = _x(4, m=900)
    seen = {}

    def fake(name):
        def exact(data, **kw):
            seen[name] = np.array(data)
            return np.ascontiguousarray(data[:, :2] * 3.0)
        return exact

    monkeypatch.setattr(J, "tsne_jax", fake("jax"))
    monkeypatch.setattr(T, "tsne_torch", fake("torch"))
    with _f32():
        want = J.tsne_jax_landmark(x, n_landmarks=200, seed=11, chunk=256)
    got = T.tsne_torch_landmark(x, n_landmarks=200, seed=11, chunk=256,
                                device=CPU)
    np.testing.assert_array_equal(seen["torch"], seen["jax"])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("m,max_samples", [(400, 30000), (3000, 800)],
                         ids=["exact", "landmark"])
def test_tsne_torch_recovers_blob_structure(m, max_samples):
    """tests/test_cluster.py's blob tests: the exact path at M = 400, and
    above `max_samples` the landmark path."""
    x, y = _blobs(np.random.default_rng(2009), m)
    emb = cluster.tsne_torch(x, n_iter=500, max_samples=max_samples,
                             device=CPU)
    assert emb.shape == (m, 2) and emb.dtype == np.float32
    assert np.isfinite(emb).all()
    lab = KMeans(4, n_init=10, random_state=0).fit_predict(emb)
    assert nmi(y, lab) > 0.95


def test_landmark_small_m_falls_back_to_exact():
    x = _x(5, m=120, d=5)
    a = cluster.tsne_torch_landmark(x, n_landmarks=200, n_iter=250,
                                    device=CPU)
    b = cluster.tsne_torch(x, max_samples=120, n_iter=250, device=CPU)
    np.testing.assert_array_equal(a, b)
    with pytest.raises(TypeError, match="n_landmarks"):
        cluster.tsne_torch_landmark(x, max_samples=10, device=CPU)


def test_tsne_torch_defaults_to_the_card(monkeypatch):
    """No device means the card, and without one the call raises: there
    is no quiet CPU fallback."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cluster.tsne_torch(_x())


def test_sklearn_backend_bit_equal_to_jax_packages():
    x = _x(6, m=80)
    np.testing.assert_array_equal(ttsne.tsne(x, n_iter=250),
                                  jtsne.tsne(x, n_iter=250))
