"""The port's data mesh and `parallel` module against the JAX package's, on
the CPU: the mesh and its collectives, `halo_exchange_1d`, the
time-sharded STFT on K1's plain version, and the sharded k-means / GMM.

The port runs as 2 and 4 gloo processes, each started once for the whole
module (`_rank_main`, `torch_train_common.start_ranks`); the JAX side
runs in the test process on as many of the 8 forced CPU devices
(tests/conftest.py),
from the same numpy inputs (seed 2009). Tolerances, each stated at its
test: the sharded STFT within 2e-3 (log10) of JAX's kernel path in
interpret mode (tests/test_signal.py) and within 1e-6 of K1's plain
version on the whole waveform (the same per-frame arithmetic); one
k-means / EM step from given centres at rtol 1e-5 of JAX's; full fits,
whose k-means++ seeds differ from JAX's, by NMI (> 0.99) against the
port's dense fits and the planted blobs.

This file imports no jax at its top: the rank processes import it for
`_rank_main`, and a jax import would add seconds to each. The JAX
side imports it inside the fixture.
"""

import os

import numpy as np
import pytest
import torch

from spectrogram_cube_clustering_tpu_torch import core, parallel
from spectrogram_cube_clustering_tpu_torch.core.mesh import DataMesh
from spectrogram_cube_clustering_tpu_torch.signal.stft import (
    spectrogram_plain,
)

WORLDS = (2, 4)
K = 3
T = 3200  # samples: a multiple of world * hop for 2 and 4 ranks
RANK_TIMEOUT = 300  # seconds for the rank processes


def _inputs(seed: int = 2009) -> dict:
    """Blobs far from the origin (the conditioning the centred
    expansions exist for), given centres and mixture, a waveform."""
    rng = np.random.default_rng(seed)
    centres = (rng.normal(size=(K, 9)) * 6 + 20).astype(np.float32)
    truth = rng.integers(0, K, 301)
    z = (centres[truth] + rng.normal(size=(301, 9))).astype(np.float32)
    mask = np.ones(300, np.float32)
    mask[-7:] = 0.0
    return {
        "z": z, "truth": truth, "z_even": z[:300], "mask": mask,
        "centers0": (centres + 0.5).astype(np.float32),
        "weights0": np.asarray([0.3, 0.3, 0.4], np.float32),
        "means0": (centres + 0.3).astype(np.float32),
        "covs0": np.repeat(1.5 * np.eye(9, dtype=np.float32)[None], K, 0),
        "wave": rng.normal(size=(3, T)).astype(np.float32),
    }


def _rank_main(rank: int, world: int, port: int, out_dir: str) -> None:
    """One rank of the port's side: every check's outputs, saved as
    `rank<r>_of<world>.pt`."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    out = {}
    try:
        core.make_data_mesh()
    except RuntimeError as e:
        out["no_group"] = str(e)
    core.initialize_distributed(f"127.0.0.1:{port}", world, rank,
                                device="cpu")
    mesh = core.make_data_mesh()
    inp = dict(np.load(os.path.join(out_dir, "inputs.npz")))
    out["mesh"] = (mesh.rank, mesh.world, str(mesh.device), mesh.block(8))
    out["gather_int"] = mesh.gather(
        torch.tensor([rank, 10 * rank], dtype=torch.int32))
    out["gather_float"] = mesh.gather(torch.full((2, 3), rank + 0.5))
    out["gather_bool"] = mesh.gather(torch.tensor([rank % 2 == 1]))
    out["sum"] = mesh.sum_(torch.full((3,), float(rank + 1)))
    out["broadcast"] = mesh.broadcast_(torch.full((2,), float(rank + 7)))
    mesh.barrier()
    out["multislice"] = core.make_multislice_mesh(2) == mesh
    try:
        core.make_multislice_mesh(3)
    except ValueError as e:
        out["multislice_3"] = str(e)
    out["shard_batch"] = core.shard_batch(mesh, torch.arange(8))
    out["halo"] = parallel.halo_exchange_1d(
        torch.arange(10 * rank, 10 * rank + 6, dtype=torch.float32)
        .reshape(2, 3), 2, mesh, axis=1)
    wave = torch.from_numpy(inp["wave"])
    lo, hi = mesh.block(T)
    out["spec"] = parallel.sharded_spectrogram(wave[:, lo:hi], mesh)
    if world == 2:
        out["km_step"] = parallel.sharded_kmeans_step(
            inp["z_even"], inp["centers0"], mesh)
        out["km_step_mask"] = parallel.sharded_kmeans_step(
            inp["z_even"], inp["centers0"], mesh, mask=inp["mask"])
        out["em_step"] = parallel.sharded_gmm_em_step(
            inp["z_even"], inp["weights0"], inp["means0"], inp["covs0"],
            mesh)
        out["km_full"] = parallel.sharded_kmeans(inp["z"], K, mesh, n_init=4)
        out["gmm_full"] = parallel.sharded_gmm(inp["z"], K, mesh, n_init=4)
    torch.save(out, os.path.join(out_dir, f"rank{rank}_of{world}.pt"))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{world: [each rank's outputs]}, the inputs and the JAX side's."""
    import jax
    from spectrogram_cube_clustering_tpu import parallel as jparallel
    from spectrogram_cube_clustering_tpu.core import make_data_mesh
    from torch_train_common import start_ranks, wait_ranks

    out_dir = str(tmp_path_factory.mktemp("ranks"))
    inp = _inputs()
    np.savez(os.path.join(out_dir, "inputs.npz"), **inp)
    procs = {w: start_ranks("test_torch_parallel", w, out_dir)
             for w in WORLDS}
    try:
        ref = {}
        with jax.default_matmul_precision("float32"):
            for w in WORLDS:
                mesh = make_data_mesh(jax.devices()[:w])
                ref[w, "spec"] = np.asarray(jparallel.sharded_spectrogram(
                    inp["wave"], mesh, use_pallas=True))
            mesh = make_data_mesh(jax.devices()[:2])
            ref["km_step"] = jax.device_get(jparallel.sharded_kmeans_step(
                inp["z_even"], inp["centers0"], mesh))
            ref["km_step_mask"] = jax.device_get(
                jparallel.sharded_kmeans_step(
                    inp["z_even"], inp["centers0"], mesh,
                    mask=inp["mask"]))
            ref["em_step"] = jax.device_get(jparallel.sharded_gmm_em_step(
                inp["z_even"], inp["weights0"], inp["means0"],
                inp["covs0"], mesh))
    finally:
        for w in WORLDS:
            wait_ranks(procs[w], RANK_TIMEOUT)
    got = {w: [torch.load(os.path.join(out_dir, f"rank{r}_of{w}.pt"),
                          weights_only=False) for r in range(w)]
           for w in WORLDS}
    return got, inp, ref


def _nmi(a, b) -> float:
    from sklearn.metrics import normalized_mutual_info_score

    return normalized_mutual_info_score(np.asarray(a), np.asarray(b))


def test_make_data_mesh_needs_a_group(runs):
    """Without a process group the mesh raises, naming the call that makes
    one: in the test process and in every rank before it joined."""
    with pytest.raises(RuntimeError, match="initialize_distributed"):
        core.make_data_mesh()
    for w in WORLDS:
        assert all("initialize_distributed" in r["no_group"]
                   for r in runs[0][w])


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_ranks_and_blocks(runs, world):
    for rank, r in enumerate(runs[0][world]):
        per = 8 // world
        assert r["mesh"] == (rank, world, "cpu",
                             (rank * per, (rank + 1) * per))


@pytest.mark.parametrize("world", WORLDS)
def test_collectives(runs, world):
    """Sum, broadcast (rank 0's) and gather (every rank's slot, exact for
    ints, floats and bools) give every rank the same answer."""
    ranks = np.arange(world)
    for r in runs[0][world]:
        np.testing.assert_array_equal(
            r["gather_int"].numpy(), np.stack([ranks, 10 * ranks], 1))
        assert r["gather_int"].dtype == torch.int32
        np.testing.assert_array_equal(
            r["gather_float"].numpy(),
            np.broadcast_to((ranks + 0.5)[:, None, None], (world, 2, 3)))
        np.testing.assert_array_equal(r["gather_bool"].numpy()[:, 0],
                                      ranks % 2 == 1)
        np.testing.assert_array_equal(r["sum"].numpy(),
                                      np.full(3, ranks.sum() + world))
        np.testing.assert_array_equal(r["broadcast"].numpy(), [7.0, 7.0])


@pytest.mark.parametrize("world", WORLDS)
def test_multislice_mesh(runs, world):
    """The JAX API's multi-slice mesh, the data mesh itself: the world
    splits into 2 slices, not into 3
    (tests/test_sharding.py::test_rejects_uneven_slices)."""
    for r in runs[0][world]:
        assert r["multislice"] is True
        assert "do not split" in r["multislice_3"]


@pytest.mark.parametrize("world", WORLDS)
def test_shard_batch_and_pad_to_multiple(runs, world):
    per = 8 // world
    for rank, r in enumerate(runs[0][world]):
        np.testing.assert_array_equal(r["shard_batch"].numpy(),
                                      np.arange(rank * per, (rank + 1) * per))
    assert [core.pad_to_multiple(n, 4) for n in (0, 1, 4, 5)] == [0, 4, 4, 8]
    mesh = DataMesh(rank=0, world=world, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="pad first"):
        core.shard_batch(mesh, torch.arange(world + 1))


@pytest.mark.parametrize("world", WORLDS)
def test_halo_exchange_1d(runs, world):
    """Each rank's shard gains its right neighbour's first `halo` entries
    along the axis; the last rank gains zeros."""
    for rank, r in enumerate(runs[0][world]):
        mine = np.arange(10 * rank, 10 * rank + 6, dtype=np.float32)
        mine = mine.reshape(2, 3)
        nxt = (np.arange(10 * rank + 10, 10 * rank + 16,
                         dtype=np.float32).reshape(2, 3)[:, :2]
               if rank + 1 < world else np.zeros((2, 2), np.float32))
        np.testing.assert_array_equal(r["halo"].numpy(),
                                      np.concatenate([mine, nxt], 1))


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_spectrogram_matches_jax_kernel_path(runs, world):
    """Every rank's frames against JAX's `sharded_spectrogram(use_pallas=
    True)` on as many devices (its Pallas kernel in interpret mode):
    atol 2e-3 on log10, the kernel contract (tests/test_signal.py)."""
    want = runs[2][world, "spec"]
    for r in runs[0][world]:
        assert r["spec"].shape == want.shape
        np.testing.assert_allclose(r["spec"].numpy(), want, rtol=0,
                                   atol=2e-3)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_spectrogram_matches_k1_plain_whole(runs, world):
    """On every rank, the frames are K1's plain version on the whole
    waveform within 1e-6 (each frame's arithmetic is the same; only the
    float64 sums' blocking could differ)."""
    want = spectrogram_plain(torch.from_numpy(runs[1]["wave"])).numpy()
    for r in runs[0][world]:
        np.testing.assert_allclose(r["spec"].numpy(), want, rtol=0,
                                   atol=1e-6)


def test_sharded_spectrogram_refusals():
    """The JAX package's refusals (tests/test_signal.py:279-300): a length
    that is not a multiple of world * hop, a halo longer than a shard,
    and nperseg not a multiple of hop where K1 runs; each before any
    collective."""
    mesh = DataMesh(rank=0, world=8, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="multiple of mesh"):
        parallel.sharded_spectrogram(torch.zeros(12345 // 8), mesh)
    with pytest.raises(ValueError, match="halo"):
        parallel.sharded_spectrogram(torch.zeros(200), mesh, nperseg=400,
                                     hop=100)
    with pytest.raises(ValueError, match="nperseg % hop"):
        parallel.sharded_spectrogram(torch.zeros(600), mesh, nperseg=250,
                                     hop=150)


def _rank_rows(outs, key, i=0):
    return np.concatenate([np.asarray(r[key][i]) for r in outs])


@pytest.mark.parametrize("key", ["km_step", "km_step_mask"])
def test_sharded_kmeans_step_matches_jax(runs, key):
    """One Lloyd step from given centres over 2 ranks, with and without a
    mask: the centres within rtol 1e-5 of JAX's and equal on both ranks,
    the labels (the ranks' blocks in order) equal to JAX's."""
    outs, _, ref = runs[0][2], runs[1], runs[2]
    np.testing.assert_array_equal(_rank_rows(outs, key), ref[key][0])
    for r in outs:
        np.testing.assert_allclose(r[key][1].numpy(), ref[key][1],
                                   rtol=1e-5, atol=0)
    np.testing.assert_array_equal(outs[0][key][1].numpy(),
                                  outs[1][key][1].numpy())


def test_sharded_gmm_em_step_matches_jax(runs):
    """One EM step from a given mixture over 2 ranks: weights, means and
    the mean log-likelihood within rtol 1e-5 of JAX's; the covariances
    within 1e-5 of each matrix's largest entry (their off-diagonal
    entries near 0 carry float32 sums' rounding, ~4e-6 of the largest,
    that no elementwise rtol holds)."""
    ref = runs[2]["em_step"]
    for r in runs[0][2]:
        w, mu, cov, lb = (t.numpy() for t in r["em_step"])
        for got, want in ((w, ref[0]), (mu, ref[1]), (lb, ref[3])):
            np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5,
                                       atol=0)
        want = np.asarray(ref[2])
        scale = np.abs(want).max(axis=(1, 2), keepdims=True)
        assert np.all(np.abs(cov - want) <= 1e-5 * scale)


@pytest.mark.parametrize("fit", ["km_full", "gmm_full"])
def test_sharded_fits_match_dense_fits(runs, fit):
    """The full sharded k-means and GMM on 301 rows (ragged over 2 ranks):
    the same labels and centres on both ranks, NMI > 0.99 against the
    port's dense fit and the planted blobs. (Their steps are held to
    JAX's above; JAX's full sharded fits take over a minute to compile
    and run on the CPU mesh, and their k-means++ seeds differ from the
    port's anyway.)"""
    from spectrogram_cube_clustering_tpu_torch import cluster

    outs, inp = runs[0][2], runs[1]
    labels = outs[0][fit][0].numpy()
    assert labels.shape == (301,) and labels.dtype == np.int32
    for i in (0, 1):
        np.testing.assert_array_equal(outs[0][fit][i].numpy(),
                                      outs[1][fit][i].numpy())
    dense = (cluster.kmeans if fit == "km_full" else cluster.gmm)(
        inp["z"], K, n_init=4, device="cpu")[0]
    for other in (dense.numpy(), inp["truth"]):
        assert _nmi(labels, other) > 0.99


def test_sharded_steps_refuse_uneven_rows():
    """The step functions take rows that divide over the mesh (the full
    fits pad): refused before any collective."""
    mesh = DataMesh(rank=0, world=2, device=torch.device("cpu"))
    z = np.zeros((5, 9), np.float32)
    with pytest.raises(ValueError, match="divide"):
        parallel.sharded_kmeans_step(z, z[:3], mesh)
    with pytest.raises(ValueError, match="divide"):
        parallel.sharded_gmm_em_step(z, np.ones(3) / 3, z[:3],
                                     np.repeat(np.eye(9)[None], 3, 0), mesh)
