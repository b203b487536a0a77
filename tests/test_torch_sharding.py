"""Sharded training of the port against the JAX package's and against the
port's single process, on the CPU (the counterpart of tests/
test_sharding.py): AEC and DEC epochs, parity and packed, over
device-resident batches and over the streaming loader (float32, bfloat16
and int8 wires), the loss of a padded batch whose ranks hold different
counts of real samples, and the ranks' equality.

The port runs as 2 gloo processes started once for the module
(`_rank_main`); the JAX side runs in the test process on 2 of the 8
forced CPU devices (tests/conftest.py), and so does the port's single
process, all from the same windows and the same JAX initial params
(carried by `utils.weights.state_dict_from_jax_params`). Tolerances,
JAX's own (tests/test_sharding.py), each stated at its test: AEC losses
rtol 1e-4, params rtol 1e-3 with atol 1e-5 (packed 5e-5: its larger
matmuls reorder more sums, and Adam amplifies the noise where v is
tiny); DEC labels NMI > 0.99 and histories rtol 1e-3; the uneven batch's
loss and gradients at rtol 1e-5 of the single process's.

This file imports no jax at its top: the rank processes import it for
`_rank_main`, and a jax import would add seconds to each.
"""

import os

import numpy as np
import pytest
import torch

from spectrogram_cube_clustering_tpu_torch import core, data, models, train
from spectrogram_cube_clustering_tpu_torch.core.mesh import DataMesh
from spectrogram_cube_clustering_tpu_torch.train import aec as taec

WORLD = 2
BATCH = 64
STREAM_M = 250  # the stream runs' windows: a last batch of 58 rows
ITEMS = 24      # windows an item (the last 10): some straddle the blocks
WIRES = (None, "bfloat16", "int8")
RANK_TIMEOUT = 400  # seconds for the rank processes
AEC_TOL = {"AEC": dict(rtol=1e-3, atol=1e-5),
           "packed": dict(rtol=1e-3, atol=5e-5)}
# the DEC runs start from one given init (`_initial`): k-means++ draws
# from torch's and JAX's generators differ, and on these windows'
# untrained latents they find different partitions; the init through
# the mesh is held separately
# (`test_ranks_bit_equal_after_init_and_refresh`)
DEC_CFG = dict(n_clusters=3, tol=0.0, init="load")
KMEANS_CFG = dict(n_clusters=3, tol=0.0, init="kmeans", kmeans_n_init=4,
                  kmeans_max_iter=50)


def _model(kind: str, arch: str, sd: dict):
    """A port model on the CPU holding `sd`."""
    if kind == "AEC":
        model = (models.AEC if arch == "AEC" else models.PackedAEC)(
            device="cpu")
    else:
        model = (models.DEC if arch == "AEC" else models.PackedDEC)(
            n_clusters=3, device="cpu")
    model.load_state_dict(sd)
    return model


def _params(model) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _aec_ram(x, sd, arch, mesh=None) -> dict:
    model = _model("AEC", arch, sd)
    state = train.create_train_state(model, 1e-3, mesh)
    out = train.train_aec(model, state,
                          train.make_batched_data(x, BATCH, mesh), None,
                          train.AECConfig(n_epochs=3, early_stopping=False))
    return {"losses": out["history"]["train"], "params": _params(model)}


def _initial(x, sd, arch):
    """(labels, centroids) of a seeded k-means on the DEC's latents of
    `x`, on one process."""
    from spectrogram_cube_clustering_tpu_torch import cluster

    model = _model("DEC", arch, sd)
    z = train.full_eval(model, train.make_batched_data(x, BATCH))[2]
    labels, centroids = cluster.kmeans(z, 3, n_init=4, max_iter=50,
                                       seed=2009)
    return labels.numpy(), centroids.numpy()


def _dec_ram(x, sd, arch, initial, mesh=None) -> dict:
    model = _model("DEC", arch, sd)
    out = train.train_dec(model, train.create_train_state(model, 5e-4, mesh),
                          train.make_batched_data(x, BATCH, mesh),
                          train.DECConfig(n_epochs=2, **DEC_CFG),
                          initial=initial)
    return {"labels": out["labels"], "history": out["history"]["total"]}


def _items(x):
    return [x[i:i + ITEMS] for i in range(0, len(x), ITEMS)]


def _loader_factory(x, mesh, wire=None):
    items = _items(x)
    return lambda: data.PrefetchLoader(
        lambda i: items[i], len(items), BATCH, num_workers=2,
        transfer_dtype=wire, device="cpu", sharding=mesh,
        item_windows=[len(it) for it in items])


def _aec_stream(x, sd, wire, mesh=None) -> dict:
    model = _model("AEC", "AEC", sd)
    out = train.train_aec_stream(
        model, train.create_train_state(model, 1e-3, mesh),
        _loader_factory(x, mesh, wire),
        train.AECConfig(n_epochs=2, early_stopping=False))
    return {"losses": out["history"]["train"], "params": _params(model)}


def _dec_stream(x, sd, initial, mesh=None) -> dict:
    model = _model("DEC", "AEC", sd)
    out = train.train_dec_stream(
        model, train.create_train_state(model, 5e-4, mesh),
        _loader_factory(x, mesh), len(x),
        train.DECConfig(n_epochs=2, **DEC_CFG), initial=initial)
    return {"labels": out["labels"], "history": out["history"]["total"]}


class _Recorder:
    """An optimizer stand-in for `TrainState`: keeps each step's
    gradients (after the state summed them over the ranks) and leaves the
    params as they are."""

    def __init__(self, params):
        self.params = list(params)
        self.grads = []

    def step(self):
        self.grads.append([p.grad.clone() for p in self.params])

    def zero_grad(self, set_to_none=True):
        for p in self.params:
            p.grad = None


def _uneven(x, sd, mesh=None) -> dict:
    """One epoch over 100 windows in batches of 64: the last batch holds
    36 real rows, all 32 of rank 0's block and 4 of rank 1's. Returns the
    epoch loss and each step's gradients as the state sums them, and,
    under a mesh, the last batch's loss and gradients as DDP forms them:
    each rank's mean over its own real rows, averaged over the ranks."""
    model = _model("AEC", "AEC", sd)
    opt = _Recorder(model.parameters())
    batches = train.make_batched_data(x[:100], BATCH, mesh)
    loss = taec.train_epoch(
        train.TrainState(model=model, optimizer=opt, mesh=mesh), batches)
    out = {"loss": loss, "grads": opt.grads}
    if mesh is not None:
        mask = batches.mask[1]
        local = taec._batch_loss(model, batches.x[1], mask,
                                 torch.clamp(mask.sum(), min=1.0),
                                 core.DEFAULT)
        local.backward()
        out["ddp_loss"] = float(mesh.sum_(local.detach())) / mesh.world
        out["ddp_grads"] = [mesh.sum_(p.grad) / mesh.world
                            for p in model.parameters()]
    return out


def _checksums(mesh, tensors: dict) -> torch.Tensor:
    """Every rank's (bit pattern . position) checksum of each tensor, as
    (world, n) int64: equal rows mean bit-equal tensors (up to a
    collision)."""
    sums = []
    for t in tensors.values():
        t = t.detach().contiguous().reshape(-1)
        bits = (t.view(torch.int32) if t.dtype == torch.float32
                else t).to(torch.int64)
        sums.append((bits * torch.arange(1, len(bits) + 1)).sum())
    return mesh.gather(torch.stack(sums))


def _rank_equality(x, sd, mesh) -> dict:
    """The k-means cluster init through the mesh (its labels, and their
    and the centroids' checksums on every rank), then the checksums of
    the params and the Adam state after one DEC epoch, which holds one
    refresh."""
    model = _model("DEC", "AEC", sd)
    batches = train.make_batched_data(x, BATCH, mesh)
    cfg = train.DECConfig(n_epochs=1, **KMEANS_CFG)
    labels, centroids = train.initialize_clusters(model, batches, cfg)
    init = _checksums(mesh, {"labels": labels, "centroids": centroids})
    state = train.create_train_state(model, 5e-4, mesh)
    out = train.train_dec(model, state, batches, cfg)
    adam = {f"{i}.{k}": v for i, s in enumerate(
        state.optimizer.state_dict()["state"].values())
        for k, v in s.items()}
    return {"labels": labels, "init": init,
            "refreshes": len(out["deltas"]["delta"]),
            "after": _checksums(mesh, {**model.state_dict(), **adam})}


def _rank_main(rank: int, world: int, port: int, out_dir: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    core.initialize_distributed(f"127.0.0.1:{port}", world, rank,
                                device="cpu")
    mesh = core.make_data_mesh()
    x = np.load(os.path.join(out_dir, "x.npy"))
    sds = torch.load(os.path.join(out_dir, "sds.pt"))
    initial = torch.load(os.path.join(out_dir, "initial.pt"),
                         weights_only=False)
    layout = train.make_batched_data(x[:STREAM_M], BATCH, mesh)
    out = {"layout": (layout.x, layout.mask, layout.counts,
                      train.fetch_global(layout.x, mesh, axis=1))}
    for arch in ("AEC", "packed"):
        out["aec", arch] = _aec_ram(x, sds["aec", arch], arch, mesh)
        out["dec", arch] = _dec_ram(x, sds["dec", arch], arch,
                                    initial[arch], mesh)
    out["uneven"] = _uneven(x, sds["aec", "AEC"], mesh)
    out["equal"] = _rank_equality(x, sds["dec", "AEC"], mesh)
    for wire in WIRES:
        out["stream", wire] = _aec_stream(x[:STREAM_M], sds["aec", "AEC"],
                                          wire, mesh)
    out["dec_stream"] = _dec_stream(x[:STREAM_M], sds["dec", "AEC"],
                                    initial["stream"], mesh)
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


def _jax_side(x, jparams, initial):
    """JAX's sharded runs on a 2-device mesh (tests/test_sharding.py's,
    from the same params)."""
    import jax
    import jax.numpy as jnp

    import spectrogram_cube_clustering_tpu as scc
    from spectrogram_cube_clustering_tpu.data import PrefetchLoader

    mesh = scc.core.make_data_mesh(jax.devices()[:WORLD])
    rep = scc.core.replicated_sharding(mesh)
    ref = {}

    def state(model, params, lr):
        st = scc.train.create_train_state(model, jax.random.key(0),
                                          jnp.asarray(x[:2]), lr=lr)
        return jax.device_put(st.replace(params=params), rep)

    for arch in ("AEC", "packed"):
        jm = scc.models.AEC() if arch == "AEC" else scc.models.PackedAEC()
        out = scc.train.train_aec(
            jm, state(jm, jparams["aec", arch], 1e-3),
            scc.train.make_batched_data(x, BATCH, mesh=mesh), None,
            scc.train.AECConfig(n_epochs=3, early_stopping=False))
        ref["aec", arch] = (out["history"]["train"], out["state"].params)
        jm = (scc.models.DEC(n_clusters=3) if arch == "AEC"
              else scc.models.PackedDEC(n_clusters=3))
        out = scc.train.train_dec(
            jm, state(jm, jparams["dec", arch], 5e-4),
            scc.train.make_batched_data(x, BATCH, mesh=mesh),
            scc.train.DECConfig(n_epochs=2, **DEC_CFG),
            initial=initial[arch])
        ref["dec", arch] = out["labels"]
    xs = x[:STREAM_M]
    items = _items(xs)

    def make_loader():
        return PrefetchLoader(lambda i: items[i], len(items), BATCH,
                              num_workers=2,
                              sharding=scc.core.batch_sharding(mesh, 4))

    jm = scc.models.AEC()
    out = scc.train.train_aec_stream(
        jm, state(jm, jparams["aec", "AEC"], 1e-3), make_loader,
        scc.train.AECConfig(n_epochs=2, early_stopping=False))
    ref["stream"] = (out["history"]["train"], out["state"].params)
    jm = scc.models.DEC(n_clusters=3)
    out = scc.train.train_dec_stream(
        jm, state(jm, jparams["dec", "AEC"], 5e-4), make_loader, len(xs),
        scc.train.DECConfig(n_epochs=2, **DEC_CFG),
        initial=initial["stream"])
    ref["dec_stream"] = out["labels"]
    return ref


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(each rank's outputs, the port's single-process outputs, the JAX
    side's, the windows)."""
    import jax
    import jax.numpy as jnp

    import spectrogram_cube_clustering_tpu as scc
    from spectrogram_cube_clustering_tpu_torch.utils.weights import (
        state_dict_from_jax_params,
    )
    from torch_train_common import start_ranks, wait_ranks

    out_dir = str(tmp_path_factory.mktemp("ranks"))
    x, _ = scc.data.synthetic_windows(256, n_classes=3, seed=11)
    x = np.asarray(scc.ops.sample_norm_cent(jnp.asarray(x)))
    jparams = {}
    for arch in ("AEC", "packed"):
        aec = scc.models.AEC() if arch == "AEC" else scc.models.PackedAEC()
        dec = (scc.models.DEC(n_clusters=3) if arch == "AEC"
               else scc.models.PackedDEC(n_clusters=3))
        jparams["aec", arch] = jax.device_get(
            aec.init(jax.random.key(0), jnp.asarray(x[:2]))["params"])
        jparams["dec", arch] = jax.device_get(
            dec.init(jax.random.key(1), jnp.asarray(x[:2]))["params"])
    sds = {k: state_dict_from_jax_params(v) for k, v in jparams.items()}
    initial = {arch: _initial(x, sds["dec", arch], arch)
               for arch in ("AEC", "packed")}
    initial["stream"] = _initial(x[:STREAM_M], sds["dec", "AEC"], "AEC")
    np.save(os.path.join(out_dir, "x.npy"), x)
    torch.save(sds, os.path.join(out_dir, "sds.pt"))
    torch.save(initial, os.path.join(out_dir, "initial.pt"))
    procs = start_ranks("test_torch_sharding", WORLD, out_dir)
    try:
        n = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            single = {}
            for arch in ("AEC", "packed"):
                single["aec", arch] = _aec_ram(x, sds["aec", arch], arch)
                single["dec", arch] = _dec_ram(x, sds["dec", arch], arch,
                                               initial[arch])
            single["uneven"] = _uneven(x, sds["aec", "AEC"])
            for wire in WIRES:
                single["stream", wire] = _aec_stream(
                    x[:STREAM_M], sds["aec", "AEC"], wire)
            single["dec_stream"] = _dec_stream(
                x[:STREAM_M], sds["dec", "AEC"], initial["stream"])
            model = _model("DEC", "AEC", sds["dec", "AEC"])
            single["init_labels"] = train.initialize_clusters(
                model, train.make_batched_data(x, BATCH),
                train.DECConfig(**KMEANS_CFG))[0]
        finally:
            torch.set_num_threads(n)
        with jax.default_matmul_precision("float32"):
            ref = _jax_side(x, jparams, initial)
    finally:
        wait_ranks(procs, RANK_TIMEOUT)
    ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                        weights_only=False) for r in range(WORLD)]
    return ranks, single, ref, x


def _nmi(a, b) -> float:
    from sklearn.metrics import normalized_mutual_info_score

    return normalized_mutual_info_score(np.asarray(a), np.asarray(b))


def _assert_params(got: dict, want: dict, **tol):
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), **tol,
                                   err_msg=k)


def test_layout_blocks_are_the_single_layout(runs):
    """Each rank holds its block of axis 1 of the single layout, with the
    global counts; `fetch_global` gives every rank the whole of it."""
    ranks, _, _, x = runs
    whole = train.make_batched_data(x[:STREAM_M], BATCH)
    for rank, r in enumerate(ranks):
        xb, mask, counts, fetched = r["layout"]
        lo, hi = rank * BATCH // WORLD, (rank + 1) * BATCH // WORLD
        assert torch.equal(xb, whole.x[:, lo:hi])
        assert torch.equal(mask, whole.mask[:, lo:hi])
        assert torch.equal(counts, whole.counts)
        assert torch.equal(fetched, whole.x)
    assert whole.counts.tolist() == [64, 64, 64, 58]


@pytest.mark.parametrize("arch", ["AEC", "packed"])
def test_aec_matches_jax_sharded_and_single_process(runs, arch):
    """Three epochs over 2 ranks: losses rtol 1e-4 against JAX's 2-device
    run and the port's one process, params (JAX's tolerances) against the
    port's one process and, for the parity AEC, JAX's run; both ranks end
    bit-equal. The packed AEC's params are not held across frameworks
    (ROADMAP Queue 3's Adam-drift rule: its first conv lands up to 2.1e-4
    from JAX's on these windows, as it does on one device,
    tests/test_torch_arch_train.py)."""
    from torch_train_common import _sd

    ranks, single, ref, _ = runs
    got = ranks[0]["aec", arch]
    want_losses, want_params = ref["aec", arch]
    for other in (np.asarray(want_losses), single["aec", arch]["losses"]):
        np.testing.assert_allclose(got["losses"], other, rtol=1e-4)
    if arch == "AEC":
        _assert_params(got["params"], _sd(want_params), **AEC_TOL[arch])
    _assert_params(got["params"], single["aec", arch]["params"],
                   **AEC_TOL[arch])
    _assert_params(ranks[1]["aec", arch]["params"], got["params"], rtol=0,
                   atol=0)


@pytest.mark.parametrize("arch", ["AEC", "packed"])
def test_dec_matches_jax_sharded_and_single_process(runs, arch):
    """Two DEC epochs from one given init over 2 ranks: labels NMI > 0.99
    against JAX's 2-device run and the port's one process (whose history
    it follows within rtol 1e-3); both ranks' labels equal."""
    ranks, single, ref, _ = runs
    got = ranks[0]["dec", arch]
    np.testing.assert_array_equal(got["labels"], ranks[1]["dec", arch]["labels"])
    assert _nmi(got["labels"], ref["dec", arch]) > 0.99
    assert _nmi(got["labels"], single["dec", arch]["labels"]) > 0.99
    np.testing.assert_allclose(got["history"],
                               single["dec", arch]["history"], rtol=1e-3)


def test_uneven_padded_batch_sums_instead_of_averaging(runs):
    """On the padded last batch rank 0 holds 32 real rows and rank 1 holds
    4. The sharded loss and gradients (each rank's masked sum over the
    global count, summed) equal the single process's at rtol 1e-5; DDP's
    mean over ranks is not."""
    ranks, single, _, _ = runs
    want = single["uneven"]
    for r in ranks:
        got = r["uneven"]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        assert len(got["grads"]) == len(want["grads"]) == 2
        for step_got, step_want in zip(got["grads"], want["grads"]):
            for g, w in zip(step_got, step_want):
                np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                           atol=1e-9)
        # the DDP-style mean misses the single process's last step
        ddp = np.concatenate([g.reshape(-1).numpy()
                              for g in got["ddp_grads"]])
        flat = np.concatenate([g.reshape(-1).numpy()
                               for g in want["grads"][1]])
        assert not np.allclose(ddp, flat, rtol=1e-3, atol=1e-6)


def test_ranks_bit_equal_after_init_and_refresh(runs):
    """After a k-means `initialize_clusters` on the gathered latents, and
    after a DEC epoch holding one refresh, both ranks hold bit-equal
    labels and centroids, then params and Adam moments (their checksums
    gathered with the mesh's sum); the init's labels are the single
    process's (NMI > 0.99: the ranks' latents come from other batch
    shapes)."""
    ranks, single = runs[0], runs[1]
    assert _nmi(ranks[0]["equal"]["labels"], single["init_labels"]) > 0.99
    for r in ranks:
        assert r["equal"]["refreshes"] == 1
        for key in ("init", "after"):
            sums = r["equal"][key]
            assert sums.shape[0] == WORLD
            assert torch.equal(sums[0], sums[1]), key
    assert torch.equal(ranks[0]["equal"]["after"], ranks[1]["equal"]["after"])


@pytest.mark.parametrize("wire", WIRES)
def test_aec_stream_matches_single_process_and_jax(runs, wire):
    """Two stream epochs over 2 ranks, each reading its blocks of ragged
    items: losses rtol 1e-4 and params against the port's one process on
    the same wire (a rank's int8 scales are its own samples'), and for
    float32 also against JAX's 2-device stream run."""
    from torch_train_common import _sd

    ranks, single, ref, _ = runs
    got = ranks[0]["stream", wire]
    want = single["stream", wire]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4)
    _assert_params(got["params"], want["params"], **AEC_TOL["AEC"])
    if wire is None:
        np.testing.assert_allclose(got["losses"], np.asarray(ref["stream"][0]),
                                   rtol=1e-4)
        _assert_params(got["params"], _sd(ref["stream"][1]),
                       **AEC_TOL["AEC"])


def test_dec_stream_matches_single_process_and_jax(runs):
    ranks, single, ref, _ = runs
    got = ranks[0]["dec_stream"]
    np.testing.assert_array_equal(got["labels"],
                                  ranks[1]["dec_stream"]["labels"])
    assert _nmi(got["labels"], single["dec_stream"]["labels"]) > 0.99
    assert _nmi(got["labels"], ref["dec_stream"]) > 0.99
    np.testing.assert_allclose(got["history"],
                               single["dec_stream"]["history"], rtol=1e-3)


def _counting_items(x):
    items, reads = _items(x), []

    def item_fn(i):
        reads.append(i)
        return items[i]

    return items, item_fn, reads


@pytest.mark.parametrize("wire", WIRES)
def test_loader_blocks_and_reads(wire):
    """Without collectives: each rank's loader yields its block of every
    batch of the single loader, with the global n_valid, and reads only
    the items its blocks hold (item 0, windows 0-23, lies in rank 0's
    block alone)."""
    x = np.random.default_rng(0).normal(size=(STREAM_M, 4, 101, 1)).astype(
        np.float32)
    items, item_fn, _ = _counting_items(x)
    whole = list(data.PrefetchLoader(item_fn, len(items), BATCH,
                                     num_workers=2, transfer_dtype=wire,
                                     device="cpu"))
    for rank in range(WORLD):
        mesh = DataMesh(rank=rank, world=WORLD, device=torch.device("cpu"))
        _, item_fn, reads = _counting_items(x)
        got = list(data.PrefetchLoader(
            item_fn, len(items), BATCH, num_workers=2, transfer_dtype=wire,
            sharding=mesh, item_windows=[len(it) for it in items]))
        assert [n for _, n in got] == [n for _, n in whole] == [64, 64, 64, 58]
        lo, hi = mesh.block(BATCH)
        for (b, _), (w, _) in zip(got, whole):
            for k in (b if isinstance(b, dict) else {"": b}):
                gb = b[k] if k else b
                wb = w[k] if k else w
                assert torch.equal(gb, wb[lo:hi]), (rank, k)
        needed = {i for i in range(len(items))
                  if any(lo <= g % BATCH < hi
                         for g in range(ITEMS * i, ITEMS * i + len(items[i])))}
        assert set(reads) == needed
        assert needed != set(range(len(items)))


def test_refusals_before_any_collective():
    """The JAX package's refusals (tests/test_sharding.py:288-300): a
    stream batch and a layout batch that do not divide over the mesh."""
    from spectrogram_cube_clustering_tpu_torch.workflow.train import (
        _stream_sharding,
    )

    mesh = DataMesh(rank=0, world=WORLD, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="divisible"):
        _stream_sharding(None, mesh, 63)
    assert _stream_sharding(None, mesh, 64) is mesh
    assert _stream_sharding(None, None, 63) is None
    with pytest.raises(ValueError, match="divide evenly"):
        train.make_batched_data(np.zeros((4, 4, 101, 1), np.float32), 63,
                                mesh=mesh)
