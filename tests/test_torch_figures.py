"""The port's figures against the JAX package's on the CPU.

- Each copied plotting function (`analysis/plotting.py`) on the same
  seeded inputs gives the same Agg RGBA buffer as the JAX package's at a
  small dpi, the empty-class case of tests/test_analysis.py included;
  `fractional_distance` and `distance_matrix` (`utils/mathutils.py`)
  give equal arrays.
- With matplotlib or scikit-learn blocked, `run-dc` with figures raises
  ImportError naming the package before it writes anything.

The workflow's figure trees: tests/test_torch_figures_workflow.py.
"""

import io
import os
import subprocess
import sys

import numpy as np
import pytest

from spectrogram_cube_clustering_tpu.analysis import plotting as jplot
from spectrogram_cube_clustering_tpu.utils import mathutils as jmath
from spectrogram_cube_clustering_tpu_torch.analysis import plotting as tplot
from spectrogram_cube_clustering_tpu_torch.utils import mathutils as tmath
from torch_train_common import (  # noqa: F401 (fixtures)
    one_openmp_thread,
    one_torch_thread,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K, D = 4, 9
DPI = 12  # small: the comparison is of the drawing, not its resolution


def _rgba(fig) -> bytes:
    buf = io.BytesIO()
    fig.savefig(buf, format="rgba", dpi=DPI)
    return buf.getvalue()


def _same(got, want):
    """Two figures, or two dicts of figures, render to equal buffers."""
    if isinstance(want, dict):
        assert list(got) == list(want)
        for name in want:
            _same(got[name], want[name])
        return
    a, b = _rgba(got), _rgba(want)
    assert len(a) == len(b) and a == b


def _inputs(empty: bool):
    """z, labels and centroids of a GMM (a) and a DEC (b), windows and
    their decodes; with `empty`, class 2 has no samples in either."""
    rng = np.random.default_rng(2009)
    m = 40
    z_a = rng.normal(size=(m, D)).astype(np.float32)
    z_b = rng.normal(size=(m, D)).astype(np.float32)
    classes = [0, 1, 3] if empty else list(range(K))
    labels_a = rng.choice(classes, size=m)
    labels_b = rng.choice(classes, size=m)
    cents_a = rng.normal(size=(K, D)).astype(np.float32)
    cents_b = rng.normal(size=(K, D)).astype(np.float32)
    x = rng.normal(size=(m, 4, 101, 1)).astype(np.float32)
    decodes = rng.normal(size=(K, 4, 101, 1)).astype(np.float32)
    traces = rng.normal(size=(m, 500)).astype(np.float32)
    tsne = rng.normal(size=(m, 2)).astype(np.float32)
    return dict(z_a=z_a, z_b=z_b, labels_a=labels_a, labels_b=labels_b,
                cents_a=cents_a, cents_b=cents_b, x=x, decodes=decodes,
                traces=traces, tsne=tsne)


CALLS = {
    "view_tsne": lambda p, a: p.view_tsne(a["tsne"], a["labels_b"], "GMM"),
    "view_silhscore": lambda p, a: p.view_silhscore(
        np.linspace(-0.5, 0.9, len(a["labels_b"])), a["labels_b"], K, "DEC"),
    "view_specgram_training": lambda p, a: p.view_specgram_training(
        a["x"][:4], a["x"][4:8], n_samples=4, figtitle="AEC"),
    "view_latent_space": lambda p, a: p.view_latent_space(
        a["z_a"], a["labels_a"], a["z_b"], a["labels_b"], a["cents_a"],
        a["cents_b"]),
    "view_latent_space_single": lambda p, a: p.view_latent_space(
        a["z_b"], a["labels_b"]),
    "view_class_pdf_paper": lambda p, a: p.view_class_pdf_paper(
        a["z_a"], a["z_b"], a["labels_a"], a["labels_b"], a["cents_a"],
        a["cents_b"], K),
    "cluster_gallery": lambda p, a: p.cluster_gallery(
        a["x"], a["z_b"], a["labels_b"], a["cents_b"],
        centroid_decodes=a["decodes"], traces=a["traces"]),
    "cluster_gallery_traces_callable": lambda p, a: p.cluster_gallery(
        a["x"], a["z_b"], a["labels_b"], a["cents_b"],
        traces=lambda i: a["traces"][i][::2]),
    "view_class_cdf": lambda p, a: p.view_class_cdf(
        a["z_a"], a["labels_a"], a["z_b"], a["labels_b"], a["cents_a"],
        a["cents_b"]),
    "view_class_cdf_single": lambda p, a: p.view_class_cdf(
        a["z_b"], a["labels_b"], a["cents_b"]),
    "analyze_dec": lambda p, a: p.analyze_dec(
        a["x"], a["z_a"], a["z_b"], a["labels_a"], a["labels_b"],
        a["cents_a"], a["cents_b"], a["tsne"], epoch=4,
        centroid_decodes=a["decodes"]),
}


#: the comparative figures, drawn per centroid: tests/test_analysis.py's
#: empty-class case
EMPTY_CLASS = ("view_latent_space", "view_class_pdf_paper", "cluster_gallery",
               "view_class_cdf")


@pytest.mark.parametrize("name,empty", [(n, False) for n in CALLS]
                         + [(n, True) for n in EMPTY_CLASS])
def test_figure_matches_jax(name, empty):
    """The copy draws what the original draws, pixel for pixel; with an
    empty class neither crashes."""
    args = _inputs(empty)
    _same(CALLS[name](tplot, args), CALLS[name](jplot, args))


def test_helpers_match_jax():
    assert tplot.cmap_lifeaquatic() == jplot.cmap_lifeaquatic()
    assert tplot.cmap_lifeaquatic(15) == jplot.cmap_lifeaquatic(15)
    assert (tplot.CMAP_FEAT, tplot.CMAP_SPEC) == (jplot.CMAP_FEAT,
                                                  jplot.CMAP_SPEC)
    for n, k in ((1, 6), (7, 6), (40, 6), (30000, 6), (30000, 5)):
        np.testing.assert_array_equal(
            tplot._percentile_rank_indices(n, k),
            jplot._percentile_rank_indices(n, k))
    for x in (np.ones((4, 101)), np.ones((4, 101, 1)), np.ones((1, 4, 101))):
        np.testing.assert_array_equal(tplot._to_hw(x), jplot._to_hw(x))
    plt = tplot._plt()
    labels = []
    for mod in (tplot, jplot):
        fig, ax = plt.subplots()
        ax.plot([0, 1], [0, 1e-6])
        ax.set_ylabel("Loss")
        mod.label_offset(ax, "y")
        labels.append(ax.get_ylabel())
        plt.close(fig)
    assert labels[0] == labels[1] and "1e" in labels[0]
    with pytest.raises(ValueError, match="axis"):
        tplot.label_offset(None, "z")


def test_mathutils_match_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(30, D))
    y = rng.normal(size=(30, D))
    for f in (1, 2, 0.5):
        np.testing.assert_array_equal(tmath.fractional_distance(x[0], y, f),
                                      jmath.fractional_distance(x[0], y, f))
        np.testing.assert_array_equal(tmath.distance_matrix(x, y, f),
                                      jmath.distance_matrix(x, y, f))
    with pytest.raises(ValueError, match="same number of rows"):
        tmath.distance_matrix(x, y[:3], 2)


def test_save_figures_and_plotter_async_match_jax(tmp_path):
    args = _inputs(False)
    names = {}
    for mod in (tplot, jplot):
        figs = {"T-SNE": mod.view_tsne(args["tsne"], args["labels_b"], "t")}
        base = tmp_path / mod.__name__
        paths = mod.save_figures(figs, str(base), epoch=8, dpi=DPI)
        thread = mod.plotter_async(figs, str(base / "async"))
        thread.join(timeout=60)
        assert not thread.is_alive()
        names[mod] = ([os.path.relpath(p, base) for p in paths],
                      sorted(os.listdir(base / "async" / "T-SNE")))
    assert names[tplot] == names[jplot] == (
        [os.path.join("T-SNE", "T-SNE_008.png")], ["T-SNE.png"])


# the blocked packages are found but fail to import (torch's compiler
# probes for some of them with find_spec, which must not raise); each
# case runs run-dc once with its set blocked, in the order below, so no
# case needs a package unblocked that an earlier one imported
BLOCKER = """
import importlib.abc, importlib.util, json, os, sys

BLOCKED = set()


class Block(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            return importlib.util.spec_from_loader(name, self)
        return None

    def create_module(self, spec):
        return None

    def exec_module(self, module):
        raise ImportError(f"blocked: {module.__name__}")


sys.meta_path.insert(0, Block())
from spectrogram_cube_clustering_tpu_torch import cli
from spectrogram_cube_clustering_tpu_torch.utils import config_training

wave, cases = sys.argv[1], json.loads(sys.argv[2])
for i, (blocked, params) in enumerate(cases):
    BLOCKED.clear()
    BLOCKED.update(blocked)
    root = os.path.join(os.path.dirname(wave), str(i))
    ini = config_training(
        {"fname_dataset": wave, "datafiletype": "waveform",
         "savepath": os.path.join(root, "Outputs"),
         "configpath": os.path.join(root, "Config"),
         "transform": "sample_norm_cent"},
        {"tb": "False", "device": "cpu", **params},
        {"batch_size": "32", "lr": "0.001"})
    try:
        cli.run_dc(init_path=ini)
        outcome = "ran"
    except ImportError as exc:
        outcome = f"ImportError: {exc}"
    written = [os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs
               if "Config" not in d]
    print("CASE", json.dumps([outcome, sorted(written)]))
"""

AEC_TRAIN = {"model": "AEC", "mode": "train", "n_epochs": 1,
             "early_stopping": "False"}
#: (blocked packages, ini keys, the package the error names; None: runs)
BLOCKED_CASES = [
    (["matplotlib", "sklearn"], {"model": "AEC", "mode": "predict",
                                 "tsne_backend": "jax",
                                 "saved_weights": "w.pt"}, "matplotlib"),
    (["matplotlib"], AEC_TRAIN, "matplotlib"),
    (["sklearn"], AEC_TRAIN, "scikit-learn"),
    (["sklearn"], {"model": "GMM", "mode": "fit", "saved_weights": "w.pt"},
     "scikit-learn"),
    (["sklearn"], {**AEC_TRAIN, "tsne_backend": "jax"}, None),
]


def test_missing_figure_package_raises_before_writing(tmp_path):
    """With figures on (the default), a missing matplotlib, or a missing
    scikit-learn unless `tsne_backend = jax`, makes run-dc raise
    ImportError naming it before any stage writes; with `tsne_backend =
    jax` the run needs no scikit-learn and draws its figures."""
    import json

    wave = str(tmp_path / "wave.npy")
    np.save(wave, np.random.default_rng(0).normal(size=(1, 20_000))
            .astype(np.float32))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(OMP_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-c", BLOCKER, wave,
         json.dumps([c[:2] for c in BLOCKED_CASES])],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [ln[5:] for ln in proc.stdout.splitlines()
             if ln.startswith("CASE ")]
    assert len(lines) == len(BLOCKED_CASES)
    for line, (blocked, params, says) in zip(lines, BLOCKED_CASES):
        outcome, written = json.loads(line)
        if says is None:
            assert outcome == "ran", (blocked, params, outcome)
            assert any(w.endswith("AEC_reconstructions.png")
                       for w in written)
        else:
            assert outcome.startswith("ImportError:") and says in outcome, (
                blocked, params, outcome)
            assert written == [], (blocked, params)
