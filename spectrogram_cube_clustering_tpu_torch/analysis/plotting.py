"""The workflow's figures: a copy (ROADMAP Queue 1 item 0) of the
functions of the JAX package's `analysis/plotting.py` that the workflow
calls, with their helpers (reference Cluster/plotting.py), pinned to the
originals by `tests/test_torch_figures.py` (the same Agg RGBA buffer on
the same inputs):

- `view_tsne`, `view_silhscore`, `view_specgram_training`;
- `view_latent_space`, `view_class_pdf_paper`, `cluster_gallery`,
  `view_class_cdf` (each with its single-model fallback);
- `analyze_dec`, `save_figures`, `plotter_async`;
- `cmap_lifeaquatic`, `label_offset` and the private helpers.

The one change is where matplotlib comes in: not at import, but in
`_plt()`, the first call of every function that draws, which selects the
Agg backend (unless one is set) and raises ImportError naming matplotlib
where it is not installed. The card's machine has no matplotlib, so the
port imports this module there and draws nothing.

Also `view_cluster_stats`, the figure of the cluster-count diagnostics
(`km_metrics = True`, `workflow.fit`), and the figures no workflow stage
draws (`tests/test_torch_analysis.py` holds them to the originals):
`view_history_aec` (and its alias `view_learning_curve`),
`view_history_dec`, `view_centroid_output`, `view_class_pdf` (and
`view_class_pdf_single`), `view_dec_output`, `compare_silhscore`,
`centroid_dashboard`, `view_specgram`, `view_detections` (an `.h5`
catalog; h5py at first use, as `data.h5` takes it), `view_series` (the
catalogues, pandas at first use), `compare_images` and
`centroid_distances`.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np


def _plt():
    """matplotlib.pyplot on the Agg backend (kept if a backend is already
    chosen); ImportError naming matplotlib where it is missing."""
    try:
        import matplotlib
    except ImportError as exc:
        raise ImportError(
            "figures need matplotlib, which is not installed; install it "
            "or set figures = False") from exc
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def cmap_lifeaquatic(n: Optional[int] = None) -> list:
    """Categorical palette inspired by Wes Anderson's The Life Aquatic —
    the published palettable/wesanderson color DATA the reference also uses
    (plotting.py:136-159, jiffyclub.github.io/palettable/wesanderson/), so
    class colors match the papers. Cycles if more classes are requested."""
    base = [
        (27, 52, 108), (244, 75, 26), (67, 48, 34), (35, 81, 53),
        (123, 109, 168), (139, 156, 184), (214, 161, 66), (1, 170, 233),
        (195, 206, 208), (229, 195, 158), (56, 2, 130), (0, 0, 0),
    ]
    colors = [tuple(v / 255 for v in c) for c in base]
    if n is None:
        return colors
    return [colors[i % len(colors)] for i in range(n)]


# cmocean substitutes (cmocean is not a dependency): the reference draws
# latent strips with cmo.deep_r and spectrograms with cmo.dense
# (plotting.py:345-346); these built-ins are the closest perceptually
# uniform matplotlib ramps.
CMAP_FEAT = "YlGnBu_r"   # ~ cmo.deep_r
CMAP_SPEC = "BuPu"       # ~ cmo.dense


def label_offset(ax, axis: str = "y"):
    """Fold the axis scientific-notation offset text into the axis label
    ("Loss (1e-3)" instead of a floating multiplier) and keep it updated on
    limit changes (reference label_offset, plotting.py:643-668)."""
    if axis == "y":
        fmt = ax.yaxis.get_major_formatter()
        ax.yaxis.offsetText.set_visible(False)
        set_label, label = ax.set_ylabel, ax.get_ylabel()
    elif axis == "x":
        fmt = ax.xaxis.get_major_formatter()
        ax.xaxis.offsetText.set_visible(False)
        set_label, label = ax.set_xlabel, ax.get_xlabel()
    else:
        raise ValueError(f"axis must be 'x' or 'y', got {axis!r}")

    def update_label(_event):
        offset = fmt.get_offset()
        set_label(label if offset == "" else f"{label} ({offset})")

    ax.callbacks.connect("ylim_changed", update_label)
    ax.callbacks.connect("xlim_changed", update_label)
    ax.figure.canvas.draw()
    update_label(None)


def _finish(fig, show: bool):
    plt = _plt()
    if show:  # pragma: no cover - interactive path
        plt.show()
    else:
        plt.close(fig)
    return fig


def _img(ax, x2d, cmap="viridis"):
    ax.imshow(np.asarray(x2d), aspect="auto", origin="lower", cmap=cmap)
    ax.set_xticks([])
    ax.set_yticks([])


def _to_hw(x) -> np.ndarray:
    """Accept (H, W), (H, W, 1) or (1, H, W) and return (H, W)."""
    x = np.asarray(x)
    if x.ndim == 3:
        x = x[..., 0] if x.shape[-1] == 1 else x[0]
    return x


def view_tsne(results, labels, title, show: bool = False):
    """t-SNE scatter colored by class (reference view_TSNE,
    plotting.py:1947-1977)."""
    plt = _plt()
    results = np.asarray(results)  # list input: fancy indexing below
    labels = np.asarray(labels)
    classes = np.unique(labels)
    colors = cmap_lifeaquatic(len(classes))
    fig, ax = plt.subplots(figsize=(6, 8))
    for j, c in enumerate(classes):
        sel = labels == c
        ax.plot(
            results[sel, 0], results[sel, 1], "o", alpha=0.2, c=colors[j],
            ms=6, mec="w", mew=0.5, rasterized=True, label=str(int(c) + 1),
        )
    ax.axis("off")
    leg = ax.legend(
        loc="center left", bbox_to_anchor=(0.9, 0.75), title="Class"
    )
    for handle in leg.legend_handles:
        handle.set_alpha(1)
    ax.set_title(title)
    return _finish(fig, show)


def view_silhscore(scores, labels, n_clusters, modeltype, show: bool = False):
    """Per-class sorted silhouette fill plot (reference view_silhscore,
    plotting.py:1760-1802)."""
    plt = _plt()
    scores = np.asarray(scores)
    labels = np.asarray(labels)
    colors = cmap_lifeaquatic(n_clusters)
    fig, ax = plt.subplots(figsize=(8, max(n_clusters, 2)), dpi=150)
    ax.set_ylim([0, scores.shape[0] + (n_clusters + 1) * 10])
    y_lower = 10
    for j in range(n_clusters):
        cs = np.sort(scores[labels == j])
        y_upper = y_lower + len(cs)
        ax.fill_betweenx(
            np.arange(y_lower, y_upper), 0, cs,
            facecolor=colors[j], edgecolor=colors[j], alpha=0.7,
        )
        ax.text(-0.05, y_lower + 0.5 * len(cs), str(j + 1), size=14)
        y_lower = y_upper + 10
    ax.axvline(float(np.mean(scores)), color="red", linestyle="--")
    ax.set_title(f"Silhouette Analysis for {modeltype}")
    ax.set_xlabel("Silhouette Coefficient")
    ax.set_ylabel("Class")
    ax.set_yticks([])
    ax.set_xticks(np.round(np.linspace(-1, 1, 11), 1))
    return _finish(fig, show)


def view_specgram_training(
    x, x_rec, n_samples: int = 4, figtitle: str = "Reconstructions",
    show: bool = False,
):
    """Input vs reconstruction spectrogram panels (reference
    view_specgram_training, plotting.py:1838-1944)."""
    plt = _plt()
    x = np.asarray(x)
    x_rec = np.asarray(x_rec)
    n = min(n_samples, len(x))
    fig, axes = plt.subplots(2, n, figsize=(3 * n, 5), squeeze=False)
    for i in range(n):
        _img(axes[0, i], _to_hw(x[i]))
        _img(axes[1, i], _to_hw(x_rec[i]))
        axes[0, i].set_title(f"#{i}")
    axes[0, 0].set_ylabel("Input")
    axes[1, 0].set_ylabel("Reconstruction")
    fig.suptitle(figtitle)
    return _finish(fig, show)


def view_latent_space_single(z, labels=None, show: bool = False):
    """Single-model latent heatmap, rows sorted by label (a simplified
    cut of reference view_latent_space for mid-training snapshots)."""
    plt = _plt()
    z = np.asarray(z)
    order = np.argsort(np.asarray(labels)) if labels is not None else slice(None)
    fig, ax = plt.subplots(figsize=(6, 8))
    im = ax.imshow(z[order], aspect="auto", cmap="viridis", interpolation="none")
    ax.set_xlabel("Latent dimension")
    ax.set_ylabel("Sample (sorted by class)" if labels is not None else "Sample")
    fig.colorbar(im, ax=ax, label="Activation")
    ax.set_title("Latent Space")
    return _finish(fig, show)


def view_latent_space(
    data_a, labels_a=None, data_b=None, labels_b=None,
    centroids_a=None, centroids_b=None, n_clusters: Optional[int] = None,
    p: int = 2, show: bool = False,
):
    """Comparative GMM-vs-DEC latent-space figure (reference
    view_latent_space, plotting.py:1391-1571): one panel per class k, each
    stacking model A (GMM) over model B (DEC); within a half-panel the
    class centroid is drawn as a (D, 1) strip next to the FULL latent set
    (D, M) with columns sorted by distance to mu_k, white dashed verticals
    marking where the OTHER centroids fall in that ordering.

    Backward-compatible: `view_latent_space(z, labels)` falls back to the
    single-model heatmap.
    """
    plt = _plt()
    if data_b is None or centroids_a is None:
        return view_latent_space_single(data_a, labels_a, show)

    from matplotlib import cm as _cm
    from matplotlib import colors as _mcolors
    from matplotlib import gridspec

    from spectrogram_cube_clustering_tpu_torch.utils.mathutils import (
        distance_matrix,
        fractional_distance,
    )

    data_a, data_b = np.asarray(data_a), np.asarray(data_b)
    labels_a = np.asarray(labels_a)
    centroids_a, centroids_b = np.asarray(centroids_a), np.asarray(centroids_b)
    if n_clusters is None:
        n_clusters = len(centroids_a)
    d = data_a.shape[1]
    # centroid indices, NOT np.unique(labels): a class can end up empty
    # (argmax(q) never assigns it) and the panels/markers are per-centroid
    label_list = np.arange(n_clusters)
    dist_mat_a = distance_matrix(centroids_a, centroids_a, p)
    dist_mat_b = distance_matrix(centroids_b, centroids_b, p)
    vmax_a, vmax_b = centroids_a.max(), centroids_b.max()

    nrows = int(np.ceil(n_clusters / 2))
    fig = plt.figure(figsize=(8, 2.5 * nrows), dpi=150)
    gs = gridspec.GridSpec(
        nrows=nrows, ncols=3, width_ratios=[0.49, 0.49, 0.02],
        height_ratios=[1] * nrows, hspace=0.3, wspace=0.05,
    )

    def _half(slot_c, slot_z, data, centroids, dist_mat, l, vmax, row_name):
        """One model's half-panel for class l: centroid strip + sorted Z."""
        dist = fractional_distance(centroids[l], data, p)
        order = np.argsort(dist)
        # where the other centroids land in this ordering
        others = np.delete(label_list, l)
        cdist = np.delete(dist_mat[l], l)
        cidx = np.searchsorted(dist[order], cdist)
        rank = np.argsort(cdist)
        cidx, others = cidx[rank], others[rank]

        ax0 = fig.add_subplot(slot_c)
        ax0.imshow(
            centroids[l][:, None], cmap=CMAP_FEAT, vmax=vmax,
            interpolation="nearest", aspect="auto",
        )
        ax0.set_xticks([])
        if l == 0:
            ax0.set_yticks(np.arange(d))
            ax0.set_yticklabels(np.arange(1, d + 1), size=5)
            if row_name:
                ax0.set_ylabel(row_name, size=14)
        else:
            ax0.set_yticks(np.arange(d))
            ax0.set_yticklabels([])
        ax1 = fig.add_subplot(slot_z)
        ax1.imshow(
            data[order].T, cmap=CMAP_FEAT, aspect="auto", vmax=vmax,
            interpolation="nearest",
        )
        ax1.vlines(cidx, -0.5, d - 0.5, colors="w", ls="dashed",
                   lw=0.75, alpha=0.5)
        for j in range(len(others)):
            ax1.text(
                cidx[j], 1.1 * (j + 1), rf"$\mu_{{{int(others[j]) + 1}}}$",
                size=6, ha="center",
                bbox=dict(boxstyle="square,pad=0", facecolor="w",
                          edgecolor="w"),
            )
        ax1.set_xticks([]), ax1.set_yticks([])
        ax1.set_xlim(0, len(data))
        return ax0, ax1

    for l in range(n_clusters):
        row, col = divmod(l, 2)
        sub = gridspec.GridSpecFromSubplotSpec(
            2, 2, subplot_spec=gs[row, col], hspace=0.04, wspace=0,
            width_ratios=[0.5, 4],
        )
        _, axa = _half(sub[0, 0], sub[0, 1], data_a, centroids_a,
                       dist_mat_a, l, vmax_a, "GMM" if l == 0 else "")
        axa.set_title(f"$k={l + 1}$", size=12)
        _half(sub[1, 0], sub[1, 1], data_b, centroids_b,
              dist_mat_b, l, vmax_b, "DEC" if l == 0 else "")

    # shared colorbars (one per model) in the last narrow column
    sub = gridspec.GridSpecFromSubplotSpec(
        2, 1, subplot_spec=gs[0, 2], hspace=0.04
    )
    for slot, vmax in ((sub[0], vmax_a), (sub[1], vmax_b)):
        ax = fig.add_subplot(slot)
        ax.axis("off")
        norm = _mcolors.Normalize(vmin=0, vmax=vmax)
        fig.colorbar(
            _cm.ScalarMappable(norm=norm, cmap=CMAP_FEAT), ax=ax,
            orientation="vertical", fraction=1.0,
        )
    fig.suptitle(
        rf"Latent space sorted by $d_{{n,k}}=\Vert z_n-\mu_k\Vert_{p}$",
        size=15,
    )
    fig.subplots_adjust(top=0.91)
    return _finish(fig, show)


def view_class_pdf_paper(
    data_a, data_b, labels_a, labels_b, centroids_a, centroids_b,
    n_clusters: int, p: int = 2, show: bool = False,
):
    """Paper-figure comparative class PDFs (reference view_class_pdf_paper,
    plotting.py:995-1167): per centroid mu_k, the normalized histogram of
    EVERY class's distances to mu_k, GMM (top) vs DEC (bottom), drawn over
    a broken x-axis ([0,4] | [10,30]) with class-colored fills and a shared
    class legend."""
    plt = _plt()
    from matplotlib import gridspec
    from matplotlib.patches import Patch

    data_a, data_b = np.asarray(data_a), np.asarray(data_b)
    labels_a, labels_b = np.asarray(labels_a), np.asarray(labels_b)
    centroids_a = np.asarray(centroids_a)
    centroids_b = np.asarray(centroids_b)
    from spectrogram_cube_clustering_tpu_torch.utils.mathutils import (
        fractional_distance,
    )

    # class indices 0..K-1 (labels are argmax over K); a missing class
    # simply yields an empty selection, never a shifted one
    label_list = np.arange(n_clusters)
    nbins = 400
    X = np.linspace(0, 40, nbins)
    colors = cmap_lifeaquatic(n_clusters)
    nrows = int(np.ceil(n_clusters / 2))
    fig = plt.figure(figsize=(12, 2.5 * nrows), dpi=150)
    gs = gridspec.GridSpec(nrows=nrows, ncols=2, hspace=0.3, wspace=0.05)
    xlim = (0, 4, 10, 30)
    ylim = 0.3

    def _class_hists(dist, labs):
        # computed once per (model, centroid); both broken-axis panes
        # reuse the same curves (they differ only in xlim)
        hists = []
        for ll in range(n_clusters):
            dsel = dist[labs == label_list[ll]]
            hist = np.histogram(dsel, bins=X)[0].astype(float)
            total = hist.sum()
            if total > 0:
                hist /= total
            hists.append(hist)
        return hists

    def _plot_hists(ax, hists):
        for ll, hist in enumerate(hists):
            ax.plot(X[:-1], hist, color=colors[ll], label=f"{ll + 1}")
            ax.fill_between(X[:-1], 0, hist, color=colors[ll], alpha=0.2)
        ax.set_ylim(0, ylim)

    for l in range(n_clusters):
        sub = gridspec.GridSpecFromSubplotSpec(
            2, 2, subplot_spec=gs[l // 2, l % 2], hspace=0, wspace=0.05,
            width_ratios=[1, 2],
        )
        dist_a = fractional_distance(centroids_a[l], data_a, p)
        dist_b = fractional_distance(centroids_b[l], data_b, p)
        axes = [fig.add_subplot(sub[i]) for i in range(4)]
        hists_a = _class_hists(dist_a, labels_a)
        hists_b = _class_hists(dist_b, labels_b)
        for ax, hists in (
            (axes[0], hists_a), (axes[1], hists_a),
            (axes[2], hists_b), (axes[3], hists_b),
        ):
            _plot_hists(ax, hists)
        axes[0].set_title(
            rf"Class PDFs relative to $\mu_{{{l + 1}}}$", loc="left", size=12
        )
        axes[1].text(1, 0.9, "GMM", ha="right", va="top",
                     transform=axes[1].transAxes, size=12)
        axes[3].text(1, 0.9, "DEC", ha="right", va="top",
                     transform=axes[3].transAxes, size=12)
        # broken x-axis: left pane [0,4], right pane [10,30]
        for left, right in ((axes[0], axes[1]), (axes[2], axes[3])):
            left.set_xlim(xlim[0], xlim[1])
            right.set_xlim(xlim[2], xlim[3])
            left.spines["right"].set_visible(False)
            right.spines["left"].set_visible(False)
            right.tick_params(labelleft=False, left=False)
            dd = 0.075
            left.plot((1, 1), (1 - dd, 1 + dd), transform=left.transAxes,
                      color="k", clip_on=False)
            right.plot((0, 0), (1 - dd, 1 + dd), transform=right.transAxes,
                       color="k", clip_on=False)
        for ax in axes[:2]:
            ax.set_xticklabels([])
        if l < n_clusters - 2:
            for ax in axes:
                ax.set_xticklabels([]), ax.set_yticklabels([])
        else:
            axes[2].set_ylabel("PDF", size=12)
            axes[3].set_xlabel(
                rf"$d=\Vert z-\mu_k\Vert_{p}$", size=12, ha="right"
            )
    proxies = [
        Patch(color=colors[i], label=str(i + 1), alpha=0.5)
        for i in range(n_clusters)
    ]
    leg = fig.legend(
        handles=proxies, loc="lower center", ncol=n_clusters, fontsize=10
    )
    leg.set_title("Classes")
    fig.subplots_adjust(bottom=0.18)
    return _finish(fig, show)


def _percentile_rank_indices(n: int, n_examples: int) -> np.ndarray:
    """Display ranks across a sorted class: the reference pins indices
    0/5k/10k/15k/20k/25k of the distance-sorted class (plotting.py:354-356)
    to show WITHIN-CLASS DIVERSITY, not just the nearest samples. That
    exact ladder only exists for classes >= 25k samples (smaller classes
    make the reference return a half-drawn figure); here the same design
    generalizes to evenly spaced percentile ranks over the class size."""
    if n >= 25000 and n_examples == 6:
        return np.asarray([0, 4999, 9999, 14999, 19999, 24999])
    return np.unique(
        np.clip(np.linspace(0, n - 1, n_examples).astype(int), 0, n - 1)
    )


def cluster_gallery(
    x, z, labels, centroids,
    centroid_decodes=None, n_examples: int = 6, traces=None, p: int = 2,
    show: bool = False,
):
    """Per-class gallery at reference fidelity (plotting.py:306-522):
    columns = classes; per class a gridspec stack of [centroid strip +
    decoded-centroid spectrogram] then `n_examples` rows of [latent strip,
    sample spectrogram, waveform], where the samples sit at fixed
    percentile ranks of the distance-to-centroid ordering (see
    _percentile_rank_indices), with shared colorbars at the bottom.

    `traces`: optional (M, L) waveform array or callable idx -> (L,) — the
    reference reads these from the H5 catalog's /4.0/Trace; the Zarr cube
    has no waveforms, so the row is drawn only when traces are provided.
    """
    plt = _plt()
    from matplotlib import cm as _cm
    from matplotlib import colors as _mcolors
    from matplotlib import gridspec

    x = np.asarray(x)
    z = np.asarray(z)
    labels = np.asarray(labels)
    centroids = np.asarray(centroids)
    label_list = np.unique(labels)
    k = len(label_list)
    n_rows = n_examples
    vmax = centroids.max()

    fig = plt.figure(figsize=(2 * max(k, 2), 2 * n_rows), dpi=150)
    heights = [1.0] * (n_rows + 1) + [0.25]
    gs_sup = gridspec.GridSpec(
        nrows=n_rows + 2, ncols=k, hspace=0.1, wspace=0.1,
        height_ratios=heights,
    )
    sub_heights = [0.5, 4, 1]

    def _cell(sup_slot, strip, spec2d, trace, strip_label, spec_label):
        gs_sub = gridspec.GridSpecFromSubplotSpec(
            nrows=3, ncols=1, subplot_spec=sup_slot, hspace=0, wspace=0,
            height_ratios=sub_heights,
        )
        ax0 = fig.add_subplot(gs_sub[0])
        ax0.imshow(
            strip[None], cmap=CMAP_FEAT, aspect="auto", vmax=vmax,
            interpolation="nearest",
        )
        ax0.set_xticks([]), ax0.set_yticks([])
        if strip_label:
            ax0.set_ylabel(strip_label, rotation=0, va="center", ha="right")
        ax1 = fig.add_subplot(gs_sub[1])
        if spec2d is not None:
            ax1.imshow(
                spec2d, cmap=CMAP_SPEC, aspect="auto", origin="lower",
                interpolation="none",
            )
        ax1.set_xticks([]), ax1.set_yticks([])
        if spec_label:
            ax1.set_ylabel(spec_label, rotation=0, va="center", ha="right")
        ax2 = fig.add_subplot(gs_sub[2])
        if trace is not None:
            ax2.plot(trace, "k", linewidth=0.5)
            ax2.set_xlim(0, len(trace) - 1)
        else:
            ax2.axis("off")
        ax2.set_xticks([]), ax2.set_yticks([])
        return ax0

    from spectrogram_cube_clustering_tpu_torch.utils.mathutils import (
        fractional_distance,
    )

    for col, label in enumerate(label_list):
        query = np.flatnonzero(labels == label)
        first_col = col == 0
        # centroid row: mu_k strip + g(mu_k) decode — indexed by the class
        # LABEL, not the column (they differ when a class is empty)
        label = int(label)
        xc = (
            _to_hw(np.asarray(centroid_decodes)[label])
            if centroid_decodes is not None else None
        )
        ax_top = _cell(
            gs_sup[0, col], centroids[label], xc, None,
            r"$\mu_k$" if first_col else "",
            r"$g(\mu_k)$" if first_col else "",
        )
        ax_top.xaxis.set_label_position("top")
        ax_top.set_xlabel(f"$k={int(label) + 1}$", va="bottom", size=14)

        if not len(query):
            continue
        dist = fractional_distance(centroids[label], z[query], p)
        order = np.argsort(dist)
        ranks = _percentile_rank_indices(len(query), n_examples)
        chosen = query[order[ranks]]
        for row, idx in enumerate(chosen):
            trace = None
            if traces is not None:
                trace = traces(idx) if callable(traces) else np.asarray(traces[idx])
            _cell(
                gs_sup[row + 1, col], z[idx], _to_hw(x[idx]), trace,
                f"$z_{{{ranks[row] + 1}}}$" if first_col else "",
                f"$x_{{{ranks[row] + 1}}}$" if first_col else "",
            )

    # bottom colorbars: spectrogram scale + latent scale (plotting.py:457-476)
    gs_bar = gridspec.GridSpecFromSubplotSpec(
        1, 2, subplot_spec=gs_sup[-1, :]
    )
    for slot, cmap, vmin_, vmax_, title in (
        (gs_bar[0], CMAP_SPEC, 0.0, 1.0, "Normalized Spectrogram Value"),
        (gs_bar[1], CMAP_FEAT, float(z.min()), float(vmax),
         "Latent Feature Value"),
    ):
        ax = fig.add_subplot(slot)
        ax.axis("off")
        norm = _mcolors.Normalize(vmin=vmin_, vmax=vmax_)
        cbar = fig.colorbar(
            _cm.ScalarMappable(norm=norm, cmap=cmap), ax=ax,
            orientation="horizontal", fraction=0.6, aspect=30,
        )
        cbar.set_label(title)
        cbar.ax.tick_params(labelsize=8)
    fig.suptitle("Classes", size=16, weight="bold")
    fig.subplots_adjust(top=0.92)
    return _finish(fig, show)


def view_cluster_stats(
    k_list, inertia, silh, gap_g=None, gap_u=None, show: bool = False
):
    """Cluster-count diagnostics (reference view_cluster_stats,
    plotting.py:1170-1221): inertia, mean silhouette, and gap statistics
    against gaussian/uniform null references on a triple y-axis."""
    plt = _plt()
    fig, host = plt.subplots(figsize=(6, 4), dpi=150)
    par1 = host.twinx()
    lines = []
    p1, = host.plot(k_list, inertia, color="navy", marker=".", label="Inertia")
    p2, = par1.plot(k_list, silh, color="darkgreen", marker=".",
                    label="Silhouette")
    lines += [p1, p2]
    host.set_xlabel("Number of Clusters")
    host.set_ylabel("Inertia")
    par1.set_ylabel("Silhouette Score")
    host.yaxis.label.set_color(p1.get_color())
    par1.yaxis.label.set_color(p2.get_color())
    if gap_g is not None or gap_u is not None:
        par2 = host.twinx()
        par2.spines["right"].set_position(("axes", 1.25))
        par2.set_frame_on(True)
        par2.patch.set_visible(False)
        for sp in par2.spines.values():
            sp.set_visible(False)
        par2.spines["right"].set_visible(True)
        if gap_g is not None:
            p3, = par2.plot(k_list, gap_g, "firebrick", ls=":", marker=".",
                            label="Gaussian")
            lines.append(p3)
        if gap_u is not None:
            p4, = par2.plot(k_list, gap_u, "firebrick", ls="-.", marker=".",
                            label="Uniform")
            lines.append(p4)
        par2.set_ylabel("Gap Statistic")
        par2.yaxis.label.set_color("firebrick")
    host.xaxis.grid()
    host.set_xticks(list(k_list))
    leg_cols = min(len(lines), 4)
    host.legend(
        lines, [ln.get_label() for ln in lines], ncol=leg_cols,
        bbox_to_anchor=(0.6, -0.28), loc="lower center",
    )
    fig.tight_layout()
    fig.subplots_adjust(right=0.72, bottom=0.25)
    return _finish(fig, show)


def view_class_cdf_single(z, labels, centroids, p: int = 2,
                          show: bool = False):
    """Single-model cut: CDF of sample distance to own centroid per class."""
    plt = _plt()
    z = np.asarray(z)
    labels = np.asarray(labels)
    centroids = np.asarray(centroids)
    k = len(centroids)
    colors = cmap_lifeaquatic(k)
    fig, ax = plt.subplots(figsize=(7, 5))
    for j in range(k):
        sel = labels == j
        if not np.any(sel):
            continue
        d = np.sort(
            np.linalg.norm(z[sel] - centroids[j], ord=p, axis=1)
        )
        ax.plot(
            d, np.arange(1, len(d) + 1) / len(d),
            color=colors[j], label=f"Class {j + 1}",
        )
    ax.set_xlabel(f"L{p} distance to centroid")
    ax.set_ylabel("CDF")
    ax.set_title("Distance-to-Centroid CDF")
    ax.legend()
    return _finish(fig, show)


def view_class_cdf(
    data_a, labels_a=None, data_b=None, labels_b=None,
    centroids_a=None, centroids_b=None, n_clusters: Optional[int] = None,
    p: int = 2, show: bool = False,
):
    """Comparative GMM-vs-DEC own-class distance CDFs (reference
    view_class_cdf, plotting.py:800-884): a 2-column grid of per-class
    panels, each overlaying both models' CDF of the class's distances to
    its own centroid, shared x-range, class tag in the corner.

    `view_class_cdf(z, labels, centroids)` falls back to the single-model
    variant.
    """
    plt = _plt()
    if centroids_a is None:
        # legacy 3-positional call: (z, labels, centroids)
        return view_class_cdf_single(data_a, labels_a, data_b, p=p, show=show)
    from matplotlib import gridspec

    from spectrogram_cube_clustering_tpu_torch.utils.mathutils import (
        fractional_distance,
    )

    data_a, data_b = np.asarray(data_a), np.asarray(data_b)
    labels_a, labels_b = np.asarray(labels_a), np.asarray(labels_b)
    centroids_a, centroids_b = np.asarray(centroids_a), np.asarray(centroids_b)
    if n_clusters is None:
        n_clusters = len(centroids_a)
    label_list = np.arange(n_clusters)  # class can be empty; see pdf note
    colors = cmap_lifeaquatic(max(n_clusters, 2))
    nrows = int(np.ceil(n_clusters / 2))
    fig = plt.figure(figsize=(7, 2 * nrows), dpi=150)
    gs = gridspec.GridSpec(nrows=nrows, ncols=2, hspace=0, wspace=0)
    max_dist = 0.0
    axes = []
    for l in range(n_clusters):
        ax = fig.add_subplot(gs[l // 2, l % 2])
        axes.append(ax)
        for data, labels, cents, name, color in (
            (data_a, labels_a, centroids_a, "GMM", colors[0]),
            (data_b, labels_b, centroids_b, "DEC", colors[1]),
        ):
            dist = fractional_distance(cents[l], data, p)
            sel = labels == label_list[l]
            d = np.sort(dist[sel])
            if len(d) == 0:
                continue
            ax.plot(d, np.arange(1, len(d) + 1) / len(d), color=color,
                    label=name)
            max_dist = max(max_dist, float(d.max()))
        ax.set_yticks([0.0, 0.5, 1.0])
        if l == n_clusters - 1 or (n_clusters % 2 == 0 and l == n_clusters - 2):
            ax.set_xlabel(rf"$d=\Vert z-\mu_k\Vert_{p}$")
            ax.set_ylabel("CDF")
        else:
            ax.set_xticklabels([]), ax.set_yticklabels([])
    for j, ax in enumerate(axes):
        ax.set_xlim(0, max_dist if max_dist > 0 else 1.0)
        ax.text(0.9, 0.15, f"$k={j + 1}$", ha="right", va="bottom",
                transform=ax.transAxes)
    handles, leg_labels = axes[-1].get_legend_handles_labels()
    fig.legend(handles, leg_labels, loc="lower center", ncol=2)
    fig.subplots_adjust(bottom=0.18)
    return _finish(fig, show)


def analyze_dec(
    x, z_aec, z_dec, labels_gmm, labels_dec, centroids_gmm, centroids_dec,
    tsne_results, epoch: int = 0, centroid_decodes=None, traces=None,
    show: bool = False,
):
    """DEC snapshot figure set (reference analyze_dec, plotting.py:31-133):
    t-SNE, gallery, comparative GMM-vs-DEC latent space, CDF, and the
    comparative class-PDF paper figure — returned as a dict keyed by the
    reference's figure-directory names."""
    k = len(np.asarray(centroids_dec))
    return {
        "T-SNE": view_tsne(
            tsne_results, labels_dec, f"t-SNE Results - Epoch {epoch}", show
        ),
        "Gallery": cluster_gallery(
            x, z_dec, labels_dec, centroids_dec,
            centroid_decodes=centroid_decodes, traces=traces, show=show,
        ),
        "LatentSpace": view_latent_space(
            z_aec, labels_gmm, z_dec, labels_dec,
            centroids_gmm, centroids_dec, show=show,
        ),
        "CDF": view_class_cdf(
            z_aec, labels_gmm, z_dec, labels_dec,
            centroids_gmm, centroids_dec, show=show,
        ),
        "PDF": view_class_pdf_paper(
            z_aec, z_dec, labels_gmm, labels_dec,
            centroids_gmm, centroids_dec, k, show=show,
        ),
    }


def save_figures(figs: dict, base_dir: str, epoch=None, dpi: int = 300):
    """Persist an analyze_dec figure dict into the reference's directory
    layout (<base>/<name>/<name>[_epoch].png; models.py:663-701)."""
    import os

    paths = []
    suffix = f"_{epoch:03d}" if epoch is not None else ""
    for name, fig in figs.items():
        d = os.path.join(base_dir, name)
        os.makedirs(d, exist_ok=True)
        p = os.path.join(d, f"{name}{suffix}.png")
        fig.savefig(p, dpi=dpi, facecolor="w")
        paths.append(p)
    return paths


def plotter_async(figs: dict, base_dir: str, epoch=None):
    """Run save_figures on a background thread (the reference's plotting
    thread is commented out because pyplot isn't thread-safe,
    models.py:1041-1046; figure *saving* on Agg is).

    Non-daemon: the interpreter joins these at shutdown, so the
    final-epoch snapshot PNGs (multi-second dpi-300 writes that are
    typically still in flight when train_dec returns) can't be truncated
    by process exit.
    """
    import threading

    t = threading.Thread(
        target=save_figures, args=(figs, base_dir, epoch), daemon=False
    )
    t.start()
    return t


def view_history_aec(history: Dict[str, Sequence], show: bool = False):
    """AEC training/validation MSE curves (reference view_history_AEC,
    plotting.py:1336-1357). `history` has keys epoch/train/validation."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(8, 5))
    ax.plot(history["epoch"], history["train"], label="Training")
    ax.plot(history["epoch"], history["validation"], label="Validation")
    ax.set_xlabel("Epoch")
    ax.set_ylabel("MSE")
    ax.set_title("AEC Training History")
    ax.legend()
    return _finish(fig, show)


view_learning_curve = view_history_aec  # plotting.py:1574-1598 variant


def view_history_dec(
    history: Dict[str, Sequence],
    deltas: Optional[Dict[str, Sequence]] = None,
    show: bool = False,
):
    """DEC loss components + delta-label curves (reference view_history_DEC,
    plotting.py:1357-1388)."""
    plt = _plt()
    n_rows = 2 if deltas else 1
    fig, axes = plt.subplots(n_rows, 1, figsize=(8, 4 * n_rows), squeeze=False)
    ax = axes[0, 0]
    ax.plot(history["iteration"], history["total"], label="Loss")
    ax.plot(history["iteration"], history["reconstruction"], label="MSE")
    ax.plot(history["iteration"], history["clustering"], label="KLD")
    ax.set_xlabel("Iteration")
    ax.set_ylabel("Loss")
    ax.set_title("DEC Training History")
    ax.legend()
    if deltas:
        ax2 = axes[1, 0]
        ax2.plot(deltas["iteration"], deltas["delta"], "o-")
        ax2.set_xlabel("Iteration")
        ax2.set_ylabel(r"$\delta$ (changed labels)")
    fig.tight_layout()
    return _finish(fig, show)


def view_centroid_output(centroid_decodes, show: bool = False):
    """Decoded centroid spectrograms (reference view_centroid_output,
    plotting.py:771-797)."""
    plt = _plt()
    xc = np.asarray(centroid_decodes)
    k = len(xc)
    fig, axes = plt.subplots(1, k, figsize=(3 * k, 3), squeeze=False)
    for j in range(k):
        _img(axes[0, j], _to_hw(xc[j]))
        axes[0, j].set_title(f"Centroid {j + 1}")
    fig.suptitle("Decoded Centroids")
    return _finish(fig, show)


def view_class_pdf_single(z, labels, centroids, p: int = 2, bins: int = 50,
                          show: bool = False):
    """Single-model cut: per-class own-centroid distance histograms."""
    plt = _plt()
    z = np.asarray(z)
    labels = np.asarray(labels)
    centroids = np.asarray(centroids)
    k = len(centroids)
    colors = cmap_lifeaquatic(k)
    fig, axes = plt.subplots(k, 1, figsize=(7, 2 * k), squeeze=False, sharex=True)
    for j in range(k):
        sel = labels == j
        ax = axes[j, 0]
        if np.any(sel):
            d = np.linalg.norm(z[sel] - centroids[j], ord=p, axis=1)
            ax.hist(d, bins=bins, density=True, color=colors[j], alpha=0.8)
        ax.set_ylabel(f"Class {j + 1}")
    axes[-1, 0].set_xlabel(f"L{p} distance to centroid")
    fig.suptitle("Distance-to-Centroid PDF")
    return _finish(fig, show)


def view_class_pdf(
    data_a, labels_a=None, data_b=None, labels_b=None,
    centroids_a=None, centroids_b=None, n_clusters: Optional[int] = None,
    p: int = 2, show: bool = False,
):
    """Comparative GMM-vs-DEC class PDFs (reference view_class_pdf,
    plotting.py:885-994): per centroid mu_k a stacked [GMM over DEC] pair
    of panels, each holding EVERY class's density histogram of distances
    to mu_k with class-colored fills, shared x-range and legend.

    `view_class_pdf(z, labels, centroids)` falls back to the single-model
    variant.
    """
    plt = _plt()
    if centroids_a is None:
        # legacy 3-positional call: (z, labels, centroids)
        return view_class_pdf_single(data_a, labels_a, data_b, p=p, show=show)
    from matplotlib import gridspec

    from spectrogram_cube_clustering_tpu_torch.utils.mathutils import (
        fractional_distance,
    )

    data_a, data_b = np.asarray(data_a), np.asarray(data_b)
    labels_a, labels_b = np.asarray(labels_a), np.asarray(labels_b)
    centroids_a, centroids_b = np.asarray(centroids_a), np.asarray(centroids_b)
    if n_clusters is None:
        n_clusters = len(centroids_a)
    label_list = np.arange(n_clusters)  # class can be empty; see pdf note
    # computed once and reused by the panel loop below — at cube scale
    # each is an O(M*D) host pass and there are 2K of them
    dists_a = [
        fractional_distance(centroids_a[l], data_a, p)
        for l in range(n_clusters)
    ]
    dists_b = [
        fractional_distance(centroids_b[l], data_b, p)
        for l in range(n_clusters)
    ]
    all_d = np.concatenate(dists_a + dists_b)
    hi = float(np.ceil(all_d.max() / 10.0)) * 10 if len(all_d) else 1.0
    bins = np.linspace(0, max(hi, 1.0), 200)
    colors = cmap_lifeaquatic(n_clusters)
    nrows = int(np.ceil(n_clusters / 2))
    fig = plt.figure(figsize=(12, 2.5 * nrows), dpi=150)
    gs = gridspec.GridSpec(nrows=nrows, ncols=2, hspace=0.3, wspace=0.05)

    def _panel(ax, dist, labels, tag):
        for ll in range(n_clusters):
            dsel = dist[labels == label_list[ll]]
            if len(dsel) == 0:  # empty class: density would divide by 0
                continue
            h = np.histogram(dsel, bins=bins, density=True)[0]
            ax.plot(bins[:-1], h, color=colors[ll], label=f"{ll + 1}")
            ax.fill_between(bins[:-1], 0, h, color=colors[ll], alpha=0.2)
        ax.set_xlim(bins[0], bins[-1])
        ax.text(1, 0.9, tag, ha="right", va="top", transform=ax.transAxes,
                size=12)

    last_ax = None
    for l in range(n_clusters):
        sub = gridspec.GridSpecFromSubplotSpec(
            2, 1, subplot_spec=gs[l // 2, l % 2], hspace=0, wspace=0
        )
        axa = fig.add_subplot(sub[0])
        _panel(axa, dists_a[l], labels_a, "GMM")
        axa.set_title(rf"Class PDFs relative to $\mu_{{{l + 1}}}$",
                      loc="left", size=12)
        axa.set_xticklabels([])
        axb = fig.add_subplot(sub[1])
        _panel(axb, dists_b[l], labels_b, "DEC")
        if l == n_clusters - 1 or (n_clusters % 2 == 0 and l == n_clusters - 2):
            axb.set_xlabel(rf"$d=\Vert z-\mu_k\Vert_{p}$", size=12)
            axb.set_ylabel("PDF", size=12)
            last_ax = axb
        else:
            axb.set_xticklabels([]), axb.set_yticklabels([])
    handles, leg_labels = (last_ax or axb).get_legend_handles_labels()
    leg = fig.legend(handles, leg_labels, loc="lower center",
                     ncol=n_clusters, fontsize=10)
    leg.set_title("Classes")
    fig.subplots_adjust(bottom=0.18)
    return _finish(fig, show)


def view_dec_output(x, label, x_rec, z, idx: int = 0, show: bool = False):
    """Single-sample input/latent/reconstruction panel (reference
    view_DEC_output, plotting.py:1224-1262)."""
    plt = _plt()
    fig, axes = plt.subplots(1, 3, figsize=(12, 3))
    _img(axes[0], _to_hw(np.asarray(x)))
    axes[0].set_title(f"Input #{idx} (class {int(label) + 1})")
    axes[1].bar(np.arange(len(z)), np.asarray(z))
    axes[1].set_title("Latent")
    _img(axes[2], _to_hw(np.asarray(x_rec)))
    axes[2].set_title("Reconstruction")
    return _finish(fig, show)


def compare_silhscore(
    scores_z, scores_x, labels, n_clusters, xlim=(-1, 1), show: bool = False
):
    """Side-by-side latent/data-space silhouette plots (reference
    compare_silhscore, plotting.py:562-640)."""
    plt = _plt()
    labels = np.asarray(labels)
    colors = cmap_lifeaquatic(n_clusters)
    fig, axes = plt.subplots(
        1, 2, figsize=(12, max(n_clusters, 2)), sharey=True
    )
    for ax, scores, name in (
        (axes[0], np.asarray(scores_z), "Latent Space"),
        (axes[1], np.asarray(scores_x), "Data Space"),
    ):
        y_lower = 10
        for j in range(n_clusters):
            cs = np.sort(scores[labels == j])
            y_upper = y_lower + len(cs)
            ax.fill_betweenx(
                np.arange(y_lower, y_upper), 0, cs,
                facecolor=colors[j], edgecolor=colors[j], alpha=0.7,
            )
            y_lower = y_upper + 10
        ax.axvline(float(np.mean(scores)), color="red", linestyle="--")
        ax.set_title(name)
        ax.set_xlim(list(xlim))
        ax.set_xlabel("Silhouette Coefficient")
        ax.set_yticks([])
    return _finish(fig, show)


def centroid_dashboard(z, labels, centroids, p: int = 2, show: bool = False):
    """Per-class distance summaries: box plot of distance-to-centroid plus
    inter-centroid distance matrix (reference centroid_dashboard,
    plotting.py:162-284)."""
    plt = _plt()
    z = np.asarray(z)
    labels = np.asarray(labels)
    centroids = np.asarray(centroids)
    k = len(centroids)
    fig, axes = plt.subplots(1, 2, figsize=(12, 5))
    dists = [
        np.linalg.norm(z[labels == j] - centroids[j], ord=p, axis=1)
        for j in range(k)
    ]
    axes[0].boxplot(
        [d if len(d) else [0.0] for d in dists],
        tick_labels=[str(j + 1) for j in range(k)],
    )
    axes[0].set_xlabel("Class")
    axes[0].set_ylabel(f"L{p} distance to centroid")
    axes[0].set_title("Within-class distances")
    cc = np.linalg.norm(
        centroids[:, None, :] - centroids[None, :, :], ord=p, axis=2
    )
    im = axes[1].imshow(cc, cmap="viridis")
    axes[1].set_title("Inter-centroid distances")
    axes[1].set_xticks(range(k))
    axes[1].set_yticks(range(k))
    fig.colorbar(im, ax=axes[1])
    return _finish(fig, show)


def view_specgram(
    x, tvec=None, fvec=None, figtitle: str = "Spectrogram", show: bool = False
):
    """Spectrogram panel with physical time/freq axes when provided
    (reference view_specgram, plotting.py:1805-1836)."""
    plt = _plt()
    x2d = _to_hw(np.asarray(x))
    fig, ax = plt.subplots(figsize=(8, 4))
    extent = None
    if tvec is not None and fvec is not None:
        extent = [tvec[0], tvec[-1], fvec[0], fvec[-1]]
    im = ax.imshow(
        x2d, aspect="auto", origin="lower", cmap="viridis", extent=extent
    )
    ax.set_xlabel("Time (s)" if tvec is not None else "Time bin")
    ax.set_ylabel("Frequency (Hz)" if fvec is not None else "Frequency bin")
    ax.set_title(figtitle)
    fig.colorbar(im, ax=ax, label="log power")
    return _finish(fig, show)


def view_detections(
    fname_dataset, img_index, figsize=(12, 9), show: bool = False
):
    """Gallery of catalog samples: spectrogram + trace per index (reference
    view_detections, plotting.py:1265-1333)."""
    import json

    from spectrogram_cube_clustering_tpu_torch.data.h5 import _h5py

    plt = _plt()
    h5py = _h5py()

    n = len(img_index)
    fig, axes = plt.subplots(2, n, figsize=figsize, squeeze=False)
    with h5py.File(fname_dataset, "r") as f:
        spec_d = f["/4.0/Spectrogram"]
        trace_d = f["/4.0/Trace"]
        cat_d = f["/4.0/Catalogue"]
        for i, idx in enumerate(img_index):
            spec = np.asarray(spec_d[idx])[:-1, 1:]
            trace = np.asarray(trace_d[idx])
            meta = json.loads(cat_d[idx])
            _img(axes[0, i], spec)
            axes[0, i].set_title(f"{meta.get('Station', '?')} #{idx}")
            axes[1, i].plot(trace, lw=0.5)
            axes[1, i].set_xticks([])
    axes[0, 0].set_ylabel("Spectrogram")
    axes[1, 0].set_ylabel("Trace")
    return _finish(fig, show)


def view_series(
    station: str,
    aws: str,
    path_to_data: str,
    path_to_catalogue: str,
    path_to_labels: str,
    env_vars=("tide", "sea_ice_conc", "temp", "wind_spd"),
    times=None,
    freq: str = "month",
    threshold=None,
    log: bool = False,
    figsize=(12, 9),
    show: bool = False,
):
    """Environmental series stacked over per-class detection counts
    (reference view_series, plotting.py:1601-1757)."""
    plt = _plt()
    from spectrogram_cube_clustering_tpu_torch.analysis.catalogue import (
        EnvironmentCatalogue,
        LabelCatalogue,
    )

    df_env = EnvironmentCatalogue(station, aws, path_to_data).df
    catalogue = LabelCatalogue(
        [path_to_catalogue, path_to_labels], threshold=threshold
    )
    counts = catalogue.gather_counts(station=station, freq=freq)
    if times is not None:
        df_env = df_env.loc[(df_env.index >= times[0]) & (df_env.index <= times[1])]
        counts = counts.loc[(counts.index >= times[0]) & (counts.index <= times[1])]

    env_vars = [v for v in env_vars if v in df_env.columns]
    n_rows = len(env_vars) + 1
    fig, axes = plt.subplots(n_rows, 1, figsize=figsize, sharex=True, squeeze=False)
    for i, var in enumerate(env_vars):
        axes[i, 0].plot(df_env.index, df_env[var], lw=0.8)
        axes[i, 0].set_ylabel(var)
    ax = axes[-1, 0]
    colors = cmap_lifeaquatic(counts.shape[1])
    for j, col in enumerate(counts.columns):
        ax.plot(counts.index, counts[col], color=colors[j], label=f"Class {col}")
    if log:
        ax.set_yscale("log")
    ax.set_ylabel(f"Detections / {freq}")
    ax.legend(ncol=min(counts.shape[1], 5), fontsize=8)
    fig.suptitle(f"{station} — environment vs class activity")
    return _finish(fig, show)


def compare_images(x, x_rec, idx: int = 0, show: bool = False):
    """Original vs reconstruction pair with a difference panel (reference
    compare_images, plotting.py:525-559)."""
    plt = _plt()
    a = _to_hw(np.asarray(x)[idx] if np.asarray(x).ndim == 4 else x)
    b = _to_hw(np.asarray(x_rec)[idx] if np.asarray(x_rec).ndim == 4 else x_rec)
    fig, axes = plt.subplots(1, 3, figsize=(12, 3))
    _img(axes[0], a)
    axes[0].set_title("Original")
    _img(axes[1], b)
    axes[1].set_title("Reconstruction")
    _img(axes[2], a - b, cmap="coolwarm")
    axes[2].set_title("Difference")
    return _finish(fig, show)


def centroid_distances(z, labels, centroids, p: int = 2, show: bool = False):
    """Mean within-class distance to each centroid as a bar chart
    (reference centroid_distances, plotting.py:287-303)."""
    plt = _plt()
    z = np.asarray(z)
    labels = np.asarray(labels)
    centroids = np.asarray(centroids)
    k = len(centroids)
    means = []
    for j in range(k):
        sel = labels == j
        means.append(
            float(np.linalg.norm(z[sel] - centroids[j], ord=p, axis=1).mean())
            if np.any(sel) else 0.0
        )
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.bar(np.arange(1, k + 1), means, color=cmap_lifeaquatic(k))
    ax.set_xlabel("Class")
    ax.set_ylabel(f"Mean L{p} distance to centroid")
    ax.set_title("Centroid Distances")
    return _finish(fig, show)
