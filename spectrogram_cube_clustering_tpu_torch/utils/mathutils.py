"""Misc math utilities: a copy (ROADMAP Queue 1 item 0) of the JAX
package's `utils/mathutils.py` (reference Cluster/utils.py:635-646,
866-869, 1024-1058): `fractional_distance` and `distance_matrix`, which
the figures use (pinned to the originals by `tests/test_torch_figures.py`),
`measure_class_inertia` and `measure_label_change` (pinned by
`tests/test_torch_analysis.py`).

`measure_label_change` builds a pandas table: pandas is imported when it
is called, and where it is missing the call raises ImportError naming it,
so the module imports without pandas (the port does not depend on it).
"""

from __future__ import annotations

import numpy as np


def fractional_distance(x: np.ndarray, y: np.ndarray, f: float) -> np.ndarray:
    """Row-wise Lp (p=f) distance between x and y, both (M, D)."""
    diff = np.abs(np.asarray(x) - np.asarray(y)) ** f
    return np.sum(diff, axis=1) ** (1.0 / f)


def distance_matrix(x: np.ndarray, y: np.ndarray, f: float) -> np.ndarray:
    """(M, M) pairwise Lp distance between rows of x and rows of y."""
    x = np.asarray(x)
    y = np.asarray(y)
    if len(x) != len(y):
        raise ValueError("x and y must have the same number of rows")
    diff = np.abs(x[:, None, :] - y[None, :, :]) ** f
    return diff.sum(axis=-1) ** (1.0 / f)


def measure_class_inertia(
    data: np.ndarray, centroids: np.ndarray, n_clusters: int
) -> np.ndarray:
    """Sum of squared distances of all samples to each centroid."""
    data = np.asarray(data)
    inertia = np.empty(n_clusters)
    for j in range(n_clusters):
        inertia[j] = np.sum(np.sum((data - centroids[j]) ** 2, axis=1))
    return inertia


def import_pandas():
    """pandas; ImportError naming it where it is not installed."""
    try:
        import pandas
    except ImportError as exc:
        raise ImportError(
            "this table needs pandas, which is not installed; install "
            "pandas to use it") from exc
    return pandas


def measure_label_change(labels1: np.ndarray, labels2: np.ndarray):
    """Confusion table of label migrations labels1 -> labels2, a pandas
    DataFrame.

    Rows are original classes; columns N_j (changed count), %N (percent of
    the dataset), and the per-destination-class counts; final row = totals.
    """
    pd = import_pandas()
    labels1 = np.asarray(labels1)
    labels2 = np.asarray(labels2)
    # classes = union of both labelings: a class empty in labels1 can
    # still receive migrations, and a fixed-width histogram over
    # [min, min+k) would both drop out-of-range destinations and shift
    # the per-class columns when the label values have gaps
    label_list = np.unique(np.concatenate([labels1, labels2]))
    k = len(label_list)
    m = len(labels1)
    counts = np.zeros((k, k), dtype=int)
    total_counts = np.zeros(k, dtype=int)
    percentages = np.zeros(k)

    for row, label in enumerate(label_list):
        sel = labels1 == label
        changed = labels2[sel][labels2[sel] != label]
        counts[row] = [int(np.sum(changed == dst)) for dst in label_list]
        total_counts[row] = counts[row].sum()
        percentages[row] = 100.0 * counts[row].sum() / m

    data = {"N_j": total_counts, "%N": percentages}
    data.update(
        {f"Class {int(label) + 1}": counts[row] for row, label in enumerate(label_list)}
    )
    # Faithful reference quirk (utils.py:1052-1057): each 'Class {j+1}'
    # column holds ORIGIN j's destination counts — so within the Class
    # block the ROW position is the destination class — while the N_j/%N
    # columns are per-origin totals indexed by row, and the index is
    # nonetheless named 'Orig'. The reference builds exactly this mixed
    # layout; replicated as-is for CSV parity.
    df = pd.DataFrame(data=data, index=[int(v) for v in label_list])
    df.loc["total"] = df.sum(numeric_only=True)
    int_cols = [c for c in df.columns if c != "%N"]
    df[int_cols] = df[int_cols].astype(int)
    df.index.names = ["Orig"]
    return df
