"""Training-history and label CSV writers (counterparts of the JAX
package's `utils/history.py`; reference Cluster/utils.py:1158-1209).

The JAX writers go through pandas, which the card's machine lacks; these
write the same tables with the stdlib `csv` module: a history's first key
is the index column, and `Labels.csv` is overwritten, not appended to.
Floats are written as their shortest round-trip repr, as pandas writes
them, so both files parse to the same table.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, Mapping, Optional, Sequence

import numpy as np


def _cell(v) -> str:
    if isinstance(v, (int, np.integer)):
        return str(int(v))
    return repr(float(v))


def add_to_history(
    history: Dict[str, list], values: Dict[str, float]
) -> Dict[str, list]:
    """Append one row of scalars to a history dict of lists (a copy of
    the JAX package's)."""
    for k, v in values.items():
        history.setdefault(k, []).append(v)
    return history


def save_history(history: Dict[str, Sequence], path: str) -> None:
    """Write a history dict of equal-length columns to CSV, first key as
    index (reference utils.py:1158-1179)."""
    cols = {k: list(v) for k, v in history.items()}
    lengths = {len(v) for v in cols.values()}
    if len(lengths) > 1:
        raise ValueError(f"history columns differ in length: {lengths}")
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(cols.keys())
        for row in zip(*cols.values()):
            w.writerow(_cell(v) for v in row)


def save_labels(
    label_rows, savepath: str, serial: Optional[str] = None
) -> str:
    """Write Labels[serial].csv (reference utils.py:1182-1209), overwriting
    any earlier file. `label_rows` is a list of dict rows (the reference's
    shape: a header of their keys, then one line per row) or an array of
    labels (`idx,label` per row)."""
    fname = os.path.join(
        savepath, f"Labels{serial}.csv" if serial else "Labels.csv"
    )
    if len(label_rows) == 0:
        return fname
    if isinstance(label_rows, (list, tuple)) and isinstance(label_rows[0],
                                                            Mapping):
        with open(fname, "w", newline="") as f:
            w = csv.DictWriter(f, label_rows[0].keys())
            w.writeheader()
            w.writerows(label_rows)
        return fname
    labels = np.asarray(label_rows)
    with open(fname, "w", newline="") as f:
        f.write("idx,label\n")
        for start in range(0, len(labels), 1 << 20):
            chunk = labels[start : start + (1 << 20)]
            idx = np.arange(start, start + len(chunk))
            np.savetxt(f, np.column_stack([idx, chunk]), fmt="%d",
                       delimiter=",")
    return fname
