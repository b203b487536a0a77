"""HDF5 spectrogram-catalog datasets and tools.

A copy of the JAX package's `data/h5.py` (numpy only; h5py imported at
first use), with one change: `get_datetime` counts days with `datetime`
instead of pandas, which the card's machine lacks. `tests/test_torch_h5.py`
holds every function and both dataset classes to the original.

Parity targets (Cluster/utils.py):
- `SeismicDataset` (utils.py:211-287): indexable over `/4.0/Spectrogram`
  in an HDF5 catalog (87x100 bins after crop; embedded time/freq vectors,
  utils.py:975-981), default pipeline crop -> vec_norm -> add channel,
  returning (idx, X);
- `query_dbSize` (utils.py:1084-1102), `get_metadata` (utils.py:928-939),
  `get_timefreqvec` (utils.py:975-981), `load_images` (utils.py:995-1014);
- RIS array name tables `get_station`/`get_channel`/`get_network`
  (utils.py:910-973);
- train/val index pickles `save_TraVal_index`/`load_TraVal_index`
  (utils.py:1212-1247, 173-179);
- dataset conversion/extraction used by the console scripts
  (utils.py:649-907).

The crop drops the last frequency row and first time column — the raw H5
layout embeds the freq vector in column 0 and the time vector in row 87
(reference SpecgramCrop, utils.py:233-236).

Every reader of an `.h5` file raises ImportError naming h5py where it
does not import. The catalog dump that `convert_h5_to_np` writes (and
`SeismicDataset(..., "np")`) needs none: convert where h5py is installed,
then train from the `.npy` (`h5_ftype = np`).
"""

from __future__ import annotations

import json
import operator
import os
import pickle
from datetime import datetime, timedelta
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

SPECTROGRAM_PATH = "/4.0/Spectrogram"
TRACE_PATH = "/4.0/Trace"
CATALOGUE_PATH = "/4.0/Catalogue"
SCALOGRAM_PATH = "/4.0/Scalogram"

STATION_LIST = [
    "DR01", "DR02", "DR03", "DR04", "DR05", "DR06", "DR07", "DR08",
    "DR09", "DR10", "DR11", "DR12", "DR13", "DR14", "DR15", "DR16",
    "RS01", "RS02", "RS03", "RS04", "RS05", "RS06", "RS07", "RS08",
    "RS09", "RS10", "RS11", "RS12", "RS13", "RS14", "RS15", "RS16",
    "RS17", "RS18",
]
CHANNEL_LIST = ["HHE", "HHN", "HHZ"]
NETWORK_LIST = ["XH"]


def get_station(station):
    """Station index <-> name (reference utils.py:944-967)."""
    if isinstance(station, (int, np.integer)):
        return STATION_LIST[int(station)]
    return STATION_LIST.index(station)


def get_channel(channel_index: int) -> str:
    return CHANNEL_LIST[channel_index]


#: the RIS deployment window's first and last day (reference
#: utils.py:916-925)
DEPLOYMENT_DAYS = (datetime(2014, 12, 2), datetime(2016, 11, 29))


def get_datetime(datetime_index: int) -> datetime:
    """Day index -> midnight of that day within the RIS deployment window
    (reference utils.py:916-925, a daily pandas date_range indexed the
    same way: negative indices count from the last day)."""
    first, last = DEPLOYMENT_DAYS
    days = (last - first).days + 1
    i = operator.index(datetime_index)
    if not -days <= i < days:
        raise IndexError(
            f"day index {i} outside the {days}-day deployment window")
    return first + timedelta(days=i % days)


def get_network(network_index: int) -> str:
    return NETWORK_LIST[network_index]


def _h5py():
    """h5py; ImportError naming it where it does not import."""
    try:
        import h5py
    except ImportError as exc:
        raise ImportError(
            "reading an .h5 catalog needs h5py, which is not installed; "
            "install it, or convert the catalog with convert-h5-to-np-torch "
            "where it is and set h5_ftype = np") from exc
    return h5py


def query_db_size(path: str) -> Tuple[int, int, int]:
    """(m, n, o) dims of the spectrogram dataset (utils.py:1084-1102)."""
    with _h5py().File(path, "r") as f:
        return tuple(f[SPECTROGRAM_PATH].shape)


def read_h5(fname: str, idx) -> np.ndarray:
    with _h5py().File(fname, "r") as f:
        return np.asarray(f[SPECTROGRAM_PATH][idx])


def get_metadata(query_index, sample_index, fname_dataset: str) -> Dict:
    """JSON metadata rows for query positions into sample_index
    (utils.py:928-939)."""
    out = {}
    with _h5py().File(fname_dataset, "r") as f:
        dset = f[CATALOGUE_PATH]
        for counter, i in enumerate(query_index):
            out[counter] = json.loads(dset[sample_index[i]])
    return out


def get_timefreqvec(fname_dataset: str) -> Tuple[np.ndarray, np.ndarray]:
    """(time vector, freq vector) embedded in sample 0 (utils.py:975-981)."""
    with _h5py().File(fname_dataset, "r") as f:
        dset = f[SPECTROGRAM_PATH]
        tvec = np.asarray(dset[0, 87, 1:])
        fvec = np.asarray(dset[0, 0:87, 0])
    return tvec, fvec


def crop_specgram(x: np.ndarray) -> np.ndarray:
    """Drop embedded time/freq vectors: X[:-1, 1:] (utils.py:233-236)."""
    return x[..., :-1, 1:]


def normalize_specgram(x: np.ndarray, transform: Optional[str]) -> np.ndarray:
    """Host-side normalizer matching ops.normalize semantics over the last
    two axes (reference SpecgramNormalizer, utils.py:213-231)."""
    if transform is None:
        return x
    if transform == "sample_normalization":
        return x / np.abs(x).max(axis=(-2, -1), keepdims=True)
    if transform == "sample_norm_cent":
        mean = x.mean(axis=(-2, -1), keepdims=True)
        return (x - mean) / (np.abs(x).max(axis=(-2, -1), keepdims=True) + 1e-8)
    if transform == "vec_norm":
        norm = np.sqrt((x * x).sum(axis=(-2, -1), keepdims=True)) + 1e-8
        return x / norm
    raise ValueError(f"unknown transform {transform!r}")


class SeismicDataset:
    """Indexable spectrogram catalog over `.h5` or `.npy` storage.

    Each item is (idx, X) with X (1, 87, 100) float32 after the default
    crop -> vec_norm pipeline (reference SeismicDataset, utils.py:211-287;
    default transform utils.py:249-257). Pass transform=None for raw
    windows, crop=False to keep the embedded time/freq vectors.
    """

    def __init__(
        self,
        fname: str,
        ftype: str = "h5",
        transform: Optional[str] = "vec_norm",
        crop: bool = True,
    ):
        if ftype not in ("h5", "np"):
            raise ValueError(f"ftype must be 'h5' or 'np', got {ftype!r}")
        self.fname = fname
        self.ftype = ftype
        self.transform = transform
        self.crop = crop
        if ftype == "np":
            self.data = np.load(fname)
            self._len = self.data.shape[0]
        else:
            self._len = query_db_size(fname)[0]

    def __len__(self) -> int:
        return self._len

    def __getitem__(self, idx: int) -> Tuple[int, np.ndarray]:
        if self.ftype == "np":
            x = np.asarray(self.data[idx], np.float32)
        else:
            x = read_h5(self.fname, idx).astype(np.float32)
        if self.crop:
            x = crop_specgram(x)
        x = normalize_specgram(x, self.transform)
        return idx, x[None, ...]  # add channel axis (utils.py:239-243)

    def load_batch(self, indices: Sequence[int]) -> np.ndarray:
        """(len(indices), 1, H, W) float32 stack.

        The H5 path reads through ONE file handle in index-sorted order
        (h5py's fancy-index requirement), then unsorts — per-event
        open/read/close cycles made load_all O(catalog) file opens."""
        indices = np.asarray(list(indices), np.int64)
        if self.ftype != "h5":
            return np.stack([self[i][1] for i in indices], axis=0)
        # h5py fancy indexing wants strictly increasing unique indices
        uniq, inv = np.unique(indices, return_inverse=True)
        with _h5py().File(self.fname, "r") as f:
            rows = np.asarray(f[SPECTROGRAM_PATH][uniq], np.float32)[inv]
        out = []
        for x in rows:
            if self.crop:
                x = crop_specgram(x)
            out.append(normalize_specgram(x, self.transform)[None, ...])
        return np.stack(out, axis=0)

    def load_all(self) -> np.ndarray:
        """Materialize the whole catalog (reference dataset_to_RAM,
        utils.py:601-632)."""
        return self.load_batch(range(len(self)))


class H5StreamDataset:
    """Block-reading H5 catalog adapter with the streaming item API of
    `ZarrCubeDataset` (`item` / `windows_per_item` / `n_windows` /
    `window_shape`), for `loadmode='stream'` over event catalogs that
    exceed host RAM: item i is catalog rows [i*block, (i+1)*block),
    cropped to (n, 87, 100, 1) float32 — one contiguous H5 read per item
    instead of one per event. Normalization is applied by the caller
    (the workflow's `_np_normalizer`), like the Zarr streaming path.
    """

    def __init__(self, fname: str, block: int = 256, crop: bool = True):
        if block < 1:
            raise ValueError(f"block must be >= 1, got {block}")
        self.fname = fname
        self.block = int(block)
        self.crop = crop
        self.m = query_db_size(fname)[0]
        with _h5py().File(fname, "r") as f:
            h, w = f[SPECTROGRAM_PATH].shape[1:3]
        self._shape = (h - 1, w - 1, 1) if crop else (h, w, 1)

    def __len__(self) -> int:
        return -(-self.m // self.block)

    @property
    def windows_per_item(self):
        """Per-item window counts (the last block may be short) — the
        form PrefetchLoader's per-host IO division accepts."""
        full, rem = divmod(self.m, self.block)
        counts = [self.block] * full
        if rem:
            counts.append(rem)
        return counts

    @property
    def n_windows(self) -> int:
        return self.m

    @property
    def window_shape(self) -> tuple:
        return self._shape

    def item(self, idx: int) -> np.ndarray:
        lo = idx * self.block
        hi = min(lo + self.block, self.m)
        if not (0 <= lo < self.m):
            raise IndexError(f"item {idx} out of range for {len(self)}")
        with _h5py().File(self.fname, "r") as f:
            x = np.asarray(f[SPECTROGRAM_PATH][lo:hi], np.float32)
        if self.crop:
            x = crop_specgram(x)
        return x[..., None]


def load_images(fname_dataset: str, index: Sequence[int]):
    """Full-resolution spectrogram images + time/freq vectors, mean/absmax
    normalized (reference load_images, utils.py:995-1014)."""
    with _h5py().File(fname_dataset, "r") as f:
        dset = f[SPECTROGRAM_PATH]
        x = np.stack([np.asarray(dset[i]) for i in index], axis=0)
        fvec = np.asarray(dset[0, 0:87, 0])
        tvec = np.asarray(dset[0, 87, 1:])
    x = x[:, :-1, 1:]
    x = (x - x.mean(axis=(1, 2), keepdims=True)) / np.abs(x).max(
        axis=(1, 2), keepdims=True
    )
    return x[:, None, :, :], tvec, fvec


# -- train/val index pickles ----------------------------------------------


def save_traval_index(
    m: int, fname_dataset: str, savepath: str,
    reserve: float = 0.0, seed: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray, str]:
    """Draw and persist train/val sample indices (utils.py:1212-1247):
    uniform choice without replacement from [1, M), 80/20 split."""
    m_db = query_db_size(fname_dataset)[0]
    if m > m_db:
        print(
            f"{m} spectrograms requested, but only {m_db} available in "
            f"database; setting M to {m_db}."
        )
        m = m_db
    rng = np.random.default_rng(seed)
    # population is [1, m_db) == m_db - 1 candidates; clamp the draw so
    # m == m_db (the clamp path above) or a reserve overshoot cannot ask
    # for more samples than exist
    n_draw = min(int(m * (1 + reserve)), m_db - 1)
    index = rng.choice(np.arange(1, m_db), size=n_draw, replace=False)
    split = int(0.8 * len(index))
    index_tra, index_val = index[:split], index[split:]
    path = os.path.join(savepath, f"TraValIndex_M={m}.pkl")
    with open(path, "wb") as f:
        pickle.dump({"index_tra": index_tra, "index_val": index_val}, f)
    print(f"{m} training & validation indices saved to:\n{path}")
    return index_tra, index_val, path


def load_traval_index(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Load index pickle (reference load_TraVal_index, utils.py:173-179)."""
    with open(path, "rb") as f:
        data = pickle.load(f)
    return data["index_tra"], data["index_val"]


# -- catalog conversion / extraction ---------------------------------------


def convert_h5_to_np(source: str, dest: Optional[str] = None) -> str:
    """Dump the (cropped, default-normalized) spectrograms to `.npy`
    (reference convert_H5_to_NP, utils.py:649-694)."""
    ds = SeismicDataset(source, "h5")
    n = len(ds)
    first = ds[0][1]
    out = np.zeros((n, *first.shape), np.float32)
    for i in range(n):
        out[i] = ds[i][1]
    dest = dest or source
    np.save(dest, out)
    return dest if dest.endswith(".npy") else dest + ".npy"


def _metadata_station(f, idx: int) -> str:
    return json.loads(f[CATALOGUE_PATH][idx])["Station"]


def extract_h5_dataset(
    source: str,
    dest: str,
    include: Optional[List] = None,
    exclude: Optional[List] = None,
    after: Optional[str] = None,
    before: Optional[str] = None,
    workers: Optional[int] = None,
) -> int:
    """Copy the catalog subset matching station/time filters to a new H5
    (reference extractH5dataset, utils.py:697-863). Returns kept count.

    include/exclude entries may be station names or indices; after/before
    are 'YYYYMMDDTHHMMSS' strings compared against the metadata StartTime.
    The metadata scan fans out over `workers` threads (default
    min(cpus, 14), mirroring the reference's 14-worker pool) each with its
    own read handle; the copy runs in 4096-row fancy-index blocks.
    """
    h5py = _h5py()
    if include is None and exclude is None:
        raise ValueError("must specify stations to include or exclude")

    def _names(vals):
        # numpy integer indices are as valid as Python ints (get_station
        # accepts both); leaving them unconverted would build a set of
        # np.int64 that matches no catalog Station string — a silent
        # empty extraction
        return [
            get_station(v) if isinstance(v, (int, np.integer)) else v
            for v in vals
        ]

    if include is not None:
        stations = _names(include)
        if exclude is not None:
            removals = set(_names(exclude))
            stations = [s for s in stations if s not in removals]
    else:
        removals = set(_names(exclude))
        stations = [s for s in STATION_LIST if s not in removals]
    stations = set(stations)

    t_after = datetime.strptime(after, "%Y%m%dT%H%M%S") if after else None
    t_before = datetime.strptime(before, "%Y%m%dT%H%M%S") if before else None

    def _row_passes(raw) -> bool:
        meta = json.loads(raw)
        if meta["Station"] not in stations:
            return False
        if t_after or t_before:
            start = str(meta.get("StartTime", "")).replace("-", "").replace(":", "")
            start = start.replace(" ", "T").split(".")[0]
            try:
                t = datetime.strptime(start[:15], "%Y%m%dT%H%M%S")
            except ValueError:
                t = None
            if t is not None:
                if t_after and t < t_after:
                    return False
                if t_before and t > t_before:
                    return False
        return True

    def _scan_chunk(lo: int, hi: int) -> list:
        # own read handle per worker: h5py handles are not thread-safe,
        # but multiple read-only handles on one file are fine — the
        # parallel analog of the reference's 14-worker process pool
        # (utils.py:830-839) without the fork/pickle overhead.
        with h5py.File(source, "r") as f:
            rows = f[CATALOGUE_PATH][lo:hi]
        return [lo + j for j, raw in enumerate(rows) if _row_passes(raw)]

    import concurrent.futures as cf

    if workers is None:
        workers = min(os.cpu_count() or 1, 14)
    with h5py.File(source, "r") as fs:
        # bound the scan by the dataset actually read — Trace may be
        # absent (the copy loop below tolerates that) or differ in length
        m = len(fs[CATALOGUE_PATH])
    chunk = max(1024, -(-m // max(workers * 4, 1)))
    spans = [(lo, min(lo + chunk, m)) for lo in range(1, m, chunk)]
    keep = []
    with cf.ThreadPoolExecutor(max_workers=workers) as pool:
        for part in pool.map(lambda s: _scan_chunk(*s), spans):
            keep.extend(part)
    keep.sort()

    with h5py.File(source, "r") as fs, h5py.File(dest, "w") as fd:
        group = fd.require_group("/4.0")
        for name in ("Catalogue", "Trace", "Spectrogram", "Scalogram"):
            path = f"/4.0/{name}"
            if path not in fs:
                continue
            dset = fs[path]
            if keep and keep[-1] >= len(dset):
                # an auxiliary dataset SHORTER than Catalogue (lengths can
                # differ — see the scan bound above) can't supply every
                # kept row; skip it whole rather than crash mid-copy and
                # leave a torn dest with half its datasets written
                import warnings

                warnings.warn(
                    f"{path} has {len(dset)} rows < kept index "
                    f"{keep[-1]}; omitting it from {dest}",
                    stacklevel=2,
                )
                continue
            out = group.create_dataset(
                name, (len(keep),) + dset.shape[1:], dtype=dset.dtype
            )
            for key, value in dset.attrs.items():
                out.attrs[key] = value
            # blocked fancy-index copies instead of row-at-a-time writes
            block = 4096
            for j0 in range(0, len(keep), block):
                sel = keep[j0 : j0 + block]
                out[j0 : j0 + len(sel)] = dset[sel]
    return len(keep)
