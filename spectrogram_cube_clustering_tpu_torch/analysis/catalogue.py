"""Label and environment catalogues.

Parity targets:
- `LabelCatalogue` (Cluster/utils.py:289-546): merges a detection-catalog
  CSV with a cluster-labels CSV into one time-indexed frame; per-station,
  seasonal, amplitude, and peak-frequency statistics; count resampling.
- `EnvironmentCatalogue` (Cluster/environment.py:26-164): joins tide
  (.mat), sea-ice (.mat), AWS meteo (.txt), ERA5 (.csv) and wave-amplitude
  (.mat) series into one DataFrame.

Both are host-side pandas analysis, off the device path. The RIS-specific
constants (station index shifts, season windows) follow the reference.

A copy (ROADMAP Queue 1 item 0) of the JAX package's
`analysis/catalogue.py`, over the port's `data/h5.py`. The one change:
pandas is imported by each function at its first line
(`utils.mathutils.import_pandas`), so this module imports without it
(the port does not depend on pandas) and a call raises ImportError naming
pandas before it reads or writes anything; `tests/test_torch_analysis.py` holds
the DataFrames to the original's.
"""

from __future__ import annotations

import glob
import os
from datetime import datetime
from typing import List, Optional, Sequence, Union

import numpy as np

from spectrogram_cube_clustering_tpu_torch.data.h5 import (
    SeismicDataset,
    get_station,
    get_timefreqvec,
)
from spectrogram_cube_clustering_tpu_torch.utils.mathutils import (
    import_pandas,
)

# Detection-catalog columns dropped on merge (reference utils.py:348-365).
_DROP_COLUMNS = [
    "channel", "dt_on", "dt_off", "fs", "delta", "npts", "STA", "LTA",
    "on", "off", "spec_start", "spec_stop",
]


class LabelCatalogue:
    """Time-indexed detections + cluster labels (utils.py:289-546)."""

    def __init__(
        self,
        paths: Sequence[str],
        label_list: Optional[List[int]] = None,
        threshold: Union[None, float, List[float]] = None,
    ):
        pd = import_pandas()
        self.paths = list(paths)
        self.freq = None
        self.df = self.build_df(self.paths)
        if label_list is not None:
            self.label_list = np.sort(np.asarray(label_list))
        else:
            self.label_list = np.sort(pd.unique(self.df["label"]))
        self.station_list = pd.unique(self.df["station"])
        self.threshold = threshold
        if threshold is not None:
            self.apply_threshold()

    @staticmethod
    def build_df(paths: Sequence[str]) -> pd.DataFrame:
        """Concat detection catalog (paths[0]) and labels CSV (paths[1]),
        index by peak time (utils.py:346-371)."""
        pd = import_pandas()
        data1 = pd.read_csv(paths[0])
        if "Index" in data1.columns:
            data1 = data1.drop(columns=["Index"])
        data2 = pd.read_csv(paths[1])
        df = pd.concat([data1, data2], axis=1)
        df = df.drop(columns=[c for c in _DROP_COLUMNS if c in df.columns])
        df = df.rename(columns={"dt_peak": "time"})
        df["time"] = pd.to_datetime(df["time"])
        return df.set_index("time").sort_index()

    def apply_threshold(self, threshold=None) -> pd.DataFrame:
        """Filter rows by peak amplitude: scalar = lower bound, 2-list =
        [lo, hi) (utils.py:327-344)."""
        if threshold is not None:
            self.threshold = threshold
        if isinstance(self.threshold, (int, float)) and not isinstance(
            self.threshold, bool
        ):
            self.df = self.df[self.df["peak"] >= self.threshold]
        elif isinstance(self.threshold, (list, tuple)):
            if len(self.threshold) != 2:
                raise ValueError("Threshold requires 1 or 2 values!")
            lo, hi = min(self.threshold), max(self.threshold)
            if lo == 0:
                lo -= 1  # catch ~0 values missed by floating point
            self.df = self.df[(self.df["peak"] >= lo) & (self.df["peak"] < hi)]
        return self.df

    def amplitude_statistics(self) -> pd.DataFrame:
        """Per-class |peak| mean/median/std/max (utils.py:305-324)."""
        pd = import_pandas()
        stats = []
        for label in self.label_list:
            subset = self.df["peak"].loc[self.df["label"] == label].abs()
            stats.append(
                (label + 1, subset.mean(), subset.median(), subset.std(),
                 subset.max())
            )
        return (
            pd.DataFrame(
                stats,
                columns=["Class", "Mean", "Median", "Standard Deviation",
                         "Maximum"],
            )
            .sort_values(by=["Class"], ignore_index=True)
            .set_index("Class")
        )

    def gather_counts(
        self, station: str, freq: str = "month",
        label_list: Optional[List[int]] = None,
    ) -> pd.DataFrame:
        """Per-class detection counts at one station, resampled to
        month/day/hour (utils.py:375-403)."""
        pd = import_pandas()
        freqcode = {"month": "1ME", "day": "1D", "hour": "1h"}.get(freq)
        if freqcode is None:
            raise ValueError(f"freq must be month/day/hour, got {freq!r}")
        self.freq = freq
        if label_list is not None and max(label_list) > max(self.label_list):
            raise ValueError("label_list includes impossibly high label.")
        if label_list is None:
            label_list = self.label_list
        frames = []
        for label in label_list:
            mask = (self.df["station"] == station) & (self.df["label"] == label)
            subset = self.df.loc[mask, ["label"]]
            counts = subset.resample(freqcode).count().rename(
                columns={"label": f"{label + 1}"}
            )
            frames.append(counts)
        return pd.concat(frames, axis=1).fillna(0).astype(int).sort_index()

    def get_peak_freq(
        self, fname_dataset: str, batch_size: int = 2048
    ) -> pd.DataFrame:
        """Class-averaged peak frequency: argmax over time-averaged spectra
        mapped through the embedded freq vector (utils.py:406-455).

        Deliberate fix vs the reference: the per-class average weights
        every SAMPLE equally (sum of per-sample peak freqs / class size).
        The reference averages per-batch means with equal weight
        (utils.py:434), over-weighting the trailing partial batch by up to
        batch_size x. The Class index stays the raw label values like the
        reference's table (note the reference numbers OTHER tables
        1-based, e.g. amplitude stats — that mixed numbering is its own).
        """
        pd = import_pandas()
        _, fvec = get_timefreqvec(fname_dataset)
        dataset = SeismicDataset(fname_dataset, "h5")
        class_avg = np.zeros(len(self.label_list))
        for j, label in enumerate(self.label_list):
            idx = self.df.loc[self.df["label"] == label, "idx"].to_numpy()
            if len(idx) == 0:
                continue
            total = 0.0
            for start in range(0, len(idx), batch_size):
                x = dataset.load_batch(idx[start : start + batch_size])
                # (B, 1, H, W): average over time bins, argmax over freq
                maxfreqind = (x.mean(axis=3)).argmax(axis=2).squeeze(-1)
                total += float(fvec[maxfreqind].sum())
            class_avg[j] = total / len(idx)
        return (
            pd.DataFrame(
                {"Class": self.label_list, "Avg_Peak_Freq": class_avg}
            )
            .sort_values(by=["Class"], ignore_index=True)
            .set_index("Class")
        )

    # Season windows follow the reference: JFM = Jan-Mar (austral summer),
    # JJA = Jun-Aug (austral winter), deployment years 2015/2016
    # (utils.py:469-517).
    _SEASONS = {
        "JFM15": (datetime(2015, 1, 1), datetime(2015, 4, 1)),
        "JJA15": (datetime(2015, 6, 1), datetime(2015, 9, 1)),
        "JFM16": (datetime(2016, 1, 1), datetime(2016, 4, 1)),
        "JJA16": (datetime(2016, 6, 1), datetime(2016, 9, 1)),
    }

    def seasonal_statistics(self, mode: Optional[str] = None) -> pd.DataFrame:
        pd = import_pandas()
        pct = {k: np.empty(len(self.label_list)) for k in self._SEASONS}
        total = np.empty(len(self.label_list))
        for j, label in enumerate(self.label_list):
            subset = self.df.loc[self.df["label"] == label]
            n = max(len(subset.index), 1)
            total[j] = len(subset.index)
            for key, (t0, t1) in self._SEASONS.items():
                mask = (subset.index >= t0) & (subset.index < t1)
                pct[key][j] = 100.0 * mask.sum() / n
        if mode is not None:
            return pd.DataFrame(
                {
                    "total": total,
                    "JFMTotal": pct["JFM15"] + pct["JFM16"],
                    "JFM15": pct["JFM15"],
                    "JFM16": pct["JFM16"],
                    "JJATotal": pct["JJA15"] + pct["JJA16"],
                    "JJA15": pct["JJA15"],
                    "JJA16": pct["JJA16"],
                }
            )
        return pd.DataFrame(
            {"JFM": pct["JFM15"] + pct["JFM16"],
             "JJA": pct["JJA15"] + pct["JJA16"]}
        )

    def station_statistics(self) -> pd.DataFrame:
        """Per-station totals, percentages, and per-class counts
        (utils.py:520-546)."""
        pd = import_pandas()
        rows = []
        total_count = len(self.df.index)
        for station in self.station_list:
            subset = self.df.loc[self.df["station"] == station]
            row = {
                "station": station,
                "N": len(subset.index),
                "percent": 100.0 * len(subset.index) / total_count,
            }
            for j, label in enumerate(self.label_list):
                row[j] = int((subset["label"] == label).sum())
            rows.append(row)
        df = pd.DataFrame(rows)
        df["N"] = df["N"].astype(int)
        return df.sort_values(by="station", ignore_index=True)


# -- environment data -------------------------------------------------------


def read_era5(path_glob: str) -> pd.DataFrame:
    """ERA5 net surface melting energy CSVs (environment.py:62-93)."""
    pd = import_pandas()
    frames = [
        pd.read_csv(
            f, index_col=[0], usecols=["time", "net_sfc_melt_energy"],
            parse_dates=True,
        )
        for f in sorted(glob.glob(path_glob))
    ]
    return pd.concat(frames) if frames else pd.DataFrame()


def read_meteo(path_glob: str) -> pd.DataFrame:
    """AWS meteo tab files -> temp (C) + wind speed (m/s)
    (environment.py:96-140)."""
    pd = import_pandas()
    frames = []
    for file in sorted(glob.glob(path_glob)):
        df = pd.read_csv(
            file, sep=" ", header=0,
            names=["Year", "Month", "Day", "Time", "temp", "wind_spd"],
            usecols=[0, 2, 3, 4, 5, 7],
            dtype={"Year": str, "Month": str, "Day": str, "Time": str},
            skipinitialspace=True, skiprows=1, na_values=444.0,
        )
        df["Hour"] = df.Time.str.slice(0, 2)
        df["Minute"] = df.Time.str.slice(2, 4)
        dti = pd.to_datetime(df[["Year", "Month", "Day", "Hour", "Minute"]])
        df = df.drop(columns=["Year", "Month", "Day", "Time", "Hour", "Minute"])
        df.index = dti
        frames.append(df)
    if not frames:
        return pd.DataFrame()
    out = pd.concat(frames).sort_index()
    return out[datetime(2014, 12, 1): datetime(2016, 12, 1)]


def read_kpdr(path: str) -> pd.DataFrame:
    """KPDR wave-amplitude .mat (MATLAB datenums) resampled to 10 min
    (environment.py:157-164)."""
    pd = import_pandas()
    from scipy.io import loadmat

    data = loadmat(path)
    datenums = data["t"].squeeze()
    timestamps = pd.to_datetime(datenums - 719529, unit="D").round("s")
    return (
        pd.DataFrame(data={"wave_ampl": data["a"].squeeze()}, index=timestamps)
        .resample("10min")
        .interpolate()
    )


# Stations whose tide-gauge row differs from the station index
# (environment.py:36-41).
_TIDE_INDEX_SHIFT = {"RS08": -1, "RS11": -1, "RS09": +1, "RS17": -2}


class EnvironmentCatalogue:
    """Joined tide / sea-ice / meteo / ERA5 / wave series
    (environment.py:26-59)."""

    def __init__(self, station: str, aws: str, path: str):
        self.station = station
        self.aws = aws
        self.path = path
        self.df = self.build_df(station, aws, path)

    @staticmethod
    def build_df(station: str, aws: str, path: str) -> pd.DataFrame:
        pd = import_pandas()
        from scipy.io import loadmat

        sta_ind = get_station(station) + _TIDE_INDEX_SHIFT.get(station, 0)
        tide = loadmat(os.path.join(path, "Tide", "RIS_Tides.mat"))["z"][sta_ind, :]
        df_tide = pd.DataFrame(
            {"tide": tide},
            index=pd.date_range("2014-12-01", "2016-12-01", freq="10min"),
        )
        ice = loadmat(os.path.join(path, "Ice", "NSIDC-0051.mat"))
        # .mat string cells round-trip as nested object arrays
        dates = [
            str(np.ravel(d)[0]) if isinstance(d, np.ndarray) else str(d)
            for d in np.ravel(ice["date"])
        ]
        df_ice = pd.DataFrame(
            {"sea_ice_conc": ice["C"].squeeze() * 100},
            index=pd.to_datetime(dates),
        )
        df_meteo = read_meteo(os.path.join(path, "Meteo", f"{aws}*.txt"))
        df_energy = read_era5(os.path.join(path, "ERA5", "*ERA5*.csv"))
        df_wave = read_kpdr(os.path.join(path, "Seismo", "KPDR_0.001_0.04.mat"))

        df = pd.concat([df_tide, df_ice, df_meteo, df_energy, df_wave], axis=1)
        for col in ("sea_ice_conc", "net_sfc_melt_energy"):
            if col in df:
                df[col] = df[col].interpolate()
        return df
