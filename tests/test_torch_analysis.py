"""The port's host analysis layer against the JAX package's on the CPU.

- `analysis/sacio.py`: the SAC and miniSEED bytes written from the same
  traces equal JAX's, each read back equal; each trace op (trim,
  detrend, taper, filter, decimate, merge) gives equal samples.
- `analysis/catalogue.py`: `LabelCatalogue` (its frame and each
  statistic, `get_peak_freq` over an `.h5` catalog), `read_era5`,
  `read_meteo`, `read_kpdr` and `EnvironmentCatalogue` give equal
  DataFrames; `utils.mathutils.measure_label_change` too, and
  `measure_class_inertia` equal arrays; `add_to_history` and
  `init_project_env` do what JAX's do.
- The 13 figures no workflow stage draws: the same Agg RGBA buffer as
  JAX's on the same inputs (as tests/test_torch_figures.py holds the
  others).
- Without pandas the catalogues and `measure_label_change`, and without
  matplotlib the new figures, raise ImportError naming the package
  before they read or write anything.

`analysis/seismic.py`: tests/test_torch_seismic.py.
"""

import io
import json
import os
import sys
from datetime import datetime, timedelta

import numpy as np
import pandas as pd
import pytest

from spectrogram_cube_clustering_tpu import utils as jutils
from spectrogram_cube_clustering_tpu.analysis import catalogue as jcat
from spectrogram_cube_clustering_tpu.analysis import plotting as jplot
from spectrogram_cube_clustering_tpu.analysis import sacio as jsacio
from spectrogram_cube_clustering_tpu_torch import utils as tutils
from spectrogram_cube_clustering_tpu_torch.analysis import catalogue as tcat
from spectrogram_cube_clustering_tpu_torch.analysis import plotting as tplot
from spectrogram_cube_clustering_tpu_torch.analysis import sacio
from torch_train_common import (  # noqa: F401 (autouse)
    one_openmp_thread,
    one_torch_thread,
)

# --------------------------------------------------------------------------
# sacio


def _trace(io_mod, n=1000, fs=20.0, t0=None, data=None, seed=0, **ids):
    stats = io_mod.Stats(starttime=t0 or datetime(2015, 1, 2, 3, 4, 5),
                         sampling_rate=fs, npts=n, **ids)
    if data is None:
        data = np.random.default_rng(seed).normal(size=n)
    return io_mod.Trace(np.array(data, copy=True), stats)


IDS = dict(network="KP", station="KPDR", location="", channel="HDH")
TRACES = {  # name -> (n, fs, start)
    "long_200hz": (2500, 200.0, None),
    "sub_hz": (100, 0.2, None),
    "non_integral": (50, 6.25, None),
    "high_rate": (64, 40_000.0, None),
    "subsecond_start": (777, 100.0, datetime(2015, 6, 1, 0, 0, 0, 250000)),
    "empty": (0, 100.0, None),
}


def _written(tmp_path, name, write, io_mod, trace_args, **kw):
    n, fs, t0 = trace_args
    path = tmp_path / f"{name}.bin"
    write(str(path), _trace(io_mod, n=n, fs=fs, t0=t0, **IDS), **kw)
    return path.read_bytes()


def _same_trace(a, b):
    assert a.data.dtype == b.data.dtype and np.array_equal(a.data, b.data)
    assert vars(a.stats) == vars(b.stats)


@pytest.mark.parametrize("order", ["<", ">"])
@pytest.mark.parametrize("case", [c for c in TRACES if c != "empty"])
def test_sac_bytes_equal_jax(tmp_path, case, order):
    got = _written(tmp_path, "port", sacio.write_sac, sacio, TRACES[case],
                   byteorder=order)
    want = _written(tmp_path, "jax", jsacio.write_sac, jsacio, TRACES[case],
                    byteorder=order)
    assert got == want
    _same_trace(sacio.read_sac(str(tmp_path / "port.bin")),
                jsacio.read_sac(str(tmp_path / "port.bin")))


@pytest.mark.parametrize("case", TRACES)
def test_mseed_bytes_equal_jax(tmp_path, case):
    got = _written(tmp_path, "port", sacio.write_mseed, sacio, TRACES[case])
    want = _written(tmp_path, "jax", jsacio.write_mseed, jsacio,
                    TRACES[case])
    assert got == want
    _same_trace(sacio.read_mseed(str(tmp_path / "port.bin")),
                jsacio.read_mseed(str(tmp_path / "port.bin")))
    st, jst = sacio.read(str(tmp_path / "port.bin")), jsacio.read(
        str(tmp_path / "port.bin"))
    assert len(st) == len(jst) == 1


T0 = datetime(2015, 1, 1)
OPS = {
    "trim": lambda tr: tr.trim(starttime=T0 + timedelta(seconds=3.02),
                               endtime=T0 + timedelta(seconds=40)),
    "detrend": lambda tr: tr.detrend(type="linear"),
    "demean": lambda tr: tr.detrend(type="demean"),
    "taper": lambda tr: tr.taper(max_percentage=0.5, type="hann",
                                 max_length=3),
    "lowpass_zerophase": lambda tr: tr.filter("lowpass", freq=0.4,
                                              corners=2, zerophase=True),
    "bandpass": lambda tr: tr.filter("bandpass", freqmin=0.5, freqmax=4.0),
    "decimate": lambda tr: tr.decimate(4, no_filter=True),
}


@pytest.mark.parametrize("op", OPS)
def test_trace_op_equals_jax(op):
    got = OPS[op](_trace(sacio, n=2000, fs=20.0, t0=T0, **IDS))
    want = OPS[op](_trace(jsacio, n=2000, fs=20.0, t0=T0, **IDS))
    _same_trace(got, want)


def _merge_inputs(io_mod, case):
    """tests/test_sacio.py's merge cases."""
    def tr(n, t, value=None, station="S"):
        return _trace(io_mod, n=n, fs=1.0, t0=T0 + timedelta(seconds=t),
                      data=None if value is None else np.full(n, value),
                      seed=t, station=station, channel="C")
    if case == "gap":
        return [tr(10, 0, 2.0), tr(10, 15, 4.0)], dict(
            method=1, fill_value="interpolate")
    if case == "overlap":
        return [tr(20, 0), tr(20, 10)], dict(method=1,
                                             interpolation_samples=5)
    if case == "out_of_order":
        return [tr(5, 5, 7.0), tr(5, 0, 3.0)], {}
    return [tr(10, 0, station="A"), tr(10, 0, station="B")], {}


@pytest.mark.parametrize("case", ["gap", "overlap", "out_of_order",
                                  "distinct_ids"])
def test_stream_merge_equals_jax(case):
    traces, kw = _merge_inputs(sacio, case)
    jtraces, _ = _merge_inputs(jsacio, case)
    got = sacio.Stream(traces[:1]) + sacio.Stream(traces[1:])
    want = jsacio.Stream(jtraces[:1]) + jsacio.Stream(jtraces[1:])
    got.merge(**kw)
    want.merge(**kw)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        _same_trace(a, b)


# --------------------------------------------------------------------------
# catalogues and utils


def _same_frame(got, want):
    pd.testing.assert_frame_equal(got, want, check_exact=True)


@pytest.fixture(scope="module")
def label_csvs(tmp_path_factory):
    """tests/test_analysis.py's detection catalog and labels, with an
    `.h5` catalog the detections index (freq vector in column 0)."""
    import h5py

    root = tmp_path_factory.mktemp("catalogue")
    rng = np.random.default_rng(21)
    n = 60
    times = pd.date_range("2015-01-01", "2016-09-01", periods=n)
    det = pd.DataFrame({
        "Index": np.arange(n), "network": "XH",
        "station": [["DR01", "DR02", "RS01"][i % 3] for i in range(n)],
        "channel": "HHZ", "dt_on": times - pd.Timedelta(seconds=5),
        "dt_peak": times, "dt_off": times + pd.Timedelta(seconds=5),
        "fs": 100.0, "delta": 0.01, "npts": 1000, "STA": 1.0, "LTA": 10.0,
        "on": 2.5, "off": 1.0, "spec_start": 0, "spec_stop": 100,
        "peak": rng.lognormal(size=n), "unit": "m/s", "idx": np.arange(n),
    })
    lab = pd.DataFrame({"label": np.arange(n) % 4})
    det_path, lab_path = str(root / "det.csv"), str(root / "lab.csv")
    det.to_csv(det_path, index=False)
    lab.to_csv(lab_path, index=False)
    h5_path = str(root / "catalog.h5")
    spec = rng.normal(size=(n, 88, 101))
    spec[:, 0:87, 0] = np.linspace(0.5, 50.0, 87)
    spec[:, 87, 1:] = np.arange(100)
    with h5py.File(h5_path, "w") as f:
        g = f.require_group("/4.0")
        g.create_dataset("Spectrogram", data=spec)
        g.create_dataset("Trace", data=rng.normal(size=(n, 100)))
        g.create_dataset("Catalogue", data=np.array(
            [json.dumps({"Station": "DR01"})] * n, dtype=h5py.string_dtype()))
    return det_path, lab_path, h5_path


CATALOGUE_CALLS = {
    "df": lambda c: c.df,
    "amplitude_statistics": lambda c: c.amplitude_statistics(),
    "gather_counts_month": lambda c: c.gather_counts("DR01", "month"),
    "gather_counts_day_subset": lambda c: c.gather_counts(
        "RS01", "day", label_list=[1, 3]),
    "gather_counts_hour": lambda c: c.gather_counts("DR02", "hour"),
    "seasonal_statistics": lambda c: c.seasonal_statistics(),
    "seasonal_statistics_mode": lambda c: c.seasonal_statistics("all"),
    "station_statistics": lambda c: c.station_statistics(),
    "threshold_scalar": lambda c: c.apply_threshold(1.0),
    "threshold_band": lambda c: c.apply_threshold([0, 2.0]),
}


@pytest.mark.parametrize("call", CATALOGUE_CALLS)
def test_label_catalogue_equals_jax(label_csvs, call):
    det_path, lab_path, _ = label_csvs
    got = CATALOGUE_CALLS[call](tcat.LabelCatalogue([det_path, lab_path]))
    want = CATALOGUE_CALLS[call](jcat.LabelCatalogue([det_path, lab_path]))
    _same_frame(got, want)


def test_label_catalogue_options_and_peak_freq_equal_jax(label_csvs):
    det_path, lab_path, h5_path = label_csvs
    kw = dict(label_list=[0, 1, 2], threshold=[0.5, 3.0])
    got = tcat.LabelCatalogue([det_path, lab_path], **kw)
    want = jcat.LabelCatalogue([det_path, lab_path], **kw)
    _same_frame(got.df, want.df)
    assert np.array_equal(got.label_list, want.label_list)
    assert list(got.station_list) == list(want.station_list)
    _same_frame(got.get_peak_freq(h5_path, batch_size=7),
                want.get_peak_freq(h5_path, batch_size=7))
    with pytest.raises(ValueError, match="impossibly high"):
        got.gather_counts("DR01", label_list=[9])


@pytest.fixture(scope="module")
def env_tree(tmp_path_factory):
    """tests/test_analysis.py's environment tree (the reference layout,
    environment.py:33-52)."""
    from scipy.io import savemat

    rng = np.random.default_rng(22)
    root = tmp_path_factory.mktemp("env")
    for sub in ("Tide", "Ice", "Meteo", "ERA5", "Seismo"):
        (root / sub).mkdir(parents=True)
    n_t = len(pd.date_range("2014-12-01", "2016-12-01", freq="10min"))
    savemat(str(root / "Tide" / "RIS_Tides.mat"),
            {"z": rng.normal(size=(34, n_t))})
    days = pd.date_range("2014-12-01", "2016-11-30", freq="D")
    savemat(str(root / "Ice" / "NSIDC-0051.mat"), {
        "C": rng.uniform(0, 1, size=(len(days), 1)),
        "date": np.array([d.strftime("%Y-%m-%d") for d in days],
                         dtype=object)})
    rows = ["Year JulianDay Month Day Time temp x wind_spd"]
    for d in days[:100]:
        rows.append(f"{d.year} {d.dayofyear} {d.month:02d} {d.day:02d} "
                    f"{d.strftime('%H%M')} {rng.normal():.1f} 0 "
                    f"{abs(rng.normal()):.1f}")
    (root / "Meteo" / "AWS01.txt").write_text("\n".join(rows) + "\n")
    pd.DataFrame({"time": days[:50],
                  "net_sfc_melt_energy": rng.uniform(0, 5, size=50)}).to_csv(
        root / "ERA5" / "SDM_ERA5.csv", index=False)
    savemat(str(root / "Seismo" / "KPDR_0.001_0.04.mat"), {
        "t": 735934.0 + np.arange(0, 10, 1 / 144.0),
        "a": rng.uniform(size=1440)})
    return str(root)


ENV_CALLS = {
    "read_era5": lambda m, root: m.read_era5(
        os.path.join(root, "ERA5", "*ERA5*.csv")),
    "read_era5_none": lambda m, root: m.read_era5(
        os.path.join(root, "ERA5", "nothing*.csv")),
    "read_meteo": lambda m, root: m.read_meteo(
        os.path.join(root, "Meteo", "AWS*.txt")),
    "read_kpdr": lambda m, root: m.read_kpdr(
        os.path.join(root, "Seismo", "KPDR_0.001_0.04.mat")),
    "environment_DR02": lambda m, root: m.EnvironmentCatalogue(
        "DR02", "AWS01", root).df,
    "environment_RS09": lambda m, root: m.EnvironmentCatalogue(
        "RS09", "AWS01", root).df,
}


@pytest.mark.parametrize("call", ENV_CALLS)
def test_environment_frames_equal_jax(env_tree, call):
    _same_frame(ENV_CALLS[call](tcat, env_tree),
                ENV_CALLS[call](jcat, env_tree))


LABEL_PAIRS = {
    "three_classes": ([0, 0, 1, 1, 2, 2], [0, 1, 1, 2, 2, 0]),
    "gapped": ([0, 0, 1, 3], [0, 3, 1, 3]),
    "no_change": ([2, 1, 0, 1], [2, 1, 0, 1]),
    "random": tuple(np.random.default_rng(4).integers(0, 6, (2, 500))),
}


@pytest.mark.parametrize("pair", LABEL_PAIRS)
def test_measure_label_change_equals_jax(pair):
    l1, l2 = (np.asarray(v) for v in LABEL_PAIRS[pair])
    _same_frame(tutils.measure_label_change(l1, l2),
                jutils.measure_label_change(l1, l2))


def test_class_inertia_history_and_project_env_match_jax(tmp_path, capsys):
    rng = np.random.default_rng(9)
    z, c = rng.normal(size=(50, 9)), rng.normal(size=(4, 9))
    got = tutils.measure_class_inertia(z, c, 4)
    want = jutils.measure_class_inertia(z, c, 4)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    rows = [{"epoch": 1, "loss": 0.5}, {"epoch": 2, "loss": 0.25, "x": 1}]
    th, jh = {}, {}
    for row in rows:
        assert tutils.add_to_history(th, row) is th
        jutils.add_to_history(jh, row)
    assert th == jh
    printed = {}
    for name, mod in (("port", tutils), ("jax", jutils)):
        (tmp_path / name / "a").mkdir(parents=True)
        mod.init_project_env(str(tmp_path / name / "a"),
                             str(tmp_path / name / "b" / "c"))
        printed[name] = capsys.readouterr().out.replace(name, "*")
        assert (tmp_path / name / "b" / "c").is_dir()
    assert printed["port"] == printed["jax"]


# --------------------------------------------------------------------------
# figures

DPI = 12  # small: the comparison is of the drawing, not its resolution


def _rgba(fig) -> bytes:
    buf = io.BytesIO()
    fig.savefig(buf, format="rgba", dpi=DPI)
    return buf.getvalue()


def _figure_inputs():
    rng = np.random.default_rng(2010)
    m, k, d = 40, 4, 9
    return dict(
        z=rng.normal(size=(m, d)).astype(np.float32),
        z_b=rng.normal(size=(m, d)).astype(np.float32),
        labels=rng.integers(0, k, size=m),
        labels_b=rng.choice([0, 1, 3], size=m),  # class 2 empty
        cents=rng.normal(size=(k, d)).astype(np.float32),
        cents_b=rng.normal(size=(k, d)).astype(np.float32),
        x=rng.normal(size=(m, 4, 101, 1)).astype(np.float32),
        scores=rng.uniform(-1, 1, size=m),
        history={"epoch": [1, 2, 3], "train": [0.9, 0.5, 0.4],
                 "validation": [1.0, 0.6, 0.5]},
        dec_history={"iteration": [0, 10, 20], "total": [3.0, 2.0, 1.5],
                     "reconstruction": [1.0, 0.8, 0.7],
                     "clustering": [2.0, 1.2, 0.8]},
        deltas={"iteration": [0, 10], "delta": [0.2, 0.01]},
    )


FIGURES = {
    "view_history_aec": lambda p, a, _: p.view_history_aec(a["history"]),
    "view_learning_curve": lambda p, a, _: p.view_learning_curve(
        a["history"]),
    "view_history_dec": lambda p, a, _: p.view_history_dec(
        a["dec_history"], a["deltas"]),
    "view_history_dec_no_deltas": lambda p, a, _: p.view_history_dec(
        a["dec_history"]),
    "view_centroid_output": lambda p, a, _: p.view_centroid_output(
        a["x"][:4]),
    "view_class_pdf_single": lambda p, a, _: p.view_class_pdf_single(
        a["z"], a["labels_b"], a["cents"]),
    "view_class_pdf": lambda p, a, _: p.view_class_pdf(
        a["z"], a["labels"], a["z_b"], a["labels_b"], a["cents"],
        a["cents_b"]),
    "view_class_pdf_three_args": lambda p, a, _: p.view_class_pdf(
        a["z"], a["labels"], a["cents"]),
    "view_dec_output": lambda p, a, _: p.view_dec_output(
        a["x"][3], 2, a["x"][4], a["z"][3], idx=3),
    "compare_silhscore": lambda p, a, _: p.compare_silhscore(
        a["scores"], a["scores"][::-1], a["labels"], 4, xlim=(-0.5, 1)),
    "centroid_dashboard": lambda p, a, _: p.centroid_dashboard(
        a["z"], a["labels_b"], a["cents"]),
    "view_specgram": lambda p, a, _: p.view_specgram(
        a["x"][0], tvec=np.arange(101), fvec=np.arange(4)),
    "view_specgram_bins": lambda p, a, _: p.view_specgram(a["x"][1]),
    "view_detections": lambda p, a, paths: p.view_detections(
        paths["h5"], [0, 2, 5]),
    "view_series": lambda p, a, paths: p.view_series(
        "DR02", "AWS01", paths["env"], paths["det"], paths["lab"],
        freq="month", times=(datetime(2015, 2, 1), datetime(2016, 6, 1)),
        log=True),
    "compare_images": lambda p, a, _: p.compare_images(a["x"], a["x"][::-1],
                                                       idx=1),
    "centroid_distances": lambda p, a, _: p.centroid_distances(
        a["z"], a["labels_b"], a["cents"], p=1),
}


@pytest.fixture(scope="module")
def figure_paths(label_csvs, env_tree):
    det_path, lab_path, h5_path = label_csvs
    return {"det": det_path, "lab": lab_path, "h5": h5_path, "env": env_tree}


@pytest.mark.parametrize("name", FIGURES)
def test_figure_matches_jax(figure_paths, name):
    """The copy draws what the original draws, pixel for pixel."""
    args = _figure_inputs()
    got = FIGURES[name](tplot, args, figure_paths)
    want = FIGURES[name](jplot, args, figure_paths)
    a, b = _rgba(got), _rgba(want)
    assert len(a) == len(b) and a == b


# --------------------------------------------------------------------------
# refusals


def _tree(root: str) -> dict:
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            out[os.path.relpath(p, root)] = os.path.getmtime(p)
    return out


REFUSALS = {
    "LabelCatalogue": ("pandas", lambda paths: tcat.LabelCatalogue(
        [paths["det"], paths["lab"]])),
    "EnvironmentCatalogue": ("pandas", lambda paths: tcat.EnvironmentCatalogue(
        "DR02", "AWS01", paths["env"])),
    "read_era5": ("pandas", lambda paths: tcat.read_era5(
        os.path.join(paths["env"], "ERA5", "*.csv"))),
    "read_meteo": ("pandas", lambda paths: tcat.read_meteo(
        os.path.join(paths["env"], "Meteo", "*.txt"))),
    "read_kpdr": ("pandas", lambda paths: tcat.read_kpdr(
        os.path.join(paths["env"], "Seismo", "KPDR_0.001_0.04.mat"))),
    "measure_label_change": ("pandas", lambda paths: (
        tutils.measure_label_change([0, 1], [1, 1]))),
    **{f"figure_{name}": ("matplotlib",
                          lambda paths, name=name: FIGURES[name](
                              tplot, _figure_inputs(), paths))
       for name in FIGURES},
}


@pytest.mark.parametrize("name", REFUSALS)
def test_refuses_without_its_package(figure_paths, monkeypatch, name):
    """With the package blocked the call raises ImportError naming it,
    and the trees it reads stay as they were."""
    package, call = REFUSALS[name]
    roots = (os.path.dirname(figure_paths["det"]), figure_paths["env"])
    before = [_tree(root) for root in roots]
    monkeypatch.setitem(sys.modules, package, None)
    with pytest.raises(ImportError, match=package):
        call(figure_paths)
    assert [_tree(root) for root in roots] == before
