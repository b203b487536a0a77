"""The port's `analysis/seismic.py` against the JAX package's on the CPU.

- The RESP pipeline on tests/test_seismic.py's RESP files (pole-zero,
  pole-zero plus FIR, a coefficient-only FIR, two epochs, a polynomial):
  metadata, parsed stages and epochs equal; the response evaluated
  within JAX's own rtol 1e-12, removed within its rtol 1e-10 (the
  polynomial conversion 1e-14); `compute_response`'s AMP/PHASE files and
  `remove_response` on a `sacio.Trace` equal.
- `sac2mseed` on the sacio backend writes the same files with pandas
  blocked as JAX's does with pandas, at the default buffers and with no
  buffer (the day that holds the inclusive end sample); the day helpers
  that replace pandas' `date_range` / `floor` / `ceil` equal pandas'.
"""

import os
import sys
from datetime import datetime, timedelta

import numpy as np
import pandas as pd
import pytest

import test_seismic as jt
from spectrogram_cube_clustering_tpu.analysis import sacio as jsacio
from spectrogram_cube_clustering_tpu.analysis import seismic as jseismic
from spectrogram_cube_clustering_tpu_torch.analysis import sacio, seismic

RESPS = {
    "paz": jt.RESP_PAZ_TEXT,
    "paz_fir": jt.RESP_PAZ_FIR_TEXT,
    "b061": jt.B061_TEXT,
    "two_epochs": jt.MULTI_EPOCH_TEXT,
}
#: the trace time each RESP is read at (the epoch of the two-epoch file)
WHEN = {"paz": None, "paz_fir": None, "b061": None,
        "two_epochs": jt.T_EPOCH2}


def _same(a, b):
    """Equal nested results: dicts, lists, arrays, numbers, datetimes."""
    assert type(a) is type(b) or (np.isscalar(a) and np.isscalar(b))
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    else:
        assert a == b


@pytest.fixture
def resp(tmp_path, request):
    p = tmp_path / "RESP.KP.KPDR..HDH"
    p.write_text(RESPS[request.param])
    return str(p), WHEN[request.param]


@pytest.mark.parametrize("resp", list(RESPS), indirect=True)
def test_resp_parsing_matches_jax(resp):
    path, when = resp
    _same(seismic.read_resp_metadata(path, when=when),
          jseismic.read_resp_metadata(path, when=when))
    _same(seismic.parse_resp_stages(path, when=when),
          jseismic.parse_resp_stages(path, when=when))
    _same(seismic.split_resp_epochs(path), jseismic.split_resp_epochs(path))


@pytest.mark.parametrize("units", ["DISP", "VEL", "ACC"])
@pytest.mark.parametrize("resp", list(RESPS), indirect=True)
def test_response_evaluated_within_jax_tolerance(resp, units):
    path, when = resp
    freqs = np.asarray([0.0, 0.01, 0.05, 0.2, 1.0, 4.0, 40.0])
    got = seismic.evaluate_response(path, freqs, units=units, when=when)
    want = jseismic.evaluate_response(path, freqs, units=units, when=when)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


@pytest.mark.parametrize("pre_filt", [None, (0.002, 0.005, 1.0, 2.0)])
@pytest.mark.parametrize("resp", list(RESPS), indirect=True)
def test_response_removed_within_jax_tolerance(resp, pre_filt):
    """tests/test_seismic.py's planted tones through the response, then
    removed by both packages."""
    path, when = resp
    fs, n = 10.0, 4096
    t = np.arange(n) / fs
    rng = np.random.default_rng(3)
    counts = (np.sin(2 * np.pi * 0.05 * t) + 0.5 * np.sin(2 * np.pi * 0.3 * t)
              ) * jt.TestNativeDeconvolution._tukey(n) * 1e6
    counts += rng.normal(scale=10.0, size=n)
    kw = dict(units="DISP", pre_filt=pre_filt, when=when)
    got = seismic.remove_response_native(counts, fs, path, **kw)
    want = jseismic.remove_response_native(counts, fs, path, **kw)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-10,
                               atol=1e-10 * np.abs(want).max())


def test_polynomial_conversion_within_jax_tolerance(tmp_path):
    p = tmp_path / "RESP.KP.KPTM..LKO"
    p.write_text(jt.POLY_RESP_TEXT)
    counts = np.linspace(-200.0, 300.0, 257)
    got = seismic.remove_response_native(counts, 1.0, str(p))
    want = jseismic.remove_response_native(counts, 1.0, str(p))
    np.testing.assert_allclose(got, want, rtol=1e-14)
    _same(seismic.parse_resp_stages(str(p)), jseismic.parse_resp_stages(str(p)))
    for mod in (seismic, jseismic):
        with pytest.raises(ValueError):
            mod.evaluate_response(str(p), np.asarray([0.1]))


def test_compute_response_writes_jax_files(tmp_path, monkeypatch):
    """The native backend's AMP./PHASE. files (no evalresp here) are
    JAX's byte for byte."""
    resp_path = tmp_path / "RESP.KP.KPDR..HDH"
    resp_path.write_text(jt.RESP_PAZ_FIR_TEXT)
    files = {}
    for name, mod in (("port", seismic), ("jax", jseismic)):
        d = tmp_path / name
        d.mkdir()
        monkeypatch.chdir(d)
        info, amp, phase = mod.compute_response(str(resp_path), 0.01, 1.0, 40,
                                                backend="native")
        files[name] = (info, {f: (d / f).read_bytes() for f in (amp, phase)})
    _same(files["port"][0], files["jax"][0])
    assert files["port"][1] == files["jax"][1]


def test_remove_response_on_a_sacio_trace_matches_jax(tmp_path):
    """`remove_response` in place on each package's own `Trace` (the
    native route: its start time picks the epoch)."""
    p = tmp_path / "RESP.KP.KPDR..HDH"
    p.write_text(jt.MULTI_EPOCH_TEXT)
    data = np.random.default_rng(8).normal(size=3000) * 1e5
    out = {}
    for name, io, mod in (("port", sacio, seismic),
                          ("jax", jsacio, jseismic)):
        tr = io.Trace(data.copy(), io.Stats(
            network="KP", station="KPDR", location="", channel="HDH",
            starttime=jt.T_EPOCH1, sampling_rate=20.0, npts=len(data)))
        mod.remove_response(tr, str(p), units="VEL",
                            pre_filt=(0.005, 0.01, 5.0, 8.0))
        out[name] = tr.data
    np.testing.assert_allclose(out["port"], out["jax"], rtol=1e-10,
                               atol=1e-10 * np.abs(out["jax"]).max())


TIMES = [datetime(2015, 1, 2), datetime(2015, 1, 2, 0, 0, 0, 1),
         datetime(2015, 1, 2, 23, 59, 59), datetime(2015, 12, 31, 12),
         datetime(2016, 2, 28, 23, 30), datetime(2016, 3, 1)]


@pytest.mark.parametrize("t", TIMES, ids=str)
def test_day_helpers_equal_pandas(t):
    """`_floor_day`, `_ceil_day` and `_days` against the pandas calls
    they replace in `sac2mseed`."""
    stamp = pd.Timestamp(t)
    assert seismic._floor_day(t) == stamp.floor("D").to_pydatetime()
    assert seismic._ceil_day(t) == stamp.ceil("D").to_pydatetime()
    for span in (0, 1, 3, 40):
        first, last = t.date(), (t + timedelta(days=span)).date()
        want = pd.date_range(first, last, freq="D")
        assert seismic._days(first, last) == [d.to_pydatetime() for d in want]
    assert seismic._days(t.date(), (t - timedelta(days=2)).date()) == []


FS = 2.0  # Hz: 4 days of samples stay small; decimation 10 keeps 0.2 Hz


def _write_days(datadir, io, n_days=4):
    """tests/test_sacio.py's daily SAC files at FS, tones continuous
    across the file edges."""
    nd = int(86400 * FS)
    for d in range(1, n_days + 1):
        t0 = datetime(2015, 1, d)
        t = (np.arange(nd) + (d - 1) * nd) / FS
        x = (np.sin(2 * np.pi * 0.01 * t) + 0.5 * np.sin(2 * np.pi * 0.3 * t)
             + 0.01 * (d - 1))
        tr = io.Trace(x, io.Stats(network="KP", station="KPDR", location="",
                                  channel="HDH", starttime=t0,
                                  sampling_rate=FS, npts=nd))
        io.write_sac(str(datadir / (t0.strftime("%Y.%j.%H.%M.%S")
                                    + ".KPDR.HDH.SAC")), tr)


@pytest.mark.parametrize("buffers", [(10, 20), (0, 0)], ids=["default",
                                                             "no_buffer"])
def test_sac2mseed_without_pandas_writes_jax_files(tmp_path, monkeypatch,
                                                   buffers):
    """The same daily SAC files through both packages' sacio backend:
    the port's run, with pandas blocked, writes JAX's files byte for
    byte (JAX's run has pandas)."""
    taper, pre_feed = buffers
    datadir = tmp_path / "sac"
    datadir.mkdir()
    _write_days(datadir, jsacio)
    kw = dict(response=False, backend="native", taper_trace=taper,
              pre_feed=pre_feed, decimation=10, lowpass_hz=0.4,
              band=(0.001, 0.04))
    want = jseismic.sac2mseed(str(datadir), str(tmp_path / "jax"), **kw)
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "pandas", None)
        got = seismic.sac2mseed(str(datadir), str(tmp_path / "port"), **kw)
    assert [os.path.basename(p) for p in got] == [
        os.path.basename(p) for p in want]
    assert len(got) == 2
    for g, w in zip(got, want):
        with open(g, "rb") as fg, open(w, "rb") as fw:
            assert fg.read() == fw.read()
