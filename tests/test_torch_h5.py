"""The port's `data/h5.py` and its four H5 console tools against the JAX
package's on the CPU, on an h5py-written catalog like `tests/test_h5.py`'s
(raw 88 x 101 rows: row 87 the time vector, column 0 the frequency
vector). Every result is bit-equal: the module is a numpy copy, and
`get_datetime` (datetime arithmetic in the port, pandas in the JAX
package) gives the same day for every index of the deployment window.
"""

import json
import os
import pickle
import sys

import h5py
import numpy as np
import pandas as pd
import pytest

from spectrogram_cube_clustering_tpu import cli as jcli
from spectrogram_cube_clustering_tpu.data import h5 as jh5
from spectrogram_cube_clustering_tpu_torch import cli
from spectrogram_cube_clustering_tpu_torch.data import h5

M, H_RAW, W_RAW = 14, 88, 101


@pytest.fixture(scope="module")
def catalog(tmp_path_factory):
    """A catalog of M events at four stations, one a day from 2015-01-01,
    with Trace and Scalogram datasets."""
    rng = np.random.default_rng(7)
    path = str(tmp_path_factory.mktemp("h5") / "cat.h5")
    spec = rng.normal(size=(M, H_RAW, W_RAW))
    spec[:, 87, 1:] = np.arange(W_RAW - 1)
    spec[:, 0:87, 0] = np.linspace(0, 10, 87)
    meta = [json.dumps({"Station": h5.STATION_LIST[i % 4],
                        "StartTime": f"2015-01-{i + 1:02d} 00:00:00.0"})
            for i in range(M)]
    with h5py.File(path, "w") as f:
        g = f.require_group("/4.0")
        g.create_dataset("Spectrogram", data=spec)
        g["Spectrogram"].attrs["units"] = "dB"
        g.create_dataset("Trace", data=rng.normal(size=(M, 200)))
        g.create_dataset("Catalogue",
                         data=np.array(meta, dtype=h5py.string_dtype()))
        g.create_dataset("Scalogram", data=rng.normal(size=(M, 4, 4)))
    return path


def _same(a, b):
    """Equal values, dtype and shape (numpy arrays, tuples, dicts)."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, tuple):
        assert len(a) == len(b)
        for u, v in zip(a, b):
            _same(u, v)
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def _h5_contents(path):
    """{dataset path: (values, attrs)} of an h5 file."""
    out = {}
    with h5py.File(path, "r") as f:
        def visit(name, obj):
            if isinstance(obj, h5py.Dataset):
                out[name] = (obj[()], dict(obj.attrs))
        f.visititems(visit)
    return out


def test_tables_match_jax():
    for i in range(len(h5.STATION_LIST)):
        assert h5.get_station(i) == jh5.get_station(i)
        assert h5.get_station(np.int64(i)) == jh5.get_station(np.int64(i))
        name = h5.STATION_LIST[i]
        assert h5.get_station(name) == jh5.get_station(name)
    for i in range(len(h5.CHANNEL_LIST)):
        assert h5.get_channel(i) == jh5.get_channel(i)
    assert h5.get_network(0) == jh5.get_network(0)
    assert (h5.SPECTROGRAM_PATH, h5.TRACE_PATH, h5.CATALOGUE_PATH,
            h5.SCALOGRAM_PATH) == (jh5.SPECTROGRAM_PATH, jh5.TRACE_PATH,
                                   jh5.CATALOGUE_PATH, jh5.SCALOGRAM_PATH)


def test_get_datetime_matches_pandas_over_the_window():
    days = pd.date_range("20141202T000000", "20161129T000000", freq="D")
    for i in range(-len(days), len(days)):
        got = h5.get_datetime(i)
        assert got == jh5.get_datetime(i) == days[i]
    for i in (len(days), -len(days) - 1):
        with pytest.raises(IndexError):
            days[i]
        with pytest.raises(IndexError):
            h5.get_datetime(i)


def test_readers_match_jax(catalog):
    _same(h5.query_db_size(catalog), jh5.query_db_size(catalog))
    for idx in (3, slice(2, 9), [1, 4, 5]):
        _same(h5.read_h5(catalog, idx), jh5.read_h5(catalog, idx))
    _same(h5.get_metadata([0, 1, 2], [5, 2, 11], catalog),
          jh5.get_metadata([0, 1, 2], [5, 2, 11], catalog))
    _same(h5.get_timefreqvec(catalog), jh5.get_timefreqvec(catalog))
    _same(h5.load_images(catalog, [4, 0, 9]),
          jh5.load_images(catalog, [4, 0, 9]))
    raw = h5.read_h5(catalog, slice(0, 3)).astype(np.float32)
    _same(h5.crop_specgram(raw), jh5.crop_specgram(raw))
    for transform in (None, "sample_normalization", "sample_norm_cent",
                      "vec_norm"):
        _same(h5.normalize_specgram(raw, transform),
              jh5.normalize_specgram(raw, transform))


@pytest.mark.parametrize("transform,crop", [("vec_norm", True),
                                            (None, True),
                                            ("sample_norm_cent", False)])
def test_seismic_dataset_matches_jax(catalog, tmp_path, transform, crop):
    """Both storages: the `.h5` and the `convert_h5_to_np` dump."""
    dump = h5.convert_h5_to_np(catalog, str(tmp_path / "dump.npy"))
    for fname, ftype in ((catalog, "h5"), (dump, "np")):
        got = h5.SeismicDataset(fname, ftype, transform, crop)
        want = jh5.SeismicDataset(fname, ftype, transform, crop)
        assert len(got) == len(want)
        for i in (0, 5, M - 1):
            _same(got[i], want[i])
        _same(got.load_batch([7, 2, 7, 0]), want.load_batch([7, 2, 7, 0]))
        _same(got.load_all(), want.load_all())
    with pytest.raises(ValueError, match="ftype"):
        h5.SeismicDataset(catalog, "zarr")


@pytest.mark.parametrize("block,crop", [(4, True), (5, False), (64, True)])
def test_h5_stream_dataset_matches_jax(catalog, block, crop):
    got = h5.H5StreamDataset(catalog, block, crop)
    want = jh5.H5StreamDataset(catalog, block, crop)
    assert len(got) == len(want)
    assert got.windows_per_item == want.windows_per_item
    assert (got.n_windows, got.window_shape) == (want.n_windows,
                                                 want.window_shape)
    for i in range(len(got)):
        _same(got.item(i), want.item(i))
    with pytest.raises(IndexError):
        got.item(len(got))
    with pytest.raises(ValueError, match="block"):
        h5.H5StreamDataset(catalog, 0)


@pytest.mark.parametrize("m,reserve,seed", [(10, 0.0, 3), (M, 0.0, 4),
                                             (40, 0.0, 5), (8, 0.25, 6)])
def test_traval_index_pickle_matches_jax(catalog, tmp_path, capsys, m,
                                         reserve, seed):
    """The pickle's bytes, the returned split and the printed lines, at a
    seed; m past the catalog's size is clamped with the JAX message."""
    outs = {}
    for name, mod in (("port", h5), ("jax", jh5)):
        d = tmp_path / name
        d.mkdir()
        tra, val, path = mod.save_traval_index(m, catalog, str(d),
                                               reserve=reserve, seed=seed)
        printed = capsys.readouterr().out.replace(str(d), "<dir>")
        with open(path, "rb") as f:
            outs[name] = (tra, val, os.path.basename(path), f.read(),
                          printed, mod.load_traval_index(path))
    got, want = outs["port"], outs["jax"]
    _same(got[:2], want[:2])
    assert got[2:5] == want[2:5]
    _same(got[5], want[5])
    assert pickle.loads(got[3])["index_tra"].dtype == want[0].dtype


def test_convert_h5_to_np_matches_jax(catalog, tmp_path):
    for name in ("port", "jax"):
        (tmp_path / name).mkdir()
    for dest in ("out.npy", "out"):
        got = h5.convert_h5_to_np(catalog, str(tmp_path / "port" / dest))
        want = jh5.convert_h5_to_np(catalog, str(tmp_path / "jax" / dest))
        assert os.path.basename(got) == os.path.basename(want)
        _same(np.load(got), np.load(want))


@pytest.mark.parametrize("kw", [
    {"include": ["DR01", "DR03"]},
    {"exclude": ["DR02"]},
    {"include": [0, 1, 2], "exclude": ["DR02"]},
    {"include": [np.int64(1), np.int32(3)]},
    {"exclude": [], "after": "20150104T000000"},
    {"include": ["DR01", "DR02", "DR03"], "before": "20150109T000000",
     "after": "20150103T120000"},
])
def test_extract_h5_dataset_matches_jax(catalog, tmp_path, kw):
    got = h5.extract_h5_dataset(catalog, str(tmp_path / "port.h5"), **kw)
    want = jh5.extract_h5_dataset(catalog, str(tmp_path / "jax.h5"), **kw)
    assert got == want > 0
    a, b = _h5_contents(tmp_path / "port.h5"), _h5_contents(
        tmp_path / "jax.h5")
    assert a.keys() == b.keys() == {f"4.0/{n}" for n in (
        "Catalogue", "Trace", "Spectrogram", "Scalogram")}
    for k in a:
        _same(a[k][0], b[k][0])
        assert a[k][1] == b[k][1]
    with pytest.raises(ValueError, match="include or exclude"):
        h5.extract_h5_dataset(catalog, str(tmp_path / "x.h5"))


def test_extract_h5_dataset_short_aux_dataset_warns_like_jax(tmp_path):
    """An auxiliary dataset shorter than the catalogue is left out of the
    copy with the JAX package's warning."""
    src = str(tmp_path / "short.h5")
    with h5py.File(src, "w") as f:
        g = f.require_group("/4.0")
        g.create_dataset("Catalogue", data=np.array(
            [json.dumps({"Station": "DR01"})] * 10,
            dtype=h5py.string_dtype()))
        g.create_dataset("Spectrogram", data=np.ones((10, 3, 3)))
        g.create_dataset("Trace", data=np.ones((4, 5)))
    msgs = {}
    for name, mod in (("port", h5), ("jax", jh5)):
        with pytest.warns(UserWarning) as rec:
            kept = mod.extract_h5_dataset(src, str(tmp_path / f"{name}.h5"),
                                          include=["DR01"], workers=2)
        msgs[name] = [str(r.message).replace(name, "<dest>") for r in rec]
        assert kept == 9
        assert set(_h5_contents(tmp_path / f"{name}.h5")) == {
            "4.0/Catalogue", "4.0/Spectrogram"}
    assert msgs["port"] == msgs["jax"]


def _tool_lines(capsys, tool, argv, root):
    tool(argv)
    return capsys.readouterr().out.replace(root, "<dir>")


def test_h5_tools_print_the_jax_lines(catalog, tmp_path, capsys):
    """query-h5size, extract-h5dataset, generate-sample-index and
    convert-h5-to-np: the printed lines and files of the `-torch` tools
    equal the JAX tools' (the sample index is drawn unseeded, so its
    pickle is checked by shape)."""
    for name in ("port", "jax"):
        (tmp_path / name).mkdir()
    for tool, jtool, argv in (
            (cli.query_h5size, jcli.query_h5size, [catalog]),
            (cli.extract_h5dataset, jcli.extract_h5dataset,
             [catalog, "{d}/sub.h5", "--include", '["DR01", "DR04"]',
              "--before", "20150112T000000"]),
            (cli.generate_sample_index, jcli.generate_sample_index,
             ["9", catalog, "{d}"]),
            (cli.convert_h5_to_np, jcli.convert_h5_to_np,
             [catalog, "--dest", "{d}/dump.npy"])):
        lines = {}
        for name, fn in (("port", tool), ("jax", jtool)):
            d = str(tmp_path / name)
            lines[name] = _tool_lines(
                capsys, fn, [a.replace("{d}", d) for a in argv], d)
        assert lines["port"] == lines["jax"] != ""
    for name in ("port", "jax"):
        d = tmp_path / name
        with open(d / "TraValIndex_M=9.pkl", "rb") as f:
            idx = pickle.load(f)
        assert (len(idx["index_tra"]), len(idx["index_val"])) == (7, 2)
    _same(np.load(tmp_path / "port" / "dump.npy"),
          np.load(tmp_path / "jax" / "dump.npy"))
    a, b = (_h5_contents(tmp_path / n / "sub.h5") for n in ("port", "jax"))
    assert a.keys() == b.keys()
    for k in a:
        _same(a[k][0], b[k][0])


def test_without_h5py_every_reader_names_it(catalog, tmp_path, monkeypatch):
    """Where h5py does not import, the `.h5` readers and the four tools
    raise ImportError naming it and write nothing; the `.npy` dump still
    loads."""
    dump = h5.convert_h5_to_np(catalog, str(tmp_path / "dump.npy"))
    monkeypatch.setitem(sys.modules, "h5py", None)
    out = tmp_path / "out"
    out.mkdir()
    for call in (
            lambda: h5.query_db_size(catalog),
            lambda: h5.SeismicDataset(catalog),
            lambda: h5.H5StreamDataset(catalog),
            lambda: cli.query_h5size([catalog]),
            lambda: cli.extract_h5dataset([catalog, str(out / "s.h5"),
                                           "--include", '["DR01"]']),
            lambda: cli.generate_sample_index(["5", catalog, str(out)]),
            lambda: cli.convert_h5_to_np([catalog, "--dest",
                                          str(out / "d.npy")])):
        with pytest.raises(ImportError, match="h5py"):
            call()
    assert os.listdir(out) == []
    assert len(h5.SeismicDataset(dump, "np")) == M
