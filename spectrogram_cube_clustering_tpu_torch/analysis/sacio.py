"""Native SAC / miniSEED IO and trace preprocessing (no obspy).

The reference's seismic preprocessing (`KPDR_sac2mseed`,
Cluster/environment.py:167-250) delegates all IO and signal ops to obspy.
obspy is not a dependency of the package, so this module implements the minimum
the pipeline needs from scratch:

- `read_sac` / `write_sac`: the SAC binary format (632-byte header of 70
  float32 + 40 int32 words + 192 chars, then float32 samples; byte order
  auto-detected via the NVHDR header version word).
- `read_mseed` / `write_mseed`: miniSEED with 4096-byte records,
  blockette 1000, big-endian IEEE-float32 payload (encoding 4) — the
  uncompressed encoding every mseed reader (incl. obspy) accepts.
- `Trace` / `Stream`: duck-type compatible with the obspy subset
  `sac2mseed` uses — trim/detrend/taper/filter/decimate/merge — with
  obspy's parameter conventions (zero-phase two-pass Butterworth,
  hann taper with max_length in seconds, merge(method=1,
  fill_value='interpolate')).

`analysis.seismic.sac2mseed(backend='auto')` uses obspy when importable
and this module otherwise, so the full SAC->MSEED pipeline executes in
obspy-less environments.

A copy (ROADMAP Queue 1 item 0) of the JAX package's `analysis/sacio.py`,
numpy with scipy imported where a filter runs; `tests/test_torch_analysis.py`
holds the bytes it writes to the original's.
"""

from __future__ import annotations

import os
import struct
from datetime import datetime, timedelta

import numpy as np

__all__ = [
    "Stats", "Trace", "Stream", "read_sac", "write_sac",
    "read_mseed", "write_mseed", "read",
]

_SAC_HDR_BYTES = 632
_SAC_UNDEF_F = -12345.0
_SAC_UNDEF_I = -12345
# float words
_F_DELTA, _F_B, _F_E = 0, 5, 6
# int words (offset into the 40-word int block)
_I_NZYEAR, _I_NZJDAY, _I_NZHOUR, _I_NZMIN, _I_NZSEC, _I_NZMSEC = range(6)
_I_NVHDR, _I_NPTS, _I_IFTYPE, _I_LEVEN = 6, 9, 15, 35
# char fields: KSTNM 8B, KEVNM 16B, then 8B each
_K_OFF = 440
_K_FIELDS = {"kstnm": (0, 8), "khole": (24, 8), "kcmpnm": (160, 8),
             "knetwk": (168, 8)}


class Stats:
    """Trace metadata, attribute-compatible with the obspy Stats subset
    the pipeline touches (network/station/location/channel/starttime/
    endtime/sampling_rate/delta/npts)."""

    def __init__(self, network="", station="", location="", channel="",
                 starttime=None, sampling_rate=1.0, npts=0):
        self.network = network
        self.station = station
        self.location = location
        self.channel = channel
        self.starttime = starttime or datetime(1970, 1, 1)
        self.sampling_rate = float(sampling_rate)
        self.npts = int(npts)

    @property
    def delta(self):
        return 1.0 / self.sampling_rate

    @property
    def endtime(self):
        n = max(self.npts - 1, 0)
        return self.starttime + timedelta(seconds=n * self.delta)

    def copy(self):
        return Stats(self.network, self.station, self.location,
                     self.channel, self.starttime, self.sampling_rate,
                     self.npts)


def _kstr(s):
    s = s.decode("ascii", "replace").strip()
    return "" if s in ("-12345", "") else s


def read_sac(path) -> "Trace":
    """Read a binary SAC file (byte order auto-detected via NVHDR)."""
    with open(path, "rb") as fh:
        raw = fh.read()
    if len(raw) < _SAC_HDR_BYTES:
        raise ValueError(f"{path}: truncated SAC header")
    for order in ("<", ">"):
        nvhdr = struct.unpack_from(order + "i", raw, (70 + _I_NVHDR) * 4)[0]
        if nvhdr in (6, 7):
            break
    else:
        raise ValueError(f"{path}: not a SAC file (NVHDR != 6/7)")
    floats = np.frombuffer(raw, order + "f4", 70, 0)
    ints = np.frombuffer(raw, order + "i4", 40, 280)
    npts = int(ints[_I_NPTS])
    data = np.frombuffer(
        raw, order + "f4", npts, _SAC_HDR_BYTES
    ).astype(np.float64)

    def k(name):
        off, ln = _K_FIELDS[name]
        return _kstr(raw[_K_OFF + off:_K_OFF + off + ln])

    year, jday = int(ints[_I_NZYEAR]), int(ints[_I_NZJDAY])
    if year == _SAC_UNDEF_I:
        t0 = datetime(1970, 1, 1)
    else:
        t0 = datetime.strptime(f"{year} {jday}", "%Y %j") + timedelta(
            hours=int(ints[_I_NZHOUR]), minutes=int(ints[_I_NZMIN]),
            seconds=int(ints[_I_NZSEC]),
            milliseconds=int(ints[_I_NZMSEC]),
        )
    b = float(floats[_F_B])
    if b != _SAC_UNDEF_F:
        t0 = t0 + timedelta(seconds=b)
    # DELTA is stored as float32 (0.05 reads back as 0.0500000007...);
    # snap to 7 significant digits so index*delta arithmetic downstream
    # (trim, merge) does not accumulate millisecond-scale drift
    delta = float("%.7g" % float(floats[_F_DELTA]))
    stats = Stats(
        network=k("knetwk"), station=k("kstnm"), location=k("khole"),
        channel=k("kcmpnm"), starttime=t0,
        sampling_rate=1.0 / delta, npts=npts,
    )
    return Trace(data, stats)


def write_sac(path, trace, byteorder="<"):
    """Write a binary SAC file (for fixtures/interchange)."""
    st = trace.stats
    floats = np.full(70, _SAC_UNDEF_F, byteorder + "f4")
    ints = np.full(40, _SAC_UNDEF_I, byteorder + "i4")
    floats[_F_DELTA] = st.delta
    floats[_F_B] = 0.0
    floats[_F_E] = (len(trace.data) - 1) * st.delta
    t0 = st.starttime
    ints[_I_NZYEAR] = t0.year
    ints[_I_NZJDAY] = int(t0.strftime("%j"))
    ints[_I_NZHOUR], ints[_I_NZMIN], ints[_I_NZSEC] = (
        t0.hour, t0.minute, t0.second)
    ints[_I_NZMSEC] = t0.microsecond // 1000
    ints[_I_NVHDR] = 6
    ints[_I_NPTS] = len(trace.data)
    ints[_I_IFTYPE] = 1  # ITIME
    ints[_I_LEVEN] = 1
    chars = bytearray(b" " * 192)

    def putk(name, val):
        off, ln = _K_FIELDS[name]
        chars[off:off + ln] = val[:ln].ljust(ln).encode("ascii")

    putk("kstnm", st.station or "-12345")
    putk("khole", st.location or "")
    putk("kcmpnm", st.channel or "-12345")
    putk("knetwk", st.network or "-12345")
    with open(path, "wb") as fh:
        fh.write(floats.tobytes())
        fh.write(ints.tobytes())
        fh.write(bytes(chars))
        fh.write(np.asarray(trace.data, byteorder + "f4").tobytes())


# ---------------------------------------------------------------------------
# miniSEED (4096-byte records, blockette 1000, encoding 4 = IEEE float32)

_MSEED_RECLEN = 4096
_MSEED_DATA_OFF = 64
_MSEED_SAMPLES = (_MSEED_RECLEN - _MSEED_DATA_OFF) // 4


def _rate_factor(fs):
    """miniSEED sample-rate (factor, multiplier): positive factor =
    samples/s, negative = s/sample; negative multiplier = divide."""
    if fs >= 1.0 and abs(fs - round(fs)) < 1e-9:
        r = int(round(fs))
        if r <= 32767:
            return r, 1
        # factor is an int16: encode large rates as factor * multiplier
        for d in (2, 4, 5, 8, 10, 16, 20, 25, 32, 50, 64, 100, 125, 128,
                  200, 250, 256, 500, 512, 1000):
            if r % d == 0 and r // d <= 32767 and d <= 32767:
                return r // d, d
        raise ValueError(f"cannot encode sampling rate {fs} in miniSEED")
    period = 1.0 / fs
    if abs(period - round(period)) < 1e-9 and round(period) <= 32767:
        return -int(round(period)), 1
    # non-integral rate: largest decimal scale whose factor fits int16
    for scale in (10000, 1000, 100, 10):
        if fs * scale <= 32767 and abs(
                fs * scale - round(fs * scale)) < 1e-6:
            return int(round(fs * scale)), -scale
    raise ValueError(f"cannot encode sampling rate {fs} in miniSEED")


def _rate_from_factor(factor, mult):
    fs = float(factor) if factor > 0 else 1.0 / -factor
    if mult > 0:
        fs *= mult
    elif mult < 0:
        fs /= -mult
    return fs


def write_mseed(path, trace):
    """Write one trace as big-endian float32 miniSEED records."""
    st = trace.stats
    data = np.asarray(trace.data, ">f4")
    factor, mult = _rate_factor(st.sampling_rate)
    delta = 1.0 / st.sampling_rate
    with open(path, "wb") as fh:
        # max(..., 1): an empty trace still writes ONE record (nsamp=0)
        # so read_mseed round-trips it instead of choking on a 0-byte file
        for ri, start in enumerate(range(0, max(len(data), 1),
                                         _MSEED_SAMPLES)):
            chunk = data[start:start + _MSEED_SAMPLES]
            t = st.starttime + timedelta(seconds=start * delta)
            hdr = struct.pack(
                ">6scc5s2s3s2sHHBBBBHHhhBBBBlHH",
                b"%06d" % ((ri % 999999) + 1), b"D", b" ",
                (st.station or "").ljust(5).encode()[:5],
                (st.location or "").ljust(2).encode()[:2],
                (st.channel or "").ljust(3).encode()[:3],
                (st.network or "").ljust(2).encode()[:2],
                t.year, int(t.strftime("%j")), t.hour, t.minute,
                t.second, 0, t.microsecond // 100,
                len(chunk), factor, mult,
                0, 0, 0, 1,  # activity/io/quality flags, n blockettes
                0, _MSEED_DATA_OFF, 48,
            )
            b1000 = struct.pack(">HHBBBB", 1000, 0, 4, 1, 12, 0)
            rec = hdr + b1000
            rec += b"\x00" * (_MSEED_DATA_OFF - len(rec))
            rec += chunk.tobytes()
            rec += b"\x00" * (_MSEED_RECLEN - len(rec))
            fh.write(rec)
    return path


def read_mseed(path) -> "Trace":
    """Read miniSEED written by `write_mseed` (single continuous trace,
    encodings 4/5 = IEEE float32/64)."""
    with open(path, "rb") as fh:
        raw = fh.read()
    chunks, stats = [], None
    pos = 0
    while pos + 48 <= len(raw):
        (_, _, _, sta, loc, cha, net, year, jday, hh, mm, ss, _, t4,
         nsamp, factor, mult, _, _, _, nblk, _, doff, boff) = struct.unpack(
            ">6scc5s2s3s2sHHBBBBHHhhBBBBlHH", raw[pos:pos + 48])
        enc, reclen_exp = 4, 12
        bpos = pos + boff
        for _ in range(nblk):
            btype, bnext = struct.unpack(">HH", raw[bpos:bpos + 4])
            if btype == 1000:
                enc, _, reclen_exp = struct.unpack(
                    ">BBB", raw[bpos + 4:bpos + 7])
            if not bnext:
                break
            bpos = pos + bnext
        reclen = 1 << reclen_exp
        if enc not in (4, 5):
            raise ValueError(f"{path}: unsupported mseed encoding {enc}")
        dt = ">f4" if enc == 4 else ">f8"
        chunks.append(np.frombuffer(raw, dt, nsamp, pos + doff))
        if stats is None:
            t0 = datetime.strptime(f"{year} {jday}", "%Y %j") + timedelta(
                hours=hh, minutes=mm, seconds=ss, microseconds=t4 * 100)
            stats = Stats(
                network=net.decode().strip(), station=sta.decode().strip(),
                location=loc.decode().strip(), channel=cha.decode().strip(),
                starttime=t0, sampling_rate=_rate_from_factor(factor, mult),
            )
        pos += reclen
    if stats is None:
        raise ValueError(f"{path}: no miniSEED records found")
    data = np.concatenate(chunks).astype(np.float64)
    stats.npts = len(data)
    return Trace(data, stats)


# ---------------------------------------------------------------------------
# Trace / Stream with the obspy op subset sac2mseed uses


class Trace:
    def __init__(self, data, stats=None):
        # always copy: taper()/filter() mutate self.data in place, which
        # must neither corrupt a float64 array the caller still holds
        # nor raise on read-only buffers (mmap/frombuffer inputs)
        self.data = np.array(data, np.float64)
        # copy the header like obspy's Trace does: mutating/aliasing the
        # caller's Stats would corrupt the sibling trace it came from
        # (its npts here, its starttime on any later trim)
        self.stats = stats.copy() if stats is not None else Stats(
            npts=len(self.data)
        )
        self.stats.npts = len(self.data)

    def copy(self):
        return Trace(self.data.copy(), self.stats.copy())

    # -- time window ------------------------------------------------------
    def trim(self, starttime=None, endtime=None):
        """Cut to [starttime, endtime], nearest sample, no padding
        (obspy trim default semantics for the in-range case)."""
        dt = self.stats.delta
        i0, i1 = 0, len(self.data)
        if starttime is not None:
            off = (starttime - self.stats.starttime).total_seconds()
            i0 = max(int(round(off / dt)), 0)
        if endtime is not None:
            off = (endtime - self.stats.starttime).total_seconds()
            i1 = min(int(round(off / dt)) + 1, len(self.data))
        self.data = self.data[i0:i1]
        self.stats.starttime += timedelta(seconds=i0 * dt)
        self.stats.npts = len(self.data)
        return self

    # -- preprocessing ops --------------------------------------------------
    def detrend(self, type="linear"):
        from scipy.signal import detrend as _detrend

        kind = {"linear": "linear", "demean": "constant",
                "constant": "constant"}[type]
        self.data = _detrend(self.data, type=kind)
        return self

    def taper(self, max_percentage=0.05, type="hann", max_length=None):
        """Hann cosine ramps on both ends; per-side length =
        min(max_percentage * npts, max_length * fs) like obspy."""
        if type != "hann":
            raise ValueError("native taper supports type='hann' only")
        n = len(self.data)
        wlen = int(max_percentage * n)
        if max_length is not None:
            wlen = min(wlen, int(max_length * self.stats.sampling_rate))
        wlen = min(wlen, n // 2)
        if wlen <= 0:
            return self
        ramp = 0.5 * (1.0 - np.cos(np.pi * np.arange(wlen) / wlen))
        self.data[:wlen] *= ramp
        self.data[n - wlen:] *= ramp[::-1]
        return self

    def filter(self, kind, freq=None, freqmin=None, freqmax=None,
               corners=4, zerophase=False):
        """Butterworth SOS lowpass/highpass/bandpass; zerophase = the
        obspy two-pass (forward + time-reversed) filter."""
        from scipy.signal import butter, sosfilt

        nyq = 0.5 * self.stats.sampling_rate
        if kind == "lowpass":
            if freq >= nyq:
                raise ValueError(
                    f"lowpass freq {freq} >= Nyquist {nyq}")
            sos = butter(corners, freq / nyq, "lowpass", output="sos")
        elif kind == "highpass":
            sos = butter(corners, freq / nyq, "highpass", output="sos")
        elif kind == "bandpass":
            if freqmax >= nyq:
                raise ValueError(
                    f"bandpass freqmax {freqmax} >= Nyquist {nyq}")
            sos = butter(corners, [freqmin / nyq, freqmax / nyq],
                         "bandpass", output="sos")
        else:
            raise ValueError(f"unsupported filter kind {kind!r}")
        out = sosfilt(sos, self.data)
        if zerophase:
            out = sosfilt(sos, out[::-1])[::-1]
        self.data = out
        return self

    def decimate(self, factor, no_filter=False):
        """Plain downsampling by slicing (the pipeline lowpasses first and
        passes no_filter=True, matching environment.py:226-229)."""
        if not no_filter:
            self.filter("lowpass", freq=0.4 * self.stats.sampling_rate
                        / factor, corners=4, zerophase=True)
        self.data = self.data[::factor]
        self.stats.sampling_rate /= factor
        self.stats.npts = len(self.data)
        return self

    def write(self, dest, format="MSEED"):
        if format.upper() != "MSEED":
            raise ValueError("native Trace.write supports MSEED only")
        write_mseed(dest, self)

    def simulate(self, **kwargs):
        raise NotImplementedError(
            "native Trace has no obspy simulate; response removal goes "
            "through analysis.seismic.remove_response_native"
        )


class Stream:
    def __init__(self, traces):
        self.traces = list(traces)

    def __add__(self, other):
        return Stream(self.traces + list(other.traces))

    def __iadd__(self, other):
        self.traces.extend(other.traces)
        return self

    def __getitem__(self, i):
        return self.traces[i]

    def __iter__(self):
        return iter(self.traces)

    def __len__(self):
        return len(self.traces)

    def merge(self, method=1, fill_value="interpolate",
              interpolation_samples=5):
        """Merge same-id traces into one continuous trace on a common
        sample grid (obspy method=1 semantics for the pipeline's cases):
        gaps are linearly interpolated between flanking samples
        (fill_value='interpolate'); at overlaps the later trace wins
        after a linear crossfade over `interpolation_samples`."""
        groups = {}
        for tr in self.traces:
            key = (tr.stats.network, tr.stats.station,
                   tr.stats.location, tr.stats.channel,
                   round(tr.stats.sampling_rate, 9))
            groups.setdefault(key, []).append(tr)
        merged = []
        for key, trs in groups.items():
            trs.sort(key=lambda t: t.stats.starttime)
            if len(trs) == 1:
                merged.append(trs[0])
                continue
            dt = trs[0].stats.delta
            t0 = trs[0].stats.starttime
            end = max(
                int(round((t.stats.starttime - t0).total_seconds() / dt))
                + len(t.data)
                for t in trs
            )
            out = np.full(end, np.nan)
            for t in trs:
                i = int(round(
                    (t.stats.starttime - t0).total_seconds() / dt))
                seg = out[i:i + len(t.data)]
                have = ~np.isnan(seg)
                n_over = int(have.sum())
                new = np.asarray(t.data, np.float64).copy()
                if n_over:
                    k = min(interpolation_samples, n_over)
                    idx = np.nonzero(have)[0][:k]
                    w = np.linspace(0.0, 1.0, k + 2)[1:-1]
                    new[idx] = (1 - w) * seg[idx] + w * new[idx]
                out[i:i + len(t.data)] = new
            nan = np.isnan(out)
            if nan.any():
                if fill_value == "interpolate":
                    ok = np.nonzero(~nan)[0]
                    out = np.interp(np.arange(end), ok, out[ok])
                else:
                    out[nan] = fill_value if fill_value is not None else 0.0
            stats = trs[0].stats.copy()
            stats.npts = end
            merged.append(Trace(out, stats))
        self.traces = merged
        return self


def read(path) -> Stream:
    """obspy.read-shaped entry point: one SAC or MSEED file -> Stream."""
    with open(path, "rb") as fh:
        head = fh.read(8)
    # mseed fixed header starts with a 6-digit sequence number + D/R/Q/M
    if len(head) >= 7 and head[:6].isdigit() and head[6:7] in b"DRQM":
        return Stream([read_mseed(path)])
    return Stream([read_sac(path)])
