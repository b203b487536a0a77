"""Seismic preprocessing: SAC -> MSEED conversion and response removal.

Parity target: `KPDR_sac2mseed` + the response-removal helpers
(Cluster/environment.py:167-521): daily windows with taper/pre-feed
buffers, detrend -> hann taper -> zero-phase 0.4 Hz lowpass -> decimate
x100 -> optional instrument-response removal -> 0.001-0.04 Hz bandpass,
written as day-long MSEED files.

obspy is not a dependency of the package, and is NOT required: `sac2mseed` runs
on the from-scratch `analysis.sacio` backend (SAC reader, Trace/Stream
ops, miniSEED writer) when obspy is absent, and response removal is
native spectral division over the RESP's full stage chain — analog
pole-zero (B053) AND digital FIR/IIR coefficient stages (B054/B061 with
B057 decimation rates) — via `remove_response_native`. Polynomial (B062)
responses are ALSO handled natively, by direct MacLaurin evaluation of
counts into physical units (`apply_polynomial_response`) — the IRIS
convention for transducer channels, which neither evalresp spectral
division nor obspy `remove_response`/`simulate` can perform at all.
Multi-epoch RESP files (one rdseed block per epoch) are also native:
the epoch covering the trace's start time is selected with evalresp's
date-range semantics (`split_resp_epochs`; the reference passes the
trace's year/julian day to the external binary for the same effect,
environment.py:434-441). obspy, when installed, is preferred for IO
(backend='auto') and remains the fallback only for truly malformed RESP
files.

A copy (ROADMAP Queue 1 item 0) of the JAX package's
`analysis/seismic.py`. The one change: `sac2mseed` counts its days with
`datetime` (`_days`, `_floor_day`, `_ceil_day`) instead of pandas'
`date_range` and `floor` / `ceil("D")`, so it runs without pandas;
`tests/test_torch_analysis.py` holds both to the same days and files.
"""

from __future__ import annotations

import os
from datetime import date, datetime, time, timedelta
from typing import Optional


def _obspy():
    try:
        import obspy

        return obspy
    except ImportError as e:
        raise ImportError(
            "seismic preprocessing requires obspy (not installed in this "
            "environment); install obspy to use analysis.seismic"
        ) from e


def _backend(backend: str = "auto"):
    """IO/trace backend for sac2mseed: obspy when importable (or forced),
    else the from-scratch `analysis.sacio` (SAC reader, Trace/Stream ops,
    miniSEED writer) so the pipeline runs in obspy-less environments."""
    if backend in ("auto", "obspy"):
        try:
            import obspy

            return obspy
        except ImportError:
            if backend == "obspy":
                _obspy()  # raise the canonical error
    elif backend != "native":
        raise ValueError(f"unknown backend {backend!r}")
    from . import sacio

    class _Native:
        read = staticmethod(sacio.read)
        # the native Trace trims on datetimes directly
        UTCDateTime = staticmethod(lambda t: t)

    return _Native


def _floor_day(t: datetime) -> datetime:
    """Midnight at or before t (pandas' `Timestamp.floor("D")`)."""
    return datetime.combine(t.date(), time())


def _ceil_day(t: datetime) -> datetime:
    """Midnight at or after t (pandas' `Timestamp.ceil("D")`)."""
    floor = _floor_day(t)
    return floor if floor == t else floor + timedelta(days=1)


def _days(first: date, last: date) -> list:
    """Each midnight from `first` to `last`, both included, as datetimes
    (pandas' `date_range(first, last, freq="D")`)."""
    start = datetime.combine(first, time())
    return [start + timedelta(days=i) for i in range((last - first).days + 1)]


def file2dt(fname: str) -> datetime:
    """SAC filename 'YYYY.JJJ.HH.MM.SS.*' -> datetime
    (environment.py:149-155)."""
    parts = fname.split(".")[0:5]
    return datetime.strptime(" ".join(parts), "%Y %j %H %M %S")


def sac2mseed(
    datadir: str = ".",
    destdir: str = ".",
    response: bool = False,
    station_pattern: str = "HDH",
    taper_trace: int = 10,
    pre_feed: int = 20,
    decimation: int = 100,
    lowpass_hz: float = 0.4,
    band: tuple = (0.001, 0.04),
    resp_file: Optional[str] = None,
    backend: str = "auto",
) -> list:
    """Convert daily SAC files to preprocessed MSEED (environment.py:167-250).

    `backend='auto'` uses obspy when installed and the native
    `analysis.sacio` implementation otherwise ('obspy'/'native' force
    one). Returns the list of written file paths.
    """
    obspy = _backend(backend)

    files = sorted(
        f for f in os.listdir(datadir)
        if station_pattern in f and "SAC" in f
    )
    if len(files) < 3:
        raise ValueError("Not enough SAC files for continuous conversion.")
    if response and resp_file is None:
        resp = [f for f in os.listdir(datadir) if "RESP" in f]
        if not resp:
            raise FileNotFoundError("No RESP files found in datadir.")
        resp_file = os.path.join(datadir, resp[0])

    os.makedirs(destdir, exist_ok=True)
    dti = _days(file2dt(files[0]).date(), file2dt(files[-1]).date())
    buffer_front = taper_trace + pre_feed
    buffer_back = taper_trace
    written = []

    for d in range(1, len(dti) - 1):
        t0, t1 = dti[d], dti[d + 1]
        time_start = t0 - timedelta(minutes=buffer_front)
        time_stop = t1 + timedelta(minutes=buffer_back)
        search_days = _days(_floor_day(time_start).date(),
                            _ceil_day(time_stop).date())
        # the reference drops the ceil'd trailing day (environment.py:218)
        # — valid only because its positive taper buffer guarantees ceil
        # bumped a day; with taper_trace=0, time_stop lands exactly on
        # midnight, ceil is a no-op, and the dropped day holds the
        # inclusive endtime sample
        use_days = (
            search_days if time_stop == search_days[-1]
            else search_days[:-1]
        )
        use_dates = {day.date() for day in use_days}
        flist = [f for f in files if file2dt(f).date() in use_dates]
        if not flist:
            continue
        st = None
        for fname in flist:
            part = obspy.read(os.path.join(datadir, fname))
            st = part if st is None else st + part
        st.merge(method=1, fill_value="interpolate", interpolation_samples=5)
        tr = st[0].trim(
            starttime=obspy.UTCDateTime(time_start),
            endtime=obspy.UTCDateTime(time_stop),
        )
        tr.detrend(type="linear")
        tr.taper(max_percentage=0.5, type="hann", max_length=60 * taper_trace)
        try:
            tr.filter("lowpass", freq=lowpass_hz, corners=2, zerophase=True)
        except ValueError as e:
            raise ValueError("Check source files; missing data likely.") from e
        tr.decimate(decimation, no_filter=True)
        if response:
            remove_response(
                tr, resp_file, units="DISP",
                pre_filt=(0.0015, 0.003, 0.5, 0.6),
            )
        tr.filter("bandpass", freqmin=band[0], freqmax=band[1], zerophase=True)
        tr.trim(
            starttime=obspy.UTCDateTime(t0), endtime=obspy.UTCDateTime(t1)
        )
        dest = os.path.join(
            destdir,
            f"KP.KPDR..HDH__{t0.strftime('%Y%m%dT%H%M%SZ')}__"
            f"{t1.strftime('%Y%m%dT%H%M%SZ')}.mseed",
        )
        tr.write(dest, format="MSEED")
        written.append(dest)
    return written


def remove_response(
    trace, resp_file: str, units: str = "DISP", pre_filt: tuple = None
) -> None:
    """Instrument-response removal via a RESP file, in place.

    The reference invokes an external `evalresp` executable and hand-rolls
    the deconvolution (environment.py:262-521, after Zhao Chen); here the
    RESP's stage chain (analog pole-zero + digital FIR/IIR) is evaluated
    and divided out natively — multi-epoch RESP files select the epoch
    covering the trace's start time (evalresp date-range semantics) —
    and polynomial (B062) responses convert by direct MacLaurin
    evaluation (`remove_response_native`), with obspy
    `simulate(seedresp=...)` as the fallback for truly malformed files.
    """
    try:
        trace.data = remove_response_native(
            trace.data, float(trace.stats.sampling_rate), resp_file,
            units=units, pre_filt=pre_filt,
            when=getattr(trace.stats, "starttime", None),
        )
        return
    except (ValueError, AttributeError):
        pass
    _obspy()
    seedresp = {"filename": resp_file, "units": units}
    # pitsasim=False matches the reference invocation (environment.py:
    # 236-242); obspy's default True changes the taper/FFT conventions.
    trace.simulate(
        paz_remove=None, pre_filt=pre_filt, seedresp=seedresp,
        pitsasim=False, sacsim=True,
    )


# ---------------------------------------------------------------------------
# RESP-file response pipeline (reference environment.py:262-521). The
# metadata/matching/parsing layers below are pure Python — no obspy — so
# they run (and are tested) in obspy-less environments; only the actual
# deconvolution (remove_trace/remove_stream) touches obspy.


def _parse_resp_time(token):
    """RESP blockette date token -> datetime, or None for open intervals
    ('No Ending Time'). Accepts the year,julian-day forms rdseed emits,
    with or without time / fractional seconds."""
    if token is None:
        return None
    s = str(token).strip()
    if not s or s.lower().startswith("no"):
        return None
    for fmt in ("%Y,%j,%H:%M:%S.%f", "%Y,%j,%H:%M:%S", "%Y,%j,%H:%M",
                "%Y,%j"):
        try:
            return datetime.strptime(s.rstrip(","), fmt)
        except ValueError:
            continue
    raise ValueError(f"unparseable RESP date {token!r}")


def _as_datetime(when):
    """Duck-typed time -> datetime: obspy UTCDateTime (.datetime), pandas
    Timestamp (.to_pydatetime), ISO string, or datetime itself."""
    if when is None or isinstance(when, datetime):
        return when
    if hasattr(when, "datetime"):  # obspy UTCDateTime
        return when.datetime
    if hasattr(when, "to_pydatetime"):  # pandas Timestamp
        return when.to_pydatetime()
    if isinstance(when, str):
        return datetime.fromisoformat(when)
    raise TypeError(f"cannot interpret {type(when).__name__} as a time")


def split_resp_epochs(resp_path: str) -> list:
    """Split a SEED RESP text file into its response epochs.

    rdseed writes one full header + blockette block per epoch, each
    opening with a B050F03 station line and carrying its own
    B052F22/B052F23 start/end dates (the reference handles this by
    passing the trace's date to the external evalresp binary,
    environment.py:434-441 — evalresp selects the covering epoch). Returns
    ``[{"t_start": datetime, "t_end": datetime|None, "lines": [...]}, ...]``
    in file order; a single-epoch file comes back as one entry holding
    every line. A duplicated header line WITHOUT its own start date is
    corruption, not a new epoch — the whole file is returned as one block
    so the strict single-epoch parsers surface their duplicate-field
    errors.
    """
    with open(resp_path) as fh:
        lines = fh.read().split("\n")
    starts = [
        i for i, raw in enumerate(lines) if raw.split()[:1] == ["B050F03"]
    ]
    if len(starts) <= 1:
        blocks = [lines]
    else:
        bounds = [0] + starts[1:] + [len(lines)]
        blocks = [lines[bounds[i]: bounds[i + 1]]
                  for i in range(len(bounds) - 1)]
    epochs = []
    for block in blocks:
        t0 = t1 = None
        for raw in block:
            toks = [t for t in raw.split(" ") if t]
            if toks[:1] == ["B052F22"] and len(toks) >= 4:
                t0 = _parse_resp_time(toks[3])
            elif toks[:1] == ["B052F23"]:
                t1 = _parse_resp_time(toks[3] if len(toks) >= 4 else None)
        epochs.append({"t_start": t0, "t_end": t1, "lines": block})
    if len(epochs) > 1 and any(e["t_start"] is None for e in epochs):
        return [{"t_start": epochs[0]["t_start"],
                 "t_end": epochs[0]["t_end"], "lines": lines}]
    return epochs


def _epoch_block(resp_path: str, when, epochs: list) -> list:
    """The epoch's lines covering `when` (evalresp date-range semantics:
    t_start <= when <= t_end, open-ended end = still active)."""
    when = _as_datetime(when)
    for e in epochs:
        if e["t_start"] is None:
            continue
        if when >= e["t_start"] and (
            e["t_end"] is None or when <= e["t_end"]
        ):
            return e["lines"]
    spans = ", ".join(
        f"[{e['t_start']} .. {e['t_end'] or 'open'}]" for e in epochs
    )
    raise ValueError(
        f"{resp_path}: no response epoch covers {when} (epochs: {spans})"
    )


def read_resp_metadata(resp_path: str, when=None) -> dict:
    """Parse instrument metadata out of a SEED RESP text file
    (reference read_file_response_text, environment.py:262-361).

    Returns dict with station/network/location/channel/t_start/t_end/
    sensitivity/frequency_sensitivity/sampling_rate (input rate divided by
    the decimation factor), plus ``n_epochs`` and ``epochs`` (the file's
    (t_start, t_end) list). Raises ValueError on conflicting duplicate
    fields or missing decimation info, like the reference.

    Multi-epoch files (rdseed appends one block per epoch): `when` (a
    datetime / obspy UTCDateTime / pandas Timestamp / ISO string — use the
    trace's start time) selects the covering epoch, evalresp-style; with
    `when=None` the FIRST epoch's metadata is returned (the station/
    network/location/channel codes `find_resp_file` matches on are
    epoch-invariant).
    """
    all_epochs = split_resp_epochs(resp_path)
    if len(all_epochs) > 1 and when is not None:
        block = _epoch_block(resp_path, when, all_epochs)
    else:
        block = all_epochs[0]["lines"]
    info = {
        "station": None, "network": None, "location": None, "channel": None,
        "t_start": None, "t_end": None, "sensitivity": None,
        "frequency_sensitivity": None, "sampling_rate": None,
    }
    f_input = None
    decimation_factor = None

    def _set(key, value, err):
        if info[key] is None:
            info[key] = value
        elif info[key] != value:
            raise ValueError(err)

    for raw in block:
        line = [t for t in raw.split(" ") if t]
        if len(line) == 3 and line[1].lower() == "station:":
            _set("station", line[2], "Multiple station names!")
        elif len(line) == 3 and line[1].lower() == "network:":
            _set("network", line[2], "Multiple network names!")
        elif len(line) == 3 and line[1].lower() == "location:":
            loc = "" if line[2] == "??" else line[2]
            _set("location", loc, "Multiple location values!")
        elif len(line) == 3 and line[1].lower() == "channel:":
            _set("channel", line[2], "Multiple channels!")
        elif len(line) == 4 and " ".join(line[1:3]).lower() == "start date:":
            t = _parse_resp_time(line[3])
            _set("t_start", t, "Multiple start dates!")
        elif len(line) == 4 and " ".join(line[1:3]).lower() == "end date:":
            t = _parse_resp_time(line[3])
            _set("t_end", t, "Multiple end dates!")
        elif (len(line) == 5
              and " ".join(line[1:4]).lower() == "input sample rate:"):
            f_input = float(line[4])
        elif (len(line) == 6
              and " ".join(line[1:5]).lower() == "input sample rate (hz):"):
            f_input = float(line[5])
        elif (len(line) == 4
              and " ".join(line[1:3]).lower() == "decimation factor:"):
            decimation_factor = float(line[3])
        elif len(line) == 3 and line[1].lower() == "sensitivity:":
            _set("sensitivity", float(line[2]),
                 "Multiple sensitivity values!")
        elif (len(line) in (5, 6)
              and " ".join(line[1:4]).lower()
              == "frequency of sensitivity:"):
            _set("frequency_sensitivity", float(line[4]),
                 "Multiple frequency of sensitivity values!")
    if f_input is None or decimation_factor is None:
        raise ValueError("Decimation information missing!")
    info["sampling_rate"] = f_input / decimation_factor
    info["n_epochs"] = len(all_epochs)
    info["epochs"] = [(e["t_start"], e["t_end"]) for e in all_epochs]
    return info


def find_resp_file(stats, resp_paths: list) -> str:
    """The RESP file whose network/station/location/channel match the
    trace's stats (reference find_file_response_text,
    environment.py:364-381). `stats` is duck-typed (obspy Stats or any
    object with those four attributes)."""
    for path in resp_paths:
        info = read_resp_metadata(path)
        if (stats.network == info["network"]
                and stats.station == info["station"]
                and stats.location == info["location"]
                and stats.channel == info["channel"]):
            return path
    raise ValueError("No corresponding response text file found!")


def read_response_function(path: str):
    """Parse an evalresp AMP.*/PHASE.* output file into (freq, value)
    arrays (reference read_file_response_function,
    environment.py:384-410)."""
    import numpy as np

    freqs, values = [], []
    with open(path) as fh:
        for line in fh.read().split("\n"):
            parts = line.split(" ")
            if len(parts) < 2:
                continue
            freqs.append(float(parts[0]))
            values.append(float(parts[1]))
    return np.asarray(freqs), np.asarray(values)


def compute_response(
    resp_path: str, f_min: float, f_max: float, n_f: int,
    backend: str = "auto", when=None,
):
    """Response curve over [f_min, f_max] with n_f log-spaced samples;
    returns (metadata, amp_file, phase_file) like the reference's
    evalresp invocation (reference compute, environment.py:413-455).

    `backend='auto'` shells out to the `evalresp` binary when it is on
    PATH (byte-level reference parity) and otherwise evaluates the RESP
    natively (`evaluate_response`), writing the same `AMP.<id>` /
    `PHASE.<id>` two-column text files (amplitude in counts/input-unit,
    phase in degrees) that `read_response_function` consumes.
    'evalresp'/'native' force one backend."""
    import numpy as np
    from subprocess import run

    if backend not in ("auto", "evalresp", "native"):
        raise ValueError(f"unknown backend {backend!r}")
    # for multi-epoch files, `when` selects the epoch; the evalresp
    # invocation below inherits it via the selected epoch's t_start
    info = read_resp_metadata(resp_path, when=when)
    suffix = ".".join(
        [info["network"], info["station"], info["location"], info["channel"]]
    )
    amp_file, phase_file = f"AMP.{suffix}", f"PHASE.{suffix}"
    if backend in ("auto", "evalresp"):
        from subprocess import CalledProcessError

        try:
            # check=True: an evalresp that runs but exits non-zero left
            # no (or stale) AMP./PHASE. files — treating it as success
            # would hand the caller a previous run's curves
            run([
                "evalresp", info["station"], info["channel"],
                str(info["t_start"].year),
                info["t_start"].strftime("%j"),
                str(f_min), str(f_max), str(n_f),
                "-f", resp_path,
                "-t", info["t_start"].strftime("%H:%M:%S"),
                "-s", "log",
            ], check=True)
            return info, amp_file, phase_file
        except (FileNotFoundError, CalledProcessError):
            if backend == "evalresp":
                raise
    freqs = np.logspace(np.log10(f_min), np.log10(f_max), int(n_f))
    parsed = parse_resp_stages(resp_path, when=when)
    # evalresp's default units: the RESP's own input units ("def"), i.e.
    # no (j*omega)^k conversion — pass the native units through
    native_units = (parsed["input_units"] or "M/S").upper()
    units = {"M": "DISP", "M/S": "VEL", "M/S**2": "ACC"}.get(
        native_units, "VEL"
    )
    h = evaluate_response(parsed, freqs, units=units)
    for path, vals in (
        (amp_file, np.abs(h)),
        (phase_file, np.degrees(np.angle(h))),
    ):
        with open(path, "w") as fh:
            for f, v in zip(freqs, vals):
                fh.write(f"{f:.6E} {v:.6E}\n")
    return info, amp_file, phase_file


# ---------------------------------------------------------------------------
# Native frequency-domain deconvolution (no obspy, no evalresp binary).
# The reference's pipeline is: evalresp computes the response curve, then
# taper + spectral division with regularization (environment.py:385-521,
# after Zhao Chen). Here the response is evaluated directly from the RESP
# file's stage chain (analog pole-zero + digital FIR/IIR coefficient
# stages) and divided out with obspy-convention water-level
# regularization, entirely in numpy.

_UNIT_DERIVS = {"M": 0, "M/S": 1, "M/S**2": 2}


def parse_resp_paz(resp_path: str, when=None) -> dict:
    """Parse the analog pole-zero stages out of a SEED RESP text file.

    Returns {"stages": [{"type", "a0", "zeros", "poles", "input_units"}...],
    "sensitivity": float, "input_units": str}. Each B053 blockette opens a
    stage: transfer type A (Laplace, rad/s) or B (Hz), A0 normalization,
    complex zeros (B053F10-13) and poles (B053F15-18). The overall
    sensitivity is the stage-0 B058F04 Sensitivity line. Raises ValueError
    when the file carries no pole-zero stage — use `parse_resp_stages` for
    the full analog + digital stage chain.
    """
    full = parse_resp_stages(resp_path, when=when)
    if not full["paz_stages"]:
        raise ValueError(f"no pole-zero (B053) stages in {resp_path}")
    return {"stages": full["paz_stages"],
            "sensitivity": full["sensitivity"],
            "input_units": full["input_units"]}


def parse_resp_stages(resp_path: str, when=None) -> dict:
    """Parse the full response-stage chain of a SEED RESP text file.

    Multi-epoch files (rdseed appends one full response block per epoch)
    are handled natively: `when` — a datetime / obspy UTCDateTime /
    pandas Timestamp / ISO string, normally the trace's start time —
    selects the covering epoch with evalresp's date-range semantics
    (reference environment.py:434-441 passes the trace year/julian-day to
    the external binary for exactly this). `when=None` on a multi-epoch
    file raises, because merging epochs would multiply every epoch's
    transfer function together.

    Covers analog pole-zero stages (blockette 053), digital coefficient
    stages (054: FIR numerators + optional IIR denominators), FIR stages
    (061, with SEED symmetry codes A/B/C), per-stage decimation info
    (057: input sample rate + applied delay correction) — everything the
    reference delegates to the external `evalresp` binary
    (environment.py:413-455) — and polynomial responses (blockette 062:
    approximation type + MacLaurin coefficients), which evalresp cannot
    express as a transfer function at all.

    Returns ``{"paz_stages": [...], "digital_stages": [...],
    "poly_stages": [...], "sensitivity": float, "input_units": str}``
    where each digital stage carries its numerator/denominator
    coefficients, symmetry code, stage input sample rate, and applied
    delay correction, and each polynomial stage its approximation code
    and index-ordered coefficient list.
    """
    paz_stages = []
    digital_stages = []
    poly_stages = []
    current = None      # open B053 stage dict
    dcurrent = None     # open B054/B061 stage dict
    pcurrent = None     # open B062 stage dict
    dstage_by_seq = {}
    seen_seq = set()    # (blockette-family, stage-sequence) pairs
    sensitivity = None

    def _epoch_guard(family, seq):
        # After epoch selection, the same (blockette, stage) appearing
        # twice WITHIN one epoch block means a corrupt file (or an epoch
        # boundary the splitter missed); merging would multiply two
        # transfer functions together and silently deconvolve a wildly
        # wrong response
        if (family, seq) in seen_seq:
            raise ValueError(
                f"{resp_path} repeats stage sequence {seq} within one "
                "response epoch — corrupt RESP (for multi-epoch files, "
                "pass when=<trace start time> to select an epoch)"
            )
        seen_seq.add((family, seq))

    def _units_from(raw):
        # "Response in units lookup: M/S - Velocity ..." -> token after
        # the colon
        try:
            return raw.split(":", 1)[1].split()[0].upper()
        except IndexError:
            return None

    all_epochs = split_resp_epochs(resp_path)
    if len(all_epochs) > 1:
        if when is None:
            raise ValueError(
                f"{resp_path} contains {len(all_epochs)} response epochs; "
                "pass when=<trace start time> to select one natively "
                "(evalresp date-range semantics)"
            )
        block = _epoch_block(resp_path, when, all_epochs)
    else:
        block = all_epochs[0]["lines"]
    for raw in block:
        line = [t for t in raw.split(" ") if t]
        if not line or not line[0].startswith("B0"):
            continue
        tag = line[0]
        if tag == "B053F03":
            current = {
                "type": line[-1] if len(line[-1]) == 1 else line[4],
                "a0": 1.0, "zeros": [], "poles": [],
                "input_units": None,
            }
            paz_stages.append(current)
        elif tag == "B053F04" and current is not None:
            _epoch_guard("B053", line[-1])
        elif tag == "B053F05" and current is not None:
            current["input_units"] = _units_from(raw)
        elif tag == "B053F07" and current is not None:
            current["a0"] = float(line[-1])
        elif tag == "B053F10-13" and current is not None:
            current["zeros"].append(
                complex(float(line[2]), float(line[3]))
            )
        elif tag == "B053F15-18" and current is not None:
            current["poles"].append(
                complex(float(line[2]), float(line[3]))
            )
        elif tag == "B054F03":
            # transfer type precedes the stage sequence in the
            # blockette: open the stage here, register its seq on F04
            dcurrent = {
                "seq": None, "ttype":
                line[-1] if len(line[-1]) == 1 else line[4],
                "numerator": [], "denominator": [],
                "symmetry": "A", "input_rate": None,
                "correction": None, "input_units": None,
            }
            digital_stages.append(dcurrent)
        elif (tag == "B054F04" and dcurrent is not None
              and dcurrent["seq"] is None):
            seq = line[-1]
            _epoch_guard("B054/B061", seq)
            dcurrent["seq"] = seq
            dstage_by_seq[seq] = dcurrent
        elif tag == "B061F03":
            seq = line[-1]
            _epoch_guard("B054/B061", seq)
            dcurrent = {
                "seq": seq, "ttype": "D",  # B061 is always digital FIR
                "numerator": [], "denominator": [],
                "symmetry": "A", "input_rate": None,
                "correction": None, "input_units": None,
            }
            digital_stages.append(dcurrent)
            dstage_by_seq[seq] = dcurrent
        elif tag in ("B054F05", "B061F06") and dcurrent is not None:
            dcurrent["input_units"] = _units_from(raw)
        elif tag == "B061F05" and dcurrent is not None:
            dcurrent["symmetry"] = line[-1].upper()
        elif tag in ("B054F08-09", "B061F09") and dcurrent is not None:
            dcurrent["numerator"].append(float(line[2]))
        elif tag == "B054F11-12" and dcurrent is not None:
            dcurrent["denominator"].append(float(line[2]))
        elif tag == "B057F03":
            seq = line[-1]
            _epoch_guard("B057", seq)
            # attach the following rate/correction lines to the
            # matching digital stage; an analog stage's B057 (no
            # coefficient blockette) must not leak onto an earlier
            # digital stage
            dcurrent = dstage_by_seq.get(seq)
        elif tag == "B057F04" and dcurrent is not None:
            dcurrent["input_rate"] = float(line[-1])
        elif tag == "B057F08" and dcurrent is not None:
            dcurrent["correction"] = float(line[-1])
        elif tag == "B058F04" and "sensitivity:" in raw.lower():
            sensitivity = float(line[-1])
        elif tag.startswith("B062"):
            # rdseed versions disagree on B062 field numbers (the
            # approximation type is F07 in some writers, F08 in
            # others), so dispatch on the label text; coefficient
            # rows are the only range-tagged (FNN-MM) B062 lines
            low = raw.lower()
            if "transfer function type" in low:
                pcurrent = {
                    "approximation": None, "coefficients": {},
                    "input_units": None,
                }
                poly_stages.append(pcurrent)
            elif "stage sequence" in low and pcurrent is not None:
                _epoch_guard("B062", line[-1])
            elif "response in units" in low and pcurrent is not None:
                pcurrent["input_units"] = _units_from(raw)
            elif "approximation type" in low and pcurrent is not None:
                pcurrent["approximation"] = _units_from(raw)
            elif "number of coefficients" in low and pcurrent is not None:
                pcurrent["declared_n"] = int(line[-1])
            elif (
                pcurrent is not None and "-" in tag and len(line) >= 3
            ):
                pcurrent["coefficients"][int(line[1])] = float(line[2])
    # stages that never accumulated coefficients (a lone B057 opening a
    # synthetic entry) are decimation-only: drop them
    digital_stages = [d for d in digital_stages if d["numerator"]]
    poly_stages = [p for p in poly_stages if p["coefficients"]]
    for p in poly_stages:
        idx = sorted(p["coefficients"])
        if idx != list(range(len(idx))):
            raise ValueError(
                f"{resp_path}: polynomial (B062) coefficient indices "
                f"{idx} are not contiguous from 0 — corrupt blockette"
            )
        declared = p.pop("declared_n", None)
        if declared is not None and declared != len(idx):
            # a contiguous-from-0 index set can still be a truncated
            # tail; the declared B062F14 count catches that silently
            # wrong case (lower-order polynomial -> wrong physical units)
            raise ValueError(
                f"{resp_path}: polynomial (B062) declares {declared} "
                f"coefficients but {len(idx)} rows present — truncated "
                "blockette"
            )
        p["coefficients"] = [p["coefficients"][i] for i in idx]
    if not paz_stages and not digital_stages and not poly_stages:
        raise ValueError(
            f"no invertible (B053/B054/B061/B062) stages in {resp_path}"
        )
    if sensitivity is None and not poly_stages:
        # polynomial RESPs map counts to physical units inside the
        # coefficients themselves; a B058 sensitivity is neither needed
        # nor applied for them
        raise ValueError(f"no overall sensitivity (B058F04) in {resp_path}")
    units = next(
        (s["input_units"]
         for s in paz_stages + digital_stages + poly_stages
         if s["input_units"]),
        None,
    )
    return {"paz_stages": paz_stages, "digital_stages": digital_stages,
            "poly_stages": poly_stages,
            "sensitivity": sensitivity, "input_units": units}


def _evaluate_digital_stage(stage: dict, freqs):
    """Unit-DC-gain transfer function of one digital (B054/B061) stage.

    FIR/IIR shape H(f) = num(e^{-jw/fs}) / den(e^{-jw/fs}) at the stage's
    input sample rate, following evalresp's conventions: symmetric FIR
    stages (SEED symmetry B/C) evaluate zero-phase (the listed half is
    expanded and the (N-1)/2-sample linear phase removed); asymmetric FIR
    stages keep their phase minus the datalogger's applied delay
    correction (B057F08 — evalresp applies it to asymmetric FIR only,
    never IIR); FIR gain is normalized to 1 at f=0 (the stage gain lives
    in the overall B058 sensitivity, exactly like A0 for analog stages —
    evalresp warns-and-normalizes the same way). Polynomial evaluation is
    Horner over the frequency vector, O(n_freqs) memory regardless of tap
    count (day-long traces x hundreds of FIR taps must not materialize an
    outer product)."""
    import numpy as np

    if stage.get("ttype", "D") not in ("D", None):
        raise ValueError(
            "analog-coefficient (B054 transfer type "
            f"{stage['ttype']!r}) stage; the native path evaluates "
            "digital (D) coefficient stages only"
        )
    fs = stage["input_rate"]
    if not fs or fs <= 0:
        raise ValueError(
            "digital stage without a B057 input sample rate; cannot "
            "evaluate its transfer function"
        )
    b = np.asarray(stage["numerator"], np.float64)
    sym = stage.get("symmetry", "A")
    if sym == "B":      # odd total length: center listed last, once
        b = np.concatenate([b, b[-2::-1]])
    elif sym == "C":    # even total length: listed half mirrors fully
        b = np.concatenate([b, b[::-1]])
    w = 2.0 * np.pi * np.asarray(freqs, np.float64) / fs
    z = np.exp(-1j * w)

    def _poly(coeffs):
        # Horner: sum_k c_k z^k evaluated highest-order-first
        acc = np.zeros_like(z)
        for c in coeffs[::-1]:
            acc = acc * z + c
        return acc

    h = _poly(b)
    a = np.asarray(stage["denominator"], np.float64)
    if a.size:
        den = _poly(a)
        h = h / np.where(den == 0, np.inf, den)
    if sym in ("B", "C"):
        # remove the symmetric filter's (N-1)/2-sample linear phase:
        # zero-phase by construction (evalresp fir_sym_1/fir_sym_2)
        h = h * np.exp(1j * w * (b.shape[0] - 1) / 2.0)
    elif not a.size and stage.get("correction"):
        h = h * np.exp(1j * 2.0 * np.pi * np.asarray(freqs, np.float64)
                       * stage["correction"])
    dc = b.sum()
    if not a.size and abs(dc) > 0:
        h = h / dc
    return h


def evaluate_response(resp_path, freqs, units: str = "DISP", when=None):
    """Complex instrument response H(f) in counts per `units` unit.

    `resp_path` is a RESP file path or an already-parsed
    `parse_resp_stages` dict (saves re-reading the file when the caller
    parsed it for metadata). H = sensitivity * prod_analog[A0 *
    prod(s - z)/prod(s - p)] * prod_digital[FIR/IIR shape] with
    s = j*2*pi*f for transfer type A (rad/s) or s = j*f for type B (Hz)
    and digital stages per `_evaluate_digital_stage`; then scaled by
    (j*omega)^k to convert the RESP's native input units to the requested
    DISP/VEL/ACC (reference units handling: environment.py:458-490's
    seedresp units; the stage chain itself replaces the reference's
    external evalresp binary, environment.py:413-455)."""
    import numpy as np

    paz = (
        resp_path if isinstance(resp_path, dict)
        else parse_resp_stages(resp_path, when=when)
    )
    if paz.get("poly_stages"):
        raise ValueError(
            "polynomial (B062) stages have no frequency-domain transfer "
            "function; apply them sample-wise via "
            "apply_polynomial_response / remove_response_native"
        )
    freqs = np.asarray(freqs, np.float64)
    h = np.full(freqs.shape, paz["sensitivity"], np.complex128)
    for stage in paz["paz_stages"]:
        s = (
            2j * np.pi * freqs
            if stage["type"].upper() == "A"
            else 1j * freqs
        )
        num = np.ones_like(h)
        for z in stage["zeros"]:
            num *= s - z
        den = np.ones_like(h)
        for p in stage["poles"]:
            den *= s - p
        # poles at the origin give den=0 at f=0; the response is
        # legitimately infinite there — keep it finite, the water level
        # caps the inversion anyway
        h *= stage["a0"] * num / np.where(den == 0, np.inf, den)
    for stage in paz["digital_stages"]:
        h *= _evaluate_digital_stage(stage, freqs)
    native = (paz["input_units"] or "M/S").upper()
    req = {"DIS": "M", "VEL": "M/S", "ACC": "M/S**2"}.get(
        units[:3].upper()
    )
    if req is not None and native in _UNIT_DERIVS:
        k = _UNIT_DERIVS[native] - _UNIT_DERIVS[req]
        if k:
            jw = 2j * np.pi * freqs
            if k < 0:
                # dividing by jw at f=0 is 0 * inf = NaN, which would
                # poison the water-level inversion (gamma = NaN) and the
                # whole deconvolved trace; the DC response is 0 there,
                # same as a pole at the origin
                jw_safe = np.where(freqs == 0, 1.0, jw)
                h = h * np.where(freqs == 0, 0.0, jw_safe ** k)
            else:
                h = h * jw ** k
    return h


def cosine_sac_taper(freqs, flimit):
    """The SAC-style frequency-domain cosine taper obspy applies for
    pre_filt (f1 < f2 < f3 < f4: cosine ramps up over [f1, f2], unity over
    [f2, f3], down over [f3, f4])."""
    import numpy as np

    f1, f2, f3, f4 = flimit
    freqs = np.asarray(freqs, np.float64)
    taper = np.zeros_like(freqs)
    mid = (freqs >= f2) & (freqs <= f3)
    taper[mid] = 1.0
    up = (freqs > f1) & (freqs < f2)
    taper[up] = 0.5 * (
        1.0 + np.cos(np.pi * (f2 - freqs[up]) / (f2 - f1))
    )
    down = (freqs > f3) & (freqs < f4)
    taper[down] = 0.5 * (
        1.0 + np.cos(np.pi * (freqs[down] - f3) / (f4 - f3))
    )
    return taper


def _invert_water_level(h, water_level_db: float):
    """obspy-convention water-level regularized reciprocal of H: bins with
    |H| below gamma = max|H| * 10^(-wl/20) are lifted to gamma before
    division, zeros replaced by gamma outright."""
    import numpy as np

    absh = np.abs(h)
    gamma = absh.max() * 10.0 ** (-float(water_level_db) / 20.0)
    out = np.array(h, np.complex128)
    zero = absh == 0.0
    small = (~zero) & (absh < gamma)
    out[zero] = gamma
    out[small] = gamma * out[small] / absh[small]
    return 1.0 / out


def apply_polynomial_response(data, stage: dict):
    """Convert raw counts to physical units through a SEED polynomial
    (blockette 062) response: physical = sum_i c_i * counts**i, evaluated
    by Horner.

    This is the IRIS convention for transducer channels (pressure,
    temperature, wind, ...): unlike seismometer responses there is no
    transfer function to divide out — the MacLaurin polynomial IS the
    counts-to-units map, applied sample-wise in the time domain. Neither
    the reference's external `evalresp` binary (environment.py:434-441)
    nor obspy `remove_response`/`simulate` can handle these at all, so
    the native path is the only one. No demeaning, tapering, or water
    level applies: the conversion is exact per sample, and demeaning
    would destroy the absolute calibration (e.g. a temperature offset).
    """
    import numpy as np

    approx = (stage.get("approximation") or "M").upper()
    if approx != "M":
        raise ValueError(
            f"unsupported polynomial approximation type {approx!r} "
            "(only MacLaurin 'M' is defined for B062 conversion)"
        )
    x = np.asarray(data, np.float64)
    acc = np.zeros_like(x)
    for c in stage["coefficients"][::-1]:
        acc = acc * x + c
    return acc


def remove_response_native(
    data,
    sampling_rate: float,
    resp_path: str,
    units: str = "DISP",
    water_level: float = 60.0,
    pre_filt: Optional[tuple] = None,
    taper_fraction: float = 0.05,
    when=None,
):
    """Instrument-response removal, pure numpy.

    Pole-zero / coefficient RESPs: demean -> cosine taper -> rfft
    (zero-padded to 2x) -> optional pre_filt cosine bandpass ->
    water-level regularized division by the RESP's full stage-chain
    response (analog pole-zero + digital FIR/IIR) -> irfft, trimmed to
    the input length. Mirrors the evalresp + spectral-division pipeline
    of the reference (environment.py:385-521) and obspy simulate's
    conventions, without either dependency. Returns float64 ground
    motion in `units`.

    Polynomial (B062) RESPs instead convert counts to physical units by
    direct MacLaurin evaluation (`apply_polynomial_response`); `units` /
    `water_level` / `pre_filt` / `taper_fraction` do not apply there.
    """
    import numpy as np

    parsed = (
        resp_path if isinstance(resp_path, dict)
        else parse_resp_stages(resp_path, when=when)
    )
    if parsed.get("poly_stages"):
        if parsed["paz_stages"] or parsed["digital_stages"]:
            raise ValueError(
                "RESP mixes a polynomial (B062) stage with pole-zero/"
                "coefficient stages; neither spectral division nor "
                "sample-wise polynomial conversion is sound for a hybrid"
            )
        if len(parsed["poly_stages"]) > 1:
            raise ValueError(
                "RESP carries multiple polynomial (B062) stages; SEED "
                "defines one total-channel polynomial per epoch"
            )
        return apply_polynomial_response(data, parsed["poly_stages"][0])

    x = np.asarray(data, np.float64)
    n = x.shape[-1]
    x = x - x.mean(axis=-1, keepdims=True)
    if taper_fraction:
        m = max(int(taper_fraction * n / 2.0), 1)
        ramp = 0.5 * (1.0 - np.cos(np.pi * np.arange(m) / m))
        taper = np.ones(n)
        taper[:m] = ramp
        taper[n - m:] = ramp[::-1]
        x = x * taper
    nfft = 1 << int(np.ceil(np.log2(2 * n)))
    spec = np.fft.rfft(x, nfft)
    freqs = np.fft.rfftfreq(nfft, 1.0 / sampling_rate)
    if pre_filt is not None:
        spec = spec * cosine_sac_taper(freqs, pre_filt)
    h = evaluate_response(parsed, freqs, units=units)
    spec = spec * _invert_water_level(h, water_level)
    return np.fft.irfft(spec, nfft)[..., :n]


def remove_trace(
    tr, resp_path: str, units: str = "DISP",
    taper_half_width: Optional[float] = None, native: bool = True, **kwargs
) -> None:
    """Deconvolve one trace's instrument response in place (reference
    remove_trace, environment.py:458-490): optional taper sized as
    2*half_width / trace duration. Prefers the native path — full
    stage-chain spectral division for pole-zero/coefficient RESPs,
    sample-wise MacLaurin conversion for polynomial (B062) RESPs,
    multi-epoch files resolved by the trace's start time (evalresp
    date-range semantics, environment.py:434-441) — with no
    obspy/evalresp needed; truly malformed files fall back to obspy
    simulate with the RESP seedresp."""
    if taper_half_width:
        duration = tr.stats.endtime - tr.stats.starttime
        if hasattr(duration, "total_seconds"):
            # native sacio Stats carry datetimes (obspy returns float
            # seconds); a float/timedelta division would TypeError before
            # the deconvolution even ran
            duration = duration.total_seconds()
        kwargs["taper_fraction"] = 2 * taper_half_width / duration
    if native:
        try:
            tr.data = remove_response_native(
                tr.data, float(tr.stats.sampling_rate), resp_path,
                units=units,
                water_level=kwargs.get("water_level", 60.0),
                pre_filt=kwargs.get("pre_filt"),
                taper_fraction=kwargs.get("taper_fraction", 0.05),
                when=getattr(tr.stats, "starttime", None),
            )
            return
        except (ValueError, AttributeError):
            # unusable RESP (no stages, hybrid poly+paz, no epoch
            # covering the trace) or a trace object without data/stats
            # arrays -> obspy's evalresp bindings
            pass
    seedresp = {"filename": resp_path, "units": units[0:3].upper()}
    tr.simulate(seedresp=seedresp, **kwargs)


def remove_stream(
    st, resp_paths: list, units: str = "DISP",
    taper_half_width: Optional[float] = None, **kwargs
) -> None:
    """Deconvolve every trace of a stream in place (reference
    remove_stream, environment.py:493-521): merge, then per trace find the
    matching RESP file and remove_trace."""
    st.merge()
    for tr in st:
        resp_path = find_resp_file(tr.stats, resp_paths)
        remove_trace(tr, resp_path, units, taper_half_width, **kwargs)
