"""One reader per per-layer metric, `metrics/<metric>.py` with
`read(data) -> float | None`; `data` is the driver's record of the run
(`window_s`, `flops`, the traced `slice`, ...). A reader that finds
nothing to read returns None, and the metric is left out of the line."""
