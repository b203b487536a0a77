"""The share of the traced slice (one whole training call after the
window) in which no kernel, copy or fill ran on the card."""

from portbench import trace


def read(data):
    return trace.idle_pct((data.get("slice") or {}).get("summary"))
