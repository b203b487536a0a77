"""Mean milliseconds of `WaveformFrontend.__call__` per request in the
traced window (H2D, K1, the model's chunks and D2H), by the harness's
clock around the frontend it hands the server."""


def read(data):
    calls = data.get("frontend_calls") or []
    if not calls:
        return None
    return 1e3 * sum(s for _, s in calls) / len(calls)
