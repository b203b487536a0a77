"""Mean milliseconds a request spends outside the frontend call: the
client's latency (send to last byte) less the frontend's time, averaged
over the traced window's requests (the mean of differences is the
difference of means, so no request needs matching to its call)."""


def read(data):
    calls = data.get("frontend_calls") or []
    lat = data.get("latencies_s") or []
    if not calls or not lat:
        return None
    return 1e3 * (sum(lat) / len(lat) - sum(s for _, s in calls) / len(calls))
