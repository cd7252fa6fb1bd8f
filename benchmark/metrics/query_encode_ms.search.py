"""query_encode_ms.search: device milliseconds per request of the operations launched
inside the benchmark's ``encode_query`` spans of the traced window (the query tower)."""


def read(run):
    busy = run.trace.get("span_device_s", {}).get("encode_query")
    n = run.trace.get("span_count", {}).get("encode_query")
    if not busy or not n:
        return None
    return 1e3 * busy / n
