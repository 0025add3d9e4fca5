"""decode_ms.serve: device ms a request under the benchmark's bench.decode span."""


def read(out):
    requests = out.facts.get("requests")
    if not out.traces or not requests:
        return None
    ns = out.traces[0].device_ns(("bench.decode",))
    return ns / 1e6 / requests if ns else None
