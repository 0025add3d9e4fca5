"""collapse_ms.serve: host ms a request under bench.collapse: the paths'
copy to the host and the native collapse_path an utterance."""


def read(out):
    requests = out.facts.get("requests")
    if not out.traces or not requests:
        return None
    ns = out.traces[0].host_ns("bench.collapse")
    return ns / 1e6 / requests if ns else None
