"""call_host_ms (ms): host time of one call of the program (runtime/
pipeline.process_scan_chunk: the copies into the graph's static inputs, the
replay, the clones out of its pool; process_scan: the whole eager body, its
launches and its reads of the host), the mean over every call of the
measured window, by the host clock around the call. Layer: the chunk
graph, or the call path that stands in its place."""


def read(tr):
    if not tr.call_ms:
        return None
    return sum(tr.call_ms) / len(tr.call_ms)
