"""call_host_ms (ms): host time of one chunk call (runtime/pipeline.
process_scan_chunk: the copies into the graph's static inputs, the replay,
the clones out of its pool), the mean over every call of the measured
window, by the host clock around the call. Layer: the chunk graph."""


def read(tr):
    if not tr.call_ms:
        return None
    return sum(tr.call_ms) / len(tr.call_ms)
