"""kernels_per_scan (kernels/scan): kernels the device ran for the calls
of the traced sub-window, over the scans handed in there: every kernel
launched inside a call (for the chunk call, the graph's replay, the copies
into its static inputs and the clones out of its pool; for the per-scan
call, the eager body's own launches). Layer: the chunk graph
(runtime/pipeline.ChunkGraph), or the call path that stands in its place."""


def read(tr):
    w = tr.window
    if w is None or not w.scans or not w.kernels_in_calls:
        return None
    return w.kernels_in_calls / w.scans
