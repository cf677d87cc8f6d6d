"""kernels_per_scan (kernels/scan): kernels the device ran for the chunk
calls of the traced sub-window (the graph's replay, the copies into its
static inputs and the clones out of its pool), over the scans handed in
there. Layer: the chunk graph (runtime/pipeline.ChunkGraph)."""


def read(tr):
    w = tr.window
    if w is None or not w.scans or not w.kernels_in_calls:
        return None
    return w.kernels_in_calls / w.scans
