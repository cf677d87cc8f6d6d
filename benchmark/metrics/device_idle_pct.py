"""device_idle_pct (%): 100 x (1 - the device's busy time / the window),
over every chunk call of the traced run's measured window, which runs
unprofiled: a chunk's busy span runs from a CUDA event recorded on the stream
before its call to one recorded after its pose copy, and the window from the
first call's event to the last one's. A gap inside a call, where the card
waits for the host's next launch, counts as busy. Layer: the device (H100)."""


def read(tr):
    if not tr.loop_span_s or not tr.loop_busy_s:
        return None
    return 100.0 * (1.0 - tr.loop_busy_s / tr.loop_span_s)
