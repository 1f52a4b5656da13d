"""Share of the traced window in which no device operation ran: the
window's host seconds minus the union of the kineto device intervals."""

UNIT = "%"
LAYER = "device"
MOVES = "recording_ms_p95"
WORKLOADS = ["diffunet.recordings-bf16"]


def read(t):
    if t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (t.window_s - t.busy_s) / t.window_s
