"""device.idle_pct: the share of the traced window in which no device
activity (kernel, copy or set) runs, in percent."""


def read(t):
    if not t.activities or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
