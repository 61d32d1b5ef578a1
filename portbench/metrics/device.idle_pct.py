"""device.idle_pct: the share of the traced stretch in which the device
runs nothing, in %."""


def read(r):
    win = r["profile"]["window"]
    busy = win.busy_s()
    return 100.0 * (1.0 - busy / win.window_s) if r["cuda"] and busy > 0 else None
