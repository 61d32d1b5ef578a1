"""loop.epoch_idle_ms: the device's idle time at the epoch boundary, in ms
a step.

From the start of each of the program's `pointseg_torch.loop.epoch_close`
spans (`train_epoch`'s host read of the mean loss) to the first device
activity after the next `pointseg_torch.data.epoch_start`, the time the
device ran nothing, summed over the host-traced stretch and divided by
its steps (`portbench/spans.py`). None where the stretch crosses no
epoch boundary.
"""

from portbench import spans


def read(r):
    p = r["profile"]
    s = spans.epoch_idle_s(p["host_window"]) if r["cuda"] else None
    return None if s is None else s / p["steps"] * 1e3
