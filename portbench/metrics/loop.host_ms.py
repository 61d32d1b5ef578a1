"""loop.host_ms: the train loop's host time a step, in ms.

The benchmark's own span from handing a batch to `train_epoch` to its
asking for the next one (the launch path of `train_step`, `to_device`,
the loop's bookkeeping), as a mean over the window's steps.
"""

import statistics


def read(r):
    spans = r["window"]["host_s"]
    return statistics.fmean(spans) * 1e3 if spans else None
