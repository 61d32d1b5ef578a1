"""data.wait_ms: the time a step waits for its batch, in ms.

The benchmark's own span around each `next()` on the program's loader
(the host `Loader`, or the device store's sampler), as a mean over the
window's steps.
"""

import statistics


def read(r):
    spans = r["window"]["wait_s"]
    return statistics.fmean(spans) * 1e3 if spans else None
