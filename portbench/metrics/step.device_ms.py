"""step.device_ms: device time a step, in ms.

The union of the device's kernel, copy and set intervals over the traced
stretch of steps (`torch.profiler`), divided by its steps.
"""


def read(r):
    p = r["profile"]
    busy = p["window"].busy_s()
    return busy / p["steps"] * 1e3 if r["cuda"] and busy > 0 else None
