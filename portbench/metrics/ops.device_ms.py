"""ops.device_ms: device time a step of the port's geometric ops, in ms.

The kernels launched inside the forward calls of `pointseg_torch.ops`'
FPS, ball query, interpolation, kNN and row gathers (each call in a named
profiler range) over the traced stretch, divided by its steps.
"""


def read(r):
    p = r["profile"]
    return p["op_device_s"] / p["steps"] * 1e3 if r["cuda"] and p["op_device_s"] > 0 else None
