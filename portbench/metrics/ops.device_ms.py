"""ops.device_ms: device time a step of the port's geometric ops, in ms.

The kernels launched inside the forward calls of `pointseg_torch.ops`'
FPS, ball query, interpolation, kNN and row gathers (each call in a named
profiler range; `portbench/opmetrics.py` lists the seven) over the traced
stretch, divided by its steps.
"""

from portbench import opmetrics


def read(r):
    return opmetrics.device_ms(r, *opmetrics.GEOMETRIC)
