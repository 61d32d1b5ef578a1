"""ops_roofline: the geometric ops' share of their roofline, in %.

For the forward op calls of `ops.device_ms`: the sum of their bound
times (the larger of bytes over 3.35 TB/s and operations over 67 TFLOP/s,
counted from the calls' argument shapes by `portbench/opwork/`) over the
sum of their device times.
"""

from portbench import opmetrics


def read(r):
    return opmetrics.roofline(r, *opmetrics.GEOMETRIC)
