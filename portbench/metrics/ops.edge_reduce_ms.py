"""ops.edge_reduce_ms: device time a step of EdgeConv's gather-reduce, in
ms: its forward kernel inside each call's range and its backward kernel,
which autograd launches outside them (`portbench/opwork/edge_reduce.py`)."""

from portbench import opmetrics


def read(r):
    return opmetrics.device_ms(r, "edge_reduce")
