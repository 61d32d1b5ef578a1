"""ops.edge_reduce_roofline: EdgeConv's gather-reduce's share of its
roofline, in %: the bound times of its forward and backward passes (bytes
over 3.35 TB/s, `portbench/opwork/edge_reduce.py`) over the device time
of `ops.edge_reduce_ms`."""

from portbench import opmetrics


def read(r):
    return opmetrics.roofline(r, "edge_reduce")
