"""ops.ball_query_roofline: the ball queries' share of their roofline, in
%: their calls' bound times (the distances' operations over 67 TFLOP/s or
the bytes over 3.35 TB/s, whichever is larger, `portbench/opwork/
ball_query.py`) over the device time of `ops.ball_query_ms`."""

from portbench import opmetrics


def read(r):
    return opmetrics.roofline(r, "ball_query")
