"""ops.ball_query_ms: device time a step of the ball queries (kernel 2),
in ms, inside each forward call's range (`portbench/opwork/ball_query.py`)."""

from portbench import opmetrics


def read(r):
    return opmetrics.device_ms(r, "ball_query")
