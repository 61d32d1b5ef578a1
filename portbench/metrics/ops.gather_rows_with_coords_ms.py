"""ops.gather_rows_with_coords_ms: device time a step of the grouped layers'
row gather of features and coordinates (kernel 7), in ms, inside each
forward call's range (`portbench/opwork/gather_rows_with_coords.py`)."""

from portbench import opmetrics


def read(r):
    return opmetrics.device_ms(r, "gather_rows_with_coords")
