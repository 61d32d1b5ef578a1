"""ops.gather_rows_with_coords_roofline: the grouped layers' row gather's
share of its roofline, in %: its calls' bound times (bytes over 3.35 TB/s,
`portbench/opwork/gather_rows_with_coords.py`) over the device time of
`ops.gather_rows_with_coords_ms`."""

from portbench import opmetrics


def read(r):
    return opmetrics.roofline(r, "gather_rows_with_coords")
