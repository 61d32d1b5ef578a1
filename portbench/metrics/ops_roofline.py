"""ops_roofline: the geometric ops' share of their roofline, in %.

For the forward op calls of `ops.device_ms`: the sum of their bound
times (the larger of bytes over 3.35 TB/s and operations over 67 TFLOP/s,
counted from the calls' argument shapes by `portbench/work.py`) over the
sum of their device times.
"""


def read(r):
    p = r["profile"]
    if not r["cuda"] or p["op_device_s"] <= 0:
        return None
    return 100.0 * p["op_bound_s"] / p["op_device_s"]
