"""step.metrics_ms: device time a step of what the program's
`pointseg_torch.step.metrics` spans launched, in ms.

The batch's loss, accuracy and mIoU, computed every step whether or not
a logger reads them: the kernels launched inside the spans over the
host-traced stretch, divided by its steps (`portbench/spans.py`).
"""

from portbench import spans


def read(r):
    return spans.per_step_ms(r, "pointseg_torch.step.metrics")
