"""step.update_ms: device time a step of what the program's
`pointseg_torch.step.update` spans launched, in ms.

The gradients' reduction over ranks (none on one card), the rate, the
clip and Adam: the kernels launched inside the spans over the
host-traced stretch, divided by its steps (`portbench/spans.py`).
"""

from portbench import spans


def read(r):
    return spans.per_step_ms(r, "pointseg_torch.step.update")
