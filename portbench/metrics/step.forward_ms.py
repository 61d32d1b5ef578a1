"""step.forward_ms: device time a step of what the program's
`pointseg_torch.step.forward` spans launched, in ms.

The model's forward pass and the masked loss: the kernels launched inside
the spans over the host-traced stretch, divided by its steps
(`portbench/spans.py`).
"""

from portbench import spans


def read(r):
    return spans.per_step_ms(r, "pointseg_torch.step.forward")
