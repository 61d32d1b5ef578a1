"""step.backward_ms: device time a step of what the program's
`pointseg_torch.step.backward` spans launched, in ms.

`zero_grad` and the backward pass: the kernels launched inside the spans,
by autograd's own thread too (`portbench/spans.py`), over the
host-traced stretch, divided by its steps.
"""

from portbench import spans


def read(r):
    return spans.per_step_ms(r, "pointseg_torch.step.backward")
