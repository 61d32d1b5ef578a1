"""model.invres_forward_ms: device time a step of what the program's
`pointseg_torch.model.invres` spans launched, in ms.

PointNeXt's InvResMLP blocks in the forward pass (ball query, grouped
layer, max, point MLP, residual add): the kernels launched inside the
spans over the host-traced stretch, divided by its steps
(`portbench/spans.py`). A program without the span gives None.
"""

from portbench import spans


def read(r):
    return spans.per_step_ms(r, "pointseg_torch.model.invres")
