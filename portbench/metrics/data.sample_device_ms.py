"""data.sample_device_ms: device time a step of the device store's
sampling, in ms.

What the program's `pointseg_torch.data.sample` spans (a batch's
uniforms, row choice, flat gather and unpack) and
`pointseg_torch.data.epoch_start` spans (an epoch's seeding and
permutation) launched over the host-traced stretch, divided by its steps
(`portbench/spans.py`).
"""

from portbench import spans


def read(r):
    return spans.per_step_ms(r, "pointseg_torch.data.sample", "pointseg_torch.data.epoch_start")
