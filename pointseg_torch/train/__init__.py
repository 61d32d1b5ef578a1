"""Training: loss, metrics, steps and loop (port of `pointseg.train`)."""

from pointseg_torch.train.loss import (  # noqa: F401
    length_mask,
    masked_cross_entropy_int,
    masked_onehot_cross_entropy,
)
from pointseg_torch.train.state import (  # noqa: F401
    TrainState,
    create_train_state,
    eval_step,
    make_optimizer,
    train_step,
)
from pointseg_torch.train.loop import evaluate, train_epoch, train_model  # noqa: F401
