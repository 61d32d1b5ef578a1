"""Weight import and checkpoints (port of `pointseg.io`)."""

from pointseg_torch.io.checkpoint import (  # noqa: F401
    latest_checkpoint,
    load_checkpoint,
    load_config,
    restore_train_state,
    save_checkpoint,
)
from pointseg_torch.io.jax_import import from_jax_variables  # noqa: F401
