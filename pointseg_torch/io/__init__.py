"""Weight import, checkpoints and export (port of `pointseg.io`)."""

from pointseg_torch.io.checkpoint import (  # noqa: F401
    latest_checkpoint,
    load_checkpoint,
    load_config,
    restore_train_state,
    save_checkpoint,
)
from pointseg_torch.io.jax_import import from_jax_variables  # noqa: F401
from pointseg_torch.io.torch_import import from_reference_state_dict  # noqa: F401
