"""Weight import (port of `pointseg.io`)."""

from pointseg_torch.io.jax_import import from_jax_variables  # noqa: F401
