"""The port's own numpy data layer: copies of the JAX package's
`pointseg/data/{s3dis,prepare,blocks,datasets,synthetic,native}.py`, kept
here so that the port imports nothing of `pointseg`."""

from pointseg_torch.data.s3dis import (  # noqa: F401
    S3DIS_CLASSES,
    S3DIS_CLASSES_13,
    NUM_S3DIS_CLASSES,
    BLOCK_SIZE,
    MIN_POINTS_PER_BLOCK,
    POINT_FEATURE_DIM,
    AREAS,
)
