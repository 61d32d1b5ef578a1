"""S3DIS dataset constants (the port's copy of `pointseg/data/s3dis.py`).

Mirrors the class vocabulary and block geometry of the reference
benchmark (reference: train.py:32-37, data_processing/preprocess_dataset.py:7-12).
"""

# 14-class vocabulary used by the modern/block stack (reference train.py:32-37).
S3DIS_CLASSES = [
    "ceiling", "floor", "wall", "beam", "column",
    "window", "door", "table", "chair", "sofa",
    "bookcase", "board", "clutter", "stairs",
]
NUM_S3DIS_CLASSES = len(S3DIS_CLASSES)

# 13-class vocabulary used by the legacy/chunked stack
# (reference models/PointNeXt/PointNeXt.py:173-187).
S3DIS_CLASSES_13 = S3DIS_CLASSES[:13]

# Side length (metres) of the XY blocks the rooms are partitioned into
# (reference data_processing/preprocess_dataset.py:12).
BLOCK_SIZE = 1.0

# Blocks with fewer points than this are dropped during preprocessing
# (reference data_processing/preprocess_dataset.py:127).
MIN_POINTS_PER_BLOCK = 100

# Feature layout of a preprocessed point: [x, y, z, r, g, b, x-cx, y-cy, z-cz]
# (reference data_processing/preprocess_dataset.py:73-90).
POINT_FEATURE_DIM = 9

AREAS = (1, 2, 3, 4, 5, 6)
