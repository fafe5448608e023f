"""Framework-wide constants (the port's copy of ``ssd_tpu/constants.py``).

All box coordinates are ``(ymin, xmin, ymax, xmax)``, normalized to
``[0, 1]`` relative to the image.
"""

import numpy as np

# Box encoding scale factors for (ty, tx, th, tw).
SCALE_FACTORS = (10.0, 10.0, 5.0, 5.0)

# Anchor-matching IoU thresholds.
MATCHING_THRESHOLD = 0.5   # IoU >= this -> positive anchor
NEGATIVE_THRESHOLD = 0.4   # IoU < this -> negative anchor; in between -> ignored

# Match-tensor sentinel values (per-anchor ground-truth index).
IGNORE_MATCH = -2
NEGATIVE_MATCH = -1

# Focal loss defaults (RetinaNet).
FOCAL_ALPHA = 0.25
FOCAL_GAMMA = 2.0

# RetinaNet class-head prior probability for bias init.
CLASS_PRIOR = 0.01

# Batch-norm defaults.
BATCH_NORM_MOMENTUM = 0.997
BATCH_NORM_EPSILON = 1e-3

# Numerical epsilon for box geometry.
EPSILON = 1e-8

# ImageNet per-channel normalization (images arrive as uint8 RGB).
MEAN_RGB = np.array([0.485, 0.456, 0.406], np.float32) * 255.0
STD_RGB = np.array([0.229, 0.224, 0.225], np.float32) * 255.0
