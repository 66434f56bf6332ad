"""Canonical joint orderings, skeleton topology and image statistics.

Copy of ``cs_vit_tpu/constants.py`` (plus ``MANO_PARENTS`` from
``cs_vit_tpu/mano/assets.py``) so the port carries no import of the JAX
package.
"""

import numpy as np

IH26M_RJOINTS_ORDER = (
    "Thumb_4", "Thumb_3", "Thumb_2", "Thumb_1",
    "Index_4", "Index_3", "Index_2", "Index_1",
    "Middle_4", "Middle_3", "Middle_2", "Middle_1",
    "Ring_4", "Ring_3", "Ring_2", "Ring_1",
    "Pinky_4", "Pinky_3", "Pinky_2", "Pinky_1",
    "Wrist",
)

HO3D_JOINTS_ORDER = (
    "Wrist",
    "Index_1", "Index_2", "Index_3",
    "Middle_1", "Middle_2", "Middle_3",
    "Pinky_1", "Pinky_2", "Pinky_3",
    "Ring_1", "Ring_2", "Ring_3",
    "Thumb_1", "Thumb_2", "Thumb_3",
    "Thumb_4", "Index_4", "Middle_4", "Ring_4", "Pinky_4",
)

# Original 16-joint MANO kinematic-tree order (wrist + 3 per finger).
MANO_JOINTS_ORDER = (
    "Wrist",
    "Index_1", "Index_2", "Index_3",
    "Middle_1", "Middle_2", "Middle_3",
    "Pinky_1", "Pinky_2", "Pinky_3",
    "Ring_1", "Ring_2", "Ring_3",
    "Thumb_1", "Thumb_2", "Thumb_3",
)

# Canonical 21-joint output order (wrist, then thumb..pinky each 1..4).
TARGET_JOINTS_ORDER = (
    "Wrist",
    "Thumb_1", "Thumb_2", "Thumb_3", "Thumb_4",
    "Index_1", "Index_2", "Index_3", "Index_4",
    "Middle_1", "Middle_2", "Middle_3", "Middle_4",
    "Ring_1", "Ring_2", "Ring_3", "Ring_4",
    "Pinky_1", "Pinky_2", "Pinky_3", "Pinky_4",
)

# 20 bones over TARGET_JOINTS_ORDER.
TARGET_JOINTS_CONNECTION = (
    (0, 1), (0, 5), (0, 9), (0, 13), (0, 17),
    (1, 2), (2, 3), (3, 4),
    (5, 6), (6, 7), (7, 8),
    (9, 10), (10, 11), (11, 12),
    (13, 14), (14, 15), (15, 16),
    (17, 18), (18, 19), (19, 20),
)

# Fingertip vertex indices on the MANO mesh (778 verts) used to extend the
# 16-row MANO regressor to the 21-joint set.
FINGERTIP_VERTEX_IDX = {
    "Thumb_4": 745,
    "Index_4": 317,
    "Middle_4": 445,
    "Ring_4": 556,
    "Pinky_4": 673,
}

# Parent of each of the 16 MANO joints in kinematic-tree order
# (wrist, index1-3, middle1-3, pinky1-3, ring1-3, thumb1-3).
MANO_PARENTS = np.asarray(
    [-1, 0, 1, 2, 0, 4, 5, 0, 7, 8, 0, 10, 11, 0, 13, 14], dtype=np.int32
)

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

NUM_MANO_VERTS = 778
NUM_MANO_JOINTS = 16
NUM_TARGET_JOINTS = 21
