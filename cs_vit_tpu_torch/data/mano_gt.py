"""MANO ground-truth synthesis for the legacy IH26M pipeline.

Parity: `cs_vit/dataset/InterHand26M/utils/preprocessing.py:308-376`
(``get_mano_data``): NeuralAnnot world-frame MANO params -> camera-space
mesh/joints/2D projections, including the root-pose camera-rotation merge,
optional horizontal flip, and the root-anchored extrinsic translation. Uses
this package's MANO layer instead of smplx, on the CPU: it is host-side
ground-truth synthesis inside the loader (port of
``cs_vit_tpu/data/mano_gt.py``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from scipy.spatial.transform import Rotation

from ..mano import ManoLayer, sh_joint_regressor
from ..mano.assets import ManoAssets
from .ih26m_legacy import cam2pixel

_SH_ROOT_IDX = 0  # Wrist is row 0 of the 21-joint TARGET regressor


class ManoGTSynthesizer:
    """Callable port of get_mano_data, one MANO side per instance."""

    def __init__(self, assets: ManoAssets, flat_hand_mean: bool = False):
        self.layer = ManoLayer(assets, flat_hand_mean=flat_hand_mean).to("cpu")
        self.regressor = sh_joint_regressor(assets)

    def __call__(
        self,
        mano_param: Dict,    # {'pose': [48], 'shape': [10], 'trans': [3]}
        cam_param: Dict,     # {'R': [3,3], 't': [3], 'focal': [2], 'princpt': [2]}
        do_flip: bool = False,
        img_shape: Optional[Tuple[int, int]] = None,
    ):
        pose = np.asarray(mano_param["pose"], np.float32).reshape(-1, 3)
        shape = np.asarray(mano_param["shape"], np.float32).reshape(1, -1)
        trans = np.asarray(mano_param["trans"], np.float32).reshape(1, 3)

        # merge camera rotation into the root pose (ref :319-326)
        if "R" in cam_param:
            R = np.asarray(cam_param["R"], np.float32).reshape(3, 3)
            root_mat = Rotation.from_rotvec(pose[0]).as_matrix()
            pose = pose.copy()
            pose[0] = Rotation.from_matrix(R @ root_mat).as_rotvec()

        # flip pose (ref :328-333; MANO has no flip pairs, so just mirror)
        if do_flip:
            pose = pose.copy()
            pose[:, 1:3] *= -1
            trans = trans.copy()
            trans[:, 0] *= -1

        with torch.no_grad():
            out = self.layer(
                torch.from_numpy(shape),
                torch.from_numpy(np.ascontiguousarray(pose[0:1].reshape(1, 3))),
                torch.from_numpy(np.ascontiguousarray(pose[1:].reshape(1, -1))),
                transl=torch.from_numpy(trans),
            )
        mesh = out["vertices"][0].numpy()                   # [778,3] m
        joints = self.regressor @ mesh                      # [21,3]

        if do_flip:
            flip_tx = joints[_SH_ROOT_IDX, 0] * -2
            mesh = mesh.copy()
            joints = joints.copy()
            mesh[:, 0] += flip_tx
            joints[:, 0] += flip_tx

        # root-anchored extrinsic translation (ref :349-355)
        if "R" in cam_param and "t" in cam_param:
            R = np.asarray(cam_param["R"], np.float32).reshape(3, 3)
            t = np.asarray(cam_param["t"], np.float32).reshape(1, 3)
            root = joints[_SH_ROOT_IDX : _SH_ROOT_IDX + 1].copy()
            joints = joints - root + root @ R.T + t
            mesh = mesh - root + root @ R.T + t

        if do_flip:
            assert img_shape is not None
            focal = np.asarray(cam_param["focal"], np.float32)
            princpt = np.asarray(cam_param["princpt"], np.float32)
            z = joints[_SH_ROOT_IDX, 2]
            flip_tx = (
                2 * ((img_shape[1] - 1) / 2.0 - princpt[0]) / focal[0] * z
                - 2 * joints[_SH_ROOT_IDX, 0]
            )
            mesh[:, 0] += flip_tx
            joints[:, 0] += flip_tx

        joint_img = cam2pixel(
            joints,
            np.asarray(cam_param["focal"], np.float32),
            np.asarray(cam_param["princpt"], np.float32),
        )[:, :2]

        return joint_img, joints, mesh, pose.reshape(-1), shape.reshape(-1)
