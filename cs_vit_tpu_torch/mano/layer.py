"""MANO forward kinematics, linear blend skinning in f32.

Port of ``cs_vit_tpu/mano/layer.py``: shape blendshapes, pose-corrective
blendshapes, the 16-step kinematic chain written out joint by joint, then
LBS. The MANO tensors are non-persistent f32 buffers, so they follow
``.to(device)`` but stay out of the state dict (the reference's does not
carry them either). Outputs are in meters.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ..constants import (
    FINGERTIP_VERTEX_IDX,
    MANO_JOINTS_ORDER,
    NUM_MANO_JOINTS,
    TARGET_JOINTS_ORDER,
)
from ..core.geometry import axis_angle_to_matrix
from ..utils.profiling import annotate
from .assets import ManoAssets


def sh_joint_regressor(assets: ManoAssets) -> np.ndarray:
    """The 21-joint regressor in TARGET_JOINTS_ORDER.

    Rows for the 16 articulated joints come from the MANO ``J_regressor``
    (kinematic order renamed to target order); the five fingertips are
    one-hot rows selecting mesh vertices.
    """
    V = assets.j_regressor.shape[1]
    out = np.zeros((len(TARGET_JOINTS_ORDER), V), dtype=np.float32)
    for src_idx, name in enumerate(MANO_JOINTS_ORDER):
        out[TARGET_JOINTS_ORDER.index(name)] = assets.j_regressor[src_idx]
    for name, vidx in FINGERTIP_VERTEX_IDX.items():
        row = np.zeros(V, dtype=np.float32)
        row[vidx] = 1.0
        out[TARGET_JOINTS_ORDER.index(name)] = row
    return out


class ManoLayer(nn.Module):
    """Batched MANO LBS: (betas, global_orient, hand_pose) -> vertices/joints."""

    def __init__(self, assets: ManoAssets, flat_hand_mean: bool = False):
        super().__init__()
        self.assets = assets
        self.parents = [int(p) for p in np.asarray(assets.parents)]

        def buf(name, value):
            self.register_buffer(
                name, torch.as_tensor(np.asarray(value), dtype=torch.float32),
                persistent=False,
            )

        buf("v_template", assets.v_template)        # [V,3]
        buf("shapedirs", assets.shapedirs)          # [V,3,10]
        buf("posedirs", assets.posedirs)            # [135,V*3]
        buf("j_regressor", assets.j_regressor)      # [16,V]
        buf("lbs_weights", assets.lbs_weights)      # [V,16]
        mean = np.zeros(45) if flat_hand_mean else assets.hands_mean
        buf("pose_mean", np.concatenate([np.zeros(3), mean]))  # [48]

    def forward(
        self,
        betas: torch.Tensor,          # [B,10]
        global_orient: torch.Tensor,  # [B,3] axis-angle
        hand_pose: torch.Tensor,      # [B,45] axis-angle (15 joints)
        transl: Optional[torch.Tensor] = None,  # [B,3]
    ) -> dict:
        B = betas.shape[0]
        J = NUM_MANO_JOINTS
        f32 = torch.float32

        # a bf16 pose is promoted by the f32 mean, as in the JAX package
        full_pose = torch.cat([global_orient, hand_pose], dim=-1) + self.pose_mean

        v_shaped = self.v_template + torch.einsum(
            "bl,vdl->bvd", betas.to(f32), self.shapedirs
        )
        joints = torch.einsum("jv,bvd->bjd", self.j_regressor, v_shaped)  # [B,16,3]

        rot_mats = axis_angle_to_matrix(full_pose.reshape(B, J, 3))      # [B,16,3,3]
        eye = torch.eye(3, dtype=f32, device=betas.device)
        pose_feature = (rot_mats[:, 1:] - eye).reshape(B, -1)            # [B,135]
        pose_offsets = (pose_feature @ self.posedirs).reshape(B, -1, 3)
        v_posed = v_shaped + pose_offsets

        # forward-kinematic chain, one joint at a time; the list index and the
        # constant row are copied to the card from pageable memory, and the
        # host waits for each copy
        with annotate("csvit.sync.mano_parents"):
            parent_joints = joints[:, self.parents[1:]]
        rel_joints = torch.cat([joints[:, :1], joints[:, 1:] - parent_joints], dim=1)
        with annotate("csvit.sync.mano_bottom"):
            bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=f32, device=betas.device)
        transforms_mat = torch.cat(
            [
                torch.cat([rot_mats, rel_joints[..., None]], dim=-1),
                bottom.expand(B, J, 1, 4),
            ],
            dim=-2,
        )  # [B,16,4,4]
        chain = [transforms_mat[:, 0]]
        for i in range(1, J):
            chain.append(chain[self.parents[i]] @ transforms_mat[:, i])
        transforms = torch.stack(chain, dim=1)                           # [B,16,4,4]
        posed_joints = transforms[:, :, :3, 3]

        # remove the rest-pose joint location from each transform (smplx style)
        joints_h = torch.cat([joints, joints.new_zeros(B, J, 1)], dim=-1)
        correction = torch.einsum("bjik,bjk->bji", transforms, joints_h)  # [B,16,4]
        rel_transforms = torch.cat(
            [transforms[..., :3], (transforms[..., 3] - correction)[..., None]], dim=-1
        )

        T = torch.einsum("vj,bjik->bvik", self.lbs_weights, rel_transforms)
        v_h = torch.cat([v_posed, v_posed.new_ones(B, v_posed.shape[1], 1)], dim=-1)
        verts = torch.einsum("bvik,bvk->bvi", T, v_h)[..., :3]

        if transl is not None:
            verts = verts + transl[:, None]
            posed_joints = posed_joints + transl[:, None]
        return {"vertices": verts, "joints": posed_joints}
