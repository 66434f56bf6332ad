"""Legacy InterHand2.6M COCO-style single-frame loader (torch-free).

Parity target: `cs_vit/dataset/InterHand26M/InterHand26M.py:34-596` — the
vendored InterWild-style loader the reference keeps alongside the newer
`InterHand26MSeq` (which supersedes it for training, SURVEY §2.2). This port
reproduces the annotation indexing exactly (COCO json parsed directly —
no pycocotools dependency):

* world->camera joint transforms, validity gating through the wrist roots,
  per-hand bboxes from valid 2D joints (extend 1.2, sanitize, xywh->xyxy),
  body bbox aspect processing, MANO-param presence gating, the human-annot
  aid lists for test splits.

Items are served in an evaluation-oriented form: per-hand square crops plus
the 42-joint GT arrays expected by ``evaluation.ih26m_metrics``. The
InterWild train-time machinery (heatmap soft-argmax targets, 2.5D
augmentation) belongs to the two-hand InterWild model the reference vendors
but never trains, and is intentionally out of scope (see PARITY.md).
Copy of ``cs_vit_tpu/data/ih26m_legacy.py``; its MANO ground truth comes from
this package's ``ManoLayer`` (``data/mano_gt.py``).
"""

from __future__ import annotations

import json
import os.path as osp
from typing import Dict, List, Optional

import numpy as np

from ..ops.resample import crop_with_square_box_np
from .dexycb import load_image_rgb

# Two-hand MANO joint order (ref `utils/mano.py:175-217`): TARGET 21-joint
# order per hand, right then left. Equal name SET to IH26M_42_JOINTS, so the
# annotation->MANO reorder in transform_db_data is a pure permutation.
TH_42_JOINTS = tuple(
    f"{side}_{name}"
    for side in ("R", "L")
    for name in (
        "Wrist",
        "Thumb_1", "Thumb_2", "Thumb_3", "Thumb_4",
        "Index_1", "Index_2", "Index_3", "Index_4",
        "Middle_1", "Middle_2", "Middle_3", "Middle_4",
        "Ring_1", "Ring_2", "Ring_3", "Ring_4",
        "Pinky_1", "Pinky_2", "Pinky_3", "Pinky_4",
    )
)

IH26M_42_JOINTS = tuple(
    f"{side}_{name}"
    for side in ("R", "L")
    for name in (
        "Thumb_4", "Thumb_3", "Thumb_2", "Thumb_1",
        "Index_4", "Index_3", "Index_2", "Index_1",
        "Middle_4", "Middle_3", "Middle_2", "Middle_1",
        "Ring_4", "Ring_3", "Ring_2", "Ring_1",
        "Pinky_4", "Pinky_3", "Pinky_2", "Pinky_1",
        "Wrist",
    )
)
ROOT_IDX = {"right": IH26M_42_JOINTS.index("R_Wrist"),
            "left": IH26M_42_JOINTS.index("L_Wrist")}
JOINT_TYPE = {"right": np.arange(0, 21), "left": np.arange(21, 42)}


def world2cam(world_coord: np.ndarray, R: np.ndarray, t: np.ndarray) -> np.ndarray:
    return (R @ world_coord.T).T + t.reshape(1, 3)


def cam2pixel(cam_coord: np.ndarray, f: np.ndarray, c: np.ndarray) -> np.ndarray:
    x = cam_coord[:, 0] / cam_coord[:, 2] * f[0] + c[0]
    y = cam_coord[:, 1] / cam_coord[:, 2] * f[1] + c[1]
    return np.stack((x, y, cam_coord[:, 2]), 1)


def get_bbox(joint_img, joint_valid, extend_ratio=1.2) -> np.ndarray:
    x = joint_img[:, 0][joint_valid == 1]
    y = joint_img[:, 1][joint_valid == 1]
    xmin, xmax, ymin, ymax = x.min(), x.max(), y.min(), y.max()
    xc, w = (xmin + xmax) / 2.0, xmax - xmin
    yc, h = (ymin + ymax) / 2.0, ymax - ymin
    xmin, xmax = xc - 0.5 * w * extend_ratio, xc + 0.5 * w * extend_ratio
    ymin, ymax = yc - 0.5 * h * extend_ratio, yc + 0.5 * h * extend_ratio
    return np.asarray([xmin, ymin, xmax - xmin, ymax - ymin], np.float32)


def sanitize_bbox(bbox, img_width, img_height) -> Optional[np.ndarray]:
    x, y, w, h = bbox
    x1 = max(0, x)
    y1 = max(0, y)
    x2 = min(img_width - 1, x1 + max(0, w - 1))
    y2 = min(img_height - 1, y1 + max(0, h - 1))
    if w * h > 0 and x2 > x1 and y2 > y1:
        return np.asarray([x1, y1, x2 - x1, y2 - y1], np.float32)
    return None


def process_bbox(
    bbox, img_width, img_height, do_sanitize=True, extend_ratio=1.25,
    aspect_ratio: float = 384.0 / 512.0,
) -> Optional[np.ndarray]:
    if do_sanitize:
        bbox = sanitize_bbox(bbox, img_width, img_height)
        if bbox is None:
            return None
    bbox = np.asarray(bbox, np.float32).copy()
    w, h = bbox[2], bbox[3]
    cx, cy = bbox[0] + w / 2.0, bbox[1] + h / 2.0
    if w > aspect_ratio * h:
        h = w / aspect_ratio
    elif w < aspect_ratio * h:
        w = h * aspect_ratio
    bbox[2] = w * extend_ratio
    bbox[3] = h * extend_ratio
    bbox[0] = cx - bbox[2] / 2.0
    bbox[1] = cy - bbox[3] / 2.0
    return bbox


class InterHand26M:
    """COCO-style single-frame IH26M loader (evaluation-oriented items)."""

    def __init__(
        self,
        root: str,
        data_split: str,
        img_size: int = 256,
        expansion_ratio: float = 2.0,
        aid_list_path: Optional[str] = None,
    ):
        self.root = root
        self.data_split = data_split
        self.img_size = img_size
        self.expansion_ratio = expansion_ratio
        self.img_path = osp.join(root, "images")
        self.annot_path = osp.join(root, "annotations")
        self.aid_list_path = aid_list_path
        self.datalist = self._load_data()

    def _load_data(self) -> List[Dict]:
        split = self.data_split
        with open(osp.join(self.annot_path, split, f"InterHand2.6M_{split}_data.json")) as f:
            db = json.load(f)
        images = {img["id"]: img for img in db["images"]}
        anns = {ann["id"]: ann for ann in db["annotations"]}
        with open(osp.join(self.annot_path, split, f"InterHand2.6M_{split}_camera.json")) as f:
            cameras = json.load(f)
        with open(osp.join(self.annot_path, split, f"InterHand2.6M_{split}_joint_3d.json")) as f:
            joints = json.load(f)
        with open(
            osp.join(self.annot_path, split, f"InterHand2.6M_{split}_MANO_NeuralAnnot.json")
        ) as f:
            mano_params = json.load(f)

        if split == "train" or self.aid_list_path is None:
            aid_list = list(anns.keys())
        else:
            with open(self.aid_list_path) as f:
                aid_list = [int(x) for x in f.readlines()]

        datalist = []
        for aid in aid_list:
            ann = anns[aid]
            img = images[ann["image_id"]]
            img_width, img_height = img["width"], img["height"]
            img_path = osp.join(self.img_path, split, img["file_name"])
            capture_id, cam, frame_idx = img["capture"], img["camera"], img["frame_idx"]
            hand_type = ann["hand_type"]

            camd = cameras[str(capture_id)]
            t = np.asarray(camd["campos"][str(cam)], np.float32).reshape(3)
            R = np.asarray(camd["camrot"][str(cam)], np.float32).reshape(3, 3)
            t = -(R @ t.reshape(3, 1)).reshape(3)
            focal = np.asarray(camd["focal"][str(cam)], np.float32).reshape(2)
            princpt = np.asarray(camd["princpt"][str(cam)], np.float32).reshape(2)

            joint_trunc = np.asarray(ann["joint_valid"], np.float32).reshape(-1, 1)
            joint_trunc[JOINT_TYPE["right"]] *= joint_trunc[ROOT_IDX["right"]]
            joint_trunc[JOINT_TYPE["left"]] *= joint_trunc[ROOT_IDX["left"]]
            if joint_trunc.sum() == 0:
                continue

            jinfo = joints[str(capture_id)][str(frame_idx)]
            joint_valid = np.asarray(jinfo["joint_valid"], np.float32).reshape(-1, 1)
            joint_valid[JOINT_TYPE["right"]] *= joint_valid[ROOT_IDX["right"]]
            joint_valid[JOINT_TYPE["left"]] *= joint_valid[ROOT_IDX["left"]]
            if joint_valid.sum() == 0:
                continue

            joint_world = np.asarray(jinfo["world_coord"], np.float32).reshape(-1, 3)
            joint_cam = world2cam(joint_world, R, t)
            joint_cam[np.tile(joint_valid == 0, (1, 3))] = 1.0
            joint_img = cam2pixel(joint_cam, focal, princpt)[:, :2]

            body_bbox = process_bbox(
                np.asarray([0, 0, img_width, img_height], np.float32),
                img_width, img_height, extend_ratio=1.0,
            )
            if body_bbox is None:
                continue

            hand_bboxes = {}
            for h in ("left", "right"):
                if joint_trunc[JOINT_TYPE[h]].sum() == 0:
                    hb = None
                else:
                    hb = get_bbox(
                        joint_img[JOINT_TYPE[h]], joint_trunc[JOINT_TYPE[h], 0], 1.2
                    )
                    hb = sanitize_bbox(hb, img_width, img_height)
                if hb is None:
                    joint_valid[JOINT_TYPE[h]] = 0
                    joint_trunc[JOINT_TYPE[h]] = 0
                else:
                    hb = hb.copy()
                    hb[2:] += hb[:2]  # xywh -> xyxy
                hand_bboxes[h] = hb
            if hand_bboxes["left"] is None and hand_bboxes["right"] is None:
                continue

            try:
                mano_param = dict(mano_params[str(capture_id)][str(frame_idx)])
                if hand_bboxes["left"] is None:
                    mano_param["left"] = None
                if hand_bboxes["right"] is None:
                    mano_param["right"] = None
            except KeyError:
                mano_param = {"right": None, "left": None}

            datalist.append(
                {
                    "aid": aid,
                    "capture_id": capture_id,
                    "seq_name": img.get("seq_name"),
                    "cam_id": cam,
                    "frame_idx": frame_idx,
                    "img_path": img_path,
                    "img_shape": (img_height, img_width),
                    "body_bbox": body_bbox,
                    "lhand_bbox": hand_bboxes["left"],
                    "rhand_bbox": hand_bboxes["right"],
                    "joint_img": joint_img,
                    "joint_cam": joint_cam,
                    "joint_valid": joint_valid,
                    "joint_trunc": joint_trunc,
                    "cam_param": {"R": R, "t": t, "focal": focal, "princpt": princpt},
                    "mano_param": mano_param,
                    "hand_type": hand_type,
                }
            )
        return datalist

    def __len__(self) -> int:
        return len(self.datalist)

    def train_item(
        self, ix: int, rng: Optional[np.random.Generator] = None,
        hand_img_size: int = 256,
    ) -> Dict:
        """InterWild-style two-hand TRAIN item (ref `InterHand26M.py:346-596`).

        Full-frame augmentation (scale/rot/color/flip) -> body patch,
        heatmap-space hand bboxes, 42-joint 2.5D annotation + MANO GT
        targets, and per-hand sub-crops — the training form consumed by the
        two-hand InterWild model the reference vendors (but never trains;
        kept for SURVEY §2.2 completeness). Returns the reference's
        ``{"inputs", "targets", "meta_info"}`` triplet as one nested dict.
        Hand crops are resized to ``hand_img_size`` (standing in for the
        externally-supplied ``post_transform``) so items are collatable.
        """
        import copy as _copy

        from ..mano.assets import find_and_load, fix_left_shapedirs
        from .ih26m_legacy_aug import (
            LegacyAugConfig, augmentation, crop_img, process_hand_bbox,
            resize_img, transform_db_data, transform_mano_data,
        )
        from .mano_gt import ManoGTSynthesizer

        cfg = LegacyAugConfig()
        data = _copy.deepcopy(self.datalist[ix])
        img_shape = data["img_shape"]
        cam_param = data["cam_param"]
        cam_param["t"] = cam_param["t"] / 1000.0  # mm -> m (ref :353)

        img = load_image_rgb(data["img_path"], as_float=False)
        body_xywh = np.asarray(data["body_bbox"], np.float32)
        patch, img2bb_trans, bb2img_trans, rot, do_flip = augmentation(
            img.astype(np.float32), body_xywh, self.data_split, rng=rng,
            cfg=cfg,
        )
        patch = patch / 255.0  # ref's ToTensor + /255 (:360), kept HWC here

        # hand bboxes -> heatmap space (+ flip side swap, ref :362-375)
        lhand_bbox, lhand_valid = process_hand_bbox(
            data["lhand_bbox"], do_flip, img_shape, img2bb_trans, cfg
        )
        rhand_bbox, rhand_valid = process_hand_bbox(
            data["rhand_bbox"], do_flip, img_shape, img2bb_trans, cfg
        )
        if do_flip:
            lhand_bbox, rhand_bbox = rhand_bbox, lhand_bbox
            lhand_valid, rhand_valid = rhand_valid, lhand_valid
        lhand_center = (lhand_bbox[0] + lhand_bbox[1]) / 2.0
        rhand_center = (rhand_bbox[0] + rhand_bbox[1]) / 2.0
        lhand_size = lhand_bbox[1] - lhand_bbox[0]
        rhand_size = rhand_bbox[1] - rhand_bbox[0]
        # heatmap -> input-patch pixel scale (ref :377-386; NB the reference
        # names them height/width but both equal input/hm = 8 here)
        scale_xy = np.asarray(
            [cfg.input_img_shape[1] / cfg.output_body_hm_shape[2],
             cfg.input_img_shape[0] / cfg.output_body_hm_shape[1]], np.float32,
        )
        lhand_center_input = lhand_center * scale_xy
        rhand_center_input = rhand_center * scale_xy
        lhand_size_input = lhand_size * scale_xy
        rhand_size_input = rhand_size * scale_xy

        # annotation joints -> root-relative 2.5D + augmented space (:388-422)
        joint_cam = np.asarray(data["joint_cam"], np.float32) / 1000.0
        joint_valid = np.asarray(data["joint_valid"], np.float32).reshape(-1, 1)
        rel_trans = (
            joint_cam[ROOT_IDX["left"]] - joint_cam[ROOT_IDX["right"]]
        ).astype(np.float32)
        rel_trans_valid = (
            joint_valid[ROOT_IDX["left"]] * joint_valid[ROOT_IDX["right"]]
        )
        joint_cam = joint_cam.copy()
        joint_cam[JOINT_TYPE["right"]] -= joint_cam[ROOT_IDX["right"], None]
        joint_cam[JOINT_TYPE["left"]] -= joint_cam[ROOT_IDX["left"], None]
        joint_img = np.concatenate(
            [np.asarray(data["joint_img"], np.float32)[:, :2], joint_cam[:, 2:]], 1
        )
        flip_pairs = [(i, i + 21) for i in range(21)]
        joint_img, joint_cam, joint_valid, joint_trunc, rel_trans = (
            transform_db_data(
                joint_img, joint_cam, joint_valid, rel_trans, do_flip,
                img_shape, flip_pairs, img2bb_trans, rot, cfg,
                src_names=IH26M_42_JOINTS, dst_names=TH_42_JOINTS,
            )
        )

        # per-hand MANO GT (:424-500); dummies for absent hands
        if not hasattr(self, "_mano_synth"):
            right = find_and_load(is_rhand=True)
            left = fix_left_shapedirs(find_and_load(is_rhand=False), right)
            self._mano_synth = {
                "right": ManoGTSynthesizer(right),
                "left": ManoGTSynthesizer(left),
            }
        sides = {}
        for h in ("right", "left"):
            mp = data["mano_param"].get(h)
            if mp is not None:
                ji, jc, mc, pose, shape = self._mano_synth[h](
                    mp, cam_param, do_flip, img_shape
                )
                sides[h] = dict(
                    joint_img=ji.astype(np.float32),
                    joint_cam=jc.astype(np.float32),
                    mesh_cam=mc.astype(np.float32),
                    pose=pose.astype(np.float32),
                    shape=shape.astype(np.float32),
                    joint_valid=np.ones((21, 1), np.float32),
                    mesh_valid=np.ones((778, 1), np.float32),
                    pose_valid=np.ones((16,), np.float32),
                    shape_valid=np.ones((10,), np.float32),
                )
            else:
                sides[h] = dict(
                    joint_img=np.zeros((21, 2), np.float32),
                    joint_cam=np.zeros((21, 3), np.float32),
                    mesh_cam=np.zeros((778, 3), np.float32),
                    pose=np.zeros((48,), np.float32),
                    shape=np.zeros((10,), np.float32),
                    joint_valid=np.zeros((21, 1), np.float32),
                    mesh_valid=np.zeros((778, 1), np.float32),
                    pose_valid=np.zeros((16,), np.float32),
                    shape_valid=np.zeros((10,), np.float32),
                )
        if do_flip:  # change name when flip (:480-489)
            sides["right"], sides["left"] = sides["left"], sides["right"]
        cat = lambda k: np.concatenate([sides["right"][k], sides["left"][k]])  # noqa: E731
        mano_joint_img = cat("joint_img")
        mano_joint_cam = cat("joint_cam")
        mano_mesh_cam = cat("mesh_cam")
        mano_pose = cat("pose")
        mano_shape = cat("shape")
        mano_joint_valid = cat("joint_valid")
        mano_mesh_valid = cat("mesh_valid")
        mano_pose_valid = cat("pose_valid")
        mano_shape_valid = cat("shape_valid")

        # root-relative 2.5D MANO targets (:502-541)
        TH_RIGHT, TH_LEFT = np.arange(0, 21), np.arange(21, 42)
        mano_joint_img = np.concatenate(
            [mano_joint_img, mano_joint_cam[:, 2:]], 1
        )
        mano_joint_img[TH_RIGHT, 2] -= mano_joint_cam[0, 2]
        mano_joint_img[TH_LEFT, 2] -= mano_joint_cam[21, 2]
        mano_mesh_cam = mano_mesh_cam.copy()
        mano_mesh_cam[:778] -= mano_joint_cam[0, None]
        mano_mesh_cam[778:] -= mano_joint_cam[21, None]
        mano_joint_cam = mano_joint_cam.copy()
        mano_joint_cam[TH_RIGHT] -= mano_joint_cam[0, None]
        mano_joint_cam[TH_LEFT] -= mano_joint_cam[21, None]
        (mano_joint_img, mano_joint_cam, mano_mesh_cam, mano_joint_trunc,
         _, mano_pose) = transform_mano_data(
            mano_joint_img, mano_joint_cam, mano_mesh_cam, mano_joint_valid,
            np.zeros(3, np.float32), mano_pose, img2bb_trans, rot, cfg,
        )

        # per-hand sub-crops of the augmented patch (:543-557)
        lhand_img = crop_img(
            patch, lhand_center_input, lhand_size_input,
            squarify=True, avoid_zero=True,
        )
        rhand_img = crop_img(
            patch, rhand_center_input, rhand_size_input,
            squarify=True, avoid_zero=True,
        )

        return {
            "inputs": {
                "img": patch.astype(np.float32),
                "lhand_img": resize_img(lhand_img, (hand_img_size, hand_img_size)),
                "rhand_img": resize_img(rhand_img, (hand_img_size, hand_img_size)),
            },
            "targets": {
                "joint_img": joint_img,
                "mano_joint_img": mano_joint_img,
                "joint_cam": joint_cam,
                "mano_mesh_cam": mano_mesh_cam,
                "rel_trans": rel_trans,
                "mano_pose": mano_pose,
                "mano_shape": mano_shape,
                "lhand_bbox_center": lhand_center,
                "lhand_bbox_size": lhand_size,
                "rhand_bbox_center": rhand_center,
                "rhand_bbox_size": rhand_size,
                "lhand_bbox_center_input": lhand_center_input,
                "lhand_bbox_size_input": lhand_size_input,
                "rhand_bbox_center_input": rhand_center_input,
                "rhand_bbox_size_input": rhand_size_input,
            },
            "meta_info": {
                "bb2img_trans": bb2img_trans,
                "joint_valid": joint_valid,
                "joint_trunc": joint_trunc,
                "mano_joint_trunc": mano_joint_trunc,
                "mano_mesh_valid": mano_mesh_valid,
                "rel_trans_valid": rel_trans_valid,
                "mano_pose_valid": mano_pose_valid,
                "mano_shape_valid": mano_shape_valid,
                "lhand_bbox_valid": lhand_valid,
                "rhand_bbox_valid": rhand_valid,
                "is_3D": 1.0,
            },
        }

    def __getitem__(self, ix: int) -> Dict:
        """Evaluation item: per-hand square crops + 42-joint GT arrays."""
        annot = self.datalist[ix]
        img = load_image_rgb(annot["img_path"], as_float=False)
        out = {
            "img_path": annot["img_path"],
            "hand_type": annot["hand_type"],
            "joint_img": annot["joint_img"],
            "joint_cam": annot["joint_cam"],
            "joint_valid": annot["joint_valid"][:, 0],
            "joint_trunc": annot["joint_trunc"][:, 0],
            "focal": annot["cam_param"]["focal"],
            "princpt": annot["cam_param"]["princpt"],
            "mano_param": annot["mano_param"],
        }
        for h, key in (("right", "rhand_bbox"), ("left", "lhand_bbox")):
            bbox = annot[key]
            if bbox is None:
                out[f"{h}_patch"] = np.zeros(
                    (self.img_size, self.img_size, 3), np.float32
                )
                out[f"{h}_square_bbox"] = np.zeros(4, np.float32)
                out[f"{h}_valid"] = False
            else:
                patch, _, square = crop_with_square_box_np(
                    img[None], np.asarray(bbox, np.float32)[None],
                    self.expansion_ratio, self.img_size,
                )
                out[f"{h}_patch"] = patch[0]
                out[f"{h}_square_bbox"] = square[0]
                out[f"{h}_valid"] = True
        return out
