"""Legacy InterHand2.6M two-hand metric suite (copy of
``cs_vit_tpu/evaluation/ih26m_metrics.py``).

Parity: `cs_vit/dataset/InterHand26M/InterHand26M.py:598-864`
(``evaluate`` / ``print_eval_result``): per-sample root-aligned MPJPE split
by single-hand/interacting, MPVPE on 778-vertex meshes, RRVE (right-relative
two-hand vertex error), MRRPE (relative root position error), and bbox IoU —
aggregated exactly as the reference (per-joint means over valid samples).

Decoupled from the loader: callers pass plain numpy arrays. The 42-joint
two-hand convention is [right 21 | left 21] in TARGET order, wrist-rooted.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from ..constants import NUM_MANO_VERTS, NUM_TARGET_JOINTS

RIGHT = np.arange(0, NUM_TARGET_JOINTS)
LEFT = np.arange(NUM_TARGET_JOINTS, 2 * NUM_TARGET_JOINTS)
ROOT_RIGHT, ROOT_LEFT = 0, NUM_TARGET_JOINTS


def bbox_iou(box1: np.ndarray, box2: np.ndarray) -> float:
    """IoU of two xyxy boxes given as [2,2] corner arrays or [4] vectors."""
    b1 = np.asarray(box1, np.float64).reshape(-1)
    b2 = np.asarray(box2, np.float64).reshape(-1)
    x1, y1 = max(b1[0], b2[0]), max(b1[1], b2[1])
    x2, y2 = min(b1[2], b2[2]), min(b1[3], b2[3])
    inter = max(0.0, x2 - x1) * max(0.0, y2 - y1)
    a1 = max(0.0, b1[2] - b1[0]) * max(0.0, b1[3] - b1[1])
    a2 = max(0.0, b2[2] - b2[0]) * max(0.0, b2[3] - b2[1])
    union = a1 + a2 - inter
    return float(inter / union) if union > 0 else 0.0


def evaluate_sample(
    joint_gt: np.ndarray,            # [42,3] mm
    joint_out: np.ndarray,           # [42,3] mm
    joint_valid: np.ndarray,         # [42]
    hand_type: str,                  # "right" | "left" | "interacting"
    sh_joint_regressor: np.ndarray,  # [21,778]
    mesh_gt: Optional[np.ndarray] = None,    # [1556,3] mm (right|left)
    mesh_out: Optional[np.ndarray] = None,   # [1556,3] mm
    rel_trans_gt: Optional[np.ndarray] = None,   # [3] mm (left root - right root)
    rel_trans_out: Optional[np.ndarray] = None,  # [3] mm
    has_mano: Dict[str, bool] = None,
    bboxes_out: Optional[Sequence[Optional[np.ndarray]]] = None,  # [right, left] xyxy
    bboxes_gt: Optional[Sequence[Optional[np.ndarray]]] = None,
) -> Dict[str, object]:
    """Per-sample metrics; None entries where a metric does not apply."""
    has_mano = has_mano or {"right": True, "left": True}
    J = 2 * NUM_TARGET_JOINTS
    V = NUM_MANO_VERTS
    out: Dict[str, object] = {
        "mpjpe_sh": [None] * J,
        "mpjpe_ih": [None] * J,
        "mpvpe_sh": None,
        "mpvpe_ih": [None, None],
        "rrve": None,
        "mrrpe": None,
        "bbox_iou": [None, None],
    }

    joint_gt = np.array(joint_gt, np.float64)
    joint_out = np.array(joint_out, np.float64)

    # mrrpe before alignment (ref :636-649)
    if (
        rel_trans_gt is not None
        and rel_trans_out is not None
        and joint_valid[ROOT_RIGHT] * joint_valid[ROOT_LEFT]
    ):
        out["mrrpe"] = float(
            np.sqrt(np.sum((np.asarray(rel_trans_gt) - np.asarray(rel_trans_out)) ** 2))
        )

    # root-align joints and meshes per hand (ref :651-676)
    if mesh_gt is not None and mesh_out is not None:
        mesh_gt = np.array(mesh_gt, np.float64)
        mesh_out = np.array(mesh_out, np.float64)
        for h, vmask in (("right", np.arange(0, V)), ("left", np.arange(V, 2 * V))):
            root_g = (sh_joint_regressor @ mesh_gt[vmask])[0]
            root_o = (sh_joint_regressor @ mesh_out[vmask])[0]
            mesh_gt[vmask] -= root_g
            mesh_out[vmask] -= root_o
    for h, jmask, root in (("right", RIGHT, ROOT_RIGHT), ("left", LEFT, ROOT_LEFT)):
        joint_gt[jmask] -= joint_gt[root, None]
        joint_out[jmask] -= joint_out[root, None]

    # mpjpe split by hand type (ref :678-689)
    key = "mpjpe_sh" if hand_type in ("right", "left") else "mpjpe_ih"
    for j in range(J):
        if joint_valid[j]:
            out[key][j] = float(np.sqrt(np.sum((joint_out[j] - joint_gt[j]) ** 2)))

    # mpvpe / rrve (ref :691-748)
    if mesh_gt is not None and mesh_out is not None:
        def vert_err(mask):
            return float(
                np.sqrt(np.sum((mesh_gt[mask] - mesh_out[mask]) ** 2, 1)).mean()
            )

        if hand_type == "right" and has_mano.get("right"):
            out["mpvpe_sh"] = vert_err(np.arange(0, V))
        elif hand_type == "left" and has_mano.get("left"):
            out["mpvpe_sh"] = vert_err(np.arange(V, 2 * V))
        elif hand_type == "interacting":
            if has_mano.get("right"):
                out["mpvpe_ih"][0] = vert_err(np.arange(0, V))
            if has_mano.get("left"):
                out["mpvpe_ih"][1] = vert_err(np.arange(V, 2 * V))
            if (
                has_mano.get("right") and has_mano.get("left")
                and rel_trans_gt is not None and rel_trans_out is not None
            ):
                mg = mesh_gt.copy()
                mo = mesh_out.copy()
                mg[V:] += np.asarray(rel_trans_gt)
                mo[V:] += np.asarray(rel_trans_out)
                out["rrve"] = float(np.sqrt(np.sum((mg - mo) ** 2, 1)).mean())

    # bbox IoU (ref :750-773, minus the body-shape rescale which is a
    # pipeline detail of the vendored InterWild code)
    if bboxes_out is not None and bboxes_gt is not None:
        for idx in range(2):
            if bboxes_gt[idx] is not None and bboxes_out[idx] is not None:
                out["bbox_iou"][idx] = bbox_iou(bboxes_out[idx], bboxes_gt[idx])

    return out


def aggregate_results(samples: List[Dict]) -> Dict[str, float]:
    """Aggregate per-sample results (ref ``print_eval_result`` :777-864)."""
    J = 2 * NUM_TARGET_JOINTS
    per_joint_sh: List[List[float]] = [[] for _ in range(J)]
    per_joint_ih: List[List[float]] = [[] for _ in range(J)]
    mpvpe_sh, mpvpe_ih, rrve, mrrpe, ious = [], [], [], [], []
    for s in samples:
        for j in range(J):
            if s["mpjpe_sh"][j] is not None:
                per_joint_sh[j].append(s["mpjpe_sh"][j])
            if s["mpjpe_ih"][j] is not None:
                per_joint_ih[j].append(s["mpjpe_ih"][j])
        if s["mpvpe_sh"] is not None:
            mpvpe_sh.append(s["mpvpe_sh"])
        for v in s["mpvpe_ih"]:
            if v is not None:
                mpvpe_ih.append(v)
        if s["rrve"] is not None:
            rrve.append(s["rrve"])
        if s["mrrpe"] is not None:
            mrrpe.append(s["mrrpe"])
        for v in s["bbox_iou"]:
            if v is not None:
                ious.append(v)

    def nanmean(lists):
        vals = [np.mean(v) for v in lists if v]
        return float(np.mean(vals)) if vals else float("nan")

    sh = [np.mean(v) for v in per_joint_sh if v]
    ih = [np.mean(v) for v in per_joint_ih if v]
    return {
        "mpjpe_sh": float(np.mean(sh)) if sh else float("nan"),
        "mpjpe_ih": float(np.mean(ih)) if ih else float("nan"),
        "mpjpe_all": float(np.mean(sh + ih)) if (sh or ih) else float("nan"),
        "mpvpe_sh": float(np.mean(mpvpe_sh)) if mpvpe_sh else float("nan"),
        "mpvpe_ih": float(np.mean(mpvpe_ih)) if mpvpe_ih else float("nan"),
        "mpvpe_all": float(np.mean(mpvpe_sh + mpvpe_ih)) if (mpvpe_sh or mpvpe_ih) else float("nan"),
        "rrve": float(np.mean(rrve)) if rrve else float("nan"),
        "mrrpe": float(np.mean(mrrpe)) if mrrpe else float("nan"),
        "bbox_iou": float(np.mean(ious)) if ious else float("nan"),
    }


def print_eval_result(agg: Dict[str, float]):
    print()
    print("bbox IoU: %.2f" % (agg["bbox_iou"] * 100))
    print()
    print("MRRPE: %.2f mm" % agg["mrrpe"])
    print()
    print("MPVPE for all hand sequences: %.2f mm" % agg["mpvpe_all"])
    print("MPVPE for single hand sequences: %.2f mm" % agg["mpvpe_sh"])
    print("MPVPE for interacting hand sequences: %.2f mm" % agg["mpvpe_ih"])
    print("RRVE for interacting hand sequences: %.2f mm" % agg["rrve"])
    print()
    print("MPJPE for all hand sequences: %.2f mm" % agg["mpjpe_all"])
    print("MPJPE for single hand sequences: %.2f mm" % agg["mpjpe_sh"])
    print("MPJPE for interacting hand sequences: %.2f mm" % agg["mpjpe_ih"])
    print()
