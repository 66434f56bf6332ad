"""The plain reference of the fine-tune data path: a DexYCB train batch
computed from the tree's annotations and JPEG frames by the published
recipe (CS-ViT's ``DexYCB.py``, its shuffled loader and augmentations),
in float64 numpy, independent of the program's data code.

The loader: an epoch's order is ``default_rng(shuffle_seed + epoch)
.permutation(n)``, batch ``k`` its rows ``k * B`` to ``(k + 1) * B``; the
split's sequences in name order (an HDF5 group's), each one-frame window a
row. An item's augmentation draws come from ``default_rng([item_seed,
epoch, ix])``, in this order: the rotation, then the colour jitter (the
order of its four operations, then one factor each), grayscale (p 0.1),
Gaussian blur (p 0.2, sigma in [0.1, 2]) and solarize (p 0.2).

A row (``dexycb_row``): the frame decoded to RGB; for a left hand the
frame, the 2D joints' x (about the width: ``W - x``), the 3D joints' x, the
principal point's x and the pose's axis-angle y and z mirrored; the
global z-rotation by the drawn angle about the camera axis (3D joints and
the root pose) and about the principal point (2D joints); the tight box
of the rotated 2D joints, squared about its centre and widened by the
expansion ratio; the frame sampled at that square's corners rotated back
(bilinear, integer coordinates at pixel centres, zero outside, the
corners mapped onto the output's first and last pixels); then the
photometric draws on the crop in [0, 1].

``gaps`` holds the program's batch to it: the largest mean absolute pixel
gap of a row (``data_patch_gap``) and the largest gap of any label element
over the largest magnitude of its label in the batch (``data_label_gap``;
the root pose compared as rotation matrices, whose axis-angle turns over
at pi).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
from scipy.spatial.transform import Rotation

LABELS = ("square_bboxes", "bbox_tight", "joint_img", "joint_bbox_img", "joint_cam",
          "joint_rel", "joint_valid", "mano_pose", "mano_shape", "timestamp", "focal",
          "princpt", "rot_rad")


def batch_rows(n: int, shuffle_seed: int, epoch: int, k: int, batch: int) -> np.ndarray:
    """The dataset rows of batch `k` of `epoch`."""
    order = np.random.default_rng(shuffle_seed + epoch).permutation(n)
    return order[k * batch:(k + 1) * batch]


def _decode(path: str) -> np.ndarray:
    import cv2

    img = cv2.imread(path)
    if img is None:
        raise FileNotFoundError(path)
    return img[..., ::-1].astype(np.float64)  # BGR -> RGB, 0-255


def _gray(img: np.ndarray) -> np.ndarray:
    return img[..., 0] * 0.2989 + img[..., 1] * 0.587 + img[..., 2] * 0.114


def _rgb_to_hsv(img):
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    v = img.max(-1)
    d = v - img.min(-1)
    s = np.where(v > 0, d / np.where(v > 0, v, 1), 0.0)
    safe = np.where(d > 0, d, 1)
    h = np.where(v == r, 60 * (g - b) / safe,
                 np.where(v == g, 120 + 60 * (b - r) / safe, 240 + 60 * (r - g) / safe))
    h = np.where(d > 0, h, 0.0)
    return np.mod(h, 360.0), s, v


def _hsv_to_rgb(h, s, v):
    h6 = np.mod(h / 60.0, 6.0)
    i = np.floor(h6)
    f = h6 - i
    p, q, t = v * (1 - s), v * (1 - s * f), v * (1 - s * (1 - f))
    sectors = [(v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v), (v, p, q)]
    out = np.zeros(h.shape + (3,))
    for n, rgb in enumerate(sectors):
        out[i == n] = np.stack(rgb, -1)[i == n]
    return out


def _blur(img: np.ndarray, sigma: float) -> np.ndarray:
    """A 3 x 3 Gaussian, the border reflected about the edge pixel."""
    k = np.exp(-np.arange(-1, 2) ** 2 / (2 * sigma ** 2))
    k /= k.sum()
    p = np.pad(img, ((1, 1), (1, 1), (0, 0)), mode="reflect")
    rows = k[0] * p[:-2] + k[1] * p[1:-1] + k[2] * p[2:]
    return k[0] * rows[:, :-2] + k[1] * rows[:, 1:-1] + k[2] * rows[:, 2:]


def _photometric(img: np.ndarray, rng) -> np.ndarray:
    for op in rng.permutation(4):
        if op == 0:  # brightness
            img = np.clip(img * rng.uniform(0.8, 1.2), 0, 1)
        elif op == 1:  # contrast, about the mean gray
            f = rng.uniform(0.8, 1.2)
            img = np.clip(img * f + (1 - f) * _gray(img).mean(), 0, 1)
        elif op == 2:  # saturation, towards the pixel's gray
            f = rng.uniform(0.8, 1.2)
            img = np.clip(img * f + _gray(img)[..., None] * (1 - f), 0, 1)
        else:  # hue, turned by up to a tenth of the circle
            h, s, v = _rgb_to_hsv(img)
            img = np.clip(_hsv_to_rgb(np.mod(h + rng.uniform(-0.1, 0.1) * 360, 360), s, v), 0, 1)
    if rng.uniform() < 0.1:
        img = np.repeat(_gray(img)[..., None], 3, -1)
    if rng.uniform() < 0.2:
        img = _blur(img, rng.uniform(0.1, 2.0))
    if rng.uniform() < 0.2:
        img = np.where(img >= 0.5, 1 - img, img)
    return img


def _crop(img: np.ndarray, corners: np.ndarray, size: int) -> np.ndarray:
    """Bilinear samples of `img` (0-255) on the grid spanned by the corners
    (tl, tr, br, bl), in [0, 1]."""
    H, W = img.shape[:2]
    u = np.linspace(0, 1, size)
    tl, tr, bl = corners[0], corners[1], corners[3]
    pts = tl + u[None, :, None] * (tr - tl) + u[:, None, None] * (bl - tl)
    x, y = pts[..., 0], pts[..., 1]
    x0, y0 = np.floor(x).astype(int), np.floor(y).astype(int)
    out = np.zeros((size, size, 3))
    for dy in (0, 1):
        for dx in (0, 1):
            xi, yi = x0 + dx, y0 + dy
            w = (1 - np.abs(x - xi)) * (1 - np.abs(y - yi))
            inside = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
            out += (w * inside)[..., None] * img[np.clip(yi, 0, H - 1), np.clip(xi, 0, W - 1)]
    return out / 255.0


def dexycb_row(group: Dict[str, np.ndarray], t: int, root: str, pca: Dict[str, np.ndarray],
               rng, img_size: int, expansion_ratio: float) -> Dict[str, np.ndarray]:
    """Frame `t` of one sequence's annotations `group` as a train row (T=1),
    the augmentation drawn from `rng`."""
    img = _decode(f"{root}/{group['imgs_path'][t].decode()}")
    W = img.shape[1]
    hand = group["handedness"][0].decode()
    cam = group["joint_3d"][t].astype(np.float64) * 1e3
    uv = group["joint_2d"][t].astype(np.float64)
    K = group["intrinsics"].astype(np.float64).reshape(3, 3)
    focal, pp = np.array([K[0, 0], K[1, 1]]), np.array([K[0, 2], K[1, 2]])
    coeffs = group["pose_m"][0, :48].astype(np.float64)  # frame 0's: the [0:T] slice
    pose = np.concatenate([coeffs[:3], coeffs[3:] @ pca[hand]])
    if hand.startswith("l"):
        img = img[:, ::-1]
        uv = np.stack([W - uv[:, 0], uv[:, 1]], -1)
        cam = cam * [-1, 1, 1]
        pose = (pose.reshape(16, 3) * [1, -1, -1]).reshape(48)
        pp = np.array([W - pp[0], pp[1]])
    angle = float(np.float32(rng.uniform() * 2 * np.pi))
    c, s = np.cos(angle), np.sin(angle)
    rz = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    cam = cam @ rz
    root_mat = rz.T @ Rotation.from_rotvec(pose[:3]).as_matrix()
    pose = np.concatenate([Rotation.from_matrix(root_mat).as_rotvec(), pose[3:]])
    uv = (uv - pp) @ rz[:2, :2] + pp
    box = np.concatenate([uv.min(0), uv.max(0)])
    centre, half = (box[:2] + box[2:]) / 2, (box[2:] - box[:2]).max() / 2 * expansion_ratio
    square = np.concatenate([centre - half, centre + half])
    x1, y1, x2, y2 = square
    corners = np.array([[x1, y1], [x2, y1], [x2, y2], [x1, y2]])
    patch = _photometric(_crop(img, (corners - pp) @ rz[:2, :2].T + pp, img_size), rng)
    one = lambda a: np.asarray(a, np.float64)[None]  # noqa: E731  (T = 1)
    return {"patches": one(patch), "square_bboxes": one(square), "bbox_tight": one(box),
            "joint_img": one(uv), "joint_bbox_img": one(uv - box[:2]), "joint_cam": one(cam),
            "joint_rel": one(cam - cam[:1]), "joint_valid": np.ones((1, len(cam))),
            "mano_pose": one(pose), "mano_shape": one(group["beta"]), "timestamp": np.zeros(1),
            "focal": one(focal), "princpt": one(pp), "rot_rad": one(angle)}


def dexycb_batch(groups: Dict[str, Dict[str, np.ndarray]], root: str, pca, rows,
                 epoch: int, item_seed: int, img_size: int, expansion_ratio: float
                 ) -> Dict[str, np.ndarray]:
    """The rows `rows` of the split whose sequences `groups` holds by
    name, augmented as in `epoch`, stacked into a batch."""
    names = sorted(groups)
    ends = np.cumsum([len(groups[n]["imgs_path"]) for n in names])
    out: List[dict] = []
    for ix in rows:
        g = int(np.searchsorted(ends, ix, side="right"))
        t = int(ix - (ends[g - 1] if g else 0))
        rng = np.random.default_rng([item_seed, epoch, int(ix)])
        out.append(dexycb_row(groups[names[g]], t, root, pca, rng, img_size, expansion_ratio))
    return {k: np.stack([r[k] for r in out]) for k in out[0]}


def _root_matrices(pose: np.ndarray) -> np.ndarray:
    return Rotation.from_rotvec(pose[..., :3].reshape(-1, 3)).as_matrix()


def gaps(got: Dict[str, np.ndarray], want: Dict[str, np.ndarray]) -> Dict[str, float]:
    """The program's batch `got` (host arrays) against the reference's."""
    patch = np.abs(got["patches"].astype(np.float64) - want["patches"])
    label = 0.0
    for k in LABELS:
        g, w = got[k].astype(np.float64), want[k]
        if k == "mano_pose":
            label = max(label, float(np.abs(_root_matrices(g) - _root_matrices(w)).max()))
            g, w = g[..., 3:], w[..., 3:]
        label = max(label, float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-12)))
    return {"data_patch_gap": float(patch.reshape(len(patch), -1).mean(1).max()),
            "data_label_gap": label}
