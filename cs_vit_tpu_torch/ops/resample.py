"""Image crop and resample with kornia's sampling convention (port of
``cs_vit_tpu/ops/resample.py``'s crop functions).

The reference's pixel path runs through kornia
(``crop_and_resize(..., align_corners=True)`` at ``cs_vit/utils/img.py:376-385``
and the rotated-corner train crops at ``cs_vit/dataset/DexYCB.py:208-210``):

* 4 corner points [tl, tr, br, bl] in source pixel coordinates define an
  affine map onto the output rectangle; output pixel (x, y) samples source
  location ``tl + x/(W-1) * (tr - tl) + y/(H-1) * (bl - tl)``
* bilinear interpolation with align_corners=True (integer coordinates are
  pixel centres) and zero padding outside the source.

Three implementations, one math: the host crop ``crop_and_resize_np`` takes
the C crop (``cs_vit_tpu_torch/native``, the JAX package's C source, so both
packages give the same bits) for float32 and uint8 frames wherever a C
compiler exists, and its numpy path (f64 sample positions, uint8 converted
to float first) only where none does; ``crop_and_resize`` is the device
crop, a plain torch gather on the tensors' own device (``jnp`` gather code
in the JAX package, not a Pallas kernel).

TI pretraining adds ``crop_with_normalized_box_np`` (numpy, a copy of the
JAX function) and ``scale_rotate_img``, the centre scale-and-rotate of a
batch of images with reflection padding: JAX's vmapped gather written
batched in torch, on the images' device.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from .. import native


def _sample_coords(corners: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Affine source coords for each output pixel; corners [..., 4, 2]."""
    tl, tr, _, bl = (corners[..., i, :] for i in range(4))
    xs = np.linspace(0.0, 1.0, out_w)
    ys = np.linspace(0.0, 1.0, out_h)
    ex = (tr - tl)[..., None, None, :]  # along x
    ey = (bl - tl)[..., None, None, :]  # along y
    grid = (
        tl[..., None, None, :]
        + xs[None, :, None] * ex
        + ys[:, None, None] * ey
    )
    return grid  # [..., H, W, 2] (x, y) source coords


def _bilinear_gather_np(img: np.ndarray, coords: np.ndarray) -> np.ndarray:
    """img [H,W,C]; coords [h,w,2] (x,y) -> [h,w,C], zero padding."""
    H, W = img.shape[:2]
    x, y = coords[..., 0], coords[..., 1]
    x0 = np.floor(x).astype(np.int64)
    y0 = np.floor(y).astype(np.int64)
    x1, y1 = x0 + 1, y0 + 1
    wx = x - x0
    wy = y - y0

    def fetch(yi, xi):
        valid = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        xi_c = np.clip(xi, 0, W - 1)
        yi_c = np.clip(yi, 0, H - 1)
        v = img[yi_c, xi_c]
        return v * valid[..., None]

    v00 = fetch(y0, x0)
    v01 = fetch(y0, x1)
    v10 = fetch(y1, x0)
    v11 = fetch(y1, x1)
    wx = wx[..., None]
    wy = wy[..., None]
    return (
        v00 * (1 - wx) * (1 - wy)
        + v01 * wx * (1 - wy)
        + v10 * (1 - wx) * wy
        + v11 * wx * wy
    )


def crop_and_resize_np(
    images: np.ndarray,   # [N,H,W,C] float32 in [0,1] OR uint8 in [0,255]
    corners: np.ndarray,  # [N,4,2] (tl,tr,br,bl) in pixel coords
    out_size: Tuple[int, int],
) -> np.ndarray:
    """Host-side kornia-parity crop+resize -> [N,h,w,C] float32 in [0,1].

    float32 and uint8 frames go through the C crop (uint8 interpolated raw
    and scaled by 1/255 in the kernel, so decoded frames skip the full-frame
    float conversion), as in the JAX package; other dtypes, and every frame
    where no C compiler exists, take the numpy path."""
    h, w = out_size
    if images.dtype in (np.float32, np.uint8) and native.native_available():
        return native.crop_affine_bilinear_batch(images, np.asarray(corners), h, w)
    if images.dtype == np.uint8:  # numpy path: convert once
        images = images.astype(np.float32) / 255.0
    out = np.empty((images.shape[0], h, w, images.shape[-1]), dtype=images.dtype)
    for i in range(images.shape[0]):
        grid = _sample_coords(corners[i], h, w)
        out[i] = _bilinear_gather_np(images[i], grid)
    return out


def crop_and_resize(
    images: torch.Tensor,   # [N,H,W,C] float
    corners: torch.Tensor,  # [N,4,2] (tl,tr,br,bl) in pixel coords
    out_size: Tuple[int, int],
) -> torch.Tensor:
    """The device crop+resize: [N,h,w,C] in the images' dtype, on their
    device (``cs_vit_tpu/ops/resample.py:crop_and_resize``, its vmapped
    gather written batched; positions in the corners' dtype)."""
    h, w = out_size
    corners = corners.to(images.device)
    tl, tr, bl = corners[:, 0], corners[:, 1], corners[:, 3]
    xs = torch.linspace(0.0, 1.0, w, dtype=corners.dtype, device=corners.device)
    ys = torch.linspace(0.0, 1.0, h, dtype=corners.dtype, device=corners.device)
    grid = (tl[:, None, None, :] + xs[None, None, :, None] * (tr - tl)[:, None, None, :]
            + ys[None, :, None, None] * (bl - tl)[:, None, None, :])  # [N,h,w,2] (x, y)
    return _bilinear_gather(images, grid[..., 0], grid[..., 1])


def _bilinear_gather(images: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of `images` [N,H,W,C] at source positions `x`, `y`
    [N,h,w] (pixel centres at integers), zero outside (the JAX package's
    ``_bilinear_gather_jax``, batched)."""
    N, H, W, _ = images.shape
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = (x - x0)[..., None], (y - y0)[..., None]
    x0, y0 = x0.long(), y0.long()
    n = torch.arange(N, device=images.device)[:, None, None]

    def fetch(yi, xi):
        valid = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        v = images[n, yi.clamp(0, H - 1), xi.clamp(0, W - 1)]
        return v * valid[..., None]

    return (fetch(y0, x0) * (1 - wx) * (1 - wy)
            + fetch(y0, x0 + 1) * wx * (1 - wy)
            + fetch(y0 + 1, x0) * (1 - wx) * wy
            + fetch(y0 + 1, x0 + 1) * wx * wy)


def expand_bbox_square(bboxes: np.ndarray, expansion_ratio: float = 1.0) -> np.ndarray:
    """Square-expand xyxy boxes around their centre (ref ``utils/img.py:25-52``)."""
    x1, y1, x2, y2 = (bboxes[..., i] for i in range(4))
    max_side = np.maximum(x2 - x1, y2 - y1)
    cx, cy = (x1 + x2) * 0.5, (y1 + y2) * 0.5
    half = max_side * 0.5 * expansion_ratio
    return np.stack([cx - half, cy - half, cx + half, cy + half], axis=-1)


def bbox_to_corners(bboxes: np.ndarray) -> np.ndarray:
    """xyxy [...,4] -> corner points [...,4,2] ordered (tl,tr,br,bl)."""
    x1, y1, x2, y2 = (bboxes[..., i] for i in range(4))
    return np.stack(
        [
            np.stack([x1, y1], axis=-1),
            np.stack([x2, y1], axis=-1),
            np.stack([x2, y2], axis=-1),
            np.stack([x1, y2], axis=-1),
        ],
        axis=-2,
    )


def crop_with_square_box_np(
    images: np.ndarray,       # [N,H,W,C]
    tight_bbox: np.ndarray,   # [N,4] xyxy
    expansion_ratio: float = 2.0,
    output_size: int = 224,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Eval-path crop (ref ``utils/img.py:339-390``).

    Returns (patches [N,s,s,C], scale_coefs [N], square_bboxes [N,4]).
    """
    centers = (tight_bbox[:, :2] + tight_bbox[:, 2:]) / 2
    sizes = tight_bbox[:, 2:] - tight_bbox[:, :2]
    max_sizes = sizes.max(axis=1)
    square_sizes = np.stack([max_sizes, max_sizes], axis=1) * expansion_ratio
    square_bboxes = np.concatenate(
        [centers - square_sizes / 2, centers + square_sizes / 2], axis=1
    ).astype(np.float32)
    corners = bbox_to_corners(square_bboxes)
    patches = crop_and_resize_np(images, corners, (output_size, output_size))
    scales = (square_sizes[:, 0] / output_size).astype(np.float32)
    return patches, scales, square_bboxes


def crop_with_normalized_box_np(
    image: np.ndarray,            # [H,W,C]
    crop_box,                     # [4] normalized xyxy
    output_size: Tuple[int, int],
) -> np.ndarray:
    """Normalized-coordinate crop with aspect-ratio adjustment (ref
    ``cs_vit/utils/img.py:244-336``): the box is widened (never shrunk)
    about its centre to the target aspect ratio, then cropped and resized
    with align_corners=True and zero padding."""
    H, W = image.shape[:2]
    box = np.asarray(crop_box, np.float32) * np.asarray([W, H, W, H], np.float32)
    x1, y1, x2, y2 = box
    th, tw = output_size
    target_ratio = tw / th
    cur_w, cur_h = x2 - x1, y2 - y1
    cur_ratio = cur_w / cur_h
    cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
    if cur_ratio < target_ratio:
        new_w, new_h = cur_h * target_ratio, cur_h
    else:
        new_w, new_h = cur_w, cur_w / target_ratio
    x1, x2 = cx - new_w / 2, cx + new_w / 2
    y1, y2 = cy - new_h / 2, cy + new_h / 2
    corners = np.asarray([[x1, y1], [x2, y1], [x2, y2], [x1, y2]], np.float32)
    return crop_and_resize_np(image[None], corners[None], output_size)[0]


def scale_rotate_img(
    images: torch.Tensor,        # [N,H,W,C]
    scale_coef: torch.Tensor,    # [N]
    angle_degree: torch.Tensor,  # [N]
) -> torch.Tensor:
    """Centre scale+rotate with reflection padding (ref
    ``cs_vit/utils/img.py:185-212``), kornia's ``get_rotation_matrix2d`` /
    ``affine(align_corners=False)`` convention: output pixel p samples the
    source at M^-1 (p - c) + c, M the scaled rotation about the centre c,
    bilinearly, the position reflected into the image first."""
    N, H, W, C = images.shape
    cx, cy = W / 2.0, H / 2.0
    theta = angle_degree * math.pi / 180.0
    cos, sin = torch.cos(theta), torch.sin(theta)
    inv_s = 1.0 / scale_coef
    m00, m01 = (cos * inv_s)[:, None, None], (-sin * inv_s)[:, None, None]
    m10, m11 = (sin * inv_s)[:, None, None], (cos * inv_s)[:, None, None]
    ys, xs = torch.meshgrid(torch.arange(H, device=images.device),
                            torch.arange(W, device=images.device), indexing="ij")
    xs = xs.to(torch.float32) - cx
    ys = ys.to(torch.float32) - cy

    def reflect(v, n):
        period = 2 * (n - 1)
        v = torch.fmod(torch.abs(v), period)
        return torch.where(v > n - 1, period - v, v)

    sx = reflect(m00 * xs + m01 * ys + cx, W)
    sy = reflect(m10 * xs + m11 * ys + cy, H)
    return _bilinear_gather(images, sx, sy)
