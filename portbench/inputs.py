"""Seeded inputs: crops and their camera, and training targets.

Crops are uniform [0, 1) images at the configuration's size; square boxes
start at U(40, 200) px with sides U(120, 300) px; focal lengths U(500, 700)
px, principal points U(200, 320) px; joint targets N(0, 20^2) mm about a
point 400 mm in front of the camera, shape targets N(0, 0.5^2). A track is
one camera's stream: consecutive frames 33.3 ms apart whose box drifts by
at most a few pixels a frame.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .weights import derive


def crops(rows: int, frames: int, img: int, seed: int, tag: str, device,
          targets: bool = False) -> Dict[str, torch.Tensor]:
    """A [rows, frames] batch of crops on `device` (with training targets)."""
    g = torch.Generator(device).manual_seed(derive(seed, tag))

    def u(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(*shape, generator=g, device=device)

    x0 = u(40, 200, rows, frames, 2)
    side = u(120, 300, rows, frames, 1)
    batch = {
        "patches": torch.rand(rows, frames, img, img, 3, generator=g, device=device),
        "square_bboxes": torch.cat([x0, x0 + side], -1),
        "timestamp": torch.zeros(rows, frames, device=device),
        "focal": u(500, 700, rows, frames, 2),
        "princpt": u(200, 320, rows, frames, 2),
    }
    if targets:
        jc = 20.0 * torch.randn(rows, frames, 21, 3, generator=g, device=device)
        jc[..., 2] += 400.0
        batch.update(joint_cam=jc, joint_valid=torch.ones(rows, frames, 21, device=device),
                     mano_shape=0.5 * torch.randn(rows, frames, 10, generator=g, device=device))
    return batch


def track(frames: int, length: int, img: int, seed: int, tag: str) -> Dict[str, np.ndarray]:
    """One camera's frames as host arrays, `frames` + `length` - 1 of them
    so that every window of `length` consecutive frames starting below
    `frames` is a contiguous slice; the last ones repeat the first ones."""
    rng = np.random.default_rng(derive(seed, tag))
    pix = rng.random((frames, img, img, 3), dtype=np.float32)
    x0 = rng.uniform(60, 180, size=2) + np.cumsum(rng.uniform(-3, 3, size=(frames, 2)), 0)
    side = rng.uniform(150, 250) + np.cumsum(rng.uniform(-2, 2, size=(frames, 1)), 0)
    boxes = np.concatenate([x0, x0 + side], -1).astype(np.float32)
    focal = np.broadcast_to(rng.uniform(500, 700, size=2), (frames, 2)).astype(np.float32)
    princpt = np.broadcast_to(rng.uniform(200, 320, size=2), (frames, 2)).astype(np.float32)

    def wrap(a):
        return np.ascontiguousarray(np.concatenate([a, a[:length - 1]], 0))

    return {"patches": wrap(pix), "square_bboxes": wrap(boxes), "focal": wrap(focal),
            "princpt": wrap(princpt)}


def window(tr: Dict[str, np.ndarray], j: int, frames: int, length: int, frame_ms: float):
    """Request `j` of a track: the `length` newest frames ending at frame
    j + length - 1 (cyclic over the track's `frames`), batch of one, as
    ``predict_crops`` takes them; timestamps keep counting across cycles."""
    s = j % frames
    ts = ((j + np.arange(length)) * frame_ms).astype(np.float32)
    return (tr["patches"][None, s:s + length], tr["square_bboxes"][None, s:s + length],
            ts[None], tr["focal"][None, s:s + length], tr["princpt"][None, s:s + length])
