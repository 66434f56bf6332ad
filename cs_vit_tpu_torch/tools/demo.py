"""Inference demo (port of ``tools/demo.py``; parity: reference
`notebook/demo.ipynb`).

Builds the Poser from a config (``swinv2-tiny-256`` by default), loads a
``.pt`` checkpoint (random weights from the session's seed without one),
crops the image around its box with the host square crop, serves the crop
through ``PoserSession``, prints the wrist and the mean depth of the
camera-space joints and writes the reprojected skeleton on the crop as a
PNG. It computes in f32, as the JAX tool does. Without ``--image`` it runs
on the JAX tool's synthetic frame.

  python -m cs_vit_tpu_torch.tools.demo --ckpt checkpoints/exp/checkpoint \\
      --config checkpoints/exp/config.json [--image img.jpg --bbox x1 y1 x2 y2]

It runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

import numpy as np


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="cs_vit_tpu_torch demo")
    p.add_argument("--ckpt", default=None)
    p.add_argument("--config", default=None)
    p.add_argument("--image", default=None)
    p.add_argument("--bbox", type=float, nargs=4, default=None, help="tight xyxy")
    p.add_argument("--focal", type=float, nargs=2, default=[600.0, 600.0])
    p.add_argument("--princpt", type=float, nargs=2, default=None)
    p.add_argument("--out", default="demo_out.png")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def synthetic_frame():
    """(image [480,640,3] in [0,1], tight box, principal point): the JAX
    tool's frame, uniform noise from ``default_rng(0)``."""
    img = np.random.default_rng(0).uniform(size=(480, 640, 3)).astype(np.float32)
    return (img, np.asarray([200.0, 140.0, 440.0, 380.0], np.float32),
            np.asarray([320.0, 240.0], np.float32))


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, np.ndarray]:
    """Run the demo; returns the crop's ``joint_cam`` [21,3] (mm), the
    reprojected joints [21,2] and the drawn grid [S,S,3]."""
    import cv2

    from ..config import FinetuneConfig
    from ..evaluation import reproject_pinhole
    from ..ops.resample import crop_with_square_box_np
    from ..serving import PoserSession
    from ..utils.vis import reprojection_grid

    args = build_argparser().parse_args(argv)
    cfg = (FinetuneConfig.from_json_file(args.config) if args.config
           else FinetuneConfig(exp="demo", backbone="swinv2-tiny-256", phase="inference"))
    session = PoserSession(cfg, checkpoint=args.ckpt, batch_size=1, seq_len=1,
                           dtype="float32", device=args.device)
    if args.ckpt:
        print(f"loaded {args.ckpt}")

    if args.image:
        img = cv2.cvtColor(cv2.imread(args.image), cv2.COLOR_BGR2RGB)
        img = img.astype(np.float32) / 255.0
        bbox = np.asarray(args.bbox or [img.shape[1] * 0.25, img.shape[0] * 0.25,
                                        img.shape[1] * 0.75, img.shape[0] * 0.75], np.float32)
        princpt = np.asarray(args.princpt or [img.shape[1] / 2, img.shape[0] / 2], np.float32)
    else:
        print("no --image given; running on a synthetic frame")
        img, bbox, princpt = synthetic_frame()

    patch, _, square = crop_with_square_box_np(img[None], bbox[None], cfg.expansion_ratio,
                                               cfg.img_size)
    focal = np.asarray(args.focal, np.float32)[None, None]
    predict = session.predict_crops(patch[None], square[None], np.zeros((1, 1), np.float32),
                                    focal, princpt[None, None])
    joints = predict["joint_cam"][0, 0]
    print("joint_cam (mm), wrist:", joints[0], "| mean depth:", joints[:, 2].mean())

    reproj = reproject_pinhole(predict["joint_cam"], focal, princpt[None, None])[0]
    grid = reprojection_grid(patch, square, reproj)
    cv2.imwrite(args.out, cv2.cvtColor((grid * 255).astype(np.uint8), cv2.COLOR_RGB2BGR))
    print(f"wrote {args.out}")
    return {"joint_cam": joints, "reproj": reproj[0], "grid": grid}


if __name__ == "__main__":
    main()
