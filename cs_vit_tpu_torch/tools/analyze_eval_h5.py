"""Eval-dump analysis: root and joint distributions from eval H5 files (port
of ``tools/analyze_eval_h5.py``; the reference's
`notebook/caam_pred_dist.ipynb` as a CLI).

Loads one or more eval dumps (the schema ``evaluation.EvalH5Writer``
writes, the reference's `scripts/eval.py:204-249`), prints root-position and
error-distribution statistics, and with ``--plot`` saves the notebook's
XY/YZ/XZ root scatter projections as a PNG (``matplotlib`` is imported only
then).

  python -m cs_vit_tpu_torch.tools.analyze_eval_h5 eval_dexycb.h5 \\
      [eval_ho3d.h5 ...] [--plot roots.png] [--pred]

With ``--pred`` the scatter uses predicted roots instead of ground truth;
the error statistics (needing both) are printed whenever
``joint_cam_pred`` exists.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Optional, Sequence

import numpy as np

from ..evaluation.metrics import compute_metrics


def _percentiles(x: np.ndarray) -> str:
    p = np.percentile(x, [5, 25, 50, 75, 95])
    return (
        f"mean {np.mean(x):8.2f}  p5 {p[0]:8.2f}  p25 {p[1]:8.2f}  "
        f"p50 {p[2]:8.2f}  p75 {p[3]:8.2f}  p95 {p[4]:8.2f}"
    )


def analyze(path: str, use_pred: bool = False) -> dict:
    import h5py

    with h5py.File(path, "r") as f:
        gt = f["joint_cam_gt"][:]            # [N,21,3] mm
        pred = f["joint_cam_pred"][:] if "joint_cam_pred" in f else None

    roots = (pred if use_pred and pred is not None else gt)[:, 0]  # [N,3]
    print(f"== {path} ({gt.shape[0]} samples) ==")
    for ax, name in enumerate("XYZ"):
        print(f"  root {name} (mm): {_percentiles(roots[:, ax])}")

    out = {"roots": roots}
    if pred is not None:
        m = compute_metrics(gt, pred)
        for k, v in m.items():
            print(f"  {k}: {v:.2f} mm")
        root_err = np.linalg.norm(gt[:, 0] - pred[:, 0], axis=-1)
        joint_err = np.linalg.norm(gt - pred, axis=-1).mean(-1)
        print(f"  root-error  (mm): {_percentiles(root_err)}")
        print(f"  joint-error (mm): {_percentiles(joint_err)}")
        out.update(metrics=m, root_err=root_err, joint_err=joint_err)
    return out


def plot_roots(results: dict, out_path: str):
    """XY / YZ / XZ scatter projections (notebook `plot_3d_projections`)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axs = plt.subplots(1, 3, figsize=(15, 5))
    pairs = [(0, 1, "XY"), (1, 2, "YZ"), (0, 2, "XZ")]
    for (a, b, title), ax in zip(pairs, axs):
        for name, res in results.items():
            roots = res["roots"]
            ax.scatter(roots[:, a], roots[:, b], alpha=0.5, s=1,
                       label=os.path.basename(name))
        ax.set_title(f"{title} Plane Projection")
        ax.set_xlabel(f"{title[0]} axis")
        ax.set_ylabel(f"{title[1]} axis")
        ax.grid(True)
    axs[0].legend(markerscale=8)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    print(f"wrote {out_path}")


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, dict]:
    ap = argparse.ArgumentParser(prog="cs_vit_tpu_torch analyze_eval_h5",
                                 description="root/joint distributions from eval H5 dumps")
    ap.add_argument("h5", nargs="+", help="eval H5 dump(s)")
    ap.add_argument("--plot", default=None, help="save root scatter PNG here")
    ap.add_argument("--pred", action="store_true",
                    help="scatter predicted roots instead of GT")
    args = ap.parse_args(argv)

    results = {p: analyze(p, args.pred) for p in args.h5}
    if args.plot:
        plot_roots(results, args.plot)
    return results


if __name__ == "__main__":
    main()
