"""Accuracy metrics from an eval dump (port of ``cs_vit_tpu/cli/benchmark.py``;
parity: `scripts/benchmark.py`).

python -m cs_vit_tpu_torch.cli.benchmark <prediction.h5>
"""

from __future__ import annotations

import argparse

from ..evaluation import compute_metrics


def main(prediction_path: str) -> dict:
    import h5py

    with h5py.File(prediction_path, "r") as f:
        gt = f["joint_cam_gt"][:]
        pred = f["joint_cam_pred"][:]
    metrics = compute_metrics(gt, pred)
    print(f"mprpe: {metrics['mprpe']} mm")
    print(f"mpjpe_cs: {metrics['mpjpe_cs']} mm")
    print(f"mpjpe_rs: {metrics['mpjpe_rs']} mm")
    print(f"mpjpe_pa: {metrics['mpjpe_pa']} mm")
    return metrics


def cli(argv=None):
    """Console entry point (`csvit-torch-benchmark`), same surface as `python -m`."""
    parser = argparse.ArgumentParser("Calculate the result")
    parser.add_argument("prediction", type=str, help="prediction result path")
    main(parser.parse_args(argv).prediction)


if __name__ == "__main__":
    cli()
