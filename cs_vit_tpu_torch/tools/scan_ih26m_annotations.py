"""Annotation sanity scan for InterHand2.6M ``seq.h5`` files (port of
``tools/scan_ih26m_annotations.py``; the reference's
`notebook/ih26m.ipynb`).

Walks the capture/sequence/camera/hand/frame-range hierarchy and reports
every group whose annotations contain NaN (the notebook checked
``joint_img``; ``--keys`` widens the scan). Exit code 1 when any NaN is
found, so it doubles as a data gate.

  python -m cs_vit_tpu_torch.tools.scan_ih26m_annotations \\
      /path/to/annotations/train/seq.h5 [--keys joint_img joint_cam mano_pose]
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional, Sequence

import numpy as np


def scan(path: str, keys: List[str]) -> List[dict]:
    import h5py

    bad = []
    n_groups = 0
    with h5py.File(path, "r") as f:
        for capture_id, capture in f.items():
            for seq_name, sequence in capture.items():
                for cam_id, camera in sequence.items():
                    for handedness, hand in camera.items():
                        for fr_name, fr in hand.items():
                            n_groups += 1
                            annots = fr["annots"]
                            for key in keys:
                                if key not in annots:
                                    continue
                                arr = annots[key][:]
                                if np.issubdtype(arr.dtype, np.floating) and np.isnan(arr).any():
                                    where = (f"{capture_id}, {seq_name}, {cam_id}, "
                                             f"{handedness}, {fr_name}")
                                    bad.append({"path": where, "key": key,
                                                "nan_frames": int(np.isnan(arr).any(
                                                    axis=tuple(range(1, arr.ndim))).sum())})
                                    print(f"found NaN: {where} [{key}]")
    print(f"scanned {n_groups} frame-range groups; {len(bad)} with NaN")
    return bad


def main(argv: Optional[Sequence[str]] = None) -> int:
    """Scan and return the exit code: 1 when a NaN was found, else 0."""
    ap = argparse.ArgumentParser(prog="cs_vit_tpu_torch scan_ih26m_annotations",
                                 description="NaN scan of an InterHand2.6M seq.h5")
    ap.add_argument("seq_h5", help="annotations/<split>/seq.h5")
    ap.add_argument("--keys", nargs="+", default=["joint_img"],
                    help="annot datasets to scan (default: joint_img)")
    args = ap.parse_args(argv)
    return 1 if scan(args.seq_h5, args.keys) else 0


if __name__ == "__main__":
    sys.exit(main())
