"""Data-pipeline smoke loop (port of ``tools/dryrun_dexycb.py``; parity:
reference `tests/dryrun_dexycb.py:26-47`).

Iterates the DexYCB dataset through the loader, printing patch shapes. It
points at the port's synthetic fixture by default, so it runs anywhere:

  python -m cs_vit_tpu_torch.tools.dryrun_dexycb [--root /data/dexycb] [--frames 7]
"""

from __future__ import annotations

import argparse
import tempfile
from typing import List, Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> List[tuple]:
    """Run the loop; returns each iteration's patch shape."""
    from ..data import DataLoader, DexYCB

    p = argparse.ArgumentParser(prog="cs_vit_tpu_torch dryrun_dexycb")
    p.add_argument("--root", default=None)
    p.add_argument("--frames", type=int, default=7)
    p.add_argument("--batch_size", type=int, default=10)
    p.add_argument("--max_iters", type=int, default=10)
    args = p.parse_args(argv)

    root = args.root
    if root is None:
        from ..data.fixtures import make_synthetic_dexycb

        root = make_synthetic_dexycb(tempfile.mkdtemp(prefix="dryrun_dexycb_"),
                                     seq_len=args.frames + 2)
        print(f"using synthetic fixture at {root}")

    dataset = DexYCB(root, args.frames, "s1", "train", img_size=256)
    loader = DataLoader(dataset, batch_size=args.batch_size, shuffle=True)
    print(f"dataset len={len(dataset)}, {len(loader)} batches")
    shapes = []
    for i, batch in enumerate(loader):
        print(i, "patches", batch["patches"].shape)
        shapes.append(batch["patches"].shape)
        if i + 1 >= args.max_iters:
            break
    print("ok")
    return shapes


if __name__ == "__main__":
    main()
