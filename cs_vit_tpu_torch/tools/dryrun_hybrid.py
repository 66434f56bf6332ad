"""Hybrid multi-dataset smoke loop (port of ``tools/dryrun_hybrid.py``;
parity: reference `tests/dryrun_hybrid.py:27-64`).

ConcatDataset(InterHand26MSeq + DexYCB + HO3D) at T frames through the
loader, on the port's synthetic fixtures unless all three roots are given:

  python -m cs_vit_tpu_torch.tools.dryrun_hybrid [--ih26m ROOT --dexycb ROOT --ho3d ROOT]
"""

from __future__ import annotations

import argparse
import tempfile
from typing import List, Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> List[tuple]:
    """Run the loop; returns each iteration's patch shape."""
    from ..data import HO3D, ConcatDataset, DataLoader, DexYCB, InterHand26MSeq

    p = argparse.ArgumentParser(prog="cs_vit_tpu_torch dryrun_hybrid")
    p.add_argument("--ih26m", default=None)
    p.add_argument("--dexycb", default=None)
    p.add_argument("--ho3d", default=None)
    p.add_argument("--frames", type=int, default=7)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--max_iters", type=int, default=10)
    args = p.parse_args(argv)

    if args.ih26m is None or args.dexycb is None or args.ho3d is None:
        from ..data.fixtures import (
            make_synthetic_dexycb,
            make_synthetic_ho3d,
            make_synthetic_ih26mseq,
        )

        base = tempfile.mkdtemp(prefix="dryrun_hybrid_")
        args.dexycb = make_synthetic_dexycb(f"{base}/dexycb", seq_len=args.frames + 2)
        args.ho3d = make_synthetic_ho3d(f"{base}/ho3d", seq_len=args.frames + 2)
        args.ih26m = make_synthetic_ih26mseq(f"{base}/ih26m", seq_len=args.frames + 2)
        print(f"using synthetic fixtures under {base}")

    dataset = ConcatDataset(
        [
            InterHand26MSeq(args.ih26m, args.frames, "train", img_size=256),
            DexYCB(args.dexycb, args.frames, "s1", "train", img_size=256),
            HO3D(args.ho3d, args.frames, "train", img_size=256),
        ]
    )
    loader = DataLoader(dataset, batch_size=args.batch_size, shuffle=True)
    print(f"hybrid dataset len={len(dataset)}")
    shapes = []
    for i, batch in enumerate(loader):
        print(i, sorted(batch.keys())[:5], batch["patches"].shape)
        shapes.append(batch["patches"].shape)
        if i + 1 >= args.max_iters:
            break
    print("ok")
    return shapes


if __name__ == "__main__":
    main()
