"""Evaluation dump to HDF5 with the reference's exact schema (port of
``cs_vit_tpu/evaluation/writer.py``).

Parity: `scripts/eval.py:204-314` — resizable gzip datasets ``img_paths``,
``joint_cam_{gt,pred}`` [N,21,3], ``joint_reproj_{gt,pred}`` [N,21,2], written
by process 0 only. In a ``torch.distributed`` world of more than one the
gathers collect every rank's rows in rank order, as JAX's
``process_allgather`` does; on one process they are the identity. ``h5py``
is imported when a writer is made.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..utils.dist import process_count, process_index


class EvalH5Writer:
    """Appendable eval dump on process 0 (no-op on other processes)."""

    def __init__(self, path: str):
        self.is_main = process_index() == 0
        self.h5 = None
        if self.is_main:
            import h5py

            self.h5 = h5py.File(path, "w")
            str_dtype = h5py.special_dtype(vlen=str)
            self.h5.create_dataset("img_paths", shape=(0,), maxshape=(None,), dtype=str_dtype)
            for name, width in (
                ("joint_cam_gt", 3),
                ("joint_cam_pred", 3),
                ("joint_reproj_gt", 2),
                ("joint_reproj_pred", 2),
            ):
                self.h5.create_dataset(
                    name,
                    shape=(0, 21, width),
                    maxshape=(None, 21, width),
                    dtype="float32",
                    chunks=(1000, 21, width),
                    compression="gzip",
                )

    def append(
        self,
        img_paths: List[str],
        joint_cam_gt: np.ndarray,
        joint_cam_pred: np.ndarray,
        joint_reproj_gt: np.ndarray,
        joint_reproj_pred: np.ndarray,
    ):
        if not self.is_main:
            return
        h5 = self.h5
        cur = h5["img_paths"].shape[0]
        new = cur + len(img_paths)
        h5["img_paths"].resize((new,))
        h5["img_paths"][cur:new] = np.array(img_paths, dtype=object)
        for name, arr in (
            ("joint_cam_gt", joint_cam_gt),
            ("joint_cam_pred", joint_cam_pred),
            ("joint_reproj_gt", joint_reproj_gt),
            ("joint_reproj_pred", joint_reproj_pred),
        ):
            h5[name].resize((new,) + h5[name].shape[1:])
            h5[name][cur:new] = arr.astype(np.float32)

    def close(self):
        if self.h5 is not None:
            self.h5.close()


def _size(group) -> int:
    if group is None:
        return process_count()
    import torch.distributed as dist

    return dist.get_world_size(group)


def _all_gather(obj, group=None) -> list:
    """Every rank's `obj`, in rank order (a pickled all-gather, which NCCL
    and gloo both take)."""
    import torch.distributed as dist

    out = [None] * _size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


def _gathered(obj, group) -> list:
    """:func:`_all_gather` over the world, or over `group` when one is given."""
    return _all_gather(obj) if group is None else _all_gather(obj, group)


def gather_to_host0(arr: np.ndarray, group=None) -> np.ndarray:
    """Rows of every process (of `group`: under tensor parallelism the data
    group, never the model peers, which hold the same rows), rank-major (ref
    `eval.py:75-82`); the identity on one process."""
    if _size(group) == 1:
        return arr
    return np.concatenate([np.asarray(a) for a in _gathered(np.asarray(arr), group)], axis=0)


def gather_strings_to_host0(strings: List[str], group=None) -> List[str]:
    """Strings of every process (of `group`), rank-major (ref
    `eval.py:53-72`); the identity on one process."""
    if _size(group) == 1:
        return strings
    return [s for part in _gathered(list(strings), group) for s in part]
