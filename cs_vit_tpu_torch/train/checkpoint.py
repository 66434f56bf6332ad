"""Checkpoints in the reference's layout (port of
``cs_vit_tpu/train/checkpoint.py``).

  <ckpt_dir>/checkpoint_<E>   one ``.pt`` file per epoch
  <ckpt_dir>/checkpoint       symlink to the latest

Each file holds the reference schema ``{"model": state_dict, "merged":
state_dict, "epoch": E}`` (what ``tools/export_torch_ckpt.py`` writes, and
what ``PoserSession`` reads) plus ``"optimizer"`` (the AdamW state dict) and
``"step"``. :func:`merge_params` is torch's ``load_state_dict(...,
strict=False)``: take the loaded entries whose name and shape match.
"""

from __future__ import annotations

import os
from typing import Dict, List, Mapping, Optional, Tuple

import torch

from .state import TrainState


def merge_params(template: Mapping[str, torch.Tensor], loaded: Mapping[str, torch.Tensor]
                 ) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """strict=False merge: the `loaded` entries whose name and shape match
    `template`, the rest from `template`. Returns (merged, names kept from
    the template)."""
    out, skipped = {}, []
    for k, v in template.items():
        if k in loaded and tuple(loaded[k].shape) == tuple(v.shape):
            out[k] = loaded[k]
        else:
            out[k] = v
            skipped.append(k)
    return out, skipped


def save_checkpoint(ckpt_dir: str, epoch: int, state: TrainState) -> str:
    """Write checkpoint_<epoch> and point the ``checkpoint`` symlink at it."""
    ckpt_dir = os.path.abspath(ckpt_dir)
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"checkpoint_{epoch}")
    sd = {k: v.detach().cpu() for k, v in state.model.state_dict().items()}
    torch.save({"model": sd, "merged": sd, "epoch": epoch,
                "optimizer": state.optimizer.state_dict(), "step": state.step}, path)
    link = os.path.join(ckpt_dir, "checkpoint")
    if os.path.islink(link) or os.path.exists(link):
        os.remove(link)
    os.symlink(f"checkpoint_{epoch}", link)
    return path


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    link = os.path.join(os.path.abspath(ckpt_dir), "checkpoint")
    return os.path.realpath(link) if os.path.exists(link) else None


def restore_checkpoint(path: str, state: Optional[TrainState] = None) -> Dict:
    """Read a checkpoint file; with `state`, also load its model (strict),
    optimizer, ``step`` and ``epoch`` into it."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if state is not None:
        state.model.load_state_dict(payload["model"], strict=True)
        if "optimizer" in payload:
            state.optimizer.load_state_dict(payload["optimizer"])
        state.step = int(payload.get("step", 0))
        state.epoch = int(payload.get("epoch", 0))
    return payload
