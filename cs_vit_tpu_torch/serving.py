"""Inference session for the Poser (port of ``cs_vit_tpu/serving.py``).

Build and load once, run a fixed batch shape, serve numpy in / numpy out,
padding a short request by repeating its last row:

    sess = PoserSession.from_experiment("checkpoints/myexp", seq_len=T)
    out = sess.predict_crops(patches, square_bboxes, timestamps, focal, princpt)
    out["joint_cam"]  # [N, T, 21, 3] mm; [N, 1, 21, 3] with realtime temporal encoders

A session runs ``seq_len`` frames per sample: the config's
``temporal_supervision`` decides whether all of them (``"full"``) or the last
one (``"realtime"``, which reads the timestamps) come out, and its
``attention_impl`` which backbone path runs. Timestamps stay f32 when the
images are bf16.

Checkpoints are reference-style ``.pt`` files (``{"model"|"merged":
state_dict}``, as ``tools/export_torch_ckpt.py`` writes them from an orbax
checkpoint of the JAX package, and ``train.save_checkpoint`` writes them) or
a plain state dict. ``predict_images`` takes full frames and tight boxes
through the host square crop (the C crop) into ``predict_crops``.
"""

from __future__ import annotations

import os.path as osp
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .cli.common import build_model, resolve_device
from .config import FinetuneConfig
from .models import init_poser_weights
from .ops.resample import crop_with_square_box_np
from .train.checkpoint import latest_checkpoint
from .train.convert import load_reference_state_dict
from .utils.profiling import annotate

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# weights without a checkpoint are random from this seed (the JAX session
# initialises from key 42 likewise), so every session of one config agrees
INIT_SEED = 42


def load_checkpoint_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """The state dict inside a reference-style ``.pt`` (``merged`` before
    ``model``), or the file itself when it is a plain state dict."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("merged", "model"):
        if isinstance(obj, dict) and isinstance(obj.get(key), dict):
            return obj[key]
    return obj


class PoserSession:
    """Load-once, fixed-shape Poser inference on one device."""

    def __init__(
        self,
        cfg: FinetuneConfig,
        checkpoint: Optional[str] = None,
        batch_size: int = 8,
        seq_len: int = 1,
        dtype: str = "bfloat16",
        device="cuda",
    ):
        if dtype not in _DTYPES:
            raise ValueError(f"dtype must be one of {sorted(_DTYPES)}, got {dtype!r}")
        self.cfg = cfg
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.device = resolve_device(device)
        self._dtype = _DTYPES[dtype]

        model = build_model(cfg)
        if checkpoint:
            load_reference_state_dict(model, load_checkpoint_state_dict(checkpoint))
        else:
            init_poser_weights(model, INIT_SEED)
        # float parameters go to the compute dtype; buffers (BatchNorm running
        # statistics, MANO tensors, masks, tables) stay f32
        with torch.no_grad():
            for p in model.parameters():
                p.data = p.data.to(self._dtype)
        self.model = model.to(self.device).eval()

    @classmethod
    def from_experiment(
        cls, exp_dir: str, batch_size: int = 8, seq_len: int = 1, **kw
    ) -> "PoserSession":
        """Build from ``<exp_dir>/config.json`` and the checkpoint file the
        ``<exp_dir>/checkpoint`` symlink points at (as training writes it), or
        else ``<exp_dir>/checkpoint.pt``; random weights from ``INIT_SEED``
        when there is neither."""
        cfg = FinetuneConfig.from_json_file(osp.join(exp_dir, "config.json"))
        ckpt = latest_checkpoint(exp_dir)
        if ckpt is None or not osp.isfile(ckpt):
            ckpt = osp.join(exp_dir, "checkpoint.pt")
        return cls(cfg, checkpoint=ckpt if osp.isfile(ckpt) else None,
                   batch_size=batch_size, seq_len=seq_len, **kw)

    def warmup(self):
        """Run one batch ahead of the first request (kernel build and load,
        cuDNN algorithm choice, allocator growth)."""
        S = self.cfg.img_size
        B, T = self.batch_size, self.seq_len
        self._run(
            np.zeros((B, T, S, S, 3), np.float32),
            np.tile(np.asarray([0, 0, S, S], np.float32), (B, T, 1)),
            np.zeros((B, T), np.float32),
            np.full((B, T, 2), 500.0, np.float32),
            np.full((B, T, 2), S / 2.0, np.float32),
        )

    def _upload(self, patches, bboxes, ts, focal, princpt) -> Tuple[torch.Tensor, ...]:
        """The five inputs on the session's device, the images in its dtype."""
        def dev(x, dtype=torch.float32):
            return torch.as_tensor(np.asarray(x, np.float32)).to(self.device, dtype)

        return dev(patches, self._dtype), dev(bboxes), dev(ts), dev(focal), dev(princpt)

    @torch.no_grad()
    def _forward(self, *inputs: torch.Tensor) -> Dict[str, torch.Tensor]:
        if self.model.latent_trans is not None:
            # the JAX session's jitted predict passes no "latent" rng either,
            # and flax raises there
            raise ValueError(
                "PoserSession predicts without a latent generator, so a config with "
                f"num_latent_layer={self.cfg.num_latent_layer} cannot be served: set "
                "num_latent_layer=None, as evaluation does (cs_vit_tpu/cli/evaluate.py:56); "
                "the checkpoint's latent_trans.* keys are then dropped on load")
        return self.model.predict(*inputs)

    def _run(self, patches, bboxes, ts, focal, princpt) -> Dict[str, torch.Tensor]:
        return self._forward(*self._upload(patches, bboxes, ts, focal, princpt))

    def predict_crops(
        self,
        patches: np.ndarray,        # [N, T, S, S, 3] float in [0,1]
        square_bboxes: np.ndarray,  # [N, T, 4] xyxy
        timestamps: np.ndarray,     # [N, T] ms
        focal: np.ndarray,          # [N, T, 2]
        princpt: np.ndarray,        # [N, T, 2]
    ) -> Dict[str, np.ndarray]:
        """Batched inference, each chunk padded to the session's batch size.
        Under a profiler each chunk opens ``csvit.serve.input`` (padding,
        copies to the card), ``csvit.serve.forward`` and
        ``csvit.serve.output`` (copies to the host, which wait for the
        forward)."""
        N = patches.shape[0]
        B = self.batch_size
        outs = []
        for s in range(0, N, B):
            e = min(s + B, N)
            pad = B - (e - s)

            def padded(x):
                chunk = np.asarray(x[s:e])
                if pad:
                    chunk = np.concatenate([chunk, np.repeat(chunk[-1:], pad, axis=0)], axis=0)
                return chunk

            with annotate("csvit.serve.input"):
                inputs = self._upload(
                    padded(patches), padded(square_bboxes), padded(timestamps),
                    padded(focal), padded(princpt),
                )
            with annotate("csvit.serve.forward"):
                result = self._forward(*inputs)
            with annotate("csvit.serve.output"):
                outs.append({k: v[: e - s].float().cpu().numpy() for k, v in result.items()})
        return {k: np.concatenate([o[k] for o in outs], axis=0) for k in outs[0]}

    def predict_images(
        self,
        images: np.ndarray,      # [N, H, W, 3] float in [0,1]
        tight_bboxes: np.ndarray,  # [N, 4] xyxy
        focal: np.ndarray,       # [N, 2]
        princpt: np.ndarray,     # [N, 2]
        timestamps: Optional[np.ndarray] = None,  # [N] ms
    ) -> Dict[str, np.ndarray]:
        """Full-frame API: host-side square crop (the C crop) + predict.

        Single-frame (T=1); returns per-image outputs with the T axis dropped.
        """
        N = images.shape[0]
        patches, _, squares = crop_with_square_box_np(
            images.astype(np.float32), np.asarray(tight_bboxes, np.float32),
            self.cfg.expansion_ratio, self.cfg.img_size,
        )
        ts = np.zeros((N, 1), np.float32) if timestamps is None else \
            np.asarray(timestamps, np.float32).reshape(N, 1)
        out = self.predict_crops(
            patches[:, None], squares[:, None], ts,
            np.asarray(focal, np.float32)[:, None],
            np.asarray(princpt, np.float32)[:, None],
        )
        return {k: v[:, 0] for k, v in out.items()}
