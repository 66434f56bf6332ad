"""What the serving kinds share: weights made from the seed and rounded
to the served type, BatchNorm statistics calibrated on the cell's own
traffic, the program's session, the answers of the window, and the check
of a sample of them against the reference: ``crop_mean_mm``, the largest
over the sample's crops (frames) of a crop's mean distance in mm between
its served camera-space joints and the reference's; the widest single
joint's gap is kept beside it (``joint_mm``).

Faults for the readings (``plant``): ``control`` (the reference in fp8 in
the program's place), ``half`` (each answer's second half of rows left out
and filled with the first half's), ``answer`` (the first answer of the
window altered where the request returns it: its first crop's joints
replaced by its last crop's, or moved by 50 mm along each axis with one
crop).
"""

from __future__ import annotations

import numpy as np
import torch

from . import program
from .reference import Poser, reference_numerics
from .weights import calibrate, derive, load_reference, make_mano, make_weights

INPUTS = ("patches", "square_bboxes", "timestamp", "focal", "princpt")


class Serving:
    """The base of the serving kinds' drivers; a kind adds ``setup``,
    ``unit``, ``work``, ``calibration_inputs`` and ``request``."""

    frames = 1
    chunk = 32  # reference rows at a time

    def __init__(self, cell, seed, device):
        self.cell, self.seed, self.device = cell, seed, device
        self.stand_in = None  # the precision of the reference in the program's place
        self.model_cfg = dict(cell.config["model"], **cell.config["serve"]["model"])
        self.trace_units = cell.params["trace_units"]
        self.answers = []  # (request key, joint_cam)

    def calibration_inputs(self):
        raise NotImplementedError

    def request(self, key):
        """Request `key`'s ``predict_crops`` arguments (host arrays)."""
        raise NotImplementedError

    def build(self, batch_size):
        dev, seed = self.device, self.seed
        ref = Poser(self.model_cfg).to(dev)
        weights = make_weights(ref, seed, dev, served=True)
        self.mano = make_mano(seed, dev)
        load_reference(ref, weights, self.mano)
        self.stats = calibrate(ref, self.calibration_inputs(), derive(seed, "calibration-latent"))
        del ref
        self.session = program.session(self.cell.config, batch_size, self.frames, weights,
                                       self.stats, self.mano, dev)

    def serve(self, key) -> int:
        out = self.session.predict_crops(*self.request(key))["joint_cam"]
        self.answers.append((key, out))
        return out.shape[0]

    def plant(self, fault: str):
        """Plant `fault` for the readings (never in the benchmark's runs)."""
        if fault in ("control", "bf16"):
            self.stand_in = "fp8" if fault == "control" else "bf16"
            return
        predict = self.session.predict_crops

        def planted(*args):
            out = dict(predict(*args))
            jc = out["joint_cam"]
            if fault == "half":
                h = jc.shape[0] // 2
                jc = np.concatenate([jc[:h], jc[:jc.shape[0] - h]], 0)
            elif fault == "answer" and not self.answers:
                jc = jc.copy()
                jc[0] = jc[-1] if jc.shape[0] > 1 else jc[0] + 50.0
            out["joint_cam"] = jc
            return out

        self.session.predict_crops = planted

    def spans(self):
        model = self.session.model
        return ([(b, "pb.block") for b in program.block_modules(model, self.cell.config)]
                + [(mod, f"pb.head.{n}") for n, mod in program.head_modules(model).items()])

    def optimizer(self):
        return None

    def finish(self):
        pass

    def release(self):
        del self.session
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()

    def sample(self):
        """The finished requests the reference checks, drawn from the seed;
        the first answer is always among them."""
        n = min(self.cell.params["sample"], len(self.answers))
        rng = np.random.default_rng(derive(self.seed, "sample"))
        rest = rng.choice(np.arange(1, len(self.answers)), size=n - 1, replace=False) \
            if n > 1 else []
        return [self.answers[0]] + [self.answers[i] for i in rest]

    def check(self) -> dict:
        sample = self.sample()
        args = [np.concatenate(a, 0) for a in zip(*(self.request(k) for k, _ in sample))]
        served = torch.from_numpy(np.concatenate([jc for _, jc in sample], 0))
        truth = self._reference(args, "f32")
        if self.stand_in is not None:
            served = self._reference(args, self.stand_in)
        gap = torch.linalg.vector_norm(served.float() - truth, dim=-1)
        gap = gap.reshape(-1, gap.shape[-1])  # a row a crop (frame), a column a joint
        return {"crop_mean_mm": float(gap.mean(-1).max()), "joint_mm": float(gap.max())}

    def _reference(self, args, precision) -> torch.Tensor:
        ref = Poser(self.model_cfg).to(self.device)
        weights = make_weights(ref, self.seed, self.device, served=True)
        load_reference(ref, weights, self.mano, self.stats)
        del weights
        out = []
        with torch.no_grad(), reference_numerics(precision):
            for s in range(0, args[0].shape[0], self.chunk):
                part = [torch.from_numpy(np.ascontiguousarray(a[s:s + self.chunk])).to(self.device)
                        for a in args]
                out.append(ref.predict(*part)["joint_cam"].cpu())
        return torch.cat(out, 0)
