"""Traffic kind ``stream``: one camera tracked live, closed loop with one
client. Request j is the newest ``frames`` crops of a seeded track
(``frame_ms`` apart) through a ``PoserSession`` of batch ``batch`` and
``frames`` frames; the next request goes when the last answer is back.

Params: ``batch``, ``frames``, ``frame_ms``, ``track`` (distinct frames of
the track, cycled), ``calibration`` (samples of the calibration batch, each
``frames`` frames of its own track), ``sample`` (finished requests the
reference checks), ``trace_units`` (requests profiled). The check and the
faults are ``portbench.served``'s.
"""

from __future__ import annotations

import numpy as np

from portbench import flops
from portbench.inputs import track, window
from portbench.served import Serving


class Driver(Serving):
    def __init__(self, cell, seed, device):
        super().__init__(cell, seed, device)
        p = cell.params
        self.batch, self.frames, self.frame_ms = p["batch"], p["frames"], p["frame_ms"]
        self.track_len = p["track"]

    def calibration_inputs(self):
        import torch

        img = self.model_cfg["img_size"]
        parts = [window(track(self.frames, self.frames, img, self.seed, f"calibration{i}"),
                        0, self.frames, self.frames, self.frame_ms)
                 for i in range(self.cell.params["calibration"])]
        return [torch.from_numpy(np.concatenate(a, 0)).to(self.device) for a in zip(*parts)]

    def request(self, key):
        return window(self.track, key, self.track_len, self.frames, self.frame_ms)

    def setup(self):
        self.track = track(self.track_len, self.frames, self.model_cfg["img_size"], self.seed,
                           "track")
        self.build(self.batch)
        for j in range(3):  # warm-up at the served shapes
            self.session.predict_crops(*self.request(j))
        self.j = 0

    def unit(self) -> int:
        n = self.serve(self.j)
        self.j += 1
        return n

    def work(self) -> dict:
        prods = flops.poser_products(self.model_cfg, self.batch, self.frames, train=False)
        return {"flops": flops.forward_flops(prods),
                "block_bounds": flops.block_bounds(self.model_cfg, self.batch * self.frames)}
