"""Traffic kind ``batch``: one client, closed loop, each request a batch of
T=1 crops as host numpy arrays through ``PoserSession.predict_crops``.

Params: ``batch`` (crops a request, the session's batch size), ``pool``
(distinct requests made from the seed; the client cycles through them),
``calibration`` (rows of the calibration batch), ``sample`` (finished
requests that the reference checks), ``trace_units`` (requests profiled).
The check and the faults are ``portbench.served``'s.
"""

from __future__ import annotations

from portbench import flops
from portbench.inputs import crops
from portbench.served import INPUTS, Serving


class Driver(Serving):
    def __init__(self, cell, seed, device):
        super().__init__(cell, seed, device)
        p = cell.params
        self.batch, self.pool = p["batch"], p["pool"]

    def calibration_inputs(self):
        cal = crops(self.cell.params["calibration"], 1, self.model_cfg["img_size"], self.seed,
                    "calibration", self.device)
        return [cal[k] for k in INPUTS]

    def request(self, key):
        return self.requests[key]

    def setup(self):
        img = self.model_cfg["img_size"]
        self.requests = []
        for i in range(self.pool):
            r = crops(self.batch, 1, img, self.seed, f"request{i}", self.device)
            self.requests.append(tuple(r[k].cpu().numpy() for k in INPUTS))
        self.build(self.batch)
        self.session.predict_crops(*self.requests[0])  # warm-up at the served shapes
        self.i = 0

    def unit(self) -> int:
        n = self.serve(self.i % self.pool)
        self.i += 1
        return n

    def work(self) -> dict:
        prods = flops.poser_products(self.model_cfg, self.batch, 1, train=False)
        return {"flops": flops.forward_flops(prods),
                "block_bounds": flops.block_bounds(self.model_cfg, self.batch)}
