"""Traffic kind ``train``: spatial fine-tune steps of the program.

Params: ``batch`` (crops a step a card, T=1), ``pool`` (distinct batches
made on the card from the seed; the steps cycle through them),
``calibration`` (rows of the calibration batch), ``trace_units`` (steps
profiled), ``keep_at`` (the step after which set-up keeps a copy of the
state), ``world`` (cards, 1 when absent).

In a world of more than one card every rank builds the same weights from
the seed, joins the program's world (``program.join_world``) and trains on
batches and droppath draws of its own (rank 0's are those of a one-card
cell) through the program's data-parallel step; a unit is one step of the
world, ``world * batch`` crops. Rank 0 reports; the reference follows the
program's data-parallel semantics over the global batch, one rank's rows
at a time on rank 0's card: each rank's rows through the forward with
BatchNorm on their own statistics, the loss and the gradients averaged over
the ranks, then the clip and AdamW; the readings are rank 0's.

Set-up builds the train state (f32 masters, AdamW, the compute dtype's
step), then drives it through its first steps, on batches 0, 1, 2, ...,
through the very call the window makes; they are the warm-up too. It keeps
on the host each of the first three steps' losses, step 1's predicted
joints and each trained leaf's clipped gradient as the optimizer got it
(the leaf's ``.grad`` after the step), each leaf's change after step 3,
and, after step ``keep_at``, a copy of the state (the trained leaves,
AdamW's moments and count, the droppath and latent generators). The
window continues the same state. After it (``finish``) the copy is put
back into the same tensors and one more step goes through the same call,
with the same readings: the path after the window is checked, from a state
that does not depend on the window's length (the gaps of a state trained
on the pool for a whole window grow as its gradients shrink). Once the
program is freed the reference runs the same three steps from the seed's
weights, batches and draws, and then one step from the kept copy: there it
follows the program from the program's own state; the three first steps
check the start by themselves.

The numbers (``compare``), for the first steps and, with ``_last``, for
the step after the window; leaves are the trained ones whose reference
gradient is at least a thousandth of the median leaf's (the others move by
round-off alone), and a leaf's gap is the norm of the difference between
the program's tensor and the reference's over the larger of the
reference's norm of that leaf and of the median leaf:

- ``joint_mean_mm``: the mean distance in mm between the predicted joints
  (64 x 21) of step 1 (of the step after the window);
- ``grad``: the median leaf's gap of the clipped gradients;
- ``grad_kind``: the same gaps, their median over the leaves of each kind
  (the name with its indices as ``*``), the worst kind's;
- ``grad_blocks``: as ``grad_kind``, over the kinds of the backbone's
  blocks alone (24 leaves a kind, whose weight gradients the block
  kernels compute);
- ``change``: the median leaf's gap of the change in weights after three
  steps (after the one step);
- ``ranks_apart`` (a world of more than one card): the largest difference
  between the ranks' copies of any trained leaf after the step after the
  window.

The workload file's limits say which are compared. Kept beside them
(``info``): the relative loss gaps, the widest joint gap, and the worst
leaf and kinds by name.

Faults for the readings (``plant``): ``frozen`` (the program's step leaves
the parameters where they were), ``exchange`` (the program's step without
its average across the world: each rank steps on its own rows' loss and
gradients); in the program's place the reference
with ``control`` (its products in fp8), ``half`` (the forward over the
whole batch, the loss over its first half), ``grad2`` (the backbone's
backward returns twice the gradient), ``dw`` (every block's MLP output
weight gets twice its gradient).
"""

from __future__ import annotations

import statistics
import time
from collections import defaultdict

import torch

from portbench import flops, program, world
from portbench.backbones import kind as backbone_kind
from portbench.inputs import crops
from portbench.reference import Poser, reference_numerics, reference_steps
from portbench.weights import calibrate, derive, load_reference, make_mano, make_weights

_INPUTS = ("patches", "square_bboxes", "timestamp", "focal", "princpt")
_STAND_INS = {"control": ("fp8", None), "bf16": ("bf16", None), "half": ("f32", "half"),
              "grad2": ("f32", "grad2"), "dw": ("f32", "dw")}


def _host(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", torch.float32, copy=True)


class Driver:
    def __init__(self, cell, seed, device):
        self.cell, self.seed, self.device = cell, seed, device
        self.model_cfg = cell.config["model"]
        p = cell.params
        self.batch, self.pool, self.trace_units = p["batch"], p["pool"], p["trace_units"]
        self.keep_at = p["keep_at"]
        self.world = p.get("world", 1)
        self.rank = 0
        self.latent = bool(self.model_cfg.get("num_latent_layer"))
        self.kind = backbone_kind(self.model_cfg)
        self.stand_in = None  # (precision, fault) of the reference in the program's place

    # -- set-up -----------------------------------------------------------

    def setup(self):
        dev, seed, m = self.device, self.seed, self.model_cfg
        if self.world > 1:
            if not program.join_world(dev) or world.size() != self.world:
                raise RuntimeError(f"the cell needs a world of {self.world} ranks; "
                                   f"this process is in one of {world.size()}")
            self.rank = world.rank()
        ref = Poser(m).to(dev)
        weights = make_weights(ref, seed, dev, served=False)
        self.mano = make_mano(seed, dev)
        load_reference(ref, weights, self.mano)
        cal = crops(self.cell.params["calibration"], 1, m["img_size"], seed, "calibration", dev)
        self.stats = calibrate(ref, [cal[k] for k in _INPUTS], derive(seed, "calibration-latent"))
        del ref, cal
        self.batches = [self._batch(self.rank, i) for i in range(self.pool)]
        self.state, self.step, self.names = program.train_state(
            self.cell.config, self.batch, weights, self.stats, self.mano, dev, self.world)
        self.lr = program.lr_for(self.cell.config, self.batch, self.world)
        self.gen = self._generator(derive(seed, _tag("droppath", self.rank)))
        self.lgen = (self._generator(derive(seed, _tag("latent", self.rank)))
                     if self.latent else None)
        self.i = 0
        first = self._steps(3)
        first["change"] = {n: _host(p.detach() - weights[n]) for n, p in self._leaves()}
        self.program = {"first": first}
        del weights
        t, start = time.perf_counter(), self.i
        while self.i < self.keep_at:
            self.unit()
        # seconds a step at the warm-up's pace (a world sizes its window by it)
        self.pace = (time.perf_counter() - t) / max(self.i - start, 1)
        self.kept = self._keep()

    def _batch(self, rank: int, i: int) -> dict:
        """Rank `rank`'s batch `i`, made on this process's card."""
        return crops(self.batch, 1, self.model_cfg["img_size"], self.seed,
                     _tag(f"batch{i}", rank), self.device, targets=True)

    def _leaves(self):
        return [(self.names[id(p)], p) for p in self.state.optimizer.params()]

    def _steps(self, n: int) -> dict:
        """`n` steps through the window's call; their losses, and the
        first's joints and clipped gradients."""
        self.unit()
        out = {"losses": [self.loss], "joints": _host(self.met["joint_cam_pred"]),
               "grads": {name: _host(p.grad) for name, p in self._leaves()}}
        for _ in range(n - 1):
            self.unit()
            out["losses"].append(self.loss)
        return out

    def plant(self, fault: str):
        """Plant `fault` for the readings (never in the benchmark's runs)."""
        step = self.step
        if fault == "exchange":
            def alone(state, batch, gen, lgen):
                return step.update(state, step.local(batch, gen, lgen))

            self.step = alone
            return
        if fault != "frozen":
            self.stand_in = _STAND_INS[fault]
            return

        def frozen(state, batch, gen, lgen):
            before = [p.detach().clone() for p in state.optimizer.params()]
            state, met = step(state, batch, gen, lgen)
            with torch.no_grad():
                for p, b in zip(state.optimizer.params(), before):
                    p.copy_(b)
            return state, met

        self.step = frozen

    # -- the window ---------------------------------------------------------

    def unit(self) -> int:
        self.state, self.met = self.step(self.state, self.batches[self.i % self.pool], self.gen,
                                         self.lgen)
        self.loss = float(self.met["loss"])  # a step ends when its loss is on the host
        self.i += 1
        return self.batch * self.world

    def spans(self):
        model = self.state.model
        return ([(b, "pb.block") for b in program.block_modules(model, self.cell.config)]
                + [(mod, f"pb.head.{n}") for n, mod in program.head_modules(model).items()])

    def optimizer(self):
        return self.state.optimizer

    def work(self) -> dict:
        prods = flops.poser_products(self.model_cfg, self.batch, 1, train=True)
        return {"flops": flops.step_flops(prods),
                "block_bounds": flops.block_bounds(self.model_cfg, self.batch)}

    def _keep(self) -> dict:
        """A host copy of the state: the trained leaves, AdamW's moments and
        count, the next batch, the generators."""
        opt = self.state.optimizer
        leaves = self._leaves()
        return {"params": {n: _host(p) for n, p in leaves},
                "exp_avg": {n: _host(opt.state[p]["exp_avg"]) for n, p in leaves},
                "exp_avg_sq": {n: _host(opt.state[p]["exp_avg_sq"]) for n, p in leaves},
                "steps": opt.updates_taken(), "i": self.i, "batch": self.i % self.pool,
                "gen": self.gen.get_state(),
                "lgen": self.lgen.get_state() if self.latent else None}

    def finish(self):
        """Put the kept state back in place (into the same tensors) and take
        one more step through the window's call."""
        opt, k = self.state.optimizer, self.kept
        with torch.no_grad():
            for n, p in self._leaves():
                p.copy_(k["params"][n])
                st = opt.state[p]
                st["exp_avg"].copy_(k["exp_avg"][n])
                st["exp_avg_sq"].copy_(k["exp_avg_sq"][n])
                st["step"].fill_(k["steps"])
        self.gen.set_state(k["gen"])
        if self.latent:
            self.lgen.set_state(k["lgen"])
        self.i = k["i"]
        last = self._steps(1)
        last["change"] = {n: _host(p) - k["params"][n] for n, p in self._leaves()}
        self.program["last"] = last
        if self.world > 1:
            self.apart = world.apart([p for _, p in self._leaves()])
        # each rank's generators at the kept step, for the reference
        self.kept_gens = world.gather((k["gen"], k["lgen"]))

    def release(self):
        del self.state, self.step
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()

    # -- correctness ----------------------------------------------------------

    def _generator(self, seed=None, state=None):
        gen = torch.Generator(self.device)
        return gen.manual_seed(seed) if state is None else gen.set_state(state)

    def _reference(self, precision: str, fault=None) -> dict:
        """The reference's readings of the first three steps and of the step
        after the window, with its products in `precision` and `fault`
        planted."""
        ref = Poser(self.model_cfg).to(self.device)
        weights = make_weights(ref, self.seed, self.device, served=False)
        load_reference(ref, weights, self.mano, self.stats)
        del weights
        _plant_reference(ref, fault, self.kind)
        rows = slice(0, self.batch // 2) if fault == "half" else None
        k, ranks = self.kept, range(self.world)

        def shards(i):  # the world's batch `i`, one rank's rows a shard
            return [self.batches[i] if r == 0 else self._batch(r, i) for r in ranks]

        def gens(tag):
            return [self._generator(derive(self.seed, _tag(tag, r))) for r in ranks]

        with reference_numerics(precision):
            first = reference_steps(ref, [shards(i) for i in range(3)], self.lr, gens("droppath"),
                                    gens("latent") if self.latent else None, loss_rows=rows)
            with torch.no_grad():
                for n, p in k["params"].items():
                    ref.get_parameter(n).copy_(p)
            last = reference_steps(
                ref, [shards(k["batch"])], self.lr,
                [self._generator(state=g) for g, _ in self.kept_gens],
                [self._generator(state=g) for _, g in self.kept_gens] if self.latent else None,
                k, rows)
        del ref
        return {"first": first, "last": last}

    def check(self) -> dict:
        truth = self._reference("f32")
        got = self.program if self.stand_in is None else self._reference(*self.stand_in)
        out = compare(got, truth, self.kind.block_leaf)
        if self.world > 1:
            out["ranks_apart"] = self.apart
        return out


class _Twice(torch.autograd.Function):
    """The identity forward; twice the gradient backward."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return 2 * g


def _plant_reference(ref: Poser, fault, kind) -> None:
    if fault == "grad2":
        ref.backbone.register_forward_hook(lambda mod, args, out: _Twice.apply(out))
    elif fault == "dw":
        for name, p in ref.named_parameters():
            if kind.mlp_out_weight(name):
                p.register_hook(lambda g: 2 * g)


def _tag(stream: str, rank: int) -> str:
    """The seed stream `stream` of rank `rank` (rank 0's is a one-card
    cell's)."""
    return stream if rank == 0 else f"{stream}.rank{rank}"


def kind(name: str) -> str:
    """A leaf's kind: its name with every index as ``*``."""
    return ".".join("*" if s.isdigit() else s for s in name.split("."))


def _gaps(got: dict, ref: dict, leaves) -> dict:
    """Each leaf's norm of the difference over the larger of the
    reference's norm of the leaf and of the median leaf."""
    norms = {n: float(torch.linalg.vector_norm(ref[n])) for n in leaves}
    med = statistics.median(norms.values())
    return {n: float(torch.linalg.vector_norm(got[n] - ref[n])) / max(norms[n], med)
            for n in leaves}


def _worst_kind(gaps: dict):
    by = defaultdict(list)
    for n, g in gaps.items():
        by[kind(n)].append(g)
    med = {k: statistics.median(v) for k, v in by.items()}
    worst = max(med, key=med.get)
    return worst, med[worst]


def compare(got: dict, truth: dict, block_leaf) -> dict:
    """The numbers (see the module's text) and, under ``info``, the
    readings kept beside them; `block_leaf` tells the backbone's blocks'
    leaves."""
    out, info = {}, {}
    for part, tag in (("first", ""), ("last", "_last")):
        g, t = got[part], truth[part]
        dist = torch.linalg.vector_norm(g["joints"] - t["joints"], dim=-1)
        norms = {n: float(torch.linalg.vector_norm(x)) for n, x in t["grads"].items()}
        med = statistics.median(norms.values())
        moved = [n for n, x in norms.items() if x >= 1e-3 * med]
        grad = _gaps(g["grads"], t["grads"], moved)
        change = _gaps(g["change"], t["change"], moved)
        worst_kind, worst_kind_gap = _worst_kind(grad)
        blocks_kind, blocks_gap = _worst_kind({n: x for n, x in grad.items() if block_leaf(n)})
        worst = max(grad, key=grad.get)
        out[f"joint_mean_mm{tag}"] = float(dist.mean())
        out[f"grad{tag}"] = statistics.median(grad.values())
        out[f"grad_kind{tag}"] = worst_kind_gap
        out[f"grad_blocks{tag}"] = blocks_gap
        out[f"change{tag}"] = statistics.median(change.values())
        out[f"joint_max_mm{tag}"] = float(dist.max())
        info[f"kinds{tag}"] = [worst_kind, blocks_kind]
        info[f"grad_worst{tag}"] = [worst, grad[worst]]
        info[f"change_kind{tag}"] = list(_worst_kind(change))
        info[f"loss{tag}"] = [abs(a - b) / abs(b) for a, b in zip(g["losses"], t["losses"])]
    out["info"] = info
    return out
