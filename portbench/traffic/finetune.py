"""Traffic kind ``finetune``: the program's own fine-tune data path feeding
its spatial steps, as ``cli.finetune`` runs them.

Params: those of the ``train`` kind (``batch``, ``pool`` at least 4,
``calibration``, ``keep_at``, ``trace_units``), and ``sequences``,
``frames`` and ``frame_hw``: the synthetic DexYCB tree's train sequences,
frames a sequence and frame size; ``repeat``: how many times the train
split lists each sequence (its frames on disk once). DexYCB's s1 train
split is about 465k frames, an epoch of about 7,300 b64 steps, so a run
restarts its loader (``cli.finetune.main`` makes a new thread pool and
prefetch thread each epoch, and the first batch of each epoch waited
2.5-10 s on the H100's host) once in thousands of steps; the tree's 512
frames alone would make an epoch of 8 steps and put a restart in every
eighth step of the window. Listed 32 times they make an epoch of 256
steps, longer than set-up and the window together.

Set-up ends by waiting until the loader's queues are full (``_fill``), so
that the window starts with them full rather than with the loader's threads
refilling those the warm-up steps drained.

Set-up writes the tree's JPEG frames to a temporary directory and builds
the program's data path (``portbench.program_feed``: the program's fixture
seeded from the run's seed, ``DexYCB`` at the configuration's crop with its
annotations held in memory, ``build_loader`` shuffled from the run's seed
with the configuration's 8 loader threads, ``cli.finetune.device_batches``
with the patches cast to bf16 on the host and each wait for a batch inside
the program's ``csvit.data.wait`` span), epoch after epoch, as
``cli.finetune.main`` does. A unit is one step: the wait for the next batch
and the step, ended when its loss is on the host.

Correctness is the ``train`` kind's (its ``Driver``, ``compare`` and
reference): the reference steps on the batches the program stepped on,
kept on the card: the first three steps' and the one the step after the
window takes (drawn from the loader when set-up keeps the state). Its
faults and control are the ``train`` kind's. Besides, the first three
batches are held to the data path's plain reference
(``portbench.reference.data``: the same rows decoded, flipped, rotated,
cropped and augmented from the tree's files and annotations):
``data_patch_gap`` and ``data_label_gap``.

A traced run's info holds ``loader_cpu_ms``: the CPU time of the process's
threads other than the one that steps (the loader's 8 threads, its batching
thread and the prefetch's copy thread) over the window's steps, in ms a
step.
"""

from __future__ import annotations

import shutil
import tempfile
import time

from portbench import program_feed
from portbench.cell import driver_module
from portbench.reference import data as data_reference
from portbench.weights import derive

train = driver_module("train")
_KEPT = 3  # the kept step's batch, after the first three steps'
_IDLE_CPU_S = 0.1  # CPU seconds the process's threads use in half a second once idle
_FILL_S = 60.0  # the longest set-up waits for the loader's queues to fill


class Driver(train.Driver):
    def setup(self):
        if self.pool < _KEPT + 1:
            raise ValueError(f"a finetune cell keeps {_KEPT + 1} batches; pool is {self.pool}")
        p = self.cell.params
        self.others_cpu_s = None  # kept from the window's first step on
        self.root = tempfile.mkdtemp(prefix="portbench-dexycb-")
        self.groups = program_feed.dexycb_tree(self.root, p["sequences"], p["frames"],
                                               p["frame_hw"], derive(self.seed, "dexycb"),
                                               p["repeat"])
        self.shuffle_seed = derive(self.seed, "shuffle") % 2**32
        self.feed = program_feed.finetune_feed(self.cell.config, self.batch, self.root,
                                               self.groups, self.shuffle_seed, self.device)
        self.replay = None
        super().setup()
        self._fill()
        self.others_cpu_s = []

    def _fill(self):
        """Wait until the loader's queues are full. Its threads then wait for
        room, so the process's CPU time stops growing while this one sleeps."""
        deadline = time.perf_counter() + _FILL_S
        while time.perf_counter() < deadline:
            cpu = time.process_time()
            time.sleep(0.5)
            if time.process_time() - cpu < _IDLE_CPU_S:
                return

    def _batch(self, rank: int, i: int):
        return None  # the batches come from the loader

    def unit(self) -> int:
        cpu, own = time.process_time(), time.thread_time()
        batch, self.replay = (next(self.feed), None) if self.replay is None else (
            self.replay, None)
        if self.i < _KEPT:  # the reference steps on the first three steps' batches
            self.batches[self.i] = {k: v.clone() for k, v in batch.items()}
        self.state, self.met = self.step(self.state, batch, self.gen, self.lgen)
        self.loss = float(self.met["loss"])  # a step ends when its loss is on the host
        self.i += 1
        if self.others_cpu_s is not None:
            self.others_cpu_s.append(time.process_time() - cpu - (time.thread_time() - own))
        return self.batch

    def work(self) -> dict:
        window = self.others_cpu_s[:-self.trace_units]  # not the traced steps
        return dict(super().work(), loader_cpu_ms=1e3 * sum(window) / max(len(window), 1))

    def _keep(self) -> dict:
        kept = super()._keep()
        self.batches[_KEPT] = {k: v.clone() for k, v in next(self.feed).items()}
        kept["batch"] = _KEPT
        return kept

    def finish(self):
        self.replay = self.batches[_KEPT]
        super().finish()

    def release(self):
        self.feed.close()
        super().release()

    def check(self) -> dict:
        try:
            out = super().check()
            n = sum(len(g["imgs_path"]) for g in self.groups.values())
            crop, pca = program_feed.crop(self.cell.config), program_feed.mano_pca()
            for k in range(_KEPT):  # batch k of epoch 1
                got = {name: t.float().cpu().numpy() for name, t in self.batches[k].items()}
                rows = data_reference.batch_rows(n, self.shuffle_seed, 1, k, self.batch)
                want = data_reference.dexycb_batch(self.groups, self.root, pca, rows, 1,
                                                   program_feed.ITEM_SEED, **crop)
                for name, gap in data_reference.gaps(got, want).items():
                    out[name] = max(out.get(name, 0.0), gap)
            return out
        finally:
            shutil.rmtree(self.root, ignore_errors=True)
