"""The readers of the program's ``csvit.*`` spans (portbench.spans and the
nine ``portbench/layers/`` files that use it), on a hand-built Chrome
trace of one step (one unit, 0-1000 us):

- the forward launches one kernel from the calling thread (200-300 us);
  the backward one from autograd's device thread (460-560 us), which only
  attribution by time sees;
- AdamW launches one kernel from the calling thread (820-860 us) and one
  from another thread (870-880 us), which ``optim_ms`` leaves out;
- each kernel starts 5 us after its launch, as on an empty queue;
- one sync inside ``csvit.sync.clip``, one after the step in the unit (the
  caller's loss read), one after the unit;
- a request's span straddles the unit's end (900-1100 us).

The same trace with the device's clock drifted (drawn 300 us early at the
start, and 2% more of the time since) reads the same: the readers put each
kernel back at its launch. A trace without the program's spans, as an
older program gives, reads None in every new metric.
"""

import pytest

from portbench.cell import reader
from portbench.spans import busy, idle_ms, unnamed_syncs
from portbench.tracing import Trace

MAIN, AUTOGRAD = 1, 2
SPANS = [("csvit.step", 10, 990), ("csvit.step.cast", 10, 100),
         ("csvit.step.forward", 100, 400), ("csvit.step.backward", 400, 700),
         ("csvit.step.update", 700, 980), ("csvit.sync.finite", 705, 715),
         ("csvit.step.clip", 720, 800), ("csvit.sync.clip", 780, 795),
         ("csvit.step.optim", 800, 900), ("csvit.serve.output", 900, 1100)]
# (launching thread, launch start, kernel start, kernel end)
KERNELS = [(MAIN, 195, 200, 300), (AUTOGRAD, 455, 460, 560), (MAIN, 815, 820, 860),
           (AUTOGRAD, 865, 870, 880)]
SYNCS = [(MAIN, 785), (MAIN, 995), (MAIN, 1050)]


def _x(name, cat, ts, end, tid=MAIN, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": end - ts, "tid": tid,
            "args": args}


def _drift(ts):
    """How early a drifted device clock draws an event at `ts`, in us."""
    return 300 + 0.02 * ts


def _trace(program_spans=True, device=True, drifted=False):
    ev = [_x("pb.unit", "user_annotation", 0, 1000)]
    if program_spans:
        ev += [_x(n, "user_annotation", a, b) for n, a, b in SPANS]
    if device:
        for i, (tid, launch, k0, k1) in enumerate(KERNELS):
            early = _drift(k0) if drifted else 0
            ev += [_x("cudaLaunchKernel", "cuda_runtime", launch, launch + 5, tid, correlation=i),
                   _x(f"kernel{i}", "kernel", k0 - early, k1 - early, tid=7, correlation=i)]
        ev += [_x("cudaStreamSynchronize", "cuda_runtime", ts, ts + 2, tid)
               for tid, ts in SYNCS]
    return Trace({"traceEvents": ev}, {"unit_s": 1e-3})


# idle in a span = its interval minus the kernels running then, in ms
READINGS = {
    "cast_idle_ms.train": 0.090,
    "fwd_idle_ms.train": 0.200,        # 300 us less the forward's kernel
    "bwd_idle_ms.train": 0.200,        # 300 us less autograd's thread's kernel
    "update_idle_ms.train": 0.230,     # 280 us less AdamW's two kernels
    "optim_ms.train": 0.040,           # the calling thread's kernel only
    "unnamed_syncs_per_step.train": 1.0,
    "output_idle_ms.batch": 0.100,     # the part of 900-1100 inside the unit
}
NEW_METRICS = ["cast_idle_ms.train", "fwd_idle_ms.train", "bwd_idle_ms.train",
               "update_idle_ms.train", "optim_ms.train", "unnamed_syncs_per_step.train",
               "input_idle_ms.batch", "output_idle_ms.batch", "fwd_idle_ms.stream"]


@pytest.mark.parametrize("metric", list(READINGS))
@pytest.mark.parametrize("drifted", [False, True])
def test_reader_on_a_hand_built_trace(metric, drifted):
    t = _trace(drifted=drifted)
    assert any(d["ts"] < l["ts"] for d, l in t.issued) == drifted
    assert reader("layers", metric)(t) == pytest.approx(READINGS[metric], abs=1e-9)


@pytest.mark.parametrize("drifted", [False, True])
def test_device_events_are_read_on_the_host_clock(drifted):
    # a clean capture is read as drawn; a drifted one with each kernel at
    # its launch, 5 us before where it ran
    expect = [(k0, k1) for _, _, k0, k1 in KERNELS]
    if drifted:
        expect = [(launch, launch + k1 - k0) for _, launch, k0, k1 in KERNELS]
    got = busy(_trace(drifted=drifted))
    assert [x for iv in got for x in iv] == pytest.approx([x for iv in expect for x in iv],
                                                          abs=1e-9)


def test_attribution_is_by_time_not_by_thread():
    t = _trace()
    # the same-thread rule sees nothing of the backward's kernel; time does
    assert t.device_us_under(lambda n: n == "csvit.step.backward") == 0
    assert idle_ms(t, "csvit.step.backward") == pytest.approx(0.2)


def test_syncs_inside_and_outside_the_named_spans():
    t = _trace()
    assert t.count_host(["cudaStreamSynchronize"]) == 2  # the third is after the unit
    assert unnamed_syncs(t) == 1.0


@pytest.mark.parametrize("metric", NEW_METRICS)
@pytest.mark.parametrize("program_spans,device", [(False, True), (True, False)])
def test_reader_reads_none_without_spans_or_device_events(metric, program_spans, device):
    assert reader("layers", metric)(_trace(program_spans, device)) is None
