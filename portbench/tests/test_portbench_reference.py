"""The plain reference against the program's eager path at the tiny size
on the CPU (f32): the served joints of both configurations, and three
spatial train steps (losses, step-1 joints and clipped gradients, each
leaf's change)."""

import copy

import numpy as np
import pytest
import torch

from portbench import program
from portbench.inputs import crops
from portbench.reference import Poser, reference_numerics, reference_steps
from portbench.tests.tiny import tiny_cell
from portbench.weights import calibrate, load_reference, make_mano, make_weights

INPUTS = ("patches", "square_bboxes", "timestamp", "focal", "princpt")
CELLS = {"poser": ("poser-serve-b64", "poser-train-b64"),
         "spenc": ("spenc-stream-rt3-b1", "spenc-train-b64")}


def _inputs(rows, frames, seed, tag):
    b = crops(rows, frames, 32, seed, tag, "cpu")
    b["timestamp"] = 33.3 * torch.arange(frames).float()[None].repeat(rows, 1)
    return [b[k] for k in INPUTS]


@pytest.mark.parametrize("kind", list(CELLS))
def test_served_joints_match(kind):
    cell = tiny_cell(CELLS[kind][0])
    config = copy.deepcopy(cell.config)
    model = dict(config["model"], **config["serve"]["model"])
    frames = 3 if kind == "spenc" else 1
    ref = Poser(model)
    weights, mano = make_weights(ref, 5, "cpu", served=True), make_mano(5, "cpu")
    load_reference(ref, weights, mano)
    stats = calibrate(ref, _inputs(8, frames, 5, "calibration"), 7)
    sess = program.session(config, 4, frames, weights, stats, mano, "cpu")
    args = _inputs(4, frames, 6, "request")
    got = sess.predict_crops(*[a.numpy() for a in args])["joint_cam"]
    with torch.no_grad(), reference_numerics("f32"):
        want = ref.predict(*args)["joint_cam"].numpy()
    np.testing.assert_allclose(got, want, atol=0.05, rtol=1e-4)


@pytest.mark.parametrize("kind", list(CELLS))
def test_train_steps_match(kind):
    cell = tiny_cell(CELLS[kind][1])
    config = cell.config
    ref = Poser(config["model"])
    weights, mano = make_weights(ref, 5, "cpu", served=False), make_mano(5, "cpu")
    load_reference(ref, weights, mano)
    stats = calibrate(ref, _inputs(8, 1, 5, "calibration"), 7)
    load_reference(ref, weights, mano, stats)
    state, step, names = program.train_state(config, 4, weights, stats, mano, "cpu")
    batches = [crops(4, 1, 32, 6, f"batch{i}", "cpu", targets=True) for i in range(3)]
    gen, lgen = torch.Generator().manual_seed(11), torch.Generator().manual_seed(12)
    lgen = lgen if kind == "spenc" else None
    losses, joints, grads = [], None, None
    for b in batches:
        state, met = step(state, b, gen, lgen)
        losses.append(float(met["loss"]))
        joints = met["joint_cam_pred"] if joints is None else joints
        if grads is None:  # step 1's clipped gradients, as the optimizer got them
            grads = {names[id(p)]: p.grad.detach().clone() for p in state.optimizer.params()}
    with reference_numerics("f32"):
        want = reference_steps(ref, [[b] for b in batches], program.lr_for(config, 4),
                               [torch.Generator().manual_seed(11)],
                               [torch.Generator().manual_seed(12)] if kind == "spenc" else None)
    np.testing.assert_allclose(losses, want["losses"], rtol=1e-5)
    np.testing.assert_allclose(joints.numpy(), want["joints"].numpy(), atol=0.05)
    norms = {n: float(torch.linalg.vector_norm(g)) for n, g in want["grads"].items()}
    med = float(np.median(list(norms.values())))
    moved = {n: d for n, d in want["change"].items() if norms[n] >= 1e-3 * med}
    # out: biases before a BatchNorm and unused encoder layers (round-off or decay alone)
    assert len(moved) > 0.75 * len(want["change"])
    for n, d in moved.items():
        got = state.model.get_parameter(n).detach() - weights[n]
        assert float(torch.linalg.vector_norm(got)) == pytest.approx(
            float(torch.linalg.vector_norm(d)), rel=1e-3, abs=1e-7), n
        gap = float(torch.linalg.vector_norm(grads[n] - want["grads"][n]))
        assert gap <= 1e-3 * max(norms[n], med), n
