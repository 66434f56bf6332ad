"""The readings behind the realtime floors of
tests/test_torch_temporal_train.py (slow: ``-m slow``; about 2.5 minutes on
one CPU process).

For each seed of SEEDS it runs that file's realtime case (the JAX f32 step,
JAX's float64 grads and statistics, the port's step) and reads, leaf by
leaf, JAX's own f32 miss of the float64 values and the port's, as fractions
of the leaf's scale, and the port's miss as a fraction of its allowance.
For the seeds of PERTURBED_SEEDS it also reads JAX's f32 grads and
statistics (one jax.jit of the step's loss) with every parameter and the
model's inputs (MOVED: the patches, boxes, timestamps and intrinsics)
moved by one f32 ulp, each element up or down at random, in DRAWS draws:
the spread of an f32 result whose operands differ by their last bit, as
another order of the same sums leaves them. It prints one line a
seed and holds:

* the port within its allowances at every seed (grads and statistics);
* every leaf at which the port misses by more than the spatial floors
  allow in the set that gets the larger floors (SOFTMAX_GRAD_LEAVES,
  SOFTMAX_STAT_LEAVES);
* SOFTMAX_GRAD_FLOOR no smaller than JAX's largest unmoved f32 miss over
  those grad leaves and seeds, and SOFTMAX_STAT_FLOOR no smaller than
  JAX's largest miss over those statistics with its operands moved (the
  floors are those readings, rounded up).

Readings on an x86-64 CPU, as fractions of the leaf's scale (leaves of
a scale over SCALE_MIN): JAX's own f32 miss / the port's, for the grads
of the softmax leaves and of the other temporal leaves and for the norm2
statistics; the port's largest miss as a fraction of its allowance (grads,
statistics); and, moved by one ulp, JAX's largest miss over the draws
(softmax grads, other grads, norm2 statistics):

  seed  softmax grads      other grads        norm2 stats        port/allowance  moved by one ulp
  23    1.58e-4 / 3.60e-4  3.89e-5 / 1.78e-4  2.56e-5 / 7.30e-5  0.263 / 0.379   4.62e-4, 1.97e-4, 1.28e-4
  5     3.42e-4 / 3.23e-4  1.30e-4 / 1.11e-4  1.27e-5 / 1.96e-5  0.181 / 0.415
  6     9.08e-4 / 7.14e-4  3.65e-4 / 9.09e-5  1.45e-5 / 2.84e-5  0.152 / 0.572   8.21e-2, 8.25e-4, 4.99e-5
  7     5.36e-4 / 1.73e-4  9.97e-4 / 5.73e-4  1.91e-5 / 6.69e-6  0.363 / 0.067
  8     1.91e-3 / 1.60e-3  1.02e-4 / 8.92e-5  1.29e-5 / 1.83e-5  0.297 / 0.509
  9     1.45e-3 / 3.14e-3  2.56e-4 / 2.16e-4  1.34e-5 / 7.40e-5  0.746 / 0.153   6.96e-3, 7.07e-4, 2.38e-4

So SOFTMAX_GRAD_FLOOR is 1.92e-3 (seed 8's 1.915e-3) and
SOFTMAX_STAT_FLOOR 2.39e-4 (seed 9's moved 2.382e-4): unmoved, JAX's
statistics miss by at most 2.6e-5 and the port's by up to 7.4e-5, inside
the spread that one-ulp moves of JAX's own operands show.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cs_vit_tpu_torch.models.poser import phase_trainable_params
from cs_vit_tpu_torch.train import TrainState, build_optimizer, make_train_step, \
    state_dict_from_flax

from .helpers import tiny_poser
from .test_torch_temporal_train import (
    GRAD_FLOOR,
    LR,
    SOFTMAX_GRAD_FLOOR,
    SOFTMAX_GRAD_LEAVES,
    SOFTMAX_STAT_FLOOR,
    SOFTMAX_STAT_LEAVES,
    STAT_FLOOR,
    TEMPORAL,
    _jax_temporal_step,
    _port_from,
    _torch_batch,
    grad_atol,
    stat_atol,
)

SEEDS = (23, 5, 6, 7, 8, 9)
PERTURBED_SEEDS = (23, 9, 6)
DRAWS = 8
SCALE_MIN = 1e-4  # leaves of a smaller scale are left out of the fractions
# the model's inputs, each moved by one ulp in the perturbed draws
MOVED = ("patches", "square_bboxes", "timestamp", "focal", "princpt")


def _frac(a, b):
    scale = float(np.abs(b).max())
    return float(np.abs(a - b).max()) / scale if scale > SCALE_MIN else 0.0


def _perturbed(jmodel, js, seed):
    """JAX's largest f32 miss, as a fraction of each leaf's scale, over DRAWS
    jitted steps with the parameters and inputs moved by one ulp: ({grad leaf: fraction},
    {statistic: fraction}), in the port's names."""
    key = jax.random.key(0)
    stats = jax.tree.map(jnp.asarray, js["variables"]["batch_stats"])

    @jax.jit
    def grads_stats(params, batch):
        def loss(p):
            out, mutated = jmodel.apply({"params": p, "batch_stats": stats}, batch,
                                        phase="temporal", rngs={"droppath": key, "latent": key},
                                        mutable=["batch_stats"])
            return out["loss"], mutated["batch_stats"]
        return jax.grad(loss, has_aux=True)(params)

    config = _port_from(js).config
    want_g = state_dict_from_flax(js["grads64"], js["variables"]["batch_stats"], config)
    want_s = state_dict_from_flax(js["variables"]["params"], js["new_stats64"], config)
    rng = np.random.default_rng(seed)

    def moved(v):
        up = rng.integers(0, 2, size=np.shape(v)).astype(bool)
        return np.nextafter(v, np.where(up, np.inf, -np.inf).astype(np.float32))

    worst_g, worst_s = {}, {}
    for _ in range(DRAWS):
        params = jax.tree.map(lambda v: jnp.asarray(moved(np.asarray(v))),
                              js["variables"]["params"])
        batch = {k: jnp.asarray(moved(v) if k in MOVED else v) for k, v in js["batch"].items()}
        g, s = grads_stats(params, batch)
        g = state_dict_from_flax(jax.tree.map(np.asarray, g), js["variables"]["batch_stats"],
                                 config)
        s = state_dict_from_flax(js["variables"]["params"], jax.tree.map(np.asarray, s), config)
        for n in want_g:
            if n.startswith(TEMPORAL) and n in g:
                worst_g[n] = max(worst_g.get(n, 0.0), _frac(g[n], want_g[n]))
        for n in want_s:
            if n.startswith(TEMPORAL) and n.endswith(("running_mean", "running_var")):
                worst_s[n] = max(worst_s.get(n, 0.0), _frac(s[n], want_s[n]))
    return worst_g, worst_s


@pytest.mark.slow
def test_realtime_floors_from_jax_f32_misses():
    jmodel = tiny_poser(temporal_supervision="realtime", temporal_init_method="random")
    jax_soft = jax_stat_soft = 0.0
    for seed in SEEDS:
        js = _jax_temporal_step("realtime", seed)
        model = _port_from(js)
        state = TrainState.create(model, build_optimizer(model, "temporal", LR))
        step = make_train_step(model, state.optimizer, "temporal")
        state, metrics = step(state, _torch_batch(js["batch"]), None)
        stats = js["variables"]["batch_stats"]
        sd_grads = state_dict_from_flax(js["grads"], stats, model.config)
        sd_grads64 = state_dict_from_flax(js["grads64"], stats, model.config)
        sd_new = state_dict_from_flax(js["new_params"], js["new_stats"], model.config)
        sd_stats64 = state_dict_from_flax(js["variables"]["params"], js["new_stats64"],
                                          model.config)
        norm64 = float(np.sqrt(sum((sd_grads64[n] ** 2).sum()
                                   for n, _ in phase_trainable_params(model, "temporal"))))
        clip, clip64 = min(1.0, 5.0 / js["grad_norm"]), min(1.0, 5.0 / norm64)
        line = {"seed": seed, "grad jax soft": 0.0, "grad jax other": 0.0,
                "grad port soft": 0.0, "grad port other": 0.0, "grad port/allowance": 0.0,
                "stat jax soft": 0.0, "stat port soft": 0.0, "stat port/allowance": 0.0}
        for n, p in model.named_parameters():
            if not n.startswith(TEMPORAL):
                continue
            g_jax, g64, got = sd_grads[n] * clip, sd_grads64[n] * clip64, p.grad.numpy()
            soft = bool(SOFTMAX_GRAD_LEAVES.search(n))
            where = "soft" if soft else "other"
            line[f"grad jax {where}"] = max(line[f"grad jax {where}"], _frac(g_jax, g64))
            line[f"grad port {where}"] = max(line[f"grad port {where}"], _frac(got, g64))
            jax_miss = float(np.abs(g_jax - g64).max())
            miss = float(np.abs(got - g64).max())
            line["grad port/allowance"] = max(line["grad port/allowance"],
                                              miss / grad_atol("realtime", n, jax_miss, g64))
            spatial = 2 * max(jax_miss, GRAD_FLOOR * float(np.abs(g64).max()) + 1e-6 * 5.0)
            assert soft or miss <= spatial, (seed, n, miss, spatial)
        for n, b in model.named_buffers():
            if not (n.startswith(TEMPORAL) and n.endswith(("running_mean", "running_var"))):
                continue
            want64 = sd_stats64[n]
            jax_miss = float(np.abs(sd_new[n] - want64).max())
            miss = float(np.abs(b.numpy() - want64).max())
            soft = bool(SOFTMAX_STAT_LEAVES.search(n))
            if soft:
                line["stat jax soft"] = max(line["stat jax soft"], _frac(sd_new[n], want64))
                line["stat port soft"] = max(line["stat port soft"], _frac(b.numpy(), want64))
            line["stat port/allowance"] = max(line["stat port/allowance"],
                                              miss / stat_atol("realtime", n, jax_miss, want64))
            spatial = 2 * max(jax_miss, 1e-5 + STAT_FLOOR * float(np.abs(want64).max()))
            assert soft or miss <= spatial, (seed, n, miss, spatial)
        jax_soft = max(jax_soft, line["grad jax soft"])
        if seed in PERTURBED_SEEDS:
            pg, ps = _perturbed(jmodel, js, seed)
            line["perturbed grad jax soft"] = max(
                (v for n, v in pg.items() if SOFTMAX_GRAD_LEAVES.search(n)), default=0.0)
            line["perturbed grad jax other"] = max(
                (v for n, v in pg.items() if not SOFTMAX_GRAD_LEAVES.search(n)), default=0.0)
            line["perturbed stat jax soft"] = max(
                (v for n, v in ps.items() if SOFTMAX_STAT_LEAVES.search(n)), default=0.0)
            jax_stat_soft = max(jax_stat_soft, line["perturbed stat jax soft"])
        print("readings " + " ".join(f"{k}={v:.3g}" if isinstance(v, float) else f"{k}={v}"
                                     for k, v in line.items()), flush=True)
        assert line["grad port/allowance"] <= 1.0 and line["stat port/allowance"] <= 1.0, line
    print(f"readings floors: grad {jax_soft:.4g} (SOFTMAX_GRAD_FLOOR {SOFTMAX_GRAD_FLOOR}), "
          f"stat {jax_stat_soft:.4g} (SOFTMAX_STAT_FLOOR {SOFTMAX_STAT_FLOOR})", flush=True)
    assert jax_soft <= SOFTMAX_GRAD_FLOOR and jax_stat_soft <= SOFTMAX_STAT_FLOOR
