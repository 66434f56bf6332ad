"""The unit's model FLOPs (portbench.flops) over the untraced time a unit
times the bf16 peak, in %."""

from portbench.peaks import BF16_FLOPS


def read(t):
    return 100.0 * t.info["flops"] / (t.info["unit_s"] * BF16_FLOPS)
