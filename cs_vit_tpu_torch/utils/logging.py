"""Console + TensorBoard logging honoring the {"loss","logs"} contract
(copy of ``cs_vit_tpu/utils/logging.py``).

Parity: `cs_vit/utils/misc.py:46-52,103-237` (flatten_dict, rank-prefixed
printer, grouped loss console output) and the TB scalar/lr/grad-norm writes
at `scripts/finetune.py:234-268` (via tensorboardX, host 0 only).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, Optional, Tuple


def flatten_dict(
    d: Dict[str, Any], prefix: str = ""
) -> Iterable[Tuple[str, Any]]:
    """Yields ('group/sub', leaf) pairs for nested scalar-log dicts."""
    for k, v in d.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            yield from flatten_dict(v, key)
        else:
            yield key, v


def wrap_prefix_print(prefix: str) -> Callable:
    def print_(*args, **kwargs):
        print(prefix, *args, **kwargs)

    return print_


def nop(*args, **kwargs):
    del args, kwargs


def print_grouped_losses(
    epoch: int,
    iteration: int,
    total_iters: int,
    iter_time_s: float,
    lr: float,
    scalar_logs: Dict[str, Any],
    print_: Callable = print,
):
    """Compact grouped-loss console line (colorless port of misc.py:137-237)."""
    parts = [
        f"E{epoch} it {iteration + 1}/{total_iters}",
        f"{iter_time_s * 1e3:.0f} ms/it",
        f"lr {lr:.3e}",
    ]
    for key, value in flatten_dict(scalar_logs):
        try:
            parts.append(f"{key}={float(value):.4f}")
        except (TypeError, ValueError):
            pass
    print_(" | ".join(parts))


class TBLogger:
    """tensorboardX writer on process 0; silently no-ops elsewhere/if absent."""

    def __init__(self, log_dir: Optional[str], enabled: bool = True):
        self.writer = None
        if enabled and log_dir:
            try:
                from tensorboardX import SummaryWriter

                self.writer = SummaryWriter(log_dir)
            except Exception:
                self.writer = None

    def scalars(self, scalar_logs: Dict[str, Any], step: int, prefix: str = "train"):
        if self.writer is None:
            return
        for key, value in flatten_dict(scalar_logs):
            try:
                self.writer.add_scalar(f"{prefix}/{key}", float(value), step)
            except (TypeError, ValueError):
                pass

    def scalar(self, name: str, value: float, step: int):
        if self.writer is not None:
            self.writer.add_scalar(name, float(value), step)

    def image(self, name: str, img_hwc, step: int):
        if self.writer is not None:
            self.writer.add_image(name, img_hwc, step, dataformats="HWC")

    def close(self):
        if self.writer is not None:
            self.writer.close()
