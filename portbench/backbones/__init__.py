"""A backbone kind by name. A configuration's ``model.backbone.kind``
(``"swinv2"`` when the key is absent) names the file
``portbench/backbones/<kind>.py``, which gives everything of the benchmark
that depends on the backbone; the reference Poser, ``portbench.flops``,
``portbench.weights``, ``portbench.program`` and the traffic drivers ask
it and hold no backbone's code themselves:

- ``Backbone(bb, image_size)``: the plain float32 reference (plain
  ``torch``, nothing of the program), built from the configuration's
  ``backbone`` section; ``forward(x, gen)`` maps normalised NHWC images to
  the last stage's patches [B, P, D] (``gen`` draws stochastic depth, None
  for none);
- ``outputs(model) -> (dim, heads, num_p)``: the patches' width D, the
  heads of the Poser's attention over them, and the side of their grid
  (P = num_p ** 2), from the configuration's ``model`` section;
- ``products(model, images, train)``: the backbone's products over
  `images` images, as ``portbench.flops`` lists them;
- ``block_bounds(model, images)``: seconds, the sum over its blocks of each
  block's bound, forward (``fwd_s``) and vector-Jacobian product
  (``bwd_s``), in bf16;
- ``block_leaf(name)`` and ``mlp_out_weight(name)``: whether a reference
  parameter is one of its blocks' leaves, and one of its blocks' MLP output
  weights (read by the train kind's check and its ``dw`` fault);
- ``PROGRAM_CONFIG``: the attributes of the program's ``backbone.config``
  that have to equal the configuration's keys of the same names;
- ``PROGRAM_BLOCK``: the dotted path of the program's block class.
"""

from __future__ import annotations

import functools
from pathlib import Path

from ..cell import _module

HERE = Path(__file__).resolve().parent
_load = functools.lru_cache(maxsize=None)(_module)


def kind(model: dict):
    """The kind module of the configuration's ``model`` section."""
    name = model["backbone"].get("kind", "swinv2")
    path = HERE / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no backbone kind {name!r}: looked for {path}")
    return _load(path)
