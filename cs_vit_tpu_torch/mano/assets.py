"""MANO model-asset loading (port of ``cs_vit_tpu/mano/assets.py``).

Loads the official ``MANO_RIGHT.pkl``/``MANO_LEFT.pkl`` (chumpy-pickled)
without the ``chumpy``/``smplx`` packages, and builds a deterministic
synthetic stand-in with the same tensor shapes. ``synthetic_assets`` draws
exactly the numbers the JAX package draws (numpy ``default_rng(seed)``,
float64), so both packages run the same fake hand.
"""

from __future__ import annotations

import dataclasses
import io
import os
import pickle
from typing import Optional

import numpy as np

from ..constants import MANO_PARENTS, NUM_MANO_JOINTS, NUM_MANO_VERTS


@dataclasses.dataclass
class ManoAssets:
    """Numpy bundle of the MANO model tensors (meters)."""

    v_template: np.ndarray       # [778, 3]
    shapedirs: np.ndarray        # [778, 3, 10]
    posedirs: np.ndarray         # [135, 778*3] (pre-flattened, smplx layout)
    j_regressor: np.ndarray      # [16, 778]
    lbs_weights: np.ndarray      # [778, 16]
    hands_mean: np.ndarray       # [45]
    hands_components: np.ndarray  # [45, 45] PCA basis
    parents: np.ndarray          # [16]
    faces: np.ndarray            # [F, 3]
    is_rhand: bool = True
    synthetic: bool = False


class _ChumpyTolerantUnpickler(pickle.Unpickler):
    """Unpickle chumpy-era pickles by mapping chumpy arrays to numpy."""

    def find_class(self, module, name):
        if module.startswith("chumpy"):
            return _ChShim
        if module == "scipy.sparse.csc" and name == "csc_matrix":
            from scipy.sparse import csc_matrix

            return csc_matrix
        return super().find_class(module, name)


class _ChShim:
    """Minimal stand-in for chumpy.Ch: keeps __dict__, exposes the array."""

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        self.__dict__.update(state if isinstance(state, dict) else {})


def _to_np(x) -> np.ndarray:
    if isinstance(x, _ChShim):
        d = x.__dict__
        for key in ("x", "v", "a", "r"):
            if key in d:
                return _to_np(d[key])
        raise ValueError(f"cannot extract array from chumpy shim: {list(d)}")
    if hasattr(x, "toarray"):
        return np.asarray(x.toarray())
    return np.asarray(x)


def load_mano_pkl(path: str, is_rhand: bool = True) -> ManoAssets:
    """Parse an official MANO pickle into :class:`ManoAssets`."""
    with open(path, "rb") as f:
        data = _ChumpyTolerantUnpickler(io.BytesIO(f.read()), encoding="latin1").load()

    posedirs = _to_np(data["posedirs"]).astype(np.float64)
    # smplx stores posedirs transposed+flattened: [135, V*3]
    posedirs = posedirs.reshape(NUM_MANO_VERTS * 3, -1).T
    shapedirs = _to_np(data["shapedirs"]).astype(np.float64)[..., :10]
    parents = (
        _to_np(data["kintree_table"])[0].astype(np.int32)
        if "kintree_table" in data else MANO_PARENTS.copy()
    )
    return ManoAssets(
        v_template=_to_np(data["v_template"]).astype(np.float64),
        shapedirs=shapedirs,
        posedirs=posedirs,
        j_regressor=_to_np(data["J_regressor"]).astype(np.float64),
        lbs_weights=_to_np(data["weights"]).astype(np.float64),
        hands_mean=_to_np(data["hands_mean"]).astype(np.float64),
        hands_components=_to_np(data["hands_components"]).astype(np.float64),
        parents=parents,
        faces=_to_np(data["f"]).astype(np.int64),
        is_rhand=is_rhand,
        synthetic=False,
    )


def synthetic_assets(seed: int = 0, is_rhand: bool = True) -> ManoAssets:
    """Deterministic fake MANO with valid shapes/kinematics for tests.

    A smooth random blob whose 16 "joints" are convex vertex combinations,
    so FK, bone lengths and the fingertip extension behave sensibly; it is
    NOT anatomically a hand. The draw order is that of the JAX package.
    """
    rng = np.random.default_rng(seed)
    V, J = NUM_MANO_VERTS, NUM_MANO_JOINTS

    v_template = rng.normal(scale=0.03, size=(V, 3))
    v_template[:, 2] += 0.1  # keep in front of a nominal camera

    shapedirs = rng.normal(scale=0.002, size=(V, 3, 10))
    posedirs = rng.normal(scale=0.0005, size=(135, V * 3))

    # Each joint regresses from a small soft neighborhood of vertices.
    j_regressor = np.zeros((J, V))
    anchor = rng.choice(V, size=J, replace=False)
    for j in range(J):
        d = np.linalg.norm(v_template - v_template[anchor[j]], axis=-1)
        w = np.exp(-(d / 0.01) ** 2)
        j_regressor[j] = w / w.sum()

    # LBS weights: soft assignment to the nearest joints.
    joints0 = j_regressor @ v_template
    d = np.linalg.norm(v_template[:, None] - joints0[None], axis=-1)  # [V, J]
    logits = -d / 0.02
    lbs_weights = np.exp(logits - logits.max(axis=1, keepdims=True))
    lbs_weights /= lbs_weights.sum(axis=1, keepdims=True)

    hands_mean = rng.normal(scale=0.05, size=(45,))
    q = np.linalg.qr(rng.normal(size=(45, 45)))[0]

    n_faces = 1538
    faces = rng.integers(0, V, size=(n_faces, 3)).astype(np.int64)

    return ManoAssets(
        v_template=v_template,
        shapedirs=shapedirs,
        posedirs=posedirs,
        j_regressor=j_regressor,
        lbs_weights=lbs_weights,
        hands_mean=hands_mean,
        hands_components=q,
        parents=MANO_PARENTS.copy(),
        faces=faces,
        is_rhand=is_rhand,
        synthetic=True,
    )


_SEARCH_NAMES = {
    True: ("MANO_RIGHT.pkl", "mano/MANO_RIGHT.pkl", "mano_v1_2/models/MANO_RIGHT.pkl"),
    False: ("MANO_LEFT.pkl", "mano/MANO_LEFT.pkl", "mano_v1_2/models/MANO_LEFT.pkl"),
}


def find_and_load(
    model_path: Optional[str] = None, is_rhand: bool = True, allow_synthetic: bool = True
) -> ManoAssets:
    """Load real MANO assets from `model_path` (or $MANO_MODEL_DIR), else synthetic."""
    roots = []
    if model_path:
        roots.append(model_path)
    if os.environ.get("MANO_MODEL_DIR"):
        roots.append(os.environ["MANO_MODEL_DIR"])
    for root in roots:
        if os.path.isfile(root):
            return load_mano_pkl(root, is_rhand=is_rhand)
        for name in _SEARCH_NAMES[is_rhand]:
            p = os.path.join(root, name)
            if os.path.isfile(p):
                return load_mano_pkl(p, is_rhand=is_rhand)
    if not allow_synthetic:
        raise FileNotFoundError(
            f"MANO model not found under {roots}; set MANO_MODEL_DIR or pass model_path"
        )
    return synthetic_assets(is_rhand=is_rhand)
