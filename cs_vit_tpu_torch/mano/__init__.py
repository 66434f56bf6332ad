from .assets import ManoAssets, find_and_load, load_mano_pkl, synthetic_assets  # noqa: F401
from .layer import ManoLayer, sh_joint_regressor  # noqa: F401
