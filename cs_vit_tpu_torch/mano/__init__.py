from .assets import (  # noqa: F401
    ManoAssets,
    find_and_load,
    fix_left_shapedirs,
    load_mano_pkl,
    save_mano_pkl,
    synthetic_assets,
)
from .layer import ManoLayer, sh_joint_regressor  # noqa: F401
