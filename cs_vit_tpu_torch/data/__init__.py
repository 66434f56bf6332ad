from .base import ConcatDataset, DataLoader, SlidingWindowDataset, collate  # noqa: F401
from .dexycb import DexYCB  # noqa: F401
from .ho3d import HO3D  # noqa: F401
from .ih26m_seq import InterHand26MSeq  # noqa: F401
from .ho3d_fs import HO3D_FS  # noqa: F401
from .ih26m_legacy import InterHand26M  # noqa: F401
from .pretrain import COCO2017, Ego4DHandImage, HIntHandImage  # noqa: F401
