from .base import ConcatDataset, DataLoader, SlidingWindowDataset, collate  # noqa: F401
from .dexycb import DexYCB  # noqa: F401
