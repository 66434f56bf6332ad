from .modules import (  # noqa: F401
    MHA,
    CrossAttnDecoder,
    DecoderBlock,
    EncoderBlock,
    FeedForwardNetwork,
    LayerNorm,
    Linear,
    PositionalEncoding,
    TorchBatchNorm,
)
from .poser import (  # noqa: F401
    PerspectiveEncoder,
    Poser,
    PoserConfig,
    SpatialEncoder,
    TemporalEncoder,
    init_poser_weights,
)
from .swinv2 import SwinV2, SwinV2Config, swinv2_base_256, swinv2_tiny_256  # noqa: F401
