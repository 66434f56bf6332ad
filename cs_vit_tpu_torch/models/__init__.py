from .latent import MLP3, ScaleRotComplexEmbedTransformationGroup, compose_sr  # noqa: F401
from .modules import (  # noqa: F401
    MHA,
    ContinuousAngleEmbedding,
    CrossAttnDecoder,
    DecoderBlock,
    EncoderBlock,
    FeedForwardNetwork,
    LayerNorm,
    Linear,
    PositionalEncoding,
    RoPE2DPositionalEncoding,
    TorchBatchNorm,
)
from .poser import (  # noqa: F401
    PerspectiveEncoder,
    Poser,
    PoserConfig,
    SpatialEncoder,
    TemporalEncoder,
    init_poser_weights,
    latent_draws,
    sparse_corner_coords,
)
from .swinv2 import SwinV2, SwinV2Config, swinv2_base_256, swinv2_tiny_256  # noqa: F401
