from .dinov2 import Dinov2Backbone, Dinov2Config  # noqa: F401
from .latent import (  # noqa: F401
    MLP3,
    ImageLatentTransformerGroup,
    ScaleRotComplexEmbedTransformationGroup,
    ScaleRotTransformationGroup,
    compose_hf_cr_hr,
    compose_sr,
)
from .modules import (  # noqa: F401
    MHA,
    ContinuousAngleEmbedding,
    CrossAttnDecoder,
    DecoderBlock,
    EncoderBlock,
    FeedForwardNetwork,
    LayerNorm,
    Linear,
    LoraCompatibleMHA,
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
from .ti import (  # noqa: F401
    TIDinoTransGroup,
    TIDinoViT,
    TIViT,
    dino_forward,
    dino_stage_mask,
    support_loss,
    ti_forward,
    ti_stage_mask,
    update_teacher,
)
from .vit import (  # noqa: F401
    LoRADense,
    ViTConfig,
    ViTEncoder,
    ViTMAEDecoderConfig,
    ViTMAEDecoderNoMask,
    get_2d_sincos_pos_embed,
    merge_lora_params,
)
