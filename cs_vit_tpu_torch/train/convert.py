"""Weights carried across from the JAX package.

:func:`state_dict_from_flax` is this package's own copy of the mapping in
``cs_vit_tpu/train/convert.py:export_poser_state_dict``: a flax parameter
tree and batch-stats tree (nested dicts of numpy arrays) become reference
state-dict names, which load strictly into :class:`~..models.poser.Poser`.
It covers every module of the Poser: backbone, perspective encoder,
spatial encoder of either type, temporal encoders of either form, heads and
the latent group.

Name scheme (flax -> reference):
  backbone/*                   -> backbone.* (HF Swinv2 names)
  perspective_mlp/proj         -> perspective_mlp.proj
  perspective_mlp/bn{0,1,2}    -> perspective_mlp.layer.{0,3,6} (+ running stats)
  perspective_mlp/fc{0,1,2}    -> perspective_mlp.layer.{1,4,7}
  perspective_mlp/out          -> perspective_mlp.layer.9
  spatial_encoder/layerN       -> spatial_encoder.layers.N (decoder or encoder blocks)
  *_temporal_encoder/layerN    -> *_temporal_encoder.layers.N (+ zero_conv);
                                  "full": encoder blocks and pe_temporal.pe.weight,
                                  "realtime": cross-attention decoders (norm1,
                                  cross_atten, norm2, ffn) and no pe_temporal
  {pose,shape,root}_decoder    -> {pose,shape,root}_decoder.0
  latent_trans/rope2d          -> latent_trans.rope2d.embedding
  latent_trans/{scale,angle}_embedder -> latent_trans.*_embedder.{freq_base,
                                  proj.0 (Dense), proj.2 (LayerNorm)}
  latent_trans/{scale,angle}_linear/fc{1,2,3} -> latent_trans.*_linear.{0,2,4}
  latent_trans/srN             -> latent_trans.sr.N (encoder blocks)
Dense kernels [in, out] become Linear weights [out, in]; the patch conv
HWIO becomes OIHW; BatchNorm scale/bias -> weight/bias, mean/var ->
running_mean/running_var, with num_batches_tracked = 0.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from ..models.poser import PoserConfig
from ..models.swinv2 import SwinV2Config


def _flatten(tree: Mapping, prefix=()) -> Dict[tuple, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _join(prefix: str, name: str) -> str:
    return f"{prefix}.{name}" if prefix else name


class FlaxMapper:
    """Writes flax leaves under reference names into ``self.out``.

    Each method takes the flax path of a module (a tuple) and the reference
    name prefix of its counterpart ("" for a module at the root).
    """

    def __init__(self, params: Mapping, batch_stats: Mapping = None):
        self.p = _flatten(params)
        self.s = _flatten(batch_stats or {})
        self.out: Dict[str, np.ndarray] = {}

    def lin(self, fpath, tname, bias=True):
        self.out[_join(tname, "weight")] = self.p[fpath + ("kernel",)].T
        if bias:
            self.out[_join(tname, "bias")] = self.p[fpath + ("bias",)]

    def ln(self, fpath, tname):
        self.out[_join(tname, "weight")] = self.p[fpath + ("scale",)]
        self.out[_join(tname, "bias")] = self.p[fpath + ("bias",)]

    def bn(self, fpath, tname):
        self.ln(fpath, tname)
        self.out[_join(tname, "running_mean")] = self.s[fpath + ("mean",)]
        self.out[_join(tname, "running_var")] = self.s[fpath + ("var",)]
        self.out[_join(tname, "num_batches_tracked")] = np.zeros((), np.int64)

    def mha(self, fpath, tname):
        for n in ("query", "key", "value", "output"):
            self.lin(fpath + (n,), _join(tname, n))

    def ffn(self, fpath, tname):
        self.lin(fpath + ("fc1",), _join(tname, "net.0"))
        self.lin(fpath + ("fc2",), _join(tname, "net.2"))

    def encoder_block(self, fpath, tname):
        self.mha(fpath + ("attn",), _join(tname, "attn"))
        self.ffn(fpath + ("ffn",), _join(tname, "ffn"))
        self.bn(fpath + ("norm1",), _join(tname, "norm1"))
        self.bn(fpath + ("norm2",), _join(tname, "norm2"))

    def decoder_block(self, fpath, tname):
        self.mha(fpath + ("self_atten",), _join(tname, "self_atten"))
        self.mha(fpath + ("cross_atten",), _join(tname, "cross_atten"))
        self.ffn(fpath + ("ffn",), _join(tname, "ffn"))
        for n in ("norm1", "norm2", "norm3"):
            self.bn(fpath + (n,), _join(tname, n))

    def cross_attn_decoder(self, fpath, tname):
        self.mha(fpath + ("cross_atten",), _join(tname, "cross_atten"))
        self.ffn(fpath + ("ffn",), _join(tname, "ffn"))
        self.bn(fpath + ("norm1",), _join(tname, "norm1"))
        self.bn(fpath + ("norm2",), _join(tname, "norm2"))

    def angle_embedder(self, fpath, tname):
        self.out[_join(tname, "freq_base")] = self.p[fpath + ("freq_base",)]
        self.lin(fpath + ("proj",), _join(tname, "proj.0"))
        self.ln(fpath + ("norm",), _join(tname, "proj.2"))

    def mlp3(self, fpath, tname):
        for i, n in ((0, "fc1"), (2, "fc2"), (4, "fc3")):
            self.lin(fpath + (n,), _join(tname, str(i)))

    def latent_group(self, fpath, tname, num_layers):
        self.out[_join(tname, "rope2d.embedding")] = self.p[fpath + ("rope2d", "embedding")]
        for name in ("scale_embedder", "angle_embedder"):
            self.angle_embedder(fpath + (name,), _join(tname, name))
        for name in ("scale_linear", "angle_linear"):
            self.mlp3(fpath + (name,), _join(tname, name))
        for i in range(num_layers):
            self.encoder_block(fpath + (f"sr{i}",), _join(tname, f"sr.{i}"))

    def swinv2_block(self, fpath, tname, qkv_bias=True):
        a, sa = fpath + ("attn",), _join(tname, "attention.self")
        self.out[_join(sa, "logit_scale")] = self.p[a + ("logit_scale",)]
        self.lin(a + ("cpb1",), _join(sa, "continuous_position_bias_mlp.0"))
        self.lin(a + ("cpb2",), _join(sa, "continuous_position_bias_mlp.2"), bias=False)
        self.lin(a + ("query",), _join(sa, "query"), bias=qkv_bias)
        self.lin(a + ("key",), _join(sa, "key"), bias=False)
        self.lin(a + ("value",), _join(sa, "value"), bias=qkv_bias)
        self.lin(a + ("proj",), _join(tname, "attention.output.dense"))
        self.ln(fpath + ("layernorm_before",), _join(tname, "layernorm_before"))
        self.ln(fpath + ("layernorm_after",), _join(tname, "layernorm_after"))
        self.lin(fpath + ("intermediate",), _join(tname, "intermediate.dense"))
        self.lin(fpath + ("output",), _join(tname, "output.dense"))

    def swinv2(self, fpath, tname, sw: SwinV2Config):
        self.out[_join(tname, "embeddings.patch_embeddings.projection.weight")] = (
            self.p[fpath + ("patch_embed", "kernel")].transpose(3, 2, 0, 1)
        )
        self.out[_join(tname, "embeddings.patch_embeddings.projection.bias")] = (
            self.p[fpath + ("patch_embed", "bias")]
        )
        self.ln(fpath + ("patch_norm",), _join(tname, "embeddings.norm"))
        for st in range(sw.num_layers):
            layer = _join(tname, f"encoder.layers.{st}")
            for bix in range(sw.depths[st]):
                self.swinv2_block(fpath + (f"stage{st}_block{bix}",), f"{layer}.blocks.{bix}",
                                  sw.qkv_bias)
            if st < sw.num_layers - 1:
                ds = fpath + (f"stage{st}_downsample",)
                self.lin(ds + ("reduction",), f"{layer}.downsample.reduction", bias=False)
                self.ln(ds + ("norm",), f"{layer}.downsample.norm")
        self.ln(fpath + ("layernorm",), _join(tname, "layernorm"))


def state_dict_from_flax(
    params: Mapping, batch_stats: Mapping, config: PoserConfig
) -> Dict[str, np.ndarray]:
    """flax (params, batch_stats) -> reference state-dict names (numpy)."""
    m = FlaxMapper(params, batch_stats)
    m.swinv2(("backbone",), "backbone", config.swin_config())
    m.out["query_token"] = m.p[("query_token",)]

    m.lin(("perspective_mlp", "proj"), "perspective_mlp.proj")
    for i, idx in enumerate((0, 3, 6)):
        m.bn(("perspective_mlp", f"bn{i}"), f"perspective_mlp.layer.{idx}")
    for i, idx in enumerate((1, 4, 7)):
        m.lin(("perspective_mlp", f"fc{i}"), f"perspective_mlp.layer.{idx}")
    m.lin(("perspective_mlp", "out"), "perspective_mlp.layer.9")

    m.out["spatial_encoder.pe_spatial.pe.weight"] = m.p[("spatial_encoder", "pe_spatial", "pe")]
    spatial = m.decoder_block if config.spatial_layer_type == "decoder" else m.encoder_block
    for i in range(config.num_spatial_layer):
        spatial(("spatial_encoder", f"layer{i}"), f"spatial_encoder.layers.{i}")

    realtime = config.temporal_supervision == "realtime"
    for name in ("pose_temporal_encoder", "shape_temporal_encoder", "root_temporal_encoder"):
        if not realtime:  # the trope PE has no parameters
            m.out[f"{name}.pe_temporal.pe.weight"] = m.p[(name, "pe_temporal", "pe")]
        block = m.cross_attn_decoder if realtime else m.encoder_block
        for i in range(config.num_temporal_layer):
            block((name, f"layer{i}"), f"{name}.layers.{i}")
        m.lin((name, "zero_conv"), f"{name}.zero_conv", bias=False)

    for name in ("pose_decoder", "shape_decoder", "root_decoder"):
        m.lin((name,), f"{name}.0")

    if config.num_latent_layer is not None:
        m.latent_group(("latent_trans",), "latent_trans", config.num_latent_layer)

    return {k: np.array(v, order="C") for k, v in m.out.items()}


LATENT_PREFIX = "latent_trans."


def load_reference_state_dict(module: torch.nn.Module, state_dict: Mapping) -> torch.nn.Module:
    """Load a reference-schema state dict (numpy arrays or tensors) into a
    port module strictly, keeping each parameter's and buffer's current
    dtype and device.

    A module without a latent group (evaluation and serving drop it, as
    ``cs_vit_tpu/cli/evaluate.py`` does) takes a latent-trained checkpoint:
    exactly its ``latent_trans.*`` keys are dropped, with a message that
    says how many; every other key stays strict."""
    current = module.state_dict()
    if not any(k.startswith(LATENT_PREFIX) for k in current):
        dropped = [k for k in state_dict if k.startswith(LATENT_PREFIX)]
        if dropped:
            print(f"load_reference_state_dict: dropped {len(dropped)} {LATENT_PREFIX}* keys "
                  "(the model has no latent group)")
            state_dict = {k: v for k, v in state_dict.items() if not k.startswith(LATENT_PREFIX)}
    tensors = {}
    for k, v in state_dict.items():
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v))
        ref = current.get(k)
        tensors[k] = t.to(dtype=ref.dtype, device=ref.device) if ref is not None else t
    module.load_state_dict(tensors, strict=True)
    return module

