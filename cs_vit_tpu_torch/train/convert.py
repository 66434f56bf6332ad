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

TI pretraining's models come across by :func:`tivit_state_dict_from_flax`
(encoder with or without LoRA, MAE decoder, latent group),
:func:`dino_state_dict_from_flax` (a DINO student or teacher) and
:func:`dino_trans_state_dict_from_flax` (TI-DINO's latent group), under HF's
ViT / ViTMAEDecoder / Dinov2Model names:
  blockN/attention/{query,key,value}/base (+ lora_A, lora_B)
                               -> encoder.layer.N.attention.attention.* (+ lora_A, lora_B)
  blockN/attention/output      -> encoder.layer.N.attention.output.dense
  blockN/{intermediate,output} -> encoder.layer.N.{intermediate,output}.dense
  (DINOv2) blockN/{query,key,value,attn_output} -> encoder.layer.N.attention.*,
  blockN/layer_scale{1,2}      -> encoder.layer.N.layer_scale{1,2}.lambda1,
  blockN/{fc1,fc2}             -> encoder.layer.N.mlp.{fc1,fc2}
The TI-only latent groups map as the Poser's does (``srN`` -> ``sr.N``;
the legacy group's ``{hf,cr,hr}N`` -> ``{hf,cr,hr}.N``), and the deprecated
``LoraCompatibleMHA``'s ``in_{q,k,v}`` and ``out`` become the reference's
``mha.in_proj_weight``/``in_proj_bias`` and ``mha.out_proj``.
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

    def lora_dense(self, fpath, tname):
        self.lin(fpath + ("base",), tname)
        if fpath + ("lora_A",) in self.p:
            self.out[_join(tname, "lora_A")] = self.p[fpath + ("lora_A",)]
            self.out[_join(tname, "lora_B")] = self.p[fpath + ("lora_B",)]

    def patch_embed(self, fpath, tname):
        self.out[_join(tname, "projection.weight")] = self.p[fpath + ("kernel",)].transpose(
            3, 2, 0, 1)
        self.out[_join(tname, "projection.bias")] = self.p[fpath + ("bias",)]

    def vit_layer(self, fpath, tname):
        for n in ("query", "key", "value"):
            self.lora_dense(fpath + ("attention", n), _join(tname, f"attention.attention.{n}"))
        self.lin(fpath + ("attention", "output"), _join(tname, "attention.output.dense"))
        self.ln(fpath + ("layernorm_before",), _join(tname, "layernorm_before"))
        self.ln(fpath + ("layernorm_after",), _join(tname, "layernorm_after"))
        self.lin(fpath + ("intermediate",), _join(tname, "intermediate.dense"))
        self.lin(fpath + ("output",), _join(tname, "output.dense"))

    def vit(self, fpath, tname, num_layers):
        self.patch_embed(fpath + ("patch_embed",), _join(tname, "embeddings.patch_embeddings"))
        for n in ("cls_token", "position_embeddings"):
            self.out[_join(tname, f"embeddings.{n}")] = self.p[fpath + (n,)]
        for i in range(num_layers):
            self.vit_layer(fpath + (f"block{i}",), _join(tname, f"encoder.layer.{i}"))
        self.ln(fpath + ("layernorm",), _join(tname, "layernorm"))

    def mae_decoder(self, fpath, tname, num_layers):
        self.lin(fpath + ("decoder_embed",), _join(tname, "decoder_embed"))
        for i in range(num_layers):
            self.vit_layer(fpath + (f"block{i}",), _join(tname, f"decoder_layers.{i}"))
        self.ln(fpath + ("decoder_norm",), _join(tname, "decoder_norm"))
        self.lin(fpath + ("decoder_pred",), _join(tname, "decoder_pred"))

    def dinov2(self, fpath, tname, num_layers):
        self.patch_embed(fpath + ("patch_embed",), _join(tname, "embeddings.patch_embeddings"))
        for n in ("cls_token", "position_embeddings"):
            self.out[_join(tname, f"embeddings.{n}")] = self.p[fpath + (n,)]
        width = self.p[fpath + ("cls_token",)].shape[-1]
        self.out[_join(tname, "embeddings.mask_token")] = np.zeros((1, width), np.float32)
        for i in range(num_layers):
            b, t = fpath + (f"block{i}",), _join(tname, f"encoder.layer.{i}")
            self.ln(b + ("norm1",), _join(t, "norm1"))
            self.ln(b + ("norm2",), _join(t, "norm2"))
            for n in ("query", "key", "value"):
                self.lin(b + (n,), _join(t, f"attention.attention.{n}"))
            self.lin(b + ("attn_output",), _join(t, "attention.output.dense"))
            for k in ("1", "2"):
                self.out[_join(t, f"layer_scale{k}.lambda1")] = self.p[b + (f"layer_scale{k}",)]
            for n in ("fc1", "fc2", "weights_in", "weights_out"):
                if b + (n, "kernel") in self.p:
                    self.lin(b + (n,), _join(t, f"mlp.{n}"))
        self.ln(fpath + ("layernorm",), _join(tname, "layernorm"))

    def scale_rot_group(self, fpath, tname, num_layers):
        for name in ("scale_embedder", "angle_embedder"):
            self.angle_embedder(fpath + (name,), _join(tname, name))
        for i in range(num_layers):
            self.encoder_block(fpath + (f"sr{i}",), _join(tname, f"sr.{i}"))

    def image_latent_group(self, fpath, tname, num_layers):
        self.angle_embedder(fpath + ("angle_embedder",), _join(tname, "angle_embedder"))
        for op in ("hf", "cr", "hr"):
            for i in range(num_layers):
                self.encoder_block(fpath + (f"{op}{i}",), _join(tname, f"{op}.{i}"))

    def lora_mha(self, fpath, tname):
        for n in ("q_proj", "k_proj", "v_proj"):
            self.lin(fpath + (n,), _join(tname, n))
        ins = ("in_q", "in_k", "in_v")
        self.out[_join(tname, "mha.in_proj_weight")] = np.concatenate(
            [self.p[fpath + (n, "kernel")].T for n in ins])
        self.out[_join(tname, "mha.in_proj_bias")] = np.concatenate(
            [self.p[fpath + (n, "bias")] for n in ins])
        self.lin(fpath + ("out",), _join(tname, "mha.out_proj"))

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


def _state_dict(m: FlaxMapper) -> Dict[str, np.ndarray]:
    return {k: np.array(v, order="C") for k, v in m.out.items()}


def _depth(params: Mapping, fpath) -> int:
    """The number of ``blockN`` under `fpath` of a flax parameter tree."""
    tree = params
    for k in fpath:
        tree = tree[k]
    return sum(1 for k in tree if k.startswith("block"))


def tivit_state_dict_from_flax(params: Mapping, batch_stats: Mapping = None
                               ) -> Dict[str, np.ndarray]:
    """A JAX ``TIViT``'s (params, batch_stats) as the port's ``TIViT`` names
    them: the encoder (with its LoRA factors where it has them), the MAE
    decoder where there is one, and the latent group."""
    m = FlaxMapper(params, batch_stats)
    m.vit(("backbone",), "backbone", _depth(params, ("backbone",)))
    if "decoder" in params:
        m.mae_decoder(("decoder",), "decoder", _depth(params, ("decoder",)))
    n_sr = sum(1 for k in params["trans_grp"] if k.startswith("sr"))
    m.scale_rot_group(("trans_grp",), "trans_grp", n_sr)
    return _state_dict(m)


def dino_state_dict_from_flax(params: Mapping) -> Dict[str, np.ndarray]:
    """A JAX ``TIDinoViT``'s params (student or teacher) as the port's
    ``TIDinoViT`` names them."""
    m = FlaxMapper(params)
    m.dinov2(("backbone",), "backbone", _depth(params, ("backbone",)))
    return _state_dict(m)


def dino_trans_state_dict_from_flax(params: Mapping, batch_stats: Mapping
                                    ) -> Dict[str, np.ndarray]:
    """A JAX ``TIDinoTransGroup``'s (params, batch_stats) as the port's
    ``TIDinoTransGroup`` names them."""
    m = FlaxMapper(params, batch_stats)
    n_sr = sum(1 for k in params["trans_grp"] if k.startswith("sr"))
    m.latent_group(("trans_grp",), "trans_grp", n_sr)
    return _state_dict(m)


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

