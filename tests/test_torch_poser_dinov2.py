"""A Poser on a DINOv2 backbone against the benchmark's plain reference
(``portbench/backbones/dinov2.py`` under ``portbench.reference.Poser``),
on the CPU with seeded random weights at a tiny size: width 48, 2 layers,
4 heads, a SwiGLU MLP, LayerScales drawn away from 1, patch 14, 56-px crops
(a 4 x 4 grid) and a position table made for 70 px (5 x 5), so that the
table's bicubic resize runs. The program is built through the benchmark's
own path (``portbench.program``: a ``FinetuneConfig`` whose ``backbone`` is
a directory holding an HF ``config.json`` of ``model_type`` ``dinov2``).

Tolerances. The program on the CPU runs in f32 on the explicit attention
path, as the reference does, with the same LayerNorm formula; the two part
only in the order of f32 sums (``F.linear`` and ``torch.einsum`` against
the reference's matmuls), about 1e-6 relative a layer. So the joints
(hundreds of mm) are held to 1e-3 mm, the loss to 1e-5 relative, and each
trained leaf's gradient to 1e-4 of its own norm plus 1e-4 of the median
leaf's (a leaf whose gradient is all round-off cannot be held relative to
itself). The change is held ten times looser: a first AdamW step moves
each element by lr * g / (|g| + eps), so an element whose gradient is
within a few round-offs of eps moves by a share of lr that those
round-offs decide. A leaf whose reference gradient is under a thousandth
of the median leaf's (the key bias, which the softmax cancels) moves by
round-off alone in both, as in the benchmark's own check: its gradient is
held under that bound instead. The forced fused path
(``F.scaled_dot_product_attention`` and ``F.layer_norm``: another softmax
and variance) is held to 1e-2 mm in inference, ten times the f32 bound and
far below what a wrong path reads (tens to hundreds of mm); its step to the
same gradient bound, and its change to 2e-3: its softmax and variance add
round-off of the size of the sums' order, which a first AdamW step
magnifies where a gradient is near eps (its worst leaf reads 7.3e-4 of the
bound's scale, the eager path's 2.8e-4; a wrong path reads order 1).
Served requests (``PoserSession``) are f32 as well and held as the joints.
"""

import contextlib
import hashlib
import io
import json
import statistics

import numpy as np
import pytest
import torch

from cs_vit_tpu_torch.cli.common import build_model, load_backbone_params, poser_config_from
from cs_vit_tpu_torch.config import FinetuneConfig
from cs_vit_tpu_torch.models import Poser, PoserConfig
from cs_vit_tpu_torch.models.dinov2 import Dinov2Backbone
from cs_vit_tpu_torch.models.poser import init_poser_weights
from portbench import program
from portbench.backbones import dinov2 as kind
from portbench.inputs import crops
from portbench.reference import Poser as RefPoser
from portbench.reference import reference_numerics, reference_steps
from portbench.weights import calibrate, load_reference, make_mano, make_weights

INPUTS = ("patches", "square_bboxes", "timestamp", "focal", "princpt")
BACKBONE = {"kind": "dinov2", "image_size": 70, "patch_size": 14, "num_channels": 3,
            "hidden_size": 48, "num_hidden_layers": 2, "num_attention_heads": 4,
            "mlp_ratio": 4, "layer_norm_eps": 1e-6, "layerscale_value": 1.0,
            "use_swiglu_ffn": True}
IMG, B, LR = 56, 4, 1e-3


def _config(hf_dir, attention_impl="auto") -> dict:
    """A benchmark configuration of the tiny DINOv2 Poser; `hf_dir` holds
    the backbone's HF ``config.json``."""
    model = {"img_size": IMG, "backbone": dict(BACKBONE, name=str(hf_dir)), "num_joints": 16,
             "num_spatial_layer": 2, "spatial_layer_type": "decoder", "num_temporal_layer": 1,
             "temporal_supervision": "full", "trope_scalar": 20.0, "num_latent_layer": None,
             "persp_embed_method": "dense", "persp_decorate": "query",
             "global_positioning": "direct"}
    return {"model": model, "attention_impl": attention_impl,
            "train": {"dtype": "float32", "lr": LR, "max_grad_norm": 5.0, "weight_decay": 0.01},
            "serve": {"dtype": "float32", "model": {}}}


def _hf_dir(tmp_path):
    hf = {k: v for k, v in BACKBONE.items() if k != "kind"}
    (tmp_path / "config.json").write_text(json.dumps(dict(hf, model_type="dinov2")))
    return tmp_path


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The reference with the seed's weights (LayerScales moved to 0.5-1.5),
    MANO, calibrated statistics, a train batch and the config."""
    config = _config(_hf_dir(tmp_path_factory.mktemp("hf")))
    ref = RefPoser(config["model"])
    weights = make_weights(ref, 3, "cpu", served=False)
    g = torch.Generator().manual_seed(4)
    for n in weights:
        if n.endswith("lambda1"):
            weights[n] = 0.5 + torch.rand(weights[n].shape, generator=g)
    mano = make_mano(3, "cpu")
    load_reference(ref, weights, mano)
    cal = crops(8, 1, IMG, 3, "calibration", "cpu")
    stats = calibrate(ref, [cal[k] for k in INPUTS], 5)
    load_reference(ref, weights, mano, stats)
    batch = crops(B, 1, IMG, 3, "batch0", "cpu", targets=True)
    return {"config": config, "ref": ref, "weights": weights, "mano": mano, "stats": stats,
            "batch": batch}


def _program(world, attention_impl="auto"):
    config = dict(world["config"], attention_impl=attention_impl)
    state, step, names = program.train_state(config, B, world["weights"], world["stats"],
                                             world["mano"], "cpu")
    return state, step, names


def test_program_config_is_the_published_rule():
    cfg = PoserConfig(backbone="dinov2-giant-14", image_size=224)
    d = cfg.dinov2_config()
    assert (cfg.hidden_dim, cfg.num_heads, cfg.num_p) == (1536, 24, 16)
    assert (d.hidden_size, d.num_hidden_layers, d.num_attention_heads, d.image_size,
            d.patch_size, d.use_swiglu_ffn, d.layerscale_value, d.layer_norm_eps) == (
        1536, 40, 24, 518, 14, True, 1.0, 1e-6)
    with torch.device("meta"):
        layer = Dinov2Backbone(d).encoder.layer[0]
    assert tuple(layer.mlp.weights_in.weight.shape) == (8192, 1536)
    assert tuple(layer.mlp.weights_out.weight.shape) == (1536, 4096)
    for bad in (dict(remat=True), dict(num_latent_layer=2, persp_decorate="patch"),
                dict(attention_impl="hybrid")):
        with pytest.raises(ValueError, match="DINOv2"):
            PoserConfig(backbone="dinov2-giant-14", image_size=224, **bad)
    with pytest.raises(ValueError, match="unknown backbone"):
        PoserConfig(backbone="dinov2-huge-14")


def test_inference_joints_match_the_reference(world):
    state, _, _ = _program(world)
    model = state.model
    b = world["batch"]
    with torch.no_grad():
        got = model.predict(*[b[k] for k in INPUTS])["joint_cam"]
        with reference_numerics("f32"):
            want = world["ref"].predict(*[b[k] for k in INPUTS])["joint_cam"]
    assert got.shape == want.shape == (B, 1, 21, 3)
    assert float((got - want).abs().max()) < 1e-3
    assert model.backbone.attn_explicit == 2 and model.backbone.attn_fused == 0


def _norm(t) -> float:
    return float(torch.linalg.vector_norm(t))


def _gap(got, want) -> float:
    return _norm(got - want)


def _step_matches_the_reference(world, attention_impl: str, change_tol: float) -> None:
    """One spatial step of the program on `attention_impl`'s path against
    the reference's: the loss, the joints, every trained leaf's gradient
    (to 1e-4) and change (to `change_tol`), each relative to the leaf's own
    norm plus the median leaf's."""
    state, step, names = _program(world, attention_impl)
    start = {names[id(p)]: p.detach().clone() for p in state.optimizer.params()}
    gen = torch.Generator().manual_seed(9)
    state, met = step(state, world["batch"], gen, None)
    ref = RefPoser(world["config"]["model"])
    load_reference(ref, world["weights"], world["mano"], world["stats"])
    with reference_numerics("f32"):
        r = reference_steps(ref, [[world["batch"]]], program.lr_for(world["config"], B),
                            [torch.Generator().manual_seed(9)], None)
    assert float(met["loss"]) == pytest.approx(r["losses"][0], rel=1e-5)
    assert float((met["joint_cam_pred"] - r["joints"]).abs().max()) < 1e-3
    leaves = {names[id(p)]: p for p in state.optimizer.params()}
    assert set(leaves) <= set(r["grads"])
    assert any(kind.block_leaf(n) for n in leaves)
    med = statistics.median(_norm(g) for g in r["grads"].values())
    med_c = statistics.median(_norm(c) for c in r["change"].values())
    for n, p in leaves.items():
        if _norm(r["grads"][n]) < 1e-3 * med:  # round-off alone: the key bias's
            assert _norm(p.grad) < 1e-3 * med, n
            continue
        assert _gap(p.grad, r["grads"][n]) <= 1e-4 * _norm(r["grads"][n]) + 1e-4 * med, n
        assert _gap(p.detach() - start[n], r["change"][n]) <= (
            change_tol * _norm(r["change"][n]) + change_tol * med_c), n


def test_one_spatial_step_matches_the_reference(world):
    _step_matches_the_reference(world, "auto", 1e-3)


def test_served_request_matches_the_reference(world):
    sess = program.session(world["config"], 4, 1, world["weights"], world["stats"],
                           world["mano"], "cpu")
    b = crops(6, 1, IMG, 3, "serve", "cpu")
    out = sess.predict_crops(*[b[k].numpy() for k in INPUTS])
    with torch.no_grad(), reference_numerics("f32"):
        want = world["ref"].predict(*[b[k] for k in INPUTS])["joint_cam"]
    assert out["joint_cam"].shape == (6, 1, 21, 3)
    assert np.abs(out["joint_cam"] - want.numpy()).max() < 1e-3


def test_forced_fused_path_counts_and_matches(world):
    state, _, _ = _program(world, attention_impl="fused")
    model = state.model
    b = world["batch"]
    with torch.no_grad():
        got = model.predict(*[b[k] for k in INPUTS])["joint_cam"]
        with reference_numerics("f32"):
            want = world["ref"].predict(*[b[k] for k in INPUTS])["joint_cam"]
    assert model.backbone.attn_fused == 2 and model.backbone.attn_explicit == 0
    assert float((got - want).abs().max()) < 1e-2
    # the fused path's backward: the step's gradients and change
    _step_matches_the_reference(world, "fused", 2e-3)


@pytest.mark.parametrize("chunk", [1, 3])
def test_chunked_reference_gives_the_whole_batch_gradients(world, monkeypatch, chunk):
    ref = world["ref"]
    b = world["batch"]
    params = [p for n, p in ref.named_parameters() if n.startswith("backbone.")]

    def grads():
        with reference_numerics("f32"):
            loss, _ = ref.loss(b)
            return torch.autograd.grad(loss, params)

    monkeypatch.setattr(kind, "CHUNK", B)
    whole = grads()
    monkeypatch.setattr(kind, "CHUNK", chunk)
    parts = grads()
    for w, p in zip(whole, parts):
        assert float((w - p).abs().max()) <= 1e-5 * float(w.abs().max()) + 1e-12


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    """An HF DINOv2 checkpoint directory: a ``transformers.Dinov2Model``
    built from an in-code config (tables and scales drawn away from HF's
    init values) and saved; (directory, model)."""
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.Dinov2Config(
        hidden_size=48, num_hidden_layers=2, num_attention_heads=4, image_size=56,
        patch_size=14, use_swiglu_ffn=True, layerscale_value=0.7, layer_norm_eps=1e-6)
    torch.manual_seed(0)
    hf = transformers.Dinov2Model(hf_cfg).eval()
    with torch.no_grad():
        for name, p in hf.named_parameters():
            if name.endswith(("cls_token", "position_embeddings", "lambda1", "mask_token")):
                p.copy_(torch.randn_like(p))
    path = tmp_path_factory.mktemp("hf_dinov2")
    hf.save_pretrained(path)
    return path, hf


def test_hf_dinov2_directory_loads_through_the_cli(hf_dir):
    """The directory builds the Poser's backbone by its ``config.json`` and
    loads its weights: the backbone gives the HF model's patches at the
    table's own size (no resize on either side; f32, the two part in
    LayerNorm's variance formula and sum orders)."""
    tmp_path, hf = hf_dir
    cfg = FinetuneConfig(backbone=str(tmp_path), img_size=56, phase="spatial")
    pc = poser_config_from(cfg)
    assert pc.dinov2 and pc.backbone == "dinov2" and pc.hidden_dim == 48
    model = build_model(cfg)
    init_poser_weights(model, 0)
    assert load_backbone_params(str(tmp_path), model.backbone)
    assert "embeddings.mask_token" not in model.backbone.state_dict()
    x = torch.rand(2, 56, 56, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got = model.backbone(x)
        want = hf(pixel_values=x.permute(0, 3, 1, 2)).last_hidden_state[:, 1:]
    assert got.shape == (2, 16, 48)
    assert float((got - want).abs().max()) < 1e-4


def test_cli_finetune_trains_from_an_hf_dinov2_directory(hf_dir, tmp_path):
    """``cli.finetune`` end to end on the CPU: a synthetic DexYCB tree, the
    backbone from the HF directory, one epoch of spatial steps, a
    checkpoint."""
    from cs_vit_tpu_torch.cli import finetune
    from cs_vit_tpu_torch.data.fixtures import make_synthetic_dexycb

    root = make_synthetic_dexycb(str(tmp_path / "dexycb"), num_seqs=1, seq_len=4)
    cfg = FinetuneConfig(exp="dino", epoch=1, backbone=str(hf_dir[0]), data=["dexycb"],
                         batch_size=2, phase="spatial", img_size=56, dexycb_root=root,
                         num_spatial_layer=1, num_temporal_layer=1)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        state = finetune.main(cfg, str(tmp_path / "ckpt"), log_every=1, device="cpu")
    log = out.getvalue()
    assert "loaded pretrained backbone" in log and "writing checkpoint for epoch 1" in log
    assert isinstance(state.model.backbone, Dinov2Backbone) and state.step == 2


def test_hf_directory_names_the_published_size(tmp_path):
    (tmp_path / "config.json").write_text(json.dumps(
        {"model_type": "dinov2", "hidden_size": 1536, "num_hidden_layers": 40,
         "num_attention_heads": 24, "patch_size": 14, "image_size": 518,
         "use_swiglu_ffn": True}))
    pc = poser_config_from(FinetuneConfig(backbone=str(tmp_path), img_size=224))
    assert pc.backbone == "dinov2"
    assert pc.dinov2_config() == PoserConfig(backbone="dinov2-giant-14").dinov2_config()


def test_init_covers_dinov2_leaves():
    model = build_model(FinetuneConfig(backbone="dinov2-small-14", img_size=56,
                                       num_spatial_layer=1, num_temporal_layer=1))
    init_poser_weights(model, 0)
    bb = dict(model.backbone.named_parameters())
    for name in ("embeddings.cls_token", "embeddings.position_embeddings"):
        t = bb[name]
        assert 0.01 < float(t.std()) < 0.03 and float(t.abs().max()) <= 0.04
    scales = [p for n, p in bb.items() if n.endswith("lambda1")]
    assert len(scales) == 24 and all(bool((s == 1.0).all()) for s in scales)
    assert all(bool(torch.isfinite(p).all()) for p in model.parameters())


# the parent's SwinV2 Posers: sha256 of the state dict's names and shapes,
# and of the module tree's repr, on the meta device; of init_poser_weights
# (seed 3) at the test size
SWIN = {"test": (32, "9a6181eab3cf1253", "1f275e588880ff7e"),
        "swinv2-base-256": (256, "f676c28a22c2bf5a", "afe660d57307581e"),
        "swinv2-tiny-256": (256, "f385d40f2db2fda8", "fadd0dbc5e7babcf")}
SWIN_INIT = "e37cd45955177361"


def _sha(data) -> str:
    return hashlib.sha256(data.encode() if isinstance(data, str) else data).hexdigest()[:16]


@pytest.mark.parametrize("name", list(SWIN))
def test_swin_poser_is_unchanged(name):
    img, names, tree = SWIN[name]
    mano = build_model(FinetuneConfig(backbone="test", img_size=32)).mano
    with torch.device("meta"):
        m = Poser(PoserConfig(backbone=name, image_size=img), mano, np.zeros((21, 778)))
    got = "\n".join(f"{n} {tuple(t.shape)}" for n, t in m.state_dict().items())
    assert (_sha(got), _sha(repr(m))) == (names, tree)
    if name == "test":
        m = Poser(PoserConfig(backbone=name, image_size=img), mano, np.zeros((21, 778)))
        init_poser_weights(m, 3)
        flat = torch.cat([p.detach().reshape(-1) for p in m.parameters()])
        assert _sha(flat.numpy().tobytes()) == SWIN_INIT


@pytest.mark.parametrize("attention_impl", ["auto", "fused"])
def test_backbone_spans(world, attention_impl):
    """Under a profiler: one ``csvit.vit.embed`` a forward, a
    ``csvit.vit.mlp`` a layer, a ``csvit.vit.attn`` a layer on the fused
    path only (the CPU's ``auto`` is the explicit path)."""
    model = _program(world, attention_impl)[0].model
    b = world["batch"]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof, \
            torch.no_grad():
        model.predict(*[b[k] for k in INPUTS])
    names = [e.name for e in prof.events() if e.name.startswith("csvit.vit.")]
    fused = attention_impl == "fused"
    assert sorted(names) == sorted(["csvit.vit.embed"] + ["csvit.vit.mlp"] * 2
                                   + ["csvit.vit.attn"] * (2 if fused else 0))
