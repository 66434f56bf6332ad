"""Port parity: weights carried across from the JAX package.

The port's ``state_dict_from_flax`` must give exactly the keys and values of
JAX ``export_poser_state_dict`` (the reference state-dict schema), and that
dict must load strictly into the port's ``Poser``.
"""

import jax
import numpy as np
import pytest

from cs_vit_tpu.cli.common import build_model as j_build_model
from cs_vit_tpu.cli.common import init_variables
from cs_vit_tpu.config import FinetuneConfig as JFinetuneConfig
from cs_vit_tpu.train.convert import export_poser_state_dict
from cs_vit_tpu_torch.cli.common import build_model
from cs_vit_tpu_torch.config import FinetuneConfig
from cs_vit_tpu_torch.train.convert import load_reference_state_dict, state_dict_from_flax


@pytest.mark.parametrize("num_spatial_layer,num_temporal_layer", [(6, 2), (2, 1)])
def test_state_dict_from_flax_matches_jax_export(num_spatial_layer, num_temporal_layer):
    kw = dict(exp="c", backbone="test", img_size=32, num_spatial_layer=num_spatial_layer,
              num_temporal_layer=num_temporal_layer)
    jcfg = JFinetuneConfig(**kw, attention_impl="xla")
    jmodel = j_build_model(jcfg)
    variables = init_variables(jmodel, jcfg, 1)
    params = jax.tree.map(np.asarray, variables["params"])
    stats = jax.tree.map(np.asarray, variables["batch_stats"])

    want = export_poser_state_dict(params, stats, jmodel.config)
    tmodel = build_model(FinetuneConfig(**kw))
    got = state_dict_from_flax(params, stats, tmodel.config)
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == np.shape(want[k]), k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    # the reference schema is exactly the port's module tree
    assert set(tmodel.state_dict()) == set(got)
    load_reference_state_dict(tmodel, got)
    sd = tmodel.state_dict()
    for k in ("backbone.encoder.layers.0.blocks.0.attention.self.query.weight",
              "perspective_mlp.layer.3.running_var", "pose_decoder.0.bias"):
        np.testing.assert_array_equal(sd[k].numpy(), got[k])


def test_strict_load_rejects_missing_and_unknown_keys():
    tmodel = build_model(FinetuneConfig(exp="c", backbone="test", img_size=32))
    sd = {k: v.numpy() for k, v in tmodel.state_dict().items()}
    extra = dict(sd, **{"latent_trans.rope2d.embedding": np.zeros(3, np.float32)})
    with pytest.raises(RuntimeError):
        load_reference_state_dict(tmodel, extra)
    sd.pop("query_token")
    with pytest.raises(RuntimeError):
        load_reference_state_dict(tmodel, sd)
