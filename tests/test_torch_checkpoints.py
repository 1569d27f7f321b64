"""Checkpoints cross between the packages: an npz written by
psnerf_tpu.train.checkpoints loads into the port, and one the port writes
loads back into the JAX package, with the same keys, shapes, values and
`__scalars__` (exact)."""

import os

import jax
import numpy as np
import pytest
import torch

from psnerf_tpu.fields.psnet import PSNetConfig as JCfg, init_psnet as jinit
from psnerf_tpu.train import checkpoints as jck
from psnerf_tpu.train.stage2 import init_stage2_params as jinit_stage2
from psnerf_torch.fields.psnet import PSNetConfig, init_psnet
from psnerf_torch.train import checkpoints as ck
from psnerf_torch.train.stage2 import init_stage2_params
from torch_helpers import flatten_jax, port_config

torch.set_num_threads(1)
CFGS = [dict(), dict(render_model="microfacet", normal_mlp=False),
        dict(visibility=False, specular_rgb=False)]


def _jax_params(cfg_kw, seed=0):
    jcfg = JCfg(**cfg_kw)
    rng = np.random.default_rng(seed)
    dirs = rng.normal(size=(7, 3)).astype(np.float32)
    ints = rng.uniform(1, 2, size=(7, 1)).astype(np.float32)
    return jcfg, jinit_stage2(jinit(jax.random.PRNGKey(seed), jcfg), dirs,
                              ints)


def _port_params(jcfg):
    model = init_psnet(port_config(jcfg, PSNetConfig))
    return init_stage2_params(model, np.zeros((7, 3), np.float32),
                              np.zeros((7, 1), np.float32))


@pytest.mark.parametrize("cfg_kw", CFGS)
def test_port_params_have_the_jax_leaf_paths(cfg_kw):
    jcfg, jparams = _jax_params(cfg_kw)
    ref = flatten_jax(jparams)
    got = ck.flatten_tree(_port_params(jcfg))
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].shape == ref[k].shape, k
        assert got[k].dtype == ref[k].dtype, k


@pytest.mark.parametrize("cfg_kw", CFGS)
def test_round_trip_jax_port_jax(tmp_path, cfg_kw):
    jcfg, jparams = _jax_params(cfg_kw)
    a = str(tmp_path / "jax.npz")
    jck.save_checkpoint(a, {"params": jparams}, {"it": 12, "note": "x"})

    flat, scalars = ck.load_checkpoint(a)
    assert scalars == {"it": 12, "note": "x"}
    params = ck.load_tree(_port_params(jcfg), flat, "params/")
    b = str(tmp_path / "port.npz")
    ck.save_checkpoint(b, {"params": params}, scalars)

    with np.load(a) as fa, np.load(b) as fb:
        assert sorted(fa.files) == sorted(fb.files)
        for k in fa.files:
            assert fa[k].dtype == fb[k].dtype, k
            np.testing.assert_array_equal(fb[k], fa[k], err_msg=k)
    back, back_scalars = jck.load_checkpoint(b, {"params": jparams})
    assert back_scalars == scalars
    ref = flatten_jax(jparams)
    for k, v in flatten_jax(back["params"]).items():
        np.testing.assert_array_equal(v, ref[k], err_msg=k)


def test_load_refuses_missing_and_misshapen_leaves(tmp_path):
    jcfg, jparams = _jax_params({})
    path = str(tmp_path / "m.npz")
    jck.save_checkpoint(path, {"params": jparams})
    flat, scalars = ck.load_checkpoint(path)
    assert scalars == {}
    bad = dict(flat)
    del bad["params/model/albedo/0/w"]
    with pytest.raises(KeyError, match="albedo/0/w"):
        ck.load_tree(_port_params(jcfg), bad, "params/")
    bad = dict(flat)
    bad["params/light_dirs"] = np.zeros((8, 3), np.float32)
    with pytest.raises(ValueError, match="light_dirs"):
        ck.load_tree(_port_params(jcfg), bad, "params/")


def test_latest_checkpoint_matches_jax(tmp_path):
    d = str(tmp_path / "ckpts")
    assert ck.latest_checkpoint(d) is None
    os.makedirs(d)
    for it in (100, 2000, 300):
        ck.save_checkpoint(os.path.join(d, f"model_{it}.npz"),
                           {"x": np.zeros(1)})
    assert ck.latest_checkpoint(d) == jck.latest_checkpoint(d)
    assert ck.latest_checkpoint(d).endswith("model_2000.npz")
    ck.save_checkpoint(os.path.join(d, "model.npz"), {"x": np.zeros(1)})
    assert ck.latest_checkpoint(d) == jck.latest_checkpoint(d)
    assert ck.latest_checkpoint(d).endswith("model.npz")
