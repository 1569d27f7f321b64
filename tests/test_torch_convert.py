"""psnerf_torch.convert and the port's convert-ckpt against psnerf_tpu's on
the CPU: reference-layout torch state dicts (stage 1's weight-norm
linears, stage 2's skip MLPs and light tables, SDPS-Net's LCNet and NENet)
convert to the same trees, leaf for leaf and bit for bit; both CLIs write
npz files with the same keys and values; a converted stage-1 npz loads
into the port's field and gives what JAX's field and the reference torch
network give (tests/test_convert.py:62-83)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psnerf_torch import convert
from psnerf_torch.cli.main import main
from psnerf_torch.fields import occupancy as occ
from psnerf_torch.preprocess import sdps
from psnerf_torch.train.checkpoints import (flatten_tree, load_checkpoint,
                                            load_module)
from psnerf_tpu import convert as jconvert
from psnerf_tpu.cli import main as jcli
from psnerf_tpu.fields import occupancy as jocc
from psnerf_tpu.preprocess import sdps as jsdps
from psnerf_tpu.train import checkpoints as jckpt
from torch_helpers import flatten_jax, sdps_reference_state_dict

torch.set_num_threads(1)
JCFG = jocc.OccFieldConfig(num_layers=3, hidden_dim=32, feat_size=16,
                           octaves_pe=2, octaves_pe_views=2, skips=(2,))


def _stage1_state_dict(seed=1):
    """The reference geometry MLP (stage1/model/network.py:36-95) and
    appearance MLP as weight-normed torch Linears, and its forward."""
    torch.manual_seed(seed)
    dims, n = JCFG.dims_geo, len(JCFG.dims_geo) - 1
    geo = [torch.nn.utils.weight_norm(torch.nn.Linear(
        dims[l], dims[l + 1] - dims[0] if l + 1 in JCFG.skips
        else dims[l + 1])) for l in range(n)]
    dims_app = [JCFG.dim_embed_view] + [JCFG.hidden_dim] * 4 + [3]
    app = [torch.nn.utils.weight_norm(torch.nn.Linear(a, b))
           for a, b in zip(dims_app[:-1], dims_app[1:])]
    sd = {}
    for name, layers in (("lin", geo), ("lina", app)):
        for l, lin in enumerate(layers):
            for k, v in lin.state_dict().items():
                sd[f"{name}{l}.{k}"] = v

    def forward(pe):
        x = pe
        for l in range(n):
            if l in JCFG.skips:
                x = torch.cat([x, pe], -1) / np.sqrt(2)
            x = geo[l](x)
            if l < n - 1:
                x = torch.nn.functional.softplus(x, beta=100)
        return x

    return {"model": sd}, forward


def _stage2_state_dicts(seed=2):
    torch.manual_seed(seed)
    din, w, depth, skip = 10, 16, 4, 2
    sd = {}
    for net, dout in (("albedo_net", 3), ("rough_net", 27),
                      ("normal_net", 3), ("visibility_net", 1)):
        linears = ([torch.nn.Linear(din, w)]
                   + [torch.nn.Linear(w + din if i == skip else w, w)
                      for i in range(depth - 1)]
                   + [torch.nn.Linear(w, dout)])
        for i, lyr in enumerate(linears):
            for k, v in lyr.state_dict().items():
                sd[f"{net}.linears.{i}.{k}"] = v
    lights = {"light_state_dict": {"weight": torch.randn(12, 3)},
              "light_inten_state_dict": {"weight": torch.rand(12, 1)}}
    return {"model_state_dict": sd}, lights


def _sdps_state_dict(kind, seed=3):
    make = sdps.LCNet if kind == "lcnet" else sdps.NENet
    net = make(generator=torch.Generator().manual_seed(seed), device="cpu")
    return {"state_dict": sdps_reference_state_dict(flatten_tree(net), kind)}


def _assert_same_leaves(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("stage", ["stage1", "stage2", "stage2_no_lights",
                                   "lcnet", "nenet"])
def test_trees_match_jax(stage):
    if stage == "stage1":
        sd, _ = _stage1_state_dict()
        got = convert.stage1_params_from_torch(sd)
        want = jconvert.stage1_params_from_torch(sd)
    elif stage.startswith("stage2"):
        sd, lights = _stage2_state_dicts()
        lights = lights if stage == "stage2" else None
        got = convert.stage2_params_from_torch(sd, lights)
        want = jconvert.stage2_params_from_torch(sd, lights)
    else:
        sd = _sdps_state_dict(stage)["state_dict"]
        load = {"lcnet": (sdps.load_lcnet_torch, jsdps.load_lcnet_torch),
                "nenet": (sdps.load_nenet_torch, jsdps.load_nenet_torch)}
        got, want = (f(sd) for f in load[stage])
    _assert_same_leaves(flatten_tree(got), flatten_jax(want))


@pytest.mark.parametrize("stage", ["stage1", "stage2", "lcnet", "nenet"])
def test_convert_ckpt_cli_matches_jax(tmp_path, monkeypatch, stage):
    # the JAX CLI turns on its persistent compile cache; none is needed here
    monkeypatch.setattr("psnerf_tpu.utils.profiling.enable_compilation_cache",
                        lambda *a, **k: None)
    extra = []
    if stage == "stage1":
        blob = _stage1_state_dict()[0]
    elif stage == "stage2":
        blob, lights = _stage2_state_dicts()
        torch.save(lights, tmp_path / "lights.pth")
        extra = ["--lights", str(tmp_path / "lights.pth")]
    else:
        blob = _sdps_state_dict(stage)
    model = str(tmp_path / "model.pth.tar")
    torch.save(blob, model)
    outs = {}
    for name, cli in (("port", main), ("jax", jcli.main)):
        outs[name] = str(tmp_path / f"{name}.npz")
        cli(["convert-ckpt", "--stage", stage, "--model", model,
             *extra, "--out", outs[name]])
    got, want = (load_checkpoint(outs[k])[0] for k in ("port", "jax"))
    _assert_same_leaves(got, want)
    if stage in ("lcnet", "nenet"):
        # the converted npz loads into the port's module
        make = sdps.LCNet if stage == "lcnet" else sdps.NENet
        _assert_same_leaves(flatten_tree(load_module(make(device="cpu"),
                                                     got)), want)


def test_converted_stage1_loads_into_the_port_field(tmp_path):
    """convert-ckpt --stage stage1 -> the port's field and JAX's give the
    reference network's logits."""
    sd, forward = _stage1_state_dict()
    model, out = str(tmp_path / "model.pt"), str(tmp_path / "s1.npz")
    torch.save(sd, model)
    main(["convert-ckpt", "--stage", "stage1", "--model", model,
          "--out", out])
    cfg = occ.OccFieldConfig(**dataclasses.asdict(JCFG))
    field = load_module(occ.init_occupancy_field(cfg), load_checkpoint(out)[0])
    jparams, _ = jckpt.load_checkpoint(
        out, jocc.init_occupancy_field(jax.random.PRNGKey(0), JCFG))

    p = np.random.default_rng(0).normal(size=(9, 3)).astype(np.float32)
    from psnerf_torch.core.encoding import nerf_embed

    with torch.no_grad():
        pe = nerf_embed(torch.as_tensor(p), cfg.octaves_pe)
        ref = forward(pe).numpy()
        got = occ.occ_logits_and_feat(field, torch.as_tensor(p), cfg).numpy()
    want = np.asarray(jocc.occ_logits_and_feat(jparams, jnp.asarray(p), JCFG))
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got, ref, atol=3e-5)
