"""Shared helpers of the tests that hold psnerf_torch against psnerf_tpu.

Data crosses between the packages as numpy arrays. A JAX parameter pytree
is flattened under the checkpoint keys (`/`-joined leaf paths), and the
port loads those keys, so both packages run one parameter set.
"""

import dataclasses

import jax
import numpy as np
import torch


def flatten_jax(tree) -> dict:
    """{`/`-joined leaf path: np.ndarray} of a JAX pytree."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        out[key] = np.asarray(leaf)
    return out


def port_config(jax_cfg, port_cls):
    """The port's dataclass of the same name, with the same field values."""
    return port_cls(**{f.name: getattr(jax_cfg, f.name)
                       for f in dataclasses.fields(jax_cfg)})


def port_psnet(jax_params: dict, jax_cfg):
    """A port PSNet on the CPU holding the JAX package's PSNet params."""
    from psnerf_torch.fields.psnet import PSNetConfig, init_psnet
    from psnerf_torch.train.checkpoints import load_module

    model = init_psnet(port_config(jax_cfg, PSNetConfig))
    return load_module(model, flatten_jax(jax_params))


def port_occ_field(jax_params: dict, jax_cfg):
    """(port OccFieldConfig, port OccField on the CPU holding the JAX
    package's stage-1 field params)."""
    from psnerf_torch.fields.occupancy import (OccFieldConfig,
                                               init_occupancy_field)
    from psnerf_torch.train.checkpoints import load_module

    cfg = port_config(jax_cfg, OccFieldConfig)
    return cfg, load_module(init_occupancy_field(cfg), flatten_jax(jax_params))


def unit(rng, shape):
    v = rng.normal(size=shape)
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def t(a):
    return torch.as_tensor(np.array(a))


def j(a):
    return jax.numpy.asarray(np.asarray(a))


def port_stage2_config(jcfg):
    """The port's Stage2Config holding the values of a JAX Stage2Config."""
    from psnerf_torch.config import Stage2Config
    from psnerf_torch.fields.psnet import PSNetConfig
    from psnerf_torch.train.losses import Stage2LossWeights
    from psnerf_torch.train.stage2 import Stage2TrainConfig

    tr = jcfg.train
    train = Stage2TrainConfig(**{
        **{f.name: getattr(tr, f.name) for f in dataclasses.fields(tr)},
        "weights": port_config(tr.weights, Stage2LossWeights)})
    return Stage2Config(**{
        **{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)},
        "net": port_config(jcfg.net, PSNetConfig), "train": train})
