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


# The stage-1 YAML and stage-2 conf that tests/test_cli.py writes for its
# 32x32 scene, as format strings of `scene` and `root` (the same text: the
# config tests hold that), for the port's CLI twin and the loaders' tests.
CLI_STAGE1_YAML = """
model:
  num_layers: 6
  hidden_dim: 128
  octaves_pe: 4
  octaves_pe_views: 2
  skips: [4]
  geometric_init: True
  feat_size: 128
  rescale: 1.0
rendering:
  type: unisurf
  n_max_network_queries: 64000
  white_background: True
  near: 1.2
  far: 5.0
  radius: 1.2
  interval_start: 0.6
  interval_end: 0.05
  interval_decay: 0.001
  num_points_in: 16
  num_points_out: 8
  ray_marching_steps: 48
dataloading:
  obj_name: synth
  data_dir: {scene}
  inten_normalize: null
training:
  type: unisurf
  out_dir: {root}/s1_out
  normal_loss: True
  normal_after: 0
  normal_angle: 65
  lambda_normloss: 0.05
  est_norm: True
  mask_loss: True
  lambda_mask: 1.0
  mask_valid: True
  n_training_points: 192
  learning_rate: 0.001
  scheduler_milestones: []
  scheduler_gamma: 0.5
  visualize_every: 100000
  print_every: 50
  backup_every: 100000
  checkpoint_every: 100
  lambda_l1_rgb: 1.0
  lambda_normals: 0.005
extraction:
  refinement_step: 0
  upsampling_steps: 1
  resolution: 12
"""

CLI_STAGE2_CONF = """
dataset{{
    obj_name = synth
    data_dir = {scene}
}}
train{{
    expname = cli_test
    light_train = True
    multi_light = True
    light_bs = 3
    light_init = pred
    light_inten_train = True
    light_inten_init = pred
    light_learning_rate = 5e-4
    light_inten_lr = 1e-3
    light_decay = True
    render_model = sgbasis
    nbasis = 9
    specular_rgb = True
    visibility = True
    vis_loss = True
    vis_plus = True
    vis_train_num = 3
    light_vis_detach = True
    vis_rgb_detach = True
    normal_mlp = True
    normal_joint = True
    shape_pregen = True
    stage1_shape_path = {root}/s1_out/shape_out
    train_order = True
    sample_in_mask = True
    plot_freq = 100000
    ckpt_freq = 100000
    num_pixels = 128
    train_all_pixels = False
    sg_learning_rate = 1e-3
    sg_sched_milestones = []
    sg_sched_factor = 0.5
}}
loss{{
    sg_rgb_weight = 1.0
    loss_type = L1
    albedo_smooth_weight = 0.05
    rough_smooth_weight = 0.01
    vis_weight = 1
}}
brdf{{
    net{{
        n_freqs_xyz = 6
        mlp_width = 32
        mlp_depth = 4
        mlp_skip_at = 2
        xyz_jitter_std = 0.01
    }}
    sgnet{{
        mlp_width = 16
        mlp_depth = 2
        mlp_skip_at = -1
    }}
    fresnel_f0 = 0.05
    light_intensity = 1.2
}}
normal{{
    net{{
        n_freqs_xyz = 6
        mlp_width = 32
        mlp_depth = 4
        mlp_skip_at = 2
        xyz_jitter_std = 0.0
    }}
    loss{{
        normal_weight = 1
        normal_smooth_weight = 0.05
    }}
}}
visibility{{
    net{{
        n_freqs_xyz = 6
        mlp_width = 32
        mlp_depth = 4
        mlp_skip_at = 2
    }}
}}
"""


def sdps_reference_keys(kind: str) -> dict:
    """{reference state-dict key: JAX leaf path} of the released SDPS-Net
    checkpoints (LCNet_CVPR2019 / NENet_CVPR2019 .pth.tar), kind "lcnet"
    or "nenet"."""
    conv = lambda ref, path: {f"{ref}.weight": f"{path}/w",
                              f"{ref}.bias": f"{path}/b"}
    keys = {}
    if kind == "lcnet":
        for i in range(7):
            keys.update(conv(f"featExtractor.conv{i + 1}.0", f"feat/{i}"))
        for i in range(4):
            keys.update(conv(f"classifier.conv{i + 1}.0", f"cls/{i}"))
        for name, ref in (("dir_x", "dir_x_est"), ("dir_y", "dir_y_est"),
                          ("ints", "int_est")):
            for k in range(2):
                keys.update(conv(f"classifier.{ref}.{k}.0",
                                 f"heads/{name}/{k}"))
        return keys
    for i in range(5):
        keys.update(conv(f"extractor.conv{i + 1}.0", f"feat/{i}"))
    keys["extractor.conv6.0.weight"] = "feat_deconv/w"
    keys.update(conv("extractor.conv7.0", "feat_out"))
    keys.update(conv("regressor.deconv1.0", "reg/0"))
    keys.update(conv("regressor.deconv2.0", "reg/1"))
    keys["regressor.deconv3.0.weight"] = "reg_deconv/w"
    keys["regressor.est_normal.0.weight"] = "est_normal/w"
    return keys


def sdps_reference_state_dict(flat: dict, kind: str) -> dict:
    """A reference-layout state dict of torch tensors from {JAX leaf path:
    array}."""
    return {ref: torch.as_tensor(np.array(flat[path]))
            for ref, path in sdps_reference_keys(kind).items()}


def random_lpips_state_dict(seed: int = 3) -> dict:
    """Random lpips-alex weights in the lpips package's spelling
    (net.sliceK.N.* AlexNet convs, non-negative lin{i}.model.1.weight
    heads), numpy arrays, for tools/export_lpips_npz.py."""
    rng = np.random.default_rng(seed)
    slice_of_conv = {0: 1, 3: 2, 6: 3, 8: 4, 10: 5}
    sd, cin = {}, 3
    for i, (conv_id, k, cout) in enumerate(zip(
            slice_of_conv, [11, 5, 3, 3, 3], [64, 192, 384, 256, 256])):
        pre = f"net.slice{slice_of_conv[conv_id]}.{conv_id}"
        sd[f"{pre}.weight"] = rng.normal(0, 0.05, (cout, cin, k, k)) \
            .astype(np.float32)
        sd[f"{pre}.bias"] = rng.normal(0, 0.01, (cout,)).astype(np.float32)
        sd[f"lin{i}.model.1.weight"] = rng.random((1, cout, 1, 1)) \
            .astype(np.float32)
        cin = cout
    return sd
