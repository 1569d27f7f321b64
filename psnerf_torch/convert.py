"""Reference torch checkpoints -> parameter trees in the JAX package's
layout (counterpart of psnerf_tpu/convert.py).

The trees hold numpy arrays at the JAX package's leaf paths, so
`train.checkpoints.save_checkpoint` writes the keys the JAX package's
convert-ckpt writes, and the port's modules load them
(`train.checkpoints.load_module`). Families (README.md:92-107):
  * stage-1 `model.pt` (CheckpointIO bundle, stage1/model/checkpoints.py):
    weight-normed linears `lin{l}.weight_g/weight_v/bias` (geometry) and
    `lina{l}.*` (appearance) -> {geo: [...], app: [...]} with v stored
    [din, dout] (transposed from torch's [dout, din]);
  * stage-2 `ModelParameters/*.pth`: `albedo_net.linears.N.*`,
    `rough_net.linears.N.*`, `normal_net.linears.N.*`,
    `visibility_net.linears.N.*` + `LightParameters/*.pth` embeddings;
  * SDPS LCNet/NENet `.pth.tar` (preprocess.sdps.load_*_torch).
"""

from __future__ import annotations

import numpy as np
import torch


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def _wn_linear_from_torch(sd: dict, prefix: str) -> dict:
    g = _np(sd[f"{prefix}.weight_g"])  # [out, 1]
    v = _np(sd[f"{prefix}.weight_v"])  # [out, in]
    b = _np(sd[f"{prefix}.bias"])
    return {"v": np.ascontiguousarray(v.T), "g": g[:, 0], "b": b}


def _linear_from_torch(sd: dict, prefix: str) -> dict:
    w = _np(sd[f"{prefix}.weight"])  # [out, in]
    b = _np(sd[f"{prefix}.bias"])
    return {"w": np.ascontiguousarray(w.T), "b": b}


def stage1_params_from_torch(state_dict: dict) -> dict:
    """state_dict: the reference NeuralNetwork state_dict (possibly nested
    under 'model' in the CheckpointIO bundle)."""
    if "model" in state_dict and isinstance(state_dict["model"], dict):
        state_dict = state_dict["model"]
    geo, app = [], []
    l = 0
    while f"lin{l}.weight_v" in state_dict:
        geo.append(_wn_linear_from_torch(state_dict, f"lin{l}"))
        l += 1
    l = 0
    while f"lina{l}.weight_v" in state_dict:
        app.append(_wn_linear_from_torch(state_dict, f"lina{l}"))
        l += 1
    if not geo or not app:
        raise KeyError("no lin*/lina* weight-norm layers found")
    return {"geo": geo, "app": app}


def _skip_mlp_from_torch(sd: dict, net: str) -> list:
    layers = []
    i = 0
    while f"{net}.linears.{i}.weight" in sd:
        layers.append(_linear_from_torch(sd, f"{net}.linears.{i}"))
        i += 1
    if not layers:
        raise KeyError(f"no layers found for {net}")
    return layers


def stage2_params_from_torch(model_sd: dict, light_sd: dict | None = None):
    """model_sd: PSNetwork state_dict ('model_state_dict' of
    ModelParameters/*.pth). light_sd: LightParameters/*.pth contents with
    'light_state_dict' / 'light_inten_state_dict'. Returns {model: {albedo,
    rough[, normal][, visibility]}[, light_dirs][, light_ints]}."""
    if "model_state_dict" in model_sd:
        model_sd = model_sd["model_state_dict"]
    model = {
        "albedo": _skip_mlp_from_torch(model_sd, "albedo_net"),
        "rough": _skip_mlp_from_torch(model_sd, "rough_net"),
    }
    if any(k.startswith("normal_net.") for k in model_sd):
        model["normal"] = _skip_mlp_from_torch(model_sd, "normal_net")
    if any(k.startswith("visibility_net.") for k in model_sd):
        model["visibility"] = _skip_mlp_from_torch(model_sd, "visibility_net")

    out = {"model": model}
    if light_sd is not None:
        out["light_dirs"] = _np(light_sd["light_state_dict"]["weight"])
        if "light_inten_state_dict" in light_sd:
            out["light_ints"] = _np(
                light_sd["light_inten_state_dict"]["weight"])
    return out


def load_torch_file(path: str):
    return torch.load(path, map_location="cpu")
