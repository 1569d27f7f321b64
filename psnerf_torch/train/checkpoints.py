"""Checkpoint I/O in the npz format of psnerf_tpu/train/checkpoints.py.

A checkpoint is one .npz of `/`-joined leaf paths (`params/model/
visibility/0/w`, `params/light_dirs`, ...) plus a `__scalars__` entry of
JSON bytes. An nn.Module contributes its state-dict keys with `.` read as
`/`, so a file written by either package loads in the other. URLs are not
fetched: a checkpoint source is a local path.
"""

from __future__ import annotations

import json
import os
import re

import numpy as np
import torch
from torch import nn


def flatten_tree(tree, prefix: str = "") -> dict:
    """{`/`-joined path: np.ndarray} of nested dicts, lists, nn.Modules,
    tensors and arrays."""
    out = {}
    if isinstance(tree, nn.Module):
        for k, v in tree.state_dict().items():
            out[prefix + k.replace(".", "/")] = v.detach().cpu().numpy()
    elif isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten_tree(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flatten_tree(v, f"{prefix}{i}/"))
    elif isinstance(tree, torch.Tensor):
        out[prefix[:-1]] = tree.detach().cpu().numpy()
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def save_checkpoint(path: str, tree, scalars: dict | None = None) -> None:
    flat = flatten_tree(tree)
    if scalars:
        flat["__scalars__"] = np.frombuffer(json.dumps(scalars).encode(),
                                            dtype=np.uint8)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **flat)
    os.replace(tmp, path)


def load_checkpoint(path: str):
    """Returns ({path: np.ndarray}, scalars)."""
    with np.load(path) as data:
        scalars = {}
        if "__scalars__" in data:
            scalars = json.loads(bytes(data["__scalars__"]).decode())
        flat = {k: data[k] for k in data.files if k != "__scalars__"}
    return flat, scalars


def _take(flat: dict, key: str, shape) -> np.ndarray:
    if key not in flat:
        raise KeyError(f"checkpoint missing leaf {key!r}")
    arr = flat[key]
    if tuple(arr.shape) != tuple(shape):
        raise ValueError(f"shape mismatch for {key!r}: ckpt {arr.shape} vs "
                         f"model {tuple(shape)}")
    return arr


@torch.no_grad()
def load_module(module: nn.Module, flat: dict, prefix: str = "") -> nn.Module:
    """Copy `prefix + <state-dict path>` arrays into a module in place."""
    for k, p in module.state_dict().items():
        arr = _take(flat, prefix + k.replace(".", "/"), p.shape)
        p.copy_(torch.as_tensor(np.array(arr), dtype=p.dtype))
    return module


def load_tree(tree: dict, flat: dict, prefix: str = "") -> dict:
    """Restore a dict of nn.Modules and tensors from flat arrays; modules
    load in place, tensors are replaced (same device and dtype)."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, nn.Module):
            out[k] = load_module(v, flat, key + "/")
        elif isinstance(v, dict):
            out[k] = load_tree(v, flat, key + "/")
        else:
            out[k] = torch.as_tensor(np.array(_take(flat, key, v.shape)),
                                     dtype=v.dtype, device=v.device)
    return out


def latest_checkpoint(ckpt_dir: str, prefix: str = "model"):
    """Path of the newest checkpoint: `<prefix>.npz` if present, else the
    highest-numbered `<prefix>_<it>.npz`, else None."""
    rolling = os.path.join(ckpt_dir, f"{prefix}.npz")
    if os.path.exists(rolling):
        return rolling
    if not os.path.isdir(ckpt_dir):
        return None
    best, best_it = None, -1
    pat = re.compile(rf"{re.escape(prefix)}_(\d+)\.npz$")
    for f in os.listdir(ckpt_dir):
        m = pat.match(f)
        if m and int(m.group(1)) > best_it:
            best_it = int(m.group(1))
            best = os.path.join(ckpt_dir, f)
    return best
