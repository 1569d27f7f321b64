"""The host-side assembly that Stage2Runner.render_view's arrays are held
to, bit for bit: each output of the frame renderer scattered with numpy
into a full frame of the reference's fill values (0 for sg_weight, the
light count for rgb_sum, 1 for everything else). Imports no JAX, so the
card's tests use it too.
"""

import numpy as np

import psnerf_torch.runners.stage2 as rs


def capture_frames(monkeypatch) -> list:
    """Every later frame render_view renders, as {name: host array}: the
    frame renderer's compact (or padded) outputs, in call order."""
    seen = []
    orig = rs.render_frame_stage2

    def frame(*args, **kwargs):
        out = orig(*args, **kwargs)
        seen.append({k: v.cpu().numpy() for k, v in out.items()})
        return out

    monkeypatch.setattr(rs, "render_frame_stage2", frame)
    return seen


def host_assembly(frame: dict, mask: np.ndarray, n_lights: int,
                  normals: np.ndarray, compact: bool) -> dict:
    """{name: [L, h, w, C] or [h, w, C]} from one frame's outputs (pixel
    axis second last), plus normal_values and mask. compact: the outputs
    hold the mask's pixels first, in raster order; else the whole frame
    and then its padding."""
    h, w = mask.shape
    n = h * w
    sel = np.flatnonzero(mask)
    fills = {"sg_weight": 0.0, "rgb_sum": float(n_lights)}
    res = {}
    for k, v in frame.items():
        if compact:
            full = np.full(v.shape[:-2] + (n, v.shape[-1]),
                           fills.get(k, 1.0), v.dtype)
            full[..., sel, :] = v[..., :len(sel), :]
        else:
            full = v[..., :n, :]
        res[k] = full.reshape(v.shape[:-2] + (h, w, v.shape[-1]))
    res["normal_values"] = normals.reshape(h, w, 3)
    res["mask"] = mask
    return res
