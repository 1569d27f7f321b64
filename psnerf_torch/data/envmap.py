"""Environment maps for relighting: load_envmap (counterpart of
psnerf_tpu/runners/stage2.py:load_envmap), with its own Radiance RGBE
decoder and a numpy copy of OpenCV's INTER_AREA resize, so that it needs
neither cv2 nor imageio.

Formats: .npy (float32 [H, W, 3]), .png (8-bit, /255, through Pillow) and
.hdr (Radiance RGBE, flat or new-style run-length-encoded scanlines, the
two forms OpenCV writes). EXR is not read: convert it to .hdr or .npy.
"""

from __future__ import annotations

import math

import numpy as np


def read_hdr(path: str) -> np.ndarray:
    """A Radiance .hdr file as float32 RGB [H, W, 3] (the "-Y H +X W"
    orientation). A texel (r, g, b, e) is (r, g, b) * 2^(e - 136), and 0
    where e = 0, as OpenCV decodes it."""
    with open(path, "rb") as fh:
        data = fh.read()
    pos = 0

    def line():
        nonlocal pos
        end = data.index(b"\n", pos)
        text = data[pos:end].decode("ascii", "replace")
        pos = end + 1
        return text

    magic = line()
    if not magic.startswith("#?"):
        raise ValueError(f"{path}: not a Radiance file ({magic!r})")
    while True:
        text = line().strip()
        if not text:
            break
        if text.startswith("FORMAT=") and text != "FORMAT=32-bit_rle_rgbe":
            raise ValueError(f"{path}: unsupported {text}")
    dims = line().split()
    if len(dims) != 4 or dims[0] != "-Y" or dims[2] != "+X":
        raise ValueError(f"{path}: unsupported orientation {dims}")
    h, w = int(dims[1]), int(dims[3])
    body = np.frombuffer(data, np.uint8, offset=pos)
    rgbe = np.empty((h, w, 4), np.uint8)
    rle = (8 <= w <= 0x7FFF and body.size >= 4 and body[0] == 2
           and body[1] == 2 and not body[2] & 0x80)
    if not rle:
        if body.size < h * w * 4:
            raise ValueError(f"{path}: truncated pixel data")
        rgbe[:] = body[:h * w * 4].reshape(h, w, 4)
    else:
        i = 0
        for y in range(h):
            head = body[i:i + 4]
            if head.size < 4 or head[0] != 2 or head[1] != 2 \
                    or (int(head[2]) << 8 | int(head[3])) != w:
                raise ValueError(f"{path}: bad scanline header at row {y}")
            i += 4
            for c in range(4):
                x = 0
                while x < w:
                    count = int(body[i])
                    i += 1
                    if count > 128:                 # a run of one byte
                        count -= 128
                        if x + count > w:
                            raise ValueError(f"{path}: bad run at row {y}")
                        rgbe[y, x:x + count, c] = body[i]
                        i += 1
                    else:                           # literal bytes
                        if count == 0 or x + count > w:
                            raise ValueError(f"{path}: bad run at row {y}")
                        rgbe[y, x:x + count, c] = body[i:i + count]
                        i += count
                    x += count
    e = rgbe[..., 3].astype(np.int32)
    scale = np.where(e > 0, np.ldexp(np.float32(1.0), e - 136), 0.0)
    return (rgbe[..., :3].astype(np.float32)
            * scale[..., None].astype(np.float32))


def _area_weights(ssize: int, dsize: int) -> np.ndarray:
    """OpenCV's area table (computeResizeAreaTab) for shrinking one axis,
    as a [dsize, ssize] weight matrix."""
    scale = ssize / dsize
    wts = np.zeros((dsize, ssize))
    for dx in range(dsize):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, ssize - fsx1)
        sx1, sx2 = math.ceil(fsx1), math.floor(fsx2)
        sx2 = min(sx2, ssize - 1)
        sx1 = min(sx1, sx2)
        if sx1 - fsx1 > 1e-3:
            wts[dx, sx1 - 1] = np.float32((sx1 - fsx1) / cell)
        wts[dx, sx1:sx2] = np.float32(1.0 / cell)
        if fsx2 - sx2 > 1e-3:
            wts[dx, sx2] = np.float32(min(min(fsx2 - sx2, 1.0), cell) / cell)
    return wts


def _area_linear_taps(ssize: int, dsize: int):
    """OpenCV's INTER_AREA rule where an axis is not shrunk on both axes:
    linear taps (index, weight of the next texel) with sx = floor(dx *
    scale) and weight (dx + 1) - (sx + 1) / scale, fractional part."""
    inv_scale = dsize / ssize
    scale = 1.0 / inv_scale
    sx = np.empty(dsize, np.int64)
    fx = np.empty(dsize, np.float32)
    for dx in range(dsize):
        s = math.floor(dx * scale)
        f = np.float32((dx + 1) - (s + 1) * inv_scale)
        f = np.float32(0.0) if f <= 0 else np.float32(f - math.floor(f))
        if s >= ssize - 1:
            s, f = ssize - 1, np.float32(0.0)
        sx[dx], fx[dx] = s, f
    return sx, fx


def resize_area(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """cv2.resize(img, (width, height), interpolation=cv2.INTER_AREA) for a
    float32 [H, W, C] image: area-weighted averages when both axes shrink,
    OpenCV's linear rule otherwise."""
    img = np.asarray(img, np.float32)
    sh, sw = img.shape[:2]
    if (sh, sw) == (height, width):
        return img.copy()
    if sh >= height and sw >= width:
        wy, wx = _area_weights(sh, height), _area_weights(sw, width)
        out = np.einsum("ys,sxc->yxc", wy,
                        np.einsum("xs,ysc->yxc", wx, img.astype(np.float64)))
        return out.astype(np.float32)
    sx, fx = _area_linear_taps(sw, width)
    sy, fy = _area_linear_taps(sh, height)
    sx1, sy1 = np.minimum(sx + 1, sw - 1), np.minimum(sy + 1, sh - 1)
    fx, fy = fx[None, :, None], fy[:, None, None]
    one = np.float32(1.0)
    rows = img[:, sx] * (one - fx) + img[:, sx1] * fx        # [H, width, C]
    return rows[sy] * (one - fy) + rows[sy1] * fy


def _read_png(path: str) -> np.ndarray:
    """An 8-bit PNG as float RGB / 255 (gray repeated, alpha dropped)."""
    from PIL import Image

    with Image.open(path) as im:
        if im.mode.startswith("I"):
            raise ValueError(f"{path}: 16-bit PNG envmaps are not read; "
                             "use .hdr or .npy")
        return np.asarray(im.convert("RGB"), np.float32) / 255.0


def load_envmap(path: str, light_h: int = 16) -> np.ndarray:
    """Load an envmap resized to [light_h, 2 * light_h, 3] float32 RGB
    (stage2/utils/eval_utils.py:11-40)."""
    if path.endswith(".npy"):
        img = np.load(path).astype(np.float32)
    elif path.endswith(".png"):
        img = _read_png(path)
    elif path.endswith(".hdr"):
        img = read_hdr(path)
    else:
        raise ValueError(f"unsupported envmap format: {path} (use .hdr, "
                         ".png or .npy)")
    return resize_area(img, 2 * light_h, light_h)
