"""Plot a metrics.jsonl stream to a PNG of loss curves, one panel per
scalar, drawn with Pillow (counterpart of psnerf_tpu/cli/plot_metrics.py,
which draws with matplotlib).

Usage: python -m psnerf_torch.cli.plot_metrics <metrics.jsonl> [out.png]
"""

from __future__ import annotations

import json
import math
import sys
from collections import defaultdict

from PIL import Image, ImageDraw

PANEL_W, PANEL_H = 440, 330      # matplotlib's 4 x 3 inch panel at 110 dpi
MARGIN_L, MARGIN_R, MARGIN_T, MARGIN_B = 70, 15, 28, 30
COLS = 3


def read_series(path: str) -> dict:
    """{scalar name: ([it], [value])} of a MetricLogger JSONL stream."""
    series = defaultdict(lambda: ([], []))
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            it = rec.pop("it")
            rec.pop("wall", None)
            for k, v in rec.items():
                series[k][0].append(it)
                series[k][1].append(v)
    return dict(series)


def _fmt(v: float) -> str:
    return f"{v:.4g}"


def _text(draw: ImageDraw.ImageDraw, x: float, y: float, s: str,
          h: str = "l", v: str = "t") -> None:
    """Text aligned at (x, y): h in l/m/r, v in t/b. Aligned by its bounding
    box, so that Pillow's bitmap font (no anchors) works too."""
    x0, y0, x1, y1 = draw.textbbox((0, 0), s)
    dx = {"l": 0, "m": (x1 - x0) / 2, "r": x1 - x0}[h] + x0
    dy = {"t": 0, "b": y1 - y0}[v] + y0
    draw.text((x - dx, y - dy), s, fill="black")


def draw_panel(draw: ImageDraw.ImageDraw, x0: int, y0: int, title: str,
               xs: list, ys: list) -> None:
    """One panel at (x0, y0): the title, a framed plot area with a light
    grid, the curve through the finite points, and the axes' end values."""
    left, top = x0 + MARGIN_L, y0 + MARGIN_T
    right, bottom = x0 + PANEL_W - MARGIN_R, y0 + PANEL_H - MARGIN_B
    _text(draw, x0 + PANEL_W // 2, y0 + 8, title, "m")
    draw.rectangle([left, top, right, bottom], outline="black")
    for i in range(1, 4):
        gx = left + (right - left) * i // 4
        gy = top + (bottom - top) * i // 4
        draw.line([gx, top, gx, bottom], fill=(225, 225, 225))
        draw.line([left, gy, right, gy], fill=(225, 225, 225))
    pts = [(x, y) for x, y in zip(xs, ys) if math.isfinite(y)]
    if not pts:
        return
    xmin, xmax = min(p[0] for p in pts), max(p[0] for p in pts)
    ymin, ymax = min(p[1] for p in pts), max(p[1] for p in pts)
    xspan, yspan = (xmax - xmin) or 1.0, (ymax - ymin) or 1.0
    px = [(left + (x - xmin) / xspan * (right - left),
           bottom - (y - ymin) / yspan * (bottom - top)) for x, y in pts]
    if len(px) > 1:
        draw.line(px, fill=(31, 119, 180), width=1)
    else:
        (cx, cy), = px
        draw.ellipse([cx - 2, cy - 2, cx + 2, cy + 2], fill=(31, 119, 180))
    _text(draw, left - 4, top, _fmt(ymax), "r")
    _text(draw, left - 4, bottom, _fmt(ymin), "r", "b")
    _text(draw, left, bottom + 4, _fmt(xmin))
    _text(draw, right, bottom + 4, _fmt(xmax), "r")


def plot_series(series: dict, out: str) -> tuple[int, int]:
    """Write the panels of `series` (sorted by name, COLS to a row) to the
    PNG `out`; returns (rows, cols)."""
    keys = sorted(series)
    cols = min(COLS, max(1, len(keys)))
    rows = max(1, (len(keys) + cols - 1) // cols)
    img = Image.new("RGB", (cols * PANEL_W, rows * PANEL_H), "white")
    draw = ImageDraw.Draw(img)
    for i, k in enumerate(keys):
        draw_panel(draw, (i % cols) * PANEL_W, (i // cols) * PANEL_H, k,
                   *series[k])
    img.save(out)
    return rows, cols


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    path = argv[0]
    out = argv[1] if len(argv) > 1 else path.replace(".jsonl", ".png")
    plot_series(read_series(path), out)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
