"""SDPS-Net's operations at the published widths, from a configuration's
own layer lists (benchmark/configs/sdps_bear.json), and the device time of
the convolution kernels that compute them on the card.

A convolution of cin to cout channels with a k x k kernel is 2 cin cout k^2
operations an output pixel; a k4 s2 transposed one 2 cin cout 16 an input
pixel. LCNet runs every layer once a light at test_hw (its classifier on
each light's features and the fused ones). NENet runs its extractor once a
light at the padded crop (the strides are exact there: the crop's sides
are multiples of 4) and its regressor once a view, after the max over the
lights. Bias adds, activations, the max and the normalisation are not
counted. Every product is float32, counted at the TF32 peak (work.py).
"""

from __future__ import annotations


def conv_kernel_seconds(summary: dict) -> tuple:
    """(seconds, launches) of the window's convolution kernels: every
    kernel but PyTorch's own (at::native: the activations, the max over the
    lights, the concatenations, the divisions), the copies and the sets.
    For float32 without TF32 cuDNN picks, on this card, implicit-GEMM
    forward kernels (sm80_xmma_fprop_implicit_gemm_*), FFT convolutions
    (DSE::regular_fft_*, DSE::vector_fft*, pointwise_mult_and_sum_complex)
    and, for the transposed convolutions, its dgrad engines
    (cudnn::detail::dgrad_engine)."""
    t, n = 0.0, 0
    for name, _, dur in summary["kernels"]:
        if "at::native" in name or name.startswith(("Memcpy", "Memset")):
            continue
        t += dur / 1e6
        n += 1
    return t, n


def _out(n: int, k: int, stride: int, pad: int) -> int:
    return (n + 2 * pad - k) // stride + 1


def lcnet_light(cfg: dict) -> float:
    """Operations of one light through LCNet at test_hw."""
    lc = cfg["lcnet"]
    h, w = lc["test_hw"]
    ops, cin = 0.0, lc["c_in"]
    for cout, stride in lc["feat"]:
        h, w = _out(h, 3, stride, 1), _out(w, 3, stride, 1)
        ops += 2.0 * cin * cout * 9 * h * w
        cin = cout
    cin *= 2
    for cout, stride in lc["cls"]:
        h, w = _out(h, 3, stride, 1), _out(w, 3, stride, 1)
        ops += 2.0 * cin * cout * 9 * h * w
        cin = cout
    hw = lc["head_width"]
    for n in (lc["dirs_cls"], lc["dirs_cls"], lc["ints_cls"]):
        ops += 2.0 * (cin * hw + hw * n) * h * w
    return ops


def nenet_pixel(cfg: dict) -> tuple:
    """(operations a light, operations once a view) of NENet a crop
    pixel."""
    ne = cfg["nenet"]
    scale, ops, cin = 1.0, 0.0, ne["c_in"]
    for cout, stride in ne["feat"]:
        scale /= stride * stride
        ops += 2.0 * cin * cout * 9 * scale
        cin = cout
    ops += 2.0 * cin * ne["feat_deconv"] * 16 * scale
    scale *= 4
    ops += 2.0 * ne["feat_deconv"] * ne["feat_out"] * 9 * scale
    once, cin = 0.0, ne["feat_out"]
    for cout in ne["reg"]:
        once += 2.0 * cin * cout * 9 * scale
        cin = cout
    once += 2.0 * cin * ne["reg_deconv"] * 16 * scale
    scale *= 4
    once += 2.0 * ne["reg_deconv"] * ne["out"] * 9 * scale
    return ops, once


def conv_flops(cfg: dict, lcnet_px, nenet_px):
    """Operations of one view from the pixels each net ran on (lights x
    test_hw pixels, lights x crop pixels), or None without them."""
    if lcnet_px is None or nenet_px is None:
        return None
    th, tw = cfg["lcnet"]["test_hw"]
    n_l = cfg["dataset_shape"]["n_lights"]
    per_light, once = nenet_pixel(cfg)
    return (lcnet_px / (th * tw) * lcnet_light(cfg)
            + nenet_px * per_light + nenet_px / n_l * once)
