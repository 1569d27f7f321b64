"""psnerf_torch's SDPS-Net on one view (preprocess.runner.sdps_view) on
the CPU: LCNet's logits and NENet's normals against the benchmark's plain
reference (benchmark/reference/sdps.py: im2col convolutions, its own crop
and rescale) on seeded weights at crops of two sizes; sdps_view against
what run_sdps writes for the same views, bit for bit; its spans and
counters in a traced call; the benchmark's operation count against the
port's own layers; the reference's light codec against the port's; and
the reference's independence from the program."""

import ast
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmark.reference import sdps as ref
from benchmark.work_sdps import conv_flops
from psnerf_torch.data.synthetic import generate_synthetic_scene
from psnerf_torch.preprocess import runner, sdps
from psnerf_torch.train.checkpoints import load_module
from psnerf_torch.utils import profiling

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
CFG = json.loads((ROOT / "benchmark" / "configs" / "sdps_bear.json")
                 .read_text())
NEAR_TIE = 1e-3     # top-two logit gap, as a fraction of the head's max


@pytest.fixture(scope="module")
def nets():
    """The reference's seeded weights and the port's modules holding
    them, loaded as load_sdps_net loads a converted npz."""
    w = ref.init_weights(CFG, 2_147_483_659)
    flat = lambda d: {k: v.numpy() for k, v in d.items()}
    lc = load_module(sdps.LCNet(device="cpu"), flat(w["lcnet"])).eval()
    ne = load_module(sdps.NENet(device="cpu"), flat(w["nenet"])).eval()
    return w, lc, ne


def _view(seed, hw, box, n_l=8):
    rng = np.random.default_rng(seed)
    mask = np.zeros(hw, np.float32)
    mask[box[0]:box[2], box[1]:box[3]] = 1.0
    imgs = rng.uniform(size=(n_l, *hw, 3)).astype(np.float32)
    return imgs * (mask[None, ..., None] > 0.5), mask


# the crops: 32 x 36 (both sides multiples of 4) and 37 x 46 (padded to
# 40 x 48 by pms_transforms' quirk)
@pytest.mark.parametrize("hw,box", [((60, 70), (20, 20, 23, 27)),
                                    ((61, 75), (16, 20, 24, 37))])
def test_nets_match_the_plain_reference(nets, hw, box):
    w, lc, ne = nets
    imgs, mask = _view(3, hw, box)
    got = runner.sdps_view(lc, ne, imgs, mask)
    cropped, cmask, crop, imgs_lc, mask_lc = runner.sdps_inputs(imgs, mask)
    with torch.no_grad():
        logits = lc.logits(torch.as_tensor(imgs_lc.transpose(0, 3, 1, 2)),
                           torch.as_tensor(mask_lc[None]))
        want = ref.view(w, CFG, imgs, mask, got["dirs"], got["intens"],
                        "cpu")
    assert tuple(int(x) for x in crop) == want["box"]
    assert tuple(want["normal"].shape[:2]) == cropped.shape[1:3]
    # logits within 1e-5 of each head's largest (measured ~2e-6: the
    # reference's float32 rescale against the port's float64 one, and the
    # im2col sums' order), classes equal away from near-ties
    for h in ("dir_x", "dir_y", "ints"):
        g, r = logits[h].double(), want["logits"][h].double()
        scale = float(r.abs().max())
        assert float((g - r).abs().max()) <= 1e-5 * scale, h
        top2 = torch.topk(r, 2, dim=1).values
        clear = (top2[:, 0] - top2[:, 1]) > NEAR_TIE * scale
        assert torch.equal(g.argmax(1)[clear], r.argmax(1)[clear]), h
    # normals on the mask: 5e-5 max, 1e-6 mean (measured up to 1.3e-5 max
    # over three seeds; each side lies up to ~9e-6 from a float64 run of the
    # same net where the raw normal is short and its normalization
    # amplifies the rounding), as test_torch_preprocess holds the port to JAX
    n = got["normal"][crop[0]:crop[2], crop[1]:crop[3]]
    h, wd = n.shape[:2]
    m = want["mask"].numpy()[:h, :wd] > 0.5
    err = np.abs(n - want["normal"].numpy()[:h, :wd])[m]
    assert err.max() < 5e-5 and err.mean() < 1e-6, (err.max(), err.mean())
    assert not got["normal"][:crop[0]].any()
    assert np.allclose(np.linalg.norm(n[m], axis=-1), 1, atol=1e-5)


def _scene(tmp_path):
    d = str(tmp_path / "scene")
    generate_synthetic_scene(d, n_views=2, n_test=0, n_lights=4, hw=(48, 52))
    return d


def test_sdps_view_matches_run_sdps(tmp_path, nets):
    """run_sdps writes what sdps_view returns: outnpy and the lights bit
    for bit, the crop sizes in its timings."""
    _, lc, ne = nets
    d = _scene(tmp_path)
    timings = {}
    out = runner.run_sdps(d, lc, ne, out_dir=str(tmp_path / "out"),
                          timings=timings)
    dirs = np.load(os.path.join(out, "light_direction_pred.npy"))
    ints = np.load(os.path.join(out, "light_intensity_pred.npy"))
    assert sorted(timings) == ["crop_hw", "crop_s", "lcnet_s", "nenet_s",
                               "read_s", "write_s"]
    for vi in range(2):
        view = f"view_{vi + 1:02d}"
        r = runner.sdps_view(lc, ne, *runner.read_view(d, view))
        np.testing.assert_array_equal(
            np.load(os.path.join(out, "outnpy", view + ".npy")), r["normal"])
        np.testing.assert_array_equal(dirs[vi], r["dirs"])
        np.testing.assert_array_equal(ints[vi], r["intens"])
        assert r["normal"].dtype == np.float32 and r["dirs"].shape == (4, 3)
        cropped = runner.sdps_inputs(*runner.read_view(d, view))[0]
        assert timings["crop_hw"][vi] == list(cropped.shape[1:3]) \
            == r["timings"]["crop_hw"]


def test_traced_sdps_view_records_its_spans_and_counters(tmp_path, nets):
    _, lc, ne = nets
    imgs, mask = _view(5, (61, 75), (16, 20, 24, 37), n_l=3)
    with profiling.trace(str(tmp_path / "trace")):
        runner.sdps_view(lc, ne, imgs, mask, test_hw=(64, 64))
        spans = profiling.spans()
        counters = profiling.counters()
    by = {s.name: s for s in spans}
    assert set(by) == {"sdps.view", "sdps.prepare", "sdps.lcnet",
                       "sdps.nenet", "sdps.readback"}
    root = by["sdps.view"]
    assert root.root == root.id and root.cause is None
    for name in ("sdps.prepare", "sdps.lcnet", "sdps.nenet",
                 "sdps.readback"):
        assert by[name].cause == root.id and by[name].root == root.id
        assert root.start_ns <= by[name].start_ns <= by[name].end_ns \
            <= root.end_ns
    cropped = runner.sdps_inputs(imgs, mask)[0]
    assert cropped.shape[1:3] == (40, 48)
    assert counters["sdps.nenet_px"] == 3 * 40 * 48
    assert counters["sdps.lcnet_px"] == 3 * 64 * 64
    # the lights (dirs, intens) and the normals: the read-backs
    assert counters["d2h_bytes"] == 4 * (3 * 3 + 3 + 3 * 40 * 48)
    assert (tmp_path / "trace").is_dir()


def test_traced_run_sdps_records_its_disk_legs(tmp_path, nets):
    _, lc, ne = nets
    d = _scene(tmp_path)
    with profiling.trace(str(tmp_path / "trace")):
        runner.run_sdps(d, lc, ne, out_dir=str(tmp_path / "out"))
        names = [s.name for s in profiling.spans()]
    for name in ("sdps.read", "sdps.write", "sdps.view"):
        assert names.count(name) == 2, name


def test_operation_count_matches_the_port_layers(nets):
    """work_sdps's count of one view equals the products of every
    convolution the port's LCNet and NENet run, counted from their
    weights and output shapes by forward hooks."""
    _, lc, ne = nets
    total = []

    def hook(mod, args, out):
        w = mod.w
        if isinstance(mod, sdps.Deconv):        # [cin, cout, k, k]
            total.append(2.0 * w[0].numel() * w.shape[0] * args[0][0, 0]
                         .numel() * args[0].shape[0])
        else:                                   # [cout, cin, k, k]
            total.append(2.0 * w[0].numel() * out.numel())

    hooks = [m.register_forward_hook(hook) for net in (lc, ne)
             for m in net.modules() if isinstance(m, (sdps.Conv,
                                                      sdps.Deconv))]
    try:
        imgs, mask = _view(7, (61, 75), (16, 20, 24, 37), n_l=5)
        cropped = runner.sdps_inputs(imgs, mask)[0]
        runner.sdps_view(lc, ne, imgs, mask)
    finally:
        for h in hooks:
            h.remove()
    cfg = dict(CFG, dataset_shape=dict(CFG["dataset_shape"], n_lights=5))
    want = conv_flops(cfg, 5 * 128 * 128, 5 * cropped.shape[1]
                      * cropped.shape[2])
    assert sum(total) == pytest.approx(want, rel=1e-12)


def test_reference_codec_matches_the_port_on_every_class():
    """The reference's float64 restatement of the published codec and the
    port's float32 decoding agree on every azimuth and elevation pair and
    every intensity class, well inside s0_sdps_bear's 1e-6 limits."""
    n, n_i = CFG["lcnet"]["dirs_cls"], CFG["lcnet"]["ints_cls"]
    x, y = torch.meshgrid(torch.arange(n), torch.arange(n), indexing="ij")
    x, y = x.reshape(-1), y.reshape(-1)
    c = torch.arange(n * n) % n_i
    logits = {"dir_x": F.one_hot(x, n).double(),
              "dir_y": F.one_hot(y, n).double(),
              "ints": F.one_hot(c, n_i).double()}
    dirs, intens = ref.lights(logits, CFG)
    got_dirs = sdps.spherical_class_to_dirs(x, y, n).double()
    got_intens = sdps.class_to_light_ints(c, n_i).double()
    assert float((got_dirs - dirs).abs().max()) < 5e-7
    assert float((got_intens - intens).abs().max()) < 5e-7
    assert torch.allclose(dirs.norm(dim=1), torch.ones(n * n,
                                                       dtype=torch.double))


@pytest.mark.parametrize("stride,k,pad", [(1, 3, 1), (2, 3, 1), (1, 1, 0)])
def test_reference_layers_match_torch(stride, k, pad):
    """The reference's im2col convolution and col2im transposed one are
    torch's conv2d and conv_transpose2d(k4, s2, p1)."""
    g = torch.Generator().manual_seed(stride * 10 + k)
    x = torch.randn((2, 5, 13, 10), generator=g)
    w = torch.randn((7, 5, k, k), generator=g)
    b = torch.randn((7,), generator=g)
    torch.testing.assert_close(ref.conv(x, w, b, stride, pad),
                               F.conv2d(x, w, b, stride, pad),
                               rtol=1e-5, atol=1e-5)
    wd = torch.randn((5, 3, 4, 4), generator=g)
    torch.testing.assert_close(ref.deconv(x, wd),
                               F.conv_transpose2d(x, wd, stride=2, padding=1),
                               rtol=1e-5, atol=1e-5)


def _roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and node.args
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")):
            roots.add("<dynamic>")
    return roots


@pytest.mark.parametrize("name", ["sdps.py", "relight.py"])
def test_reference_imports_nothing_of_the_program(name):
    roots = _roots(ROOT / "benchmark" / "reference" / name)
    assert not roots & {"psnerf_torch", "psnerf_tpu", "jax", "jaxlib",
                        "flax", "<dynamic>"}
    assert roots <= {"__future__", "benchmark", "math", "numpy", "torch"}
