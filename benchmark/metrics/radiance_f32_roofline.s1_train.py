"""K2/K3-f32's share of their roofline in the traced window: the least
time the radiance pass's forward and backward need (operations at TF32;
inputs read and outputs written once) over the device time of the f32
radiance kernels (forward, the split prologue, sweep, weight gradients,
slot reduction)."""

from benchmark import readers, work

KERNELS = ("fwd_kernel", "split_kernel", "sweep_kernel", "wgrad_kernel",
           "ordered_sum_kernel")


def read(run):
    s, steps = readers.traced(run)
    if s is None:
        return None
    secs, n = readers.kernel_seconds(s, KERNELS)
    if not n:
        return None
    f = work.unisurf_step(run.cfg)
    r, t = run.cfg["rendering"], run.cfg["training"]
    pts = t["n_training_points"] * (r["num_points_in"] + r["num_points_out"])
    u = work.Unisurf(run.cfg["model"])
    # points and ray directions in, rgb and alpha out, their gradients in;
    # the weights in and their gradients out
    nbytes = pts * 4 * (3 + 3 + 4 + 4) + 2 * 4 * u.n_params
    least = work.least_seconds({"tf32": f["radiance"]}, nbytes)
    return readers.share(least * steps, secs)
