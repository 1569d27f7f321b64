"""K1's share of its roofline in the traced export window: the march's
and the visibility's occupancy logits (operations at bf16; each point's
position in and logit out once) over K1's device time."""

from benchmark import readers, work


def read(run):
    s, views = readers.traced(run)
    if s is None or "n_surface" not in run.work:
        return None
    secs, n = readers.kernel_seconds(s, ("occ_kernel",))
    if not n:
        return None
    p = run.params
    n_dirs = run.cfg["dataset_shape"]["n_lights"] + p["vis_plus_num"]
    u = work.Unisurf(run.cfg["model"])
    per = []
    for ns in run.work["n_surface"]:
        k1 = work.export_view(run.cfg, run.work["n_pixels"], ns, n_dirs,
                              p["march_steps"], p["vis_steps"])["k1_points"]
        per.append(work.least_seconds({"bf16": k1 * u.logit}, k1 * 16))
    return readers.share(sum(per) / len(per) * views, secs)
