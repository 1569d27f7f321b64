"""The export's share of the card's peak: the operations of every view
exported in the traced window (the march of every pixel and the
visibility of every surface pixel toward every direction at bf16, the
normals at TF32) over the window."""

from benchmark import readers, work


def read(run):
    s, views = readers.traced(run)
    if s is None or "n_surface" not in run.work:
        return None
    p = run.params
    n_dirs = run.cfg["dataset_shape"]["n_lights"] + p["vis_plus_num"]
    per = []
    for n in run.work["n_surface"]:
        f = work.export_view(run.cfg, run.work["n_pixels"], n, n_dirs,
                             p["march_steps"], p["vis_steps"])
        per.append(work.least_seconds({"bf16": f["bf16"], "tf32": f["tf32"]}))
    return readers.share(sum(per) / len(per) * views, s["window_s"])
