"""The stage-2 step's share of the card's peak: the model's operations of
every step in the traced window (the heads and their jittered copies
trained, the rendering lights' visibility forward, the vis_plus rows'
visibility trained, all float32 at TF32) over the window."""

from benchmark import readers, work


def read(run):
    s, steps = readers.traced(run)
    if s is None or "num_pixels" not in run.work:
        return None
    f = work.psnet_step(run.cfg, run.work["num_pixels"],
                        run.work["light_bs"], run.work["vis_train_num"])
    return readers.share(work.least_seconds(f) * steps, s["window_s"])
