"""The whole step's share of the chip's peak, in %: the model FLOPs a step
needs (forward, weight gradient, input gradient but the stem's, for each
pass; :func:`portbench.work.step_work`) times the untraced window's steps,
over the window's time, over the peak of the compute dtype."""


def read(ctx):
    w, work = ctx["window"], ctx["work"]
    if not w["steps"] or w["seconds"] <= 0:
        return None
    return 100.0 * work["model_flops"] * w["steps"] / w["seconds"] / work["peak_flops"]
