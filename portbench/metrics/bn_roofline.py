"""The train-mode BatchNorms' share of their roofline, in %: the bytes
their forward (read x, write y) and backward (read x and dy, write dx)
need in the traced steps over the HBM bandwidth
(:func:`portbench.work.step_work`), over the device time of the kernels
launched under the port's ``BNTrain`` and ``BNTrainBackward``."""


def read(ctx):
    t = ctx["trace"]
    if not t or t["layer_s"]["bn"] <= 0:
        return None
    return 100.0 * ctx["work"]["bn_min_s"] * t["steps"] / t["layer_s"]["bn"]
