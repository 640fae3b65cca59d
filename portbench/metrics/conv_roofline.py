"""The convolutions' share of their roofline, in %: the least time the
chip could take for the traced steps' convolutions (each call the larger of
its FLOPs over the peak and its bytes over the bandwidth;
:func:`portbench.work.step_work`) over the device time of the kernels
launched under ``aten::convolution`` and ``aten::convolution_backward``."""


def read(ctx):
    t = ctx["trace"]
    if not t or t["layer_s"]["conv"] <= 0:
        return None
    return 100.0 * ctx["work"]["conv_min_s"] * t["steps"] / t["layer_s"]["conv"]
