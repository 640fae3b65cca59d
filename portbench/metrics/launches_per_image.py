"""Kernels launched on the device in the traced steps, per image: how much
the host has to issue for each image. An exact count."""


def read(ctx):
    t = ctx["trace"]
    if not t or not t["launches"]:
        return None
    return t["launches"] / (ctx["work"]["images"] * t["steps"])
