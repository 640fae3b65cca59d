"""Share of the traced window's wall time in which nothing ran on the
device, in %: one less ``busy_s``, the union of the device's activity
intervals inside the window that recorded the device alone
(:func:`portbench.harness.traced_steps`), over ``window_s``, that window's
wall time; the same two numbers as the result's ``device``. The profiler
records each activity, and so slows the host's issue a little: the share
reads somewhat higher than it would untraced."""


def read(ctx):
    t = ctx["trace"]
    if not t or t["busy_s"] <= 0 or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
