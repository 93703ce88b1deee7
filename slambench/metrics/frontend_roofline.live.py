"""The front-end's kernels' share of their roofline, in %: the least time
of the traced frames' front-end work (`slambench.work.least_seconds`,
counted per stage from the cell's shapes and feature count against the
H100's published peaks) over the device time of the kernels their
front-ends launched.  Moves `frame_ms_mean`."""

RANGE = "1.1_GrabImageStereo.extract"


def read(run: dict):
    tr = run["trace"]
    if tr is None:
        return None
    frames = tr.work_of(RANGE)
    kernel_us = sum(e - s for work in frames for s, e, _, cat in work if cat == "kernel")
    if not frames or kernel_us <= 0:
        return None
    return 100.0 * run["least_s"] * len(frames) / (kernel_us * 1e-6)
