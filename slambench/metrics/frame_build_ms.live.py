"""Frame assembly ms a frame: the mean of the program's `1.2_Frame` records
(its span around the tracker's `Frame`: the constructor, the image
bounds, the bag-of-words transform, IMU preintegration) over the traced
window's frames.  Moves `frame_ms_mean`."""

import statistics

TAG = "1.2_Frame"


def read(run: dict):
    samples = run["records"].get(TAG, [])
    return statistics.fmean(samples) if samples else None
