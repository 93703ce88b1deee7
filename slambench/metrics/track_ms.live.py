"""Host tracking ms a frame: the mean of the program's `2_Track` records
(its host span around `Tracking.track_frame`) over the traced window's
frames.  Moves `frame_ms_mean`."""

import statistics

TAG = "2_Track"


def read(run: dict):
    samples = run["records"].get(TAG, [])
    return statistics.fmean(samples) if samples else None
