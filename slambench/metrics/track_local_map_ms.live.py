"""Local-map tracking ms a frame: the mean of the program's
`2.2_Track.local_map` records (its span around
`Tracking._track_local_map`) over the traced window's tracked frames.  Moves `frame_ms_mean`."""

import statistics

TAG = "2.2_Track.local_map"


def read(run: dict):
    samples = run["records"].get(TAG, [])
    return statistics.fmean(samples) if samples else None
