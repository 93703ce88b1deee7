"""Map-lock wait ms a frame: the mean of the program's `2.0_Track.map_lock`
records (from the tracker asking for the current map's `update_lock`,
which LocalMapping and LoopClosing take, to holding it; retries after a
merge summed) over the traced window's frames.  Moves `frame_ms_mean`."""

import statistics

TAG = "2.0_Track.map_lock"


def read(run: dict):
    samples = run["records"].get(TAG, [])
    return statistics.fmean(samples) if samples else None
