"""Host tracking's waits, ms a frame: the mean of the program's
`2_Track.offcpu` records (`2_Track`'s wall time minus the tracker
thread's CPU time over it: the time it waited on a lock, the interpreter
lock or anything else) over the traced window's frames.  Moves `frame_ms_mean`."""

import statistics

TAG = "2_Track.offcpu"


def read(run: dict):
    samples = run["records"].get(TAG, [])
    return statistics.fmean(samples) if samples else None
