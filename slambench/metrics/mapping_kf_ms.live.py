"""LocalMapping ms a keyframe: the mean of the program's `LM.keyframe`
records (its span around `LocalMapping._process`) over the keyframes
the mapping thread processed in the traced window.  Moves `frame_ms_mean`."""

import statistics

TAG = "LM.keyframe"


def read(run: dict):
    samples = run["records"].get(TAG, [])
    return statistics.fmean(samples) if samples else None
