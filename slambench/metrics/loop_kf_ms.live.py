"""LoopClosing ms a keyframe: the mean of the program's `LC.keyframe`
records (its span around `LoopClosing._handle`: place recognition, and a
correction or a merge when one fires) over the keyframes the loop closer
handled in the traced window.  Moves `frame_ms_mean`."""

import statistics

TAG = "LC.keyframe"


def read(run: dict):
    samples = run["records"].get(TAG, [])
    return statistics.fmean(samples) if samples else None
