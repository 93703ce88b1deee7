"""Keyframe queue ms a keyframe: the mean of the program's `LM.queue_wait`
records (from `LocalMapping.insert_keyframe` queueing a keyframe to the
mapping thread taking it) over the traced window's keyframes.  Moves `frame_ms_mean`."""

import statistics

TAG = "LM.queue_wait"


def read(run: dict):
    samples = run["records"].get(TAG, [])
    return statistics.fmean(samples) if samples else None
