"""Front-end ms a frame: the mean, over the traced window's frames, of the
program's own CUDA-event window around each frame's front-end (its
`1.1_GrabImageStereo.extract.stream` record: the upload, the graph replay
and the copy back).  Moves `frame_ms_mean`: the front-end lies on every
live pose's path."""

import statistics

TAG = "1.1_GrabImageStereo.extract.stream"


def read(run: dict):
    samples = run["records"].get(TAG, [])
    return statistics.fmean(samples) if samples else None
