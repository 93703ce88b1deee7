"""Front-end idle ms a frame: per traced frame, the span from the first to
the last device operation its front-end queued (the work the launches
inside the program's `1.1_GrabImageStereo.extract` range queued) minus the
time the card was busy with them, averaged: the launch gap inside the
front-end.  Moves `frame_ms_mean`."""

import statistics

from slambench.trace import covered

RANGE = "1.1_GrabImageStereo.extract"


def read(run: dict):
    tr = run["trace"]
    if tr is None:
        return None
    idle = [
        (max(e for _, e, *_ in work) - min(s for s, *_ in work) - covered(
            (s, e) for s, e, *_ in work)) * 1e-3
        for work in tr.work_of(RANGE)
    ]
    return statistics.fmean(idle) if idle else None
