"""Traffic loops, one module per kind, named by a mix's `loop` key.  Each
has `warm_up(system, lap, mix, fps) -> k0`, the mix's warm-up frames
through the loop's own entry, and `run(system, lap, k0, mix, fps, seconds,
sampler, tracer) -> window`, the measured window; `fps` is the camera's
`Camera.fps`, which stamps the frames."""
