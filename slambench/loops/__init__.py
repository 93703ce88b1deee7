"""Traffic loops, one module per kind, named by a mix's `loop` key.  Each
has `warm_up(system, sensor, lap, mix, fps) -> k0`, the mix's warm-up
frames through the loop's own entry, and `run(system, sensor, lap, k0, mix,
fps, seconds, sampler, tracer) -> window`, the measured window.  A loop
hands each frame to the System through the configuration's sensor
(`sensor.track(system, lap, k, timestamp)`, `sensors/__init__.py`); `fps`
is the camera's `Camera.fps`, which stamps the frames."""
