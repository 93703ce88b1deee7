"""Sensors, one module per kind, named by a configuration's `sensor` key.

A sensor is what a configuration's frames are and how the System takes
them: its camera model, its rig, its IMU if it has one.  Each module has

- `render_lap(cfg, seed, device) -> harness.Lap`: the lap's frames, rendered
  from `seed`, with the left camera's ground truth and whatever its entry
  needs per frame (such as the IMU samples between frames);
- `make_system(cfg, vocabulary, device)`: the threaded System as
  `System.from_files` would build it for this sensor;
- `track(system, lap, k, timestamp)`: the entry-point call for lap frame k
  (`track_stereo`, `track_stereo(..., imu=...)`, `track_monocular`,
  `track_rgbd`), returning its pose or None;
- `reference_of(cfg, device, float_dtype) -> ref`: the plain reference of
  the frame's features; `ref(views)` takes lap frame k's views
  (`harness.reference_block`) and returns their packed block, and
  `ref.device` is where it runs;
- `training_descriptors(cfg, lap, ks, device) -> (N, 32) uint8`: the
  descriptors the vocabulary is trained on, from lap frames `ks`;
- `FIELDS`: the attributes of the tracker's frame that the check samples;
- `unpack(block) -> {field: array}`: a packed block as the tracker's frame
  holds it;
- `features_differ(block, got) -> int`: features that differ between the
  reference's block and the sampled `got`;
- `least_seconds(cfg)`: the least time of one frame's front-end on the
  card, for `frontend_roofline`.
"""

INTERFACE = ("render_lap", "make_system", "track", "reference_of", "training_descriptors",
             "FIELDS", "unpack", "features_differ", "least_seconds")
