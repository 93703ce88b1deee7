"""Closed laps, one module per kind: `poses(lap, k)` gives the camera-in-world
rotations (N, 3, 3) and centres (N, 3), float64 numpy, of the (fractional)
frame indices k; frame k + lap["frames"] is frame k again."""
