"""Two-view geometry: epipolar primitives, the 5-point solver, RANSAC and
pose metrics (port of `gim_tpu/geometry/`)."""
