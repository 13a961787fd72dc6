"""Ray/triangle tests and the hand-written device kernels."""
