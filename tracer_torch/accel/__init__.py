"""Acceleration structures: LBVH, treelet cut, flat frustum engine."""
