"""Camera, scene containers, integrator, progressive driver."""
