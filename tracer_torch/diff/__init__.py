"""Differentiable rendering (port of ``tracer.diff``)."""
