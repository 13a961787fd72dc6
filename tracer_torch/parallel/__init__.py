"""Rendering and gradients over several devices (``torch.distributed``)."""
