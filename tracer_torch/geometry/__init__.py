"""Geometry: OBJ/MTL loading, procedural stand-ins, device mesh buffers."""
