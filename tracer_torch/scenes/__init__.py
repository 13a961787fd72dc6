"""Scene registry and builder."""
