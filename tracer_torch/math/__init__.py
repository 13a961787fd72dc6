"""Vector math."""
