"""Scene generation from a seed."""
