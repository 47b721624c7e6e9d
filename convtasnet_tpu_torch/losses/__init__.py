"""Training objectives."""
