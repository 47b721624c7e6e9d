"""Checkpoint packages."""
