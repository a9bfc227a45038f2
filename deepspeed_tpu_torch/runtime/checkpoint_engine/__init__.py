"""Checkpoint save, verified load and offline consolidation for the engine."""
