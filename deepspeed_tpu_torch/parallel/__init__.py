"""Rank topology and the data-parallel grid over process groups."""
