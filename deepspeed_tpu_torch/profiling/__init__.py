"""Offline renderers of a run's telemetry (``profiling/report.py``)."""
