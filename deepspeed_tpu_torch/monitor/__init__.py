"""Experiment monitors: the TensorBoard, W&B and CSV writers (``monitor.py``)."""
