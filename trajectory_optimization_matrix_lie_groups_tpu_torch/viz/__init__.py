"""Visualization: convergence/trajectory plots, cost landscapes, trajectory
and URDF replay (`replay.py`) and the sweep viewers (`interactive.py`)."""
