"""Visualization: convergence/trajectory plots and cost landscapes."""
