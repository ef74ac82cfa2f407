"""Setup helpers: small-matrix algebra and reference trajectories."""
