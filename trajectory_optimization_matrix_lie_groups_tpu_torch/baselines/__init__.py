"""Baseline formulations for cross-checking (counterpart of the JAX
`baselines/` package): the embedded-Euclidean baseline families
(`embedded.py`), solved with the port's own Euclidean iLQR."""
