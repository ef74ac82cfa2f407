"""Lie-group operations: batch-first closed forms (`so3`, `se3`, `group`),
the batch-last lane primitives (`lane_lie`) and the stage linearization
with its kernel (`linearize`)."""
