"""Dynamics and cost parameter containers (SE(3) free body, rigid body with
gravity, drone) and their step functions."""
