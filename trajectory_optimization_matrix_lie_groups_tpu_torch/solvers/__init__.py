"""Solvers: the lane-layout MS-iLQR pipeline (`pipeline`)."""
