"""Small-matrix linear algebra for problem setup (counterpart of the JAX
`utils/linalg.py`)."""

import torch


def setup_inv(M):
    """Inverse of a small setup-time matrix, computed in f64 and returned in
    ``M``'s dtype and device (as the JAX package does on the host)."""
    return torch.linalg.inv(M.to(torch.float64)).to(M.dtype)
