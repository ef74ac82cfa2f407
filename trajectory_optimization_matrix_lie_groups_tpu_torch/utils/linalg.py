"""Small-matrix linear algebra for problem setup (counterpart of the JAX
`utils/linalg.py`)."""

import torch


def setup_inv(M):
    """Inverse of a small setup-time matrix, computed in f64 and returned in
    ``M``'s dtype and device (as the JAX package does on the host)."""
    return torch.linalg.inv(M.to(torch.float64)).to(M.dtype)


def chol_factor(A, n):
    """Unrolled n x n Cholesky factorization of A (n, n, *b), matrix axes
    first: a list of lists L[i][j] (i >= j) of (*b) tensors, L[j][j] the
    square root of the pivot."""
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = A[j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        L[j][j] = torch.sqrt(s)
        inv = 1.0 / L[j][j]
        for i in range(j + 1, n):
            s = A[i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv
    return L


def chol_solve(L, Bm, n):
    """Solve (L L^T) X = Bm for Bm (n, p, *b), ``L`` from `chol_factor`, by
    forward and back substitution; returns X (n, p, *b)."""
    Y = [None] * n
    for i in range(n):
        s = Bm[i]
        for k in range(i):
            s = s - L[i][k] * Y[k]
        Y[i] = s / L[i][i]
    X = [None] * n
    for i in reversed(range(n)):
        s = Y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * X[k]
        X[i] = s / L[i][i]
    return torch.stack(X)


def chol_solve_psd(A, B):
    """Solve A X = B for symmetric positive definite A (..., n, n), B
    (..., n, m) or (..., n): `chol_factor` and `chol_solve` with the matrix
    axes moved first (n small)."""
    vec = B.dim() == A.dim() - 1
    if vec:
        B = B[..., None]
    n = A.shape[-1]
    first = lambda x: x.movedim((-2, -1), (0, 1))
    X = chol_solve(chol_factor(first(A), n), first(B), n).movedim((0, 1), (-2, -1))
    return X[..., 0] if vec else X
