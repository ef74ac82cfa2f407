"""Small-matrix linear algebra for problem setup (counterpart of the JAX
`utils/linalg.py`)."""

import torch


def setup_inv(M):
    """Inverse of a small setup-time matrix, computed in f64 and returned in
    ``M``'s dtype and device (as the JAX package does on the host)."""
    return torch.linalg.inv(M.to(torch.float64)).to(M.dtype)


def chol_factor(A, n):
    """n x n Cholesky factorization of A (n, n, *b), matrix axes first:
    L (n, n, *b) with L[i][j] (i >= j) set, L[j][j] the square root of the
    pivot.  Column by column, each column's rows at once: entry (i, j) is
    A[i, j] - L[i, 0] L[j, 0] - L[i, 1] L[j, 1] - ... in that order, then
    times 1 / L[j][j] (the same operations as a loop over the entries, in
    about n^2 / 2 tensor operations instead of n^3 / 6)."""
    L = torch.empty_like(A)
    for j in range(n):
        s = A[j:, j]
        for k in range(j):
            s = s - L[j:, k] * L[j, k]
        L[j, j] = torch.sqrt(s[0])
        L[j + 1:, j] = s[1:] * (1.0 / L[j, j])
    return L


def chol_solve(L, Bm, n):
    """Solve (L L^T) X = Bm for Bm (n, p, *b), ``L`` from `chol_factor`, by
    forward and back substitution; returns X (n, p, *b).  The forward
    substitution updates the rows below each Y[k] at once, which subtracts
    the terms of each row in the same order (k ascending) as a loop over
    the rows."""
    Y = [None] * n
    S = Bm
    for k in range(n):
        Y[k] = S[0] / L[k][k]
        if k + 1 < n:
            S = S[1:] - L[k + 1:, k].unsqueeze(1) * Y[k]
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
