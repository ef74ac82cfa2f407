// The argument blocks of B5 and B6, shared by polish.cu (the tuned
// instances, nu = 6 and 4) and polish_nu.cu (their instances at any other nu
// up to 12).
#pragma once

#include "common.cuh"
#include "stage.cuh"

namespace traopt {

// B5's arguments.
struct RiccatiMxArgs {
  const double *Fx, *d, *lx, *lu;  // (N, 12, 12, B), (N, 12, B), (N, 12, B), (N, nu, B)
  const float *lxx, *luual;        // (N, 12, 12, B), (N, nu, B) or null
  const double* VxN;               // (12, B) terminal V_x
  const float* VxxN;               // (12, 12, B) terminal V_xx
  const double* fu2;               // (6, nu)
  const float *fu2_32, *Luu;       // (6, nu), (nu, nu)
  int glow;
  float *k, *K;                    // (N, nu, B), (N, nu, 12, B)
  double* gvec;                    // (N, nu, B) = Q_u
  int N, B;
};

// B6's arguments.
struct RolloutMxArgs {
  const double *qR, *qp, *xi, *u;  // nominal (N+1, ..., B), (N, nu, B)
  const float *k, *K;              // gains (N, nu, B), (N, nu, 12, B)
  const double *d, *fqR, *fqp, *fxi;  // nominal linearization (N, ..., B)
  Consts<double> c;
  double *oR, *op, *oxi, *ou;      // new trajectory (N+1, ...), controls
  double *efqR, *efqp, *efxi;      // dynamics evaluations (N, ..., B)
  int N, B;
};

}  // namespace traopt
