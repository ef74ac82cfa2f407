#!/usr/bin/env python3
"""Where the drone's kernel-vs-plain gate sits: the J readings that
`chip_smoke.py`'s `solve_fast` drone check compares with 1e-4, beside what
f32 rounding alone gives and what a faulty B13 gives.

The drone on screw-200 (`tasks/al_bench.screw200_model(drone=True)`,
B13 at (nx, nu) = (12, 4)), f32, 12 iterations, batch seed 0 as in
`chip_smoke.py`.  The metric is chip_smoke's: max over lanes 0..255 of
|J - J_ref| / |J_ref|.  Readings, each against the plain f32 solve of the
host's copy of lanes 0..255 unless named:

- ``sound``: the solve on B13 (the gate's reading);
- ``plain_f32_vs_plain_f64``: the host's plain f32 solve against its plain
  f64 solve from the same initial states (f32 rounding alone), and
  ``sound_vs_plain_f64``;
- ``faults``: the solve on B13 with a planted fault, B13 given one stage's
  Fu zeroed (``Fu0@t``) or scaled by 0.99 (``Fu*0.99@t``); the code under
  test is not changed, only the arrays handed to the kernel.

    python3 scripts/fast_gate_margin.py [--device cuda|cpu] [--batch B] [--horizon N]

Prints one JSON line.  Runs on the card (the kernels are built at first use)
unless ``--device cpu`` (the plain versions, for a rehearsal at a small
``--batch`` and ``--horizon``).
"""

import argparse
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from trajectory_optimization_matrix_lie_groups_tpu_torch.ops import riccati  # noqa: E402
from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.batched import (  # noqa: E402
    FastBatchSolver,
)
from trajectory_optimization_matrix_lie_groups_tpu_torch.tasks.al_bench import (  # noqa: E402
    screw200_model,
    screw_batch,
)

GATE = 1e-4
ITERS, SEED, CHECK_BATCH = 12, 0, 256


def j_rel(a, b):
    return ((a.cpu().double() - b.cpu().double()).abs() / b.cpu().double().abs()).max().item()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--horizon", type=int, default=200)
    args = ap.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        sys.exit("fast_gate_margin: no CUDA device (pass --device cpu to rehearse)")
    torch.backends.cuda.matmul.allow_tf32 = False
    N, B = args.horizon, args.batch
    nb = min(CHECK_BATCH, B)

    model, params, q0, xi0 = screw200_model(torch.float32, dev, horizon=N, drone=True)
    q0s, xi0s = screw_batch(q0, xi0, B, SEED)
    us0 = torch.zeros((B, N, model.nu), dtype=torch.float32, device=dev)

    def host_plain(dtype):
        """The plain solve of the host's copy of lanes 0..255 (f64: the same
        f32 initial states, cast)."""
        hmodel, hparams = screw200_model(dtype, "cpu", horizon=N, drone=True)[:2]
        small = [x[:nb].cpu().to(dtype) for x in (q0s, xi0s, us0)]
        return FastBatchSolver(hmodel, N, ITERS, plain=True).solve(
            hparams, *small, hparams["cost"].q_ref, hparams["cost"].xi_ref).J_opt

    def card_J():
        return FastBatchSolver(model, N, ITERS).solve(
            params, q0s, xi0s, us0, params["cost"].q_ref, params["cost"].xi_ref).J_opt[:nb]

    t0 = time.perf_counter()
    J_p32, J_p64 = host_plain(torch.float32), host_plain(torch.float64)
    J_k = card_J()
    lane = riccati.backward_lane
    faults = {}
    for t in (0, N // 2, N - 1):
        for tag, scale in (("Fu0", 0.0), ("Fu*0.99", 0.99)):
            def planted(Fx, Fu, *rest, t=t, scale=scale):
                Fu = Fu.clone()
                Fu[t] *= scale
                return lane(Fx, Fu, *rest)
            planted.launches = 0   # the kernel's wrapper counts on its module name
            riccati.backward_lane = planted
            try:
                faults[f"{tag}@{t}"] = j_rel(card_J(), J_p32)
            finally:
                riccati.backward_lane = lane
    card = (subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           check=True).stdout.strip() if dev.type == "cuda" else "cpu")
    print(json.dumps({
        "card": card, "path": "drone fast tier, f32", "B": B, "N": N,
        "iterations": ITERS, "lanes": nb, "gate": GATE,
        "metric": "max over lanes 0..255 of |J - J_ref| / |J_ref|",
        "sound": j_rel(J_k, J_p32),
        "plain_f32_vs_plain_f64": j_rel(J_p32, J_p64),
        "sound_vs_plain_f64": j_rel(J_k, J_p64),
        "faults": faults, "seconds": time.perf_counter() - t0}))


if __name__ == "__main__":
    main()
