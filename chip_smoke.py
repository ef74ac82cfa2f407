#!/usr/bin/env python3
"""Drive the PyTorch port's paths once on one NVIDIA GPU and check them.

    python3 chip_smoke.py
    python3 chip_smoke.py --cli [task ...]
    python3 chip_smoke.py --sharded
    python3 chip_smoke.py --b13-any
    python3 chip_smoke.py --refine
    python3 chip_smoke.py --nu

With ``--cli`` only the `cli` phase runs (below; the named tasks of
`CLI_TASKS`, all without names), with its gates and launch checks, after
the kernels' build; then the card's name and power limit.  With
``--sharded`` only the `sharded` phase runs, so, with ``--b13-any`` only
`kernels_b13_any`, with ``--refine`` only `kernels_refine`, and with
``--nu`` only `kernels_nu`.

The first two run on the screw-200 problem (the N=200 prefix of the
reference's screw-tracking problem, R = 1e-3 I, no box) for a batch of
perturbed initial poses, lane 0 unperturbed.  The f32 path is the
multiple-shooting iLQR pipeline (`solvers/pipeline.PipelineSolver`, fused
layout), B = 8192, 12 iterations.  The polish path is
`solvers/df_mixed.MixedDFPipelineSolver`: 7 f32 iterations, then 2
mixed-precision polish iterations (fp64 residuals, f32 preconditioner),
B = 16384, the system's gate-passing headline (lane-0 controls within 1e-4
of the f64 golden).  The SO(3) path is `solvers/pipeline_so3.SO3PipelineSolver`
on both SO(3) families (`tasks/so3_bench.py`: free-attitude tracking,
N = 249, and the 3-D pendulum swing-up, N = 80), B = 8192, 30 f32
iterations.  The generic fast tier is `solvers/batched.FastBatchSolver` on
any `LieModel`: the screw-200 free body on kernels B1, B13 and B14, the
drone (nu = 4) on screw-200 and the free attitude (so3_track249) on B13,
B = 8192, 12 (the drone 6, the free attitude 30) f32 iterations.  The constrained path is the reference's
N=1400 input-box AL problem (`tasks/al_bench.build_al1400`: R = 0, box
+-10) on `solvers/al_pipeline.ALPipelineSolver` and its polishes, the AL
fast tier (`solvers/al_fast.ALFastSolver`) and batched closed-loop MPC
(`solvers/mpc.py`).  The reference-exact tier is `solvers/lie_ilqr.LieILQR`
in f64 (MS, the per-stage adaptive LM backward, the nonlinear rollout; on
the free body the rollout on B14) on both SO(3) problems and screw-200,
with `solvers/al_ilqr.ALILQR` and `solvers/mpc.make_closed_loop` on it; the
anchored tier is `solvers/anchored.AnchoredFastSolver` (f32, B13 at
(12, 6)); the full-precision refiners are `solvers/df_pipeline.
DFPipelineSolver` (B1-B3 in fp64) and `solvers/polish.HighPrecisionSolver`.
B13's runtime-shape instance takes any (nx, nu) up to (12, 12) that no
tuned instance has, its large-nu instance nx <= 12 and nu = 13 ... 34
(screw200_rcs16 on the fast tier: a rigid body driven by 16 thrusters).  The error-state tier is `solvers/errorstate_ilqr.
ErrorStateILQR` on the three error-state CLI problems (`tasks/
errstate_bench.py`, N = 400, f64); the one-device sweeps are `parallel/
sweep.run_sweep` (`BatchSolver` over `LieILQR`, its rollout on B14) and
`run_rollout_sweep`.
Phases, each printed as one JSON line:

  device        the card (nvidia-smi), torch/CUDA versions, the kernels'
                build time and ptxas registers/spills (B2 f32, B5, B11 f32,
                B13 f32 and B14 f32 must not spill: their carry lives in
                registers; B2 and the rollout in fp64 must neither spill
                nor keep a stack frame);
  kernels       B1-B4 against their plain versions on the same real
                iterate, at N=200, B=256 in f32 and f64, gated per output;
                B2 also with an AL diagonal on Quu (B2_al);
  solve_f32     the f32 path: counters reset, one fused solve at B=8192
                (B1 = 1, B2 = B3 = 12 launches); counters reset again, one
                unfused solve at B=256 (B1 = B2 = B4 = 12); lane 0 against
                the committed f64 golden, lanes 0..15 against the plain
                solve of them on the host;
  solve_f64     the f32 pipeline's kernels in f64 on lanes 0..255, 20
                iterations, lane 0's controls against the golden;
  timing        the f32 path (median of 7 reps, a new batch each) and
                B1-B4 against their plain versions at B=8192, each with
                its bound, and B3's yardstick: the sum
                of B4's and B1's times (B3 computes B4's trajectory and B1's
                linearization of it);
  kernels_polish  B5-B9 against their plain versions on the polish's real
                handoff iterate at N=200, B=256, gated per output, B5 also
                with an AL diagonal (B5_al);
  solve_polish  the polish path: counters reset, one solve at B=16384
                (B1 = 1, B2 = B3 = 7, B5 = B6 = B7 = B8 = B9 = 2); lane 0
                against the golden; the kernel polish against the plain
                polish of one handoff on lanes 0..255; one fx_mode='hybrid'
                solve at B=256;
  timing_polish the polish path (median of 5 reps, a new batch each, split
                into f32 phase and polish), its plain polish (one rep), B2
                at B=16384 (the shape at which the polish path's f32 phase
                launches it 7 times) and B5, B6 and B7-B9 against their
                plain versions at B=16384, each with its bound;
  kernels_so3   B10-B12 against their plain versions on a real iterate of
                each SO(3) family at its N, B=256, in f32 and f64;
  solve_so3     for each family: counters reset, one solve at B=8192
                (B10 = 1, B11 = B12 = 30, every other kernel 0); lane 0
                against the family's committed f64 golden, lanes 0..15
                against the plain solve of the same lanes on the host, an
                f64 solve of lanes 0..255 with the golden's iteration count;
  timing_so3    each family (median of 7 reps, a new batch each) and B10-B12
                against their plain versions at B=8192, and B12's yardstick:
                its rollout phase alone plus B10, each by CUDA events (B12
                computes that rollout's trajectory and B10's linearization
                of it);
  kernels_fast  B13 at (nx, nu) = (12, 6), (12, 4), (6, 3) and B14 against
                their plain versions on a real iterate of each fast path
                (after one iteration),
                B=256, in f32 and f64;
  solve_fast    counters reset before each solve: the free body at B=8192
                (B1 = B13 = B14 = 12, every other kernel 0), lane 0 against
                the screw-200 golden, lanes 0..255 against the port's
                PipelineSolver, lanes 0..15 against the plain solve on the
                host; the drone (6 iterations, B13 = 6) against the plain
                solve of lanes 0..15 on the host; the free attitude
                (B13 = 30) against its
                golden; one f64 line-search solve at B=1024 (poses
                perturbed by Exp(0.4 n); B1 = B13 = B14 = 6, B14 rolling
                out every lane's 13 candidates at once) against the plain
                one of lanes 0..15;
  timing_fast   the free body (median of 7 reps), the drone and the free
                attitude (their solve_fast runs), and B13 at each shape and
                B14 against their plain versions at B=8192;
  kernels_al    B2 and B5 with the AL diagonal, B3, B6 and B7-B9 at the AL
                problem's shapes (N=1400, B=1024) against their plain
                versions on 16 of its lanes (the first 8 and the last 8)
                on the host, each with its time and bound;
  solve_al      B=1024, lane 0 unperturbed: counters reset, the f32 AL loop
                (16 iterations an outer, at most 12 outers; B1 = outers,
                B2 = B3 = 16 x outers), every lane below violation 1e-2;
                counters reset, `al_polish_device` (16 f32 + 2 polish
                iterations, 2 outers; B1 = 2, B2 = B3 = 32, B5-B9 = 4),
                then `al_polish`; lane 0 of each polish within 1e-4 of the
                committed f64 golden, every |u| <= 10 (1 + 1e-3), and the
                share of lanes their feasibility fallback took;
  solve_al_fast `ALFastSolver` (B13, B14) on the first 200 stages, B=8192,
                25 iterations, at most 15 outers, with its rescue, and
                `ALPipelineSolver` on the same inputs and budget: both
                converge on every lane, lane 0's J agrees to 1e-4;
  solve_mpc     `make_closed_loop_batch` on screw-200 (B=1024, H=40,
                T=100, 4 iterations a step; B1 = 100, B2 = B3 = 400) from
                q_ref[0] Exp(0.05 n): the mean tracking error falls, lanes
                0..3 equal a host loop of `PipelineSolver.solve` over 5
                steps to 1e-6; `make_closed_loop_batch_constrained` (box
                +-10, 4 AL outers a step) from the AL problem's offset
                start, applied controls inside the box, beside the
                unconstrained driver's max |u| from that start; its first
                5 steps with the `ALFastSolver` rescue (one rescue outer of
                60 line-searched iterations, B13 and B14 each), which must
                run;
  timing_al     the times of these paths: the f32 AL loop, each polish
                (solve and dual ascent apart), the AL fast tier and MPC
                solves/s (B T / wall).
  solve_exact_al  `ALILQR` on the AL problem's first 100 stages (box +-10,
                R = 0), B = 256: every lane below
                violation 1e-2, |u| <= 10 (1 + 1e-3), lane 0's tracking J
                within 1e-4 of `ALFastSolver`'s in f64 on the same lane
                (the inner at `SolverConfig`'s default tolerance, 1e-6);
  solve_anchored  the anchored tier, f32, B = 8192, 14 iterations (B13 = 14):
                lane 0 within 10x the JAX anchored solver's own error of
                the screw-200 golden (`golden/screw200_anchored_meta.json`),
                its gradient norms (lane 0, median) below the f32
                pipeline's on the same lanes and budget, B13 on the
                anchored iterate against its plain version (gate 1e-3),
                solves/s beside the fast free body's;
  solve_refine  `DFPipelineSolver` (10 f32 + 3 fp64 iterations) at
                B = 16384: the launches of its f32 phase (B1 = 1, B2 = B3 =
                10) and of its fp64 phase, `refine` (B1 = 1, B2 = 4, B3 =
                3), each counted alone, lane 0 within 1e-4 of the golden,
                solves/s (median of 3) beside the mixed polish's; fp64
                B1-B4 against their plain versions at its shapes with times
                and bounds; `HighPrecisionSolver`
                (12 f32 + 2 f64 polish iterations) at B = 1024, lane 0
                within 1e-4;
  solve_mpc_exact  `make_closed_loop` on screw-200 (4 plants, H = 40,
                T = 50, each window to the default 1e-6 within 4
                iterations): plant 0 equals a host loop of
                B = 1 `LieILQR.solve` per step to 1e-9, the tracking error
                falls;
  solve_exact   `LieILQR` at B = 1024 on so3_track249, pendulum_swingup80
                and screw-200, each to its golden's final gradient norm:
                lane 0 within 1e-6 of the golden, lanes 0..3 equal B = 1
                solves of the same lanes to 1e-9 (the same iterations);
                on screw-200 the associative backward with the linear
                rollout agrees with it to 1e-8, and the per-stage PD read's
                cost (the sequential backward against 'sequential_fixed').
                The B = 1 reference solves (these and the MPC host loop)
                run on the host in the worker processes while the card
                works, so these two lines come after the other lines of
                these tiers.
  kernels_b13_any  B13's runtime-shape instance at (6, 2), (9, 3), (12, 3)
                and (12, 12) against its plain version (f32 B = 8192, f64
                B = 1024, N = 200), each with its time and bound and the
                parent kernel's time (`ANY_PARENT_MS`); one
                `FastBatchSolver` solve (f32, B = 1024, 4 iterations;
                B13any = 4) of a (12, 3) `LieModel` (the rigid body driven
                by three torques) against use_pallas=False (J to 1e-4);
                B13's large-nu instance at (12, 16) and (12, 34), timed at
                N = 200 (f32 B = 8192, f64 B = 1024) and compared with its
                plain version at N = 40 (the f32 (12, 16) row at 200), each
                with its bound, its problems a block and its time before
                the instance's redesign (`LARGE_PARENT_MS`); one
                `FastBatchSolver` solve of screw200_rcs16 (f32, B = 1024,
                N = 200, 12 iterations; B13nuL = 12 and no other B13
                launch), every lane finite, lane 0 within 10 x the JAX
                fast tier's own f32 error of the golden, its solves/s;
                the instances' registers, stack and spills (ptxas; no f32
                instance may spill or keep a stack frame); each part's
                seconds;
  kernels_refine  (``--refine`` only) the refiner's fp64 kernels: B1-B4 in
                fp64 against their plain versions at its shapes (B = 16384,
                N = 200) on the free body (nu = 6) and the drone (nu = 4,
                gravity), each with its time, bound and share, and the
                kernels' time before their fp64 redesign
                (`REFINE_PARENT_MS`); the blocks an SM holds of B2's and
                the rollout's fp64 kernels and the waves B = 16384 takes;
                the ptxas lines of B2's and the rollout's f32, mixed (B5,
                B6) and fp64 instances (the fp64 ones neither spill nor keep
                a stack frame); one `DFPipelineSolver` solve, its f32 and
                fp64 phases counted apart, lane 0 within 1e-4 of the
                golden, and the solve's median time (3 reps);
  kernels_nu    the instances of B1-B6 at any input dimension nu = 1..
                MAX_NU (`csrc/pipeline_nu.cu`, `polish_nu.cu`: nu.cuh up to
                12, nu_large.cuh past it): (a) B1-B4 (f32 and fp64) and
                B5-B6 against their plain versions at nu = 1, 3, 5, 8, 12,
                13, 16, 24 and MAX_NU (B = 1024, on a real iterate of the
                rigid body driven through `al_bench.nu_pu(nu)`, g = 0:
                B1-B4 after two f32 iterations, B5-B6 at the polish's
                second iteration, after 12 f32 iterations and one polish
                iteration; compared at N = 40, but the kernels line's rows
                (nu = 3 and 16: B1-B4 in f32, B5, B6) at N = 200, and
                timed at N = 200), each with its time, plain time,
                bound and share, the tuned instances' times at nu = 6 on
                the same shapes beside them, B5's runtime-nu instance equal to the
                tuned one at nu = 4 and 6 on a rough iterate (2 f32
                iterations on the first 4 or 6 thrusters of
                `al_bench.rcs12_pu`), the blocks an SM holds of B2's and
                the rollout's instances and their ptxas lines (the
                large-nu rollout, f32 and fp64, and the runtime-nu B2 and
                rollout, f32 and fp64, neither spill nor keep a stack
                frame), and the large-nu B3 and B4 rows' times before
                the rollout's redesign (`NU_LARGE_PARENT_MS`) and the
                runtime-nu B2, B3 and B4 rows' times before theirs
                (`NU_PARENT_MS`), each with its speedup; B3 and B4 at
                the rcs paths' B = 16384 past one wave of the large-nu
                rollout's feedback slot (`NU_PAST_SLOT`: f32 rcs24, fp64
                rcs16 and rcs24, compared and timed at N = 40), and at
                nu <= 12 past the batch that takes g_kernel's pass
                (`NU_PAST_PASS`: torques3 and rcs12, f32 and fp64, at the
                same B and N), each rollout launch of (a) and (b) held to
                the instance it should take (up to nu = 12 with
                g_kernel's pass while B <= the build's one-warp blocks an
                SM x 32 x the SMs; the feedback slot's while the batch is
                resident at once, device memory's past it); (b) the four
                problems of `al_bench.NU_PROBLEMS` (screw200_torques3, nu =
                3; screw200_rcs12, nu = 12; screw200_rcs16, nu = 16;
                screw200_rcs24, nu = 24) through the f32 path (B = 8192,
                12 iterations; unfused at B = 256, as solve_f32's B4), the
                polish (B = 16384) and the fp64 refiner
                (B = 16384), each with its golden's schedule, counted (only
                the runtime-nu or large-nu instances launch), lane 0 within
                10 x the JAX f32 pipeline's error, 1e-4 and 1e-6 of the
                golden, every lane finite, then timed on a new batch; (c)
                every nu from 1 to 12, and 13, 16, 24 and MAX_NU (B = 64,
                N = 40, 2 f32 iterations) through `PipelineSolver` fused
                and unfused in f32 and f64, `MixedDFPipelineSolver` and
                `DFPipelineSolver`, counted (nu = 6 and 4 on the tuned
                instances, every other nu up to 12 on the runtime-nu ones,
                past 12 on the large-nu ones), fused against unfused J, all
                finite; each part's seconds;
  solve_errstate  each of the three CLI problems (errstate_tracking,
                errstate_generate, errstate_generate_linear) against its
                JAX f64 golden (`golden/errstate_*`): the same iterations
                and final flags, J history rel 1e-8, controls 1e-6; ms an
                iteration, and its linearize, backward and rollout (every
                step size) per iteration, each synchronized and timed in
                the fit;
  sweep         `run_sweep` on screw-200 (four ranges, 160 solves, 10
                iterations each; B14 = 40), one lane of each range against
                a B = 1 solve on the host (1e-9), solves/s;
  rollout_sweep `run_rollout_sweep` (four ranges, 112 rollouts of 1400
                steps), the middle lane of each against a step loop of
                those four lanes alone (1e-12), rollouts/s.
  cli           the task CLI (`tasks/run.main`, in this process, on the
                card) on the stand-in benchmark pickles
                (`tasks/golden/standin/`), one line per task with its JSON
                line, wall time and launches: se3_tracking_ms, drone_ms,
                pendulum3d_ms and so3_tracking_ms with --x64 (converged,
                controls within 1e-4 of the pickle's JAX solution;
                se3_tracking_ms's rollout on B14), mpc_batch and
                mpc_batch_constrained (B, H, T = 1024, 40, 100, f32; B1-B3;
                mpc_batch's final mean tracking error equal to a direct
                `make_closed_loop_batch` call on the same draws to 1e-6),
                al_batch (`ALPipelineSolver`, B1-B3; every lane below
                violation 1e-2), cartpole (converged), dynamics_sim
                (tests/test_task_cli.py's gates) and cost_landscape (its
                grids on the card equal to the CPU's to 1e-12);
  sharded       the multi-device layer (`parallel/`) in one-rank NCCL
                groups.  First `make_batch_mesh()` in a process with no
                group (a one-process group in memory): `BatchSolver(mesh)`
                on the v_x range of the sweep task's problem and
                `run_rollout_sweep(mesh=...)` (200 steps) against their
                one-device runs (1e-9; B14 = 10), then the CLI's `sweep`
                task, whose group is left at its end, its J range per
                parameter against the one-device sweep (relative 1e-9; B14
                = 40).  Then `initialize_multihost` on 127.0.0.1: the
                batch-sharded pipeline (`make_sharded_pipeline`, f32,
                B=8192, 12 iterations; B1 = 1, B2 = B3 = 12) against
                `PipelineSolver` on the same inputs (1e-6), lane 0 against
                the golden (the f32 gate), each half of the batch solved
                alone against the full solve's rows (1e-6), both timed in
                turns; the time-sharded Riccati sweep (fp64, N = 1400,
                (12, 6), B = 16) in 2 and 8 blocks on the card and through
                the group against `riccati.parallel_backward` (1e-8); and
                `LieILQR(backward="associative_sharded")` with its rollout
                on B14 (screw-200, f64, B = 64, 6 iterations) against
                ``backward="associative"`` (the same iterations, 1e-9).

Every host-side reference solve (the plain versions' solves of lanes 0..15
in solve_f32, solve_so3 and solve_fast, the reference-exact tier's and the
sweep's B = 1 solves) runs in one of 6 worker processes (one torch thread each),
its inputs rebuilt there from the same seeds, while the card works.

A kernel's bound is the least time the card could take for its work: the
larger of the bytes it must move (each array it reads once, each output
written once) over 3.35 TB/s and its operations over 67 TFLOP/s (f32) or
34 TFLOP/s (fp64), counted on this run's inputs (`kernel_check.work`).
Then the kernels summary line, one entry for each of B1-B14, B13's
runtime-shape and large-nu instances (B13any, B13nuL) and the runtime-nu
and large-nu instances of B1-B6 (B1nu-B6nu and B1nuL-B6nuL: their times
at nu = 3 and 16, f32 for B1-B4, N = 200, B = 1024; launches from
kernels_nu's part (b)) (B2's times at B=8192; launches of B1-B3
from the fused f32 run, of B4 from the unfused run, of B5-B9 from the
polish run, of B10-B12 from the free-attitude run, of B13 and B14 from the
free-body fast run, of B13any from the (12, 3) solve, of B13nuL from the
rcs16 solve, each named in "run"; B13any's times at (12, 3), B13nuL's at
(12, 16), f32, B = 8192; "launches_in": the launches in
each phase of the reference-exact, anchored and refiner paths, of the
sweep, of the task CLI ("cli", all its tasks) and of the multi-device
layer ("sharded")),
the card's name and power limit as nvidia-smi prints them, and the result
line.  The f32 path is timed before any polish or SO(3) work, after the
same phases as when it was the script's only path, so that its time
compares with the records (an earlier process state moves B2's time by up
to 2%, PERF.md).  Any failed check raises: the script exits non-zero and
prints no result.  Without a CUDA device it exits with status 2 before
doing anything.
"""

import json
import math
import multiprocessing
import os
import statistics
import subprocess
import sys
import time
import types

import numpy as np
import torch

N = 200
BATCH = 8192
CHECK_BATCH = 256
# the plain reference solves on the host take lanes 0..15 of the batch (on
# the host their time grows with the lanes: 64 take ~1/3 of 256's, 16 ~80%
# of 64's)
HOST_LANES = 16
ITERS = 12
F64_ITERS = 20
TIMING_REPS = 7
SEED = 0
# the polish path: bench.py's shapes and schedule (and its fallback of a
# full 12-iteration f32 phase if 7 + 2 misses the gate)
POLISH_BATCH = 16384
POLISH_F32_ITERS, POLISH_FALLBACK_F32_ITERS, POLISH_ITERS = 7, 12, 2
POLISH_REPS = 5
POLISH_GATE = 1e-4
# kernel vs plain polish of one handoff: a tenth of the accuracy gate (both
# contract the same start toward the same fixed point; only the f32
# preconditioner's rounding differs)
POLISH_AGREE = 1e-5
# the SO(3) path: both families at B = 8192 and 30 f32 iterations
SO3_ITERS = 30
SO3_PROBLEMS = ("so3_track249", "pendulum_swingup80")
# the generic fast tier: its three paths, and the line search (f64, from
# poses perturbed by Exp(0.4 n), so that short steps get chosen)
FAST_KINDS = ("free_body", "drone", "so3_track249")
# the drone's solve and its host plain solve: 6 iterations (12 before the
# error-state and sweep phases came; a host-bound loop, ~1.4 s an iteration)
DRONE_ITERS = 6
# the fast tier's kernels are checked and timed on its iterate after one
# iteration (two before the error-state and sweep phases came)
FAST_CHECK_ITERS = 1
LS_BATCH, LS_ITERS, LS_SCALE = 1024, 6, 0.4
# the constrained path: the reference's N=1400 AL problem (R = 0, box +-10)
# at B = 1024, its f32 AL loop (16 iterations an outer, at most 12 outers)
# and both polishes (16 f32 + 2 polish iterations, 2 outers), lane 0 against
# the committed f64 golden; the kernels at its shapes against their plain
# versions on AL_CHECK_LANES lanes (its first and last) on the host
AL_N, AL_BATCH, AL_ITERS, AL_OUTERS = 1400, 1024, 16, 12
AL_POLISH_OUTERS, AL_POLISH_ITERS, AL_GATE, AL_TOL = 2, 2, 1e-4, 1e-2
AL_CHECK_LANES = 16
# the AL fast tier on the first 200 stages, B = 8192, with its rescue
AL_FAST_N, AL_FAST_BATCH, AL_FAST_ITERS, AL_FAST_OUTERS = 200, 8192, 25, 15
# batched closed-loop MPC on screw-200 (R = 1e-3 I): tasks/run.py's sizes;
# lanes 0..3 against a host loop of PipelineSolver.solve over 5 steps; the
# box driver (+-10, 4 AL outers a step) from the AL problem's offset start,
# and over 5 steps with the ALFastSolver rescue (one rescue outer of 60
# line-searched iterations)
MPC_BATCH, MPC_H, MPC_T, MPC_ITERS, MPC_AL_OUTERS = 1024, 40, 100, 4, 4
MPC_HOST_STEPS, MPC_HOST_LANES, MPC_RESCUE_T, MPC_RESCUE_OUTERS = 5, 4, 5, 1
# the reference-exact tier (f64 LieILQR, MS, sequential backward, nonlinear
# rollout): each problem at B = 1024 to its golden's own final gradient norm
# (the golden is an f64 solve stopped there; at 1e-10 the JAX LieILQR stops
# 1.6e-6 from so3_track249's golden), lanes 0..3 against B = 1 solves
EXACT_PROBLEMS = ("so3_track249", "pendulum_swingup80", "screw200")
EXACT_BATCH, EXACT_LANES, EXACT_MAX_ITERS, EXACT_GATE = 1024, 4, 100, 1e-6
# ALILQR on the AL problem's first 100 stages (box +-10, R = 0; the box
# binds in its first 10), B = 256, the inner to `SolverConfig`'s default
# tolerance (1e-6); 200 stages before the large-nu rows of kernels_nu came
# (its two host-bound solves, ALILQR's and the f64 AL fast tier's, follow N)
EXACT_AL_N, EXACT_AL_BATCH, EXACT_AL_OUTERS, EXACT_AL_INNERS = 100, 256, 20, 100
# make_closed_loop on screw-200: 4 plants, H = 40, T = 50 (100 before the
# error-state and sweep phases came), each window to
# the default tolerance within the batch drivers' 4 iterations a step, plant
# 0 against a host loop
EXACT_MPC_B, EXACT_MPC_H, EXACT_MPC_T, EXACT_MPC_ITERS = 4, 40, 50, 4
# the anchored tier (f32, B13 at (12, 6)) and the full-precision refiners
ANCHORED_BATCH, ANCHORED_ITERS = 8192, 14
REFINE_BATCH, REFINE_F32_ITERS, REFINE_DF_ITERS, REFINE_REPS = 16384, 10, 3, 3
HIGHPREC_BATCH, HIGHPREC_F32_ITERS, HIGHPREC_POLISH_ITERS = 1024, 12, 2
# the host-side reference solves (the plain versions' solves of lanes 0..15,
# the reference-exact tier's B = 1 solves) run in HOST_WORKERS worker
# processes beside the card's work; each result is waited for at most
# HOST_WAIT_S
HOST_WORKERS, HOST_WAIT_S = 6, 600

# B13's runtime-shape instance at shapes no tuned instance has, f32 at
# B = 8192 and f64 at B = 1024, N = 200, against its plain version; one
# FastBatchSolver solve of a (12, 3) LieModel (a rigid body driven by three
# torques, no gravity) against use_pallas=False
ANY_SHAPES = ((6, 2), (9, 3), (12, 3), (12, 12))
ANY_BATCH = {torch.float32: 8192, torch.float64: 1024}
ANY_SOLVE_BATCH, ANY_SOLVE_ITERS = 1024, 4
# B13's large-nu instance (past nu = 12) at LARGE_SHAPES, f32 at B = 8192 and
# f64 at B = 1024, timed at N = 200 and compared with its plain version at
# N = NU_PLAIN_N (the kernels line's row, (12, 16) in f32, at N = 200); one
# FastBatchSolver solve of screw200_rcs16 (f32, B = RCS16_BATCH,
# RCS16_ITERS iterations: the JAX fast tier's recorded count), lane 0 within
# 10 x the JAX fast tier's own f32 error of the golden
LARGE_SHAPES, LARGE_LINE = ((12, 16), (12, 34)), (12, 16)
RCS16_BATCH, RCS16_ITERS = 1024, 12
# the same rows' ms on the kernel these rows replaced (one thread per
# problem reading global memory, its carry in local memory), measured by
# `python3 scripts/rates.py --b13-any` on that tree before the redesign
# (NVIDIA H100 80GB HBM3, 700.00 W; the first of two runs in one call);
# its (12, 3) solve took 6.1247 s there
ANY_PARENT_MS = {"6x2 float32 B=8192": 13.206645965576172,
                 "9x3 float32 B=8192": 28.901407877604168,
                 "12x3 float32 B=8192": 56.6419932047526,
                 "12x12 float32 B=8192": 160.92205810546875,
                 "6x2 float64 B=1024": 17.813674926757812,
                 "9x3 float64 B=1024": 46.83412170410156,
                 "12x3 float64 B=1024": 103.24589029947917,
                 "12x12 float64 B=1024": 284.1482340494792}
# the same rows' ms on B13's large-nu instance before its redesign on the
# large-nu Riccati step (the earlier step: a lane's own solves, left-looking
# chains), measured by `python3 scripts/rates.py --b13-any` on that tree
# (NVIDIA H100 80GB HBM3, 700.00 W; the redesign's first call)
LARGE_PARENT_MS = {"12x16 float32 B=8192": 60.23121134440104,
                   "12x34 float32 B=8192": 327.661376953125,
                   "12x16 float64 B=1024": 20.645994822184246,
                   "12x34 float64 B=1024": 85.74344889322917}
# the instances of B1-B6 at any input dimension (kernels_nu, --nu): each
# against its plain version at NU_CHECK on a real iterate (B =
# NU_CHECK_BATCH); the problems of `al_bench.NU_PROBLEMS` on the f32 path
# (NU_F32_BATCH, ITERS iterations), the polish and the fp64 refiner
# (NU_POLISH_BATCH, each golden's schedule), lane 0 within 10 x the JAX f32
# pipeline's error, POLISH_GATE and NU_REFINE_GATE of the golden; every nu
# from 1 to 12 through the four solvers at NU_SWEEP = (B, N, f32 iterations)
NU_CHECK, NU_CHECK_BATCH = (1, 3, 5, 8, 12), 1024
NU_F32_BATCH, NU_POLISH_BATCH, NU_REFINE_GATE = 8192, 16384, 1e-6
NU_SWEEP = (64, 40, 2)
# the large-nu instances (past 12; the largest, _build.MAX_NU, added in
# nu_phase), the per-nu sweep at these nu too.  Every row of part (a) is
# timed at N = 200 and compared with its plain version at N = NU_PLAIN_N
# (the plain versions, Python loops over the stages, take 1-5 s a call at
# N = 200; every row compared at 200 before the large-nu rows came), but
# the kernels line's rows (nu = LINE_NU: B1-B4 in f32, B5, B6) at N = 200
NU_CHECK_LARGE, NU_PLAIN_N, LINE_NU = (13, 16, 24), 40, (3, 16)
# the large-nu rows' ms of B3 and B4 before the rollout's redesign (each
# stage reading K, u and k from device memory one input at a time on the
# carry's chain), measured by `python3 scripts/rates.py --large-nu` on that
# tree at the same shapes (B = NU_CHECK_BATCH, N = 200; NVIDIA H100 80GB
# HBM3, 700.00 W; the redesign's first call)
NU_LARGE_PARENT_MS = {"B3 nu=13 float32": 2.324620819091797,
                      "B3 nu=13 float64": 2.8647296905517576,
                      "B3 nu=16 float32": 2.670886421203613,
                      "B3 nu=16 float64": 3.2311038970947266,
                      "B3 nu=24 float32": 3.562771224975586,
                      "B3 nu=24 float64": 4.170604705810547,
                      "B3 nu=34 float32": 4.693529510498047,
                      "B3 nu=34 float64": 5.353055953979492,
                      "B4 nu=13 float32": 2.1539327621459963,
                      "B4 nu=13 float64": 2.5074880599975584,
                      "B4 nu=16 float32": 2.4913728713989256,
                      "B4 nu=16 float64": 2.863462448120117,
                      "B4 nu=24 float32": 3.390252685546875,
                      "B4 nu=24 float64": 3.8054527282714843,
                      "B4 nu=34 float32": 4.520127868652343,
                      "B4 nu=34 float64": 4.990451049804688}
# the runtime-nu rows' ms of B2, B3 and B4 (nu <= 12) before their redesign
# (B2 on `riccati_group_step` / `riccati_f64_step` at a compile-time maximum
# MU = 6 or 12, the rollout with u on its chain), measured by `python3
# scripts/rates.py --nu` on that tree at the same shapes (B = NU_CHECK_BATCH,
# N = 200; NVIDIA H100 80GB HBM3, 700.00 W; the first run of the redesign's
# first timing call)
NU_PARENT_MS = {"B2 nu=1 float32": 0.649619197845459,
                "B2 nu=1 float64": 0.8479040145874024,
                "B2 nu=3 float32": 0.6522624015808105,
                "B2 nu=3 float64": 0.8671680450439453,
                "B2 nu=5 float32": 0.6531199932098388,
                "B2 nu=5 float64": 0.8654463768005372,
                "B2 nu=8 float32": 1.2184512138366699,
                "B2 nu=8 float64": 2.039155197143555,
                "B2 nu=12 float32": 1.242784023284912,
                "B2 nu=12 float64": 2.0599296569824217,
                "B3 nu=1 float32": 1.096012783050537,
                "B3 nu=1 float64": 1.528831958770752,
                "B3 nu=3 float32": 1.147993564605713,
                "B3 nu=3 float64": 1.571014404296875,
                "B3 nu=5 float32": 1.2081791877746582,
                "B3 nu=5 float64": 1.6272127151489257,
                "B3 nu=8 float32": 1.4479104042053224,
                "B3 nu=8 float64": 1.792153549194336,
                "B3 nu=12 float32": 1.6184192657470704,
                "B3 nu=12 float64": 1.9402944564819335,
                "B4 nu=1 float32": 0.9470848083496094,
                "B4 nu=1 float64": 1.1800191879272461,
                "B4 nu=3 float32": 1.0182080268859863,
                "B4 nu=3 float64": 1.2404224395751953,
                "B4 nu=5 float32": 1.0773311614990235,
                "B4 nu=5 float64": 1.2954303741455078,
                "B4 nu=8 float32": 1.3130047798156739,
                "B4 nu=8 float64": 1.4564800262451172,
                "B4 nu=12 float32": 1.481222438812256,
                "B4 nu=12 float64": 1.6165184020996093}
# the large-nu rollout past one wave of its feedback slot's blocks, at the
# paths' own shapes (B = NU_POLISH_BATCH, where the rcs24 f32 polish and the
# fp64 refiner phase of both problems take its device-memory instance):
# B3nuL and B4nuL against their plain versions at N = NU_PLAIN_N, timed there
NU_PAST_SLOT = (("screw200_rcs24", torch.float32), ("screw200_rcs16", torch.float64),
                ("screw200_rcs24", torch.float64))
# the rollout at nu <= 12 at the same B, past the batch that takes g_kernel's
# pass (the polish's f32 phase and the refiner's fp64 phase of torques3 and
# rcs12): B3nu and B4nu against their plain versions at N = NU_PLAIN_N,
# timed there
NU_PAST_PASS = tuple((name, dtype) for name in ("screw200_torques3", "screw200_rcs12")
                     for dtype in (torch.float32, torch.float64))
# the instances of the large-nu rollout (B3's and B4's first phase at every
# nu: the feedback from its shared-memory slot, or from device memory; past
# nu = 12 with G_t formed in the loop, up to 12 read from g_kernel's pass;
# f32 and fp64: 8), which may neither spill nor keep a stack frame
ROLLOUT_LARGE = "traopt::rollout_large_kernel<"
# the runtime-nu instances of B2 (MU = 4, 6, 12; f32 and fp64: 6) and
# g_kernel (f32, fp64), which may neither spill nor keep a stack frame
NU_FRAMELESS = ("traopt::riccati_nu_kernel<float,", "traopt::riccati_f64_nu_kernel<",
                "traopt::g_kernel<")
# B5's runtime-nu instance against the tuned one, both at nu = 4 and 6 on
# the same iterate: identical (max_rel, every output)
NU_TWIN_GATE = 1e-12
# the refiner's fp64 kernels (--refine): B1-B4 in fp64 at the refiner's
# batch on the free body and on the drone (nu = 4, gravity, R = 1e-2 I4)
REFINE_MODELS = ("free_body", "drone")
# the same rows' ms, and the refined solve's median s, on the kernels the
# fp64 redesign replaced (the f32 designs compiled in double), measured by
# `python3 scripts/rates.py --refine` on that tree (NVIDIA H100 80GB HBM3,
# 700.00 W; the first of two runs in one call)
REFINE_PARENT_MS = {"B1 nu=6": 4.6328575134277346, "B2 nu=6": 12.597087860107422,
                    "B3 nu=6": 8.296979522705078, "B4 nu=6": 3.663616180419922,
                    "B1 nu=4": 4.562432098388672, "B2 nu=4": 8.639756774902343,
                    "B3 nu=4": 7.393312072753906, "B4 nu=4": 2.8488128662109373,
                    "solve_s": 0.19500604299997804}
# the fp64 kernels of B2 (its terminal quadratization and its stage loop at
# nu = 6 and 4) and of the rollout (nu = 6 and 4), which must neither spill
# nor keep a stack frame
F64_FRAMELESS = ("traopt::terminal_kernel<double>", "traopt::riccati_f64_kernel<",
                 "traopt::rollout_f64_kernel<")
# the error-state tier: the three CLI problems at N = 400 in f64 against
# their JAX goldens (the same iterations and flags, us to 1e-6, J to 1e-8)
ES_US_GATE, ES_J_GATE = 1e-6, 1e-8
# the one-device sweeps: one lane of each range against a B = 1 solve on
# the host (1e-9) or a serial step loop on the card (1e-12)
SWEEP_GATE, ROLLOUT_GATE = 1e-9, 1e-12
# the task CLI on the stand-in pickles: each task with its flags (the exact
# tasks in f64, the batch tasks at the card's sizes in f32), its controls
# against the pickle's JAX solution (tests/test_task_cli.py's gate), the
# batch MPC against a direct `make_closed_loop_batch` call on the same draws
CLI_TASKS = (("se3_tracking_ms", ("--x64",)), ("drone_ms", ("--x64",)),
             ("pendulum3d_ms", ("--x64",)), ("so3_tracking_ms", ("--x64",)),
             ("mpc_batch", ()), ("mpc_batch_constrained", ()), ("al_batch", ()),
             ("cartpole", ("--x64",)), ("dynamics_sim", ("--x64",)),
             ("cost_landscape", ("--x64",)))
CLI_US_GATE, CLI_MPC_GATE, CLI_GRID_GATE = 1e-4, 1e-6, 1e-12
# the kernels each CLI task launches on the card (every other kernel 0)
CLI_KERNELS = {"se3_tracking_ms": {"B14"}, "mpc_batch": {"B1", "B2", "B3"},
               "mpc_batch_constrained": {"B1", "B2", "B3"}, "al_batch": {"B1", "B2", "B3"}}

# the multi-device layer on one card, in a one-rank NCCL group: the
# batch-sharded pipeline at the f32 path's shapes against PipelineSolver
# (SHARD_GATE; and each half of the batch solved alone against the full
# solve's rows, the lane independence a split relies on), the two-level
# time-sharded Riccati sweep at the AL horizon (N, nx, nu, B) in SHARD_BLOCKS
# blocks on the card and through the group against the one-device sweep
# (SHARD_SCAN_GATE), and LieILQR's time-sharded backward (f64, the rollout on
# B14) against its one-device backward (SHARD_LIE_GATE); the sharded and
# one-device pipeline solves timed in turns, SHARD_REPS each
SHARD_SCAN = (1400, 12, 6, 16)
SHARD_BLOCKS = (2, 8)
SHARD_LIE_BATCH, SHARD_LIE_ITERS = 64, 6
SHARD_GATE, SHARD_SCAN_GATE, SHARD_LIE_GATE = 1e-6, 1e-8, 1e-9
SHARD_REPS = 3
# first, make_batch_mesh() in a process with no group (a one-process NCCL
# group): BatchSolver(mesh) on one range of the sweep task's problem and the
# rollout sweep (SHARD_ROLLOUT_STEPS steps) through it, and the CLI's `sweep`
# task (its J range per parameter), each against its one-device run
SHARD_SWEEP_RANGE, SHARD_ROLLOUT_STEPS, SHARD_SWEEP_GATE = "v_x", 200, 1e-9

KERNELS = {
    "B1": ("linearize", "csrc/linearize.cu",
           "trajectory_optimization_matrix_lie_groups_tpu/ops/pallas_linearize.py:123"),
    "B2": ("riccati backward", "csrc/pipeline.cu",
           "trajectory_optimization_matrix_lie_groups_tpu/solvers/pipeline.py:189"),
    "B3": ("rollout + linearize", "csrc/pipeline.cu",
           "trajectory_optimization_matrix_lie_groups_tpu/solvers/pipeline.py:304"),
    "B4": ("rollout", "csrc/pipeline.cu",
           "trajectory_optimization_matrix_lie_groups_tpu/solvers/pipeline.py:274"),
    "B5": ("mixed riccati backward", "csrc/polish.cu",
           "trajectory_optimization_matrix_lie_groups_tpu/solvers/df_mixed.py:285"),
    "B6": ("mixed rollout", "csrc/polish.cu",
           "trajectory_optimization_matrix_lie_groups_tpu/solvers/df_mixed.py:391"),
    "B7": ("mixed defect (linearize tail)", "csrc/polish.cu",
           "trajectory_optimization_matrix_lie_groups_tpu/solvers/df_mixed.py:335"),
    "B8": ("mixed jacobian (linearize tail)", "csrc/polish.cu",
           "trajectory_optimization_matrix_lie_groups_tpu/solvers/df_mixed.py:354"),
    "B9": ("mixed cost quad (linearize tail)", "csrc/polish.cu",
           "trajectory_optimization_matrix_lie_groups_tpu/solvers/df_mixed.py:371"),
    "B10": ("SO(3) linearize", "csrc/so3.cu",
            "trajectory_optimization_matrix_lie_groups_tpu/solvers/pipeline_so3.py:152"),
    "B11": ("SO(3) riccati backward", "csrc/so3.cu",
            "trajectory_optimization_matrix_lie_groups_tpu/solvers/pipeline_so3.py:181"),
    "B12": ("SO(3) rollout + linearize", "csrc/so3.cu",
            "trajectory_optimization_matrix_lie_groups_tpu/solvers/pipeline_so3.py:211"),
    "B13": ("generic riccati backward", "csrc/fast.cu",
            "trajectory_optimization_matrix_lie_groups_tpu/ops/pallas_riccati.py:104"),
    "B13any": ("generic riccati backward, runtime shape", "csrc/fast.cu",
               "trajectory_optimization_matrix_lie_groups_tpu/ops/pallas_riccati.py:104"),
    "B13nuL": ("generic riccati backward, large nu", "csrc/fast_large.cuh",
               "trajectory_optimization_matrix_lie_groups_tpu/ops/pallas_riccati.py:104"),
    "B14": ("gap-closing rollout", "csrc/fast.cu",
            "trajectory_optimization_matrix_lie_groups_tpu/ops/pallas_rollout.py:42"),
    "B1nu": ("linearize, runtime nu", "csrc/pipeline_nu.cu",
             "trajectory_optimization_matrix_lie_groups_tpu/ops/pallas_linearize.py:123"),
    "B2nu": ("riccati backward, runtime nu", "csrc/pipeline_nu.cu",
             "trajectory_optimization_matrix_lie_groups_tpu/solvers/pipeline.py:189"),
    "B3nu": ("rollout + linearize, runtime nu", "csrc/pipeline_nu.cu",
             "trajectory_optimization_matrix_lie_groups_tpu/solvers/pipeline.py:304"),
    "B4nu": ("rollout, runtime nu", "csrc/pipeline_nu.cu",
             "trajectory_optimization_matrix_lie_groups_tpu/solvers/pipeline.py:274"),
    "B5nu": ("mixed riccati backward, runtime nu", "csrc/polish_nu.cu",
             "trajectory_optimization_matrix_lie_groups_tpu/solvers/df_mixed.py:285"),
    "B6nu": ("mixed rollout, runtime nu", "csrc/polish_nu.cu",
             "trajectory_optimization_matrix_lie_groups_tpu/solvers/df_mixed.py:391"),
    "B1nuL": ("linearize, large nu", "csrc/pipeline_nu.cu",
              "trajectory_optimization_matrix_lie_groups_tpu/ops/pallas_linearize.py:123"),
    "B2nuL": ("riccati backward, large nu", "csrc/pipeline_nu.cu",
              "trajectory_optimization_matrix_lie_groups_tpu/solvers/pipeline.py:189"),
    "B3nuL": ("rollout + linearize, large nu", "csrc/pipeline_nu.cu",
              "trajectory_optimization_matrix_lie_groups_tpu/solvers/pipeline.py:304"),
    "B4nuL": ("rollout, large nu", "csrc/pipeline_nu.cu",
              "trajectory_optimization_matrix_lie_groups_tpu/solvers/pipeline.py:274"),
    "B5nuL": ("mixed riccati backward, large nu", "csrc/polish_nu.cu",
              "trajectory_optimization_matrix_lie_groups_tpu/solvers/df_mixed.py:285"),
    "B6nuL": ("mixed rollout, large nu", "csrc/polish_nu.cu",
              "trajectory_optimization_matrix_lie_groups_tpu/solvers/df_mixed.py:391"),
}
PKG = "trajectory_optimization_matrix_lie_groups_tpu_torch"


T0 = time.perf_counter()


def emit(obj):
    """Print one JSON line; a phase line also gets the script's elapsed
    seconds."""
    if "phase" in obj:
        obj = {**obj, "elapsed_s": time.perf_counter() - T0}
    print(json.dumps(obj), flush=True)


def require(cond, what):
    if not cond:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


def nvidia_smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def timed(fn, sync=True):
    """(result, seconds) on the host clock around fn, synchronized."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    if sync:
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def event_ms(fn, reps):
    """Mean milliseconds per call over ``reps`` calls, by CUDA events."""
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def bound(name, s, out):
    """{"bound_ms", "bound_by", "bytes", "ops"} of kernel ``name`` on the
    inputs ``s`` with the outputs ``out`` (`kernel_check.work`)."""
    from trajectory_optimization_matrix_lie_groups_tpu_torch import kernel_check

    wk = kernel_check.work(name, s, out)
    ms, by = kernel_check.bound_ms(wk)
    return {"bound_ms": ms, "bound_by": by, "bytes": wk["bytes"],
            "ops": {str(dt).replace("torch.", ""): n for dt, n in wk["ops"].items()}}


def _lanes(x, sel, B):
    """``x`` (a tensor, or a dict/tuple/list of them) on the host, every
    lane-layout tensor (last axis B) cut to the lanes ``sel``."""
    if isinstance(x, dict):
        return {k: _lanes(v, sel, B) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_lanes(v, sel, B) for v in x)
    if isinstance(x, torch.Tensor):
        return (x[..., sel] if x.dim() and x.shape[-1] == B else x).cpu()
    return x


def _lane_errors(kern_out, plain_out, names, sel, B):
    """{"max_rel", "max_abs", "per_output"} of a kernel's outputs (on the
    card, every lane) against its plain version's on the host lanes, each
    a list of tensors in ``names`` order."""
    from trajectory_optimization_matrix_lie_groups_tpu_torch import kernel_check

    a = [_lanes(x, sel, B) for x in kern_out]
    per = {n: kernel_check.rel_err(x, y) for n, x, y in zip(names, a, plain_out, strict=True)}
    return {"max_rel": max(per.values()),
            "max_abs": max((x.double() - y.double()).abs().max().item()
                           for x, y in zip(a, plain_out)),
            "per_output": per}


def constrained_phases(dev, card, counted, expect):
    """The constrained path (`kernels_al`, `solve_al`, `solve_al_fast`,
    `solve_mpc`, `timing_al`); see the module docstring."""
    from trajectory_optimization_matrix_lie_groups_tpu_torch import kernel_check
    from trajectory_optimization_matrix_lie_groups_tpu_torch.models import constraints as cs
    from trajectory_optimization_matrix_lie_groups_tpu_torch.models import costs, dynamics
    from trajectory_optimization_matrix_lie_groups_tpu_torch.models.base import make_model
    from trajectory_optimization_matrix_lie_groups_tpu_torch.ops.group import SE3
    from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers import al_pipeline as AP
    from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers import batched as F
    from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers import df_mixed as DM
    from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers import mpc as MPC
    from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers import pipeline as P
    from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.al_fast import (
        ALFastSolver,
    )
    from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.df_pipeline import (
        join_us,
    )
    from trajectory_optimization_matrix_lie_groups_tpu_torch.tasks import al_bench

    us_gold, meta = al_bench.load_al1400_golden()
    al = {dt: al_bench.build_al1400(dt, AL_N, dev) for dt in (torch.float32, torch.float64)}
    params32, lb, ub, q0, xi0 = al[torch.float32][:5]
    params64 = al[torch.float64][0]
    dt_al = float(params32["dyn"].dt)
    q0s, xi0s = al_bench.screw_batch(q0, xi0, AL_BATCH, SEED)
    us0 = torch.zeros((AL_BATCH, AL_N, 6), dtype=torch.float32, device=dev)
    al_args = (params32["dyn"], params32["cost"], q0s, xi0s, us0)
    sel = list(range(AL_CHECK_LANES // 2)) + list(range(AL_BATCH - AL_CHECK_LANES // 2,
                                                        AL_BATCH))

    # -- kernels_al: B2 (AL diagonal), B3, B5 (AL diagonal), B6 and B7-B9 at
    # N = 1400, B = 1024, against their plain versions on the host lanes ------
    kal = {}
    s = kernel_check.kernel_inputs(P.PipelineSolver(AL_N, 2, dt_al), *al_args, luu_al=True,
                                   seed=SEED, kernel_gains=True)
    pairs = kernel_check.calls(s, dt=dt_al)
    host = kernel_check.calls(_lanes(s, sel, AL_BATCH), dt=dt_al)
    flat = kernel_check._flat
    for k in ("B2_al", "B3"):
        kal[k] = {**_lane_errors(flat(pairs[k][0]()), flat(host[k][1]()),
                                 kernel_check.OUTPUTS[k], sel, AL_BATCH),
                  "gate": kernel_check.GATES[torch.float32][k], "ms": event_ms(pairs[k][0], 3),
                  **bound(k, s, pairs[k][0]())}
    del s, pairs, host
    mx_check = DM.MixedDFPipelineSolver(AL_N, dt_al, 2, AL_POLISH_ITERS)
    s = kernel_check.polish_inputs(mx_check, params64["dyn"], params64["cost"], q0s, xi0s,
                                   us0.double(), luu_al=True, seed=SEED, kernel_gains=True)
    pairs = kernel_check.polish_calls(s, mx_check)
    host = kernel_check.polish_calls(_lanes(s, sel, AL_BATCH), mx_check)
    for k in ("B5_al", "B6", "tail"):
        names = kernel_check.POLISH_OUTPUTS[k]
        listed = lambda out: list(kernel_check._named(out, names).values())
        e = _lane_errors(listed(pairs[k][0]()), listed(host[k][1]()), names, sel, AL_BATCH)
        gates = (kernel_check.GATES["mixed"][k] if k != "tail" else
                 {o: g for t in kernel_check.TAIL for o, g in
                  kernel_check.GATES["mixed"][t].items()})
        kal[k] = {**e, "gate": gates, "ms": event_ms(pairs[k][0], 3),
                  **bound(k, s, pairs[k][0]())}
    del s, pairs, host
    emit({"phase": "kernels_al", "N": AL_N, "B": AL_BATCH, "host_lanes": sel,
          "metric": "max_rel = max|kernel - plain| / max(1, max|plain|) per output, kernel "
                    "on the card, plain on the host lanes", "card": card, **kal})
    for k, v in kal.items():
        for o, e in v["per_output"].items():
            gate = v["gate"][o] if isinstance(v["gate"], dict) else v["gate"]
            require(e <= gate, f"{k} at N={AL_N} output {o}: {e} > {gate}")

    # -- solve_al: the f32 AL loop, then both polishes ---------------------------
    loop = AP.ALPipelineSolver(P.PipelineSolver(AL_N, AL_ITERS, dt_al), lb, ub,
                               tol_constr=AL_TOL)
    res, loop_s, per_loop = counted(lambda: loop.solve(*al_args, n_al_iters=AL_OUTERS))
    outers = res.outer_iterations
    loop_err = float(np.abs(res.us[0].double().cpu().numpy() - us_gold).max())
    maxv = res.max_violation
    mx = DM.MixedDFPipelineSolver(AL_N, dt_al, AL_ITERS, AL_POLISH_ITERS)
    p64 = {"dyn": params64["dyn"], "cost": params64["cost"]}
    (dev_out, lam_d, imu_d), dev_s, per_pol = counted(lambda: AP.al_polish_device(
        mx, p64, lb, ub, res, q0s, xi0s, n_outers=AL_POLISH_OUTERS))
    us_dev = join_us(dev_out)
    dev_err = float(np.abs(us_dev[0].cpu().numpy() - us_gold).max())
    # a lane the fallback took back holds the f32 controls and no remainder
    took_d = ((dev_out.us_hi == res.us).all(dim=(1, 2))
              & (dev_out.us_lo == 0).all(dim=(1, 2)))
    timings = {}
    (us_host, _, lam_h, imu_h), host_s = timed(lambda: AP.al_polish(
        mx, p64, lb, ub, res, q0s, xi0s, n_outers=AL_POLISH_OUTERS, timings=timings))
    host_err = float(np.abs(us_host[0] - us_gold).max())
    took_h = (us_host == res.us.double().cpu().numpy()).all(axis=(1, 2))
    box = 10.0 * (1 + 1e-3)
    emit({"phase": "solve_al", "N": AL_N, "B": AL_BATCH, "inner_iterations": AL_ITERS,
          "n_al_iters": AL_OUTERS, "outers_used": outers, "converged": res.constr_converged,
          "launches_f32_loop": per_loop, "max_violation_max": maxv.max().item(),
          "max_violation_p50": maxv.median().item(), "tol": AL_TOL,
          "f32_loop_lane0_us_max_abs_err": loop_err, "golden_outer_iterations":
              meta["outer_iterations"], "golden_J": meta["J"],
          "lane0_J_augmented": res.J_opt[0].item(),
          "f32_all_finite": bool(torch.isfinite(res.us).all().item()),
          "polish_outers": AL_POLISH_OUTERS, "polish_f32_iterations": AL_ITERS,
          "polish_iterations": AL_POLISH_ITERS, "launches_polish_device": per_pol,
          "polish_device_lane0_us_max_abs_err": dev_err,
          "polish_host_lane0_us_max_abs_err": host_err, "gate": AL_GATE,
          "polish_device_max_abs_u": us_dev.abs().max().item(),
          "polish_host_max_abs_u": float(np.abs(us_host).max()), "box_gate": box,
          "fallback_share_device": took_d.double().mean().item(),
          "fallback_share_host": float(took_h.mean()),
          "polish_device_vs_host_us_max_abs": float(np.abs(us_dev.cpu().numpy()
                                                           - us_host).max()),
          "f32_loop_s": loop_s, "polish_device_s": dev_s, "polish_host_s": host_s})
    require(res.constr_converged and maxv.max().item() < AL_TOL,
            f"f32 AL loop: max violation {maxv.max().item()} after {outers} outers")
    require(per_loop == expect(B1=outers, B2=outers * AL_ITERS, B3=outers * AL_ITERS),
            f"f32 AL loop launch counts {per_loop}")
    n = AL_POLISH_OUTERS
    require(per_pol == expect(B1=n, B2=n * AL_ITERS, B3=n * AL_ITERS,
                              **{k: n * AL_POLISH_ITERS for k in ("B5", "B6", "B7", "B8", "B9")}),
            f"polish launch counts {per_pol}")
    require(dev_err <= AL_GATE, f"al_polish_device lane-0 us err {dev_err} > {AL_GATE}")
    require(host_err <= AL_GATE, f"al_polish lane-0 us err {host_err} > {AL_GATE}")
    require(us_dev.abs().max().item() <= box and float(np.abs(us_host).max()) <= box,
            "polished controls leave the box")
    require(bool(torch.isfinite(us_dev).all().item()) and bool(np.isfinite(us_host).all()),
            "non-finite polished controls")
    # the device polish's parts: one polish solve and one dual ascent step
    sol = lambda: mx.solve(p64["dyn"], p64["cost"], q0s, xi0s, res.us,
                           al=(lb, ub, lam_d, imu_d))
    _, one_solve_s = timed(sol)
    mu = imu_d.max()
    lbv, ubv = (torch.full((6,), b, dtype=torch.float32, device=dev) for b in (lb, ub))
    ascent_ms = event_ms(lambda: AP._dual_update(dev_out.us_hi, dev_out.us_lo, lam_d, imu_d,
                                                 mu, lbv, ubv, 10.0, 1e8), 5)
    del dev_out, us_dev, us_host, lam_d, imu_d, lam_h, imu_h

    # -- solve_al_fast: the AL fast tier on the first 200 stages, and the
    # pipeline on the same inputs with the same inner budget ---------------------
    pf = al_bench.build_al1400(torch.float32, AL_FAST_N, dev)[0]
    fq0s, fxi0s = al_bench.screw_batch(q0, xi0, AL_FAST_BATCH, SEED)
    fus0 = torch.zeros((AL_FAST_BATCH, AL_FAST_N, 6), dtype=torch.float32, device=dev)
    constr = cs.input_box(12, 6)
    model_c, _ = make_model(dynamics.se3_dynamics(),
                            costs.al_cost(costs.tracking_cost(SE3, 6), constr), pf["dyn"], None)
    bx = cs.input_box_params(torch.tensor(lb, dtype=torch.float32, device=dev),
                             torch.tensor(ub, dtype=torch.float32, device=dev), 6)
    alp = costs.al_init_params(pf["cost"], bx, AL_FAST_N, 12, dtype=torch.float32)
    fast = ALFastSolver(F.FastBatchSolver(model_c, AL_FAST_N, AL_FAST_ITERS,
                                          pallas_rollout_dt=dt_al), constr, tol_constr=AL_TOL)
    fres, fast_s, per_fast = counted(lambda: fast.solve(
        {"dyn": pf["dyn"], "cost": alp}, fq0s, fxi0s, fus0, n_al_iters=AL_FAST_OUTERS,
        rescue=True))
    pres, pipe_s, _ = counted(lambda: AP.ALPipelineSolver(
        P.PipelineSolver(AL_FAST_N, AL_FAST_ITERS, dt_al), lb, ub, tol_constr=AL_TOL).solve(
            pf["dyn"], pf["cost"], fq0s, fxi0s, fus0, n_al_iters=AL_FAST_OUTERS))
    fo = fres.outer_iterations
    J_rel = abs(fres.J_opt[0].item() - pres.J_opt[0].item()) / abs(pres.J_opt[0].item())
    rescue_ls_iterations = per_fast["B13"] - fo * AL_FAST_ITERS
    emit({"phase": "solve_al_fast", "N": AL_FAST_N, "B": AL_FAST_BATCH,
          "inner_iterations": AL_FAST_ITERS, "n_al_iters": AL_FAST_OUTERS,
          "fast_outers_used": fo, "fast_converged": bool(fres.constr_converged),
          "fast_max_violation": fres.max_violation.max().item(), "launches": per_fast,
          "rescue_line_search_iterations": rescue_ls_iterations,
          "pipeline_outers_used": pres.outer_iterations,
          "pipeline_converged": pres.constr_converged,
          "pipeline_max_violation": pres.max_violation.max().item(),
          "lane0_J_fast": fres.J_opt[0].item(), "lane0_J_pipeline": pres.J_opt[0].item(),
          "lane0_J_rel": J_rel, "gate": 1e-4,
          "fast_all_finite": bool(torch.isfinite(fres.us).all().item()),
          "fast_s": fast_s, "pipeline_s": pipe_s})
    require(bool(fres.constr_converged) and pres.constr_converged,
            "AL fast / pipeline: not every lane converged")
    require(rescue_ls_iterations >= 0 and rescue_ls_iterations % 60 == 0
            and per_fast == expect(B13=per_fast["B13"], B14=per_fast["B13"]),
            f"AL fast launch counts {per_fast}")
    require(J_rel <= 1e-4, f"AL fast vs pipeline lane-0 J rel {J_rel}")
    del fres, pres, fus0

    # -- solve_mpc: both batch drivers on screw-200 ---------------------------------
    model, mp, mq0, mxi0 = al_bench.screw200_model(torch.float32, dev,
                                                   horizon=MPC_T + MPC_H)
    mdyn, mcost = mp["dyn"], mp["cost"]
    pipe = P.PipelineSolver(MPC_H, MPC_ITERS, dt_al)
    mq0s, mxi0s = al_bench.screw_batch(mcost.q_ref[0], mcost.xi_ref[0], MPC_BATCH, SEED)
    run = MPC.make_closed_loop_batch(pipe, model, MPC_T)
    mres, mpc_s, per_mpc = counted(lambda: run(mdyn, mcost, mq0s, mxi0s))
    err = lambda qs, t: torch.linalg.norm(SE3.log(qs @ mcost.q_ref_inv[t]), dim=-1)
    e0, eT = err(mq0s, 0).mean().item(), err(mres.qs[:, -1], MPC_T).mean().item()
    # lanes 0..3: a host loop of PipelineSolver.solve on the card
    qs, xis = mq0s[:MPC_HOST_LANES], mxi0s[:MPC_HOST_LANES]
    us_w = torch.zeros((MPC_HOST_LANES, MPC_H, 6), dtype=torch.float32, device=dev)
    host_dev = 0.0
    for t in range(MPC_HOST_STEPS):
        out = pipe.solve(mdyn, MPC._window(mcost, t, MPC_H), qs, xis, us_w)
        host_dev = max(host_dev, (mres.us[:MPC_HOST_LANES, t] - out.us[:, 0]).abs().max().item())
        qs, xis = model.step(mp, qs, xis, out.us[:, 0], 0)
        us_w = torch.cat([out.us[:, 1:], out.us[:, -1:]], dim=1)
    # the box driver, and the unconstrained driver, from the offset start
    oq0s, oxi0s = al_bench.screw_batch(mq0, mxi0, MPC_BATCH, SEED)
    (cres, cmaxv), cmpc_s, per_cmpc = counted(lambda: MPC.make_closed_loop_batch_constrained(
        pipe, model, MPC_T, lb, ub, n_al_iters=MPC_AL_OUTERS)(mdyn, mcost, oq0s, oxi0s))
    ures = run(mdyn, mcost, oq0s, oxi0s)
    # the same box driver's first steps with the rescue
    resc_model, _ = make_model(dynamics.se3_dynamics(),
                               costs.al_cost(costs.tracking_cost(SE3, 6), constr), mdyn, None)
    rescue = ALFastSolver(F.FastBatchSolver(resc_model, MPC_H, MPC_ITERS,
                                            pallas_rollout_dt=dt_al), constr, tol_constr=AL_TOL)
    (rres, rmaxv), rescue_s, per_resc = counted(lambda: MPC.make_closed_loop_batch_constrained(
        pipe, model, MPC_RESCUE_T, lb, ub, n_al_iters=MPC_AL_OUTERS, rescue=rescue,
        rescue_outers=MPC_RESCUE_OUTERS)(mdyn, mcost, oq0s, oxi0s))
    fin = all(bool(torch.isfinite(x).all().item()) for x in (*mres, *cres, *rres))
    emit({"phase": "solve_mpc", "B": MPC_BATCH, "H": MPC_H, "T": MPC_T,
          "iterations_per_step": MPC_ITERS, "launches": per_mpc,
          "mean_tracking_err_initial": e0, "mean_tracking_err_final": eT,
          f"host_loop_lanes0_{MPC_HOST_LANES - 1}_steps0_{MPC_HOST_STEPS - 1}_max_abs_du":
              host_dev, "host_loop_gate": 1e-6, "mpc_s": mpc_s,
          "mpc_solves_per_s": MPC_BATCH * MPC_T / mpc_s,
          "box": [lb, ub], "n_al_iters": MPC_AL_OUTERS, "launches_box": per_cmpc,
          "unconstrained_max_abs_u_offset_start": ures.us.abs().max().item(),
          "box_max_abs_u_applied": cres.us.abs().max().item(),
          "box_mean_planned_violation": cmaxv.mean().item(),
          "box_max_planned_violation": cmaxv.max().item(), "box_mpc_s": cmpc_s,
          "box_mpc_solves_per_s": MPC_BATCH * MPC_T / cmpc_s,
          "rescue_T": MPC_RESCUE_T, "rescue_outers": MPC_RESCUE_OUTERS,
          "rescue_launches": per_resc,
          "rescue_steps": per_resc["B13"] // 60,
          "no_rescue_max_planned_violation_per_step":
              cmaxv[:, :MPC_RESCUE_T].amax(dim=0).tolist(),
          "rescue_max_planned_violation_per_step": rmaxv.amax(dim=0).tolist(),
          "rescue_s": rescue_s, "all_finite": fin})
    require(per_mpc == expect(B1=MPC_T, B2=MPC_T * MPC_ITERS, B3=MPC_T * MPC_ITERS),
            f"MPC launch counts {per_mpc}")
    n = MPC_T * MPC_AL_OUTERS
    require(per_cmpc == expect(B1=n, B2=n * MPC_ITERS, B3=n * MPC_ITERS),
            f"box MPC launch counts {per_cmpc}")
    require(fin, "non-finite MPC lanes")
    require(eT < e0, f"MPC tracking error {eT} not below the initial {e0}")
    require(host_dev <= 1e-6, f"MPC vs host loop {host_dev} > 1e-6")
    require(cres.us.max().item() <= ub and cres.us.min().item() >= lb,
            "box MPC applied controls leave the box")
    require(rres.us.max().item() <= ub and rres.us.min().item() >= lb,
            "rescue MPC applied controls leave the box")
    require(per_resc["B13"] > 0, "the MPC rescue never ran (no lane above tolerance)")

    emit({"phase": "timing_al", "card": card,
          "f32_al_loop": {"N": AL_N, "B": AL_BATCH, "s": loop_s, "outers": outers,
                          "solves_per_s": AL_BATCH / loop_s},
          "polish_device": {"s": dev_s, "one_polish_solve_s": one_solve_s,
                            "one_dual_ascent_ms": ascent_ms, "outers": AL_POLISH_OUTERS},
          "polish_host": {"s": host_s, **timings},
          "al_fast": {"N": AL_FAST_N, "B": AL_FAST_BATCH, "s": fast_s, "outers": fo,
                      "solves_per_s": AL_FAST_BATCH / fast_s},
          "al_pipeline_same_inputs": {"s": pipe_s, "solves_per_s": AL_FAST_BATCH / pipe_s},
          "mpc": {"B": MPC_BATCH, "T": MPC_T, "H": MPC_H, "s": mpc_s,
                  "solves_per_s": MPC_BATCH * MPC_T / mpc_s},
          "mpc_box": {"s": cmpc_s, "solves_per_s": MPC_BATCH * MPC_T / cmpc_s},
          "mpc_rescue": {"T": MPC_RESCUE_T, "s": rescue_s},
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})


def host_task(task):
    """One host-side reference solve on the CPU, in a worker process (one
    torch thread), its inputs rebuilt there from the same seeds: the plain
    versions' solves of lanes 0..15 that the f32, SO(3) and fast-tier phases
    hold their kernels' solves against, and the reference-exact tier's B = 1
    solves (`host_exact`).  A plain solve returns (J_opt, us, seconds) as
    numpy arrays and the worker's time."""
    from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers import batched as F
    from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers import pipeline as P
    from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers import pipeline_so3 as S
    from trajectory_optimization_matrix_lie_groups_tpu_torch.tasks import al_bench, so3_bench

    if task[0] in ("single", "mpc", "sweep"):
        return host_exact(task)
    torch.set_num_threads(1)
    cpu, f32 = torch.device("cpu"), torch.float32
    lanes = slice(0, HOST_LANES)
    t0 = time.perf_counter()
    if task[0] == "pipeline":
        dyn, cost, q0, xi0 = al_bench.build_screw200(f32, cpu, horizon=N)
        q0s, xi0s = al_bench.screw_batch(q0, xi0, BATCH, SEED)
        out = P.PipelineSolver(N, ITERS, float(dyn.dt), plain=True).solve(
            dyn, cost, q0s[lanes], xi0s[lanes], torch.zeros((HOST_LANES, N, 6), dtype=f32))
    elif task[0] == "so3":
        name = task[1]
        pendulum, dt_p, n_p = so3_bench.PROBLEMS[name][:3]
        build = (so3_bench.build_pendulum_swingup80 if pendulum
                 else so3_bench.build_so3_track249)
        dyn, cost, q0, xi0 = build(f32, cpu)
        q0s, xi0s = so3_bench.so3_batch(q0, xi0, BATCH, SEED)
        out = S.SO3PipelineSolver(n_p, SO3_ITERS, dt_p, pendulum=pendulum, plain=True).solve(
            dyn, cost, q0s[lanes], xi0s[lanes], torch.zeros((HOST_LANES, n_p, 3), dtype=f32))
    else:
        _, kind, iterations, dtype, B, scale, kw = task
        dtype = getattr(torch, dtype)
        model, params, q0, xi0 = al_bench.screw200_model(dtype, cpu, horizon=N,
                                                         drone=kind == "drone")
        q0s, xi0s = al_bench.screw_batch(q0, xi0, B, SEED, scale=scale)
        if kind == "free_body":
            kw = dict(pallas_rollout_dt=float(params["dyn"].dt), use_pallas_linearize=True,
                      **kw)
        cp = params["cost"]
        out = F.FastBatchSolver(model, N, iterations, plain=True, **kw).solve(
            params, q0s[lanes], xi0s[lanes],
            torch.zeros((HOST_LANES, N, model.nu), dtype=dtype), cp.q_ref, cp.xi_ref)
    return out.J_opt.numpy(), out.us.numpy(), time.perf_counter() - t0


# the host-side plain solves, submitted when the run starts
HOST_PLAIN = {
    "f32": ("pipeline",),
    "so3_track249": ("so3", "so3_track249"),
    "pendulum_swingup80": ("so3", "pendulum_swingup80"),
    "fast free_body": ("fast", "free_body", ITERS, "float32", BATCH, 0.05, {}),
    "fast drone": ("fast", "drone", DRONE_ITERS, "float32", BATCH, 0.05, {}),
    "fast line_search": ("fast", "free_body", LS_ITERS, "float64", LS_BATCH, LS_SCALE,
                         {"line_search": True}),
}


def host_plain(host, key):
    """(solve with J_opt and us as CPU tensors, seconds it took in its
    worker) of the host-side plain solve ``key`` of `HOST_PLAIN`."""
    J, us, sec = host[key].get(timeout=HOST_WAIT_S)
    return types.SimpleNamespace(J_opt=torch.as_tensor(J), us=torch.as_tensor(us)), sec


def exact_problem(name, dev):
    """(model, params, q0s, xi0s, us0, golden us, golden meta, rollout dt) of
    a reference-exact problem in f64 at EXACT_BATCH lanes, lane 0
    unperturbed and the others q0 Exp(0.05 n); the rollout dt is the free
    body's step (its rollout on B14), else None."""
    from trajectory_optimization_matrix_lie_groups_tpu_torch.models import costs, dynamics
    from trajectory_optimization_matrix_lie_groups_tpu_torch.models.base import make_model
    from trajectory_optimization_matrix_lie_groups_tpu_torch.ops.group import SO3
    from trajectory_optimization_matrix_lie_groups_tpu_torch.tasks import al_bench, so3_bench

    f64 = torch.float64
    kernel_dt = None
    if name == "screw200":
        model, params, q0, xi0 = al_bench.screw200_model(f64, dev, horizon=N)
        gold = al_bench.load_screw200_golden()
        q0s, xi0s = al_bench.screw_batch(q0, xi0, EXACT_BATCH, SEED)
        kernel_dt = float(params["dyn"].dt)
    else:
        if name == "so3_track249":
            model, params, q0, xi0 = so3_bench.so3_track249_model(f64, dev)
        else:
            dyn, cost, q0, xi0 = so3_bench.build_pendulum_swingup80(f64, dev)
            model, params = make_model(dynamics.pendulum3d_dynamics(), costs.tracking_cost(
                SO3, 3, ref_so3_terminal_quirk=True), dyn, cost)
        gold = so3_bench.load_so3_golden(name)
        q0s, xi0s = so3_bench.so3_batch(q0, xi0, EXACT_BATCH, SEED)
    us0 = torch.zeros((EXACT_BATCH, gold[0].shape[0], model.nu), dtype=f64, device=dev)
    return model, params, q0s, xi0s, us0, *gold, kernel_dt


def exact_solver(model, us_g, meta, kernel_dt, **cfg):
    """The reference-exact `LieILQR` of a problem of `exact_problem`: to the
    golden's own final gradient norm, at most EXACT_MAX_ITERS iterations."""
    from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.lie_ilqr import (
        LieILQR,
        SolverConfig,
    )

    return LieILQR(model, SolverConfig(N=us_g.shape[0], tol_grad_norm=meta["grad_norm_f64"],
                                       max_iterations=EXACT_MAX_ITERS, **cfg),
                   pallas_rollout_dt=kernel_dt)


def exact_mpc_setup(dev):
    """The closed-loop MPC problem (screw-200 over T + H + 1 reference
    entries, f64), its plants' starts and the window solver."""
    from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.lie_ilqr import (
        LieILQR,
        SolverConfig,
    )
    from trajectory_optimization_matrix_lie_groups_tpu_torch.tasks import al_bench

    model, mp, _, _ = al_bench.screw200_model(torch.float64, dev,
                                              horizon=EXACT_MPC_T + EXACT_MPC_H)
    cp = mp["cost"]
    q0s, xi0s = al_bench.screw_batch(cp.q_ref[0], cp.xi_ref[0], EXACT_MPC_B, SEED)
    solver = LieILQR(model, SolverConfig(N=EXACT_MPC_H, max_iterations=EXACT_MPC_ITERS),
                     pallas_rollout_dt=float(mp["dyn"].dt))
    return model, mp, q0s, xi0s, solver


def host_exact(task):
    """A B = 1 reference solve on the host CPU, in a worker process:
    ("single", problem, lane) -> (us (N, nu), iterations) of that lane's
    `LieILQR.solve`; ("sweep", parameter, lane) -> the same of one point of
    the perturbation sweep (`BatchSolver.solve_batch` at B = 1); ("mpc",) ->
    (qs (T+1, 4, 4), us (T, 6)) of plant 0's closed loop as a host loop of
    B = 1 `LieILQR.solve` per step."""
    from trajectory_optimization_matrix_lie_groups_tpu_torch.parallel import sweep
    from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers import mpc as MPC
    from trajectory_optimization_matrix_lie_groups_tpu_torch.tasks import errstate_bench as EB

    torch.set_num_threads(1)
    cpu = torch.device("cpu")
    if task[0] == "sweep":
        _, name, b = task
        bs, params, q0, xi0 = EB.build_sweep(torch.float64, cpu)
        q0s, xi0s = sweep.build_x0_batch(name, EB.SWEEP_RANGES[name][b:b + 1], q0, xi0)
        one = bs.solve_batch(params, q0s, xi0s, torch.zeros((1, N, 6), dtype=torch.float64))
        return one.us[0].numpy(), int(one.iteration[0])
    if task[0] == "single":
        _, name, b = task
        model, params, q0s, xi0s, us0, us_g, meta, kdt = exact_problem(name, cpu)
        one = exact_solver(model, us_g, meta, kdt).solve(
            params, (q0s[b:b + 1], xi0s[b:b + 1]), us0[b:b + 1])
        return one.us[0].numpy(), int(one.iteration[0])
    model, mp, q0s, xi0s, solver = exact_mpc_setup(cpu)
    qs, xis = q0s[:1], xi0s[:1]
    us_w = torch.zeros((1, EXACT_MPC_H, 6), dtype=torch.float64)
    q_t, u_t = [qs[0]], []
    for t in range(EXACT_MPC_T):
        cp_t = MPC._window(mp["cost"], t, EXACT_MPC_H)
        out = solver.solve({**mp, "cost": cp_t}, (qs, xis), us_w, cp_t.q_ref, cp_t.xi_ref)
        qs, xis = model.step(mp, qs, xis, out.us[:, 0], 0)
        us_w = torch.cat([out.us[:, 1:], out.us[:, -1:]], dim=1)
        q_t.append(qs[0])
        u_t.append(out.us[0, 0])
    return torch.stack(q_t).numpy(), torch.stack(u_t).numpy()


def exact_phases(dev, card, counted, expect, rates, pool):
    """The reference-exact tier, the anchored tier and the full-precision
    refiners (`solve_exact_al`, `solve_anchored`, `solve_refine`,
    `solve_mpc_exact`, `solve_exact`); see the module docstring.  Their
    B = 1 reference solves (lanes 0..3 of each `solve_exact` problem, plant
    0's closed loop) run on the host in the worker processes of ``pool``
    while the card works; `solve_mpc_exact` and `solve_exact` are printed
    once those are in.  ``rates``: the free body's and the mixed polish's
    solves/s from their timing phases.  Returns {phase: launches} for the
    kernels line."""
    from trajectory_optimization_matrix_lie_groups_tpu_torch import kernel_check
    from trajectory_optimization_matrix_lie_groups_tpu_torch.models import constraints as cs
    from trajectory_optimization_matrix_lie_groups_tpu_torch.models import costs, dynamics
    from trajectory_optimization_matrix_lie_groups_tpu_torch.models.base import make_model
    from trajectory_optimization_matrix_lie_groups_tpu_torch.ops.group import SE3
    from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers import batched as F
    from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers import mpc as MPC
    from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers import pipeline as P
    from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.al_fast import (
        ALFastSolver,
    )
    from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.al_ilqr import ALILQR
    from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.anchored import (
        AnchoredFastSolver,
        build_anchored,
    )
    from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.df_pipeline import (
        DFPipelineSolver,
        join_us,
    )
    from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.lie_ilqr import (
        LieILQR,
        SolverConfig,
    )
    from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.polish import (
        HighPrecisionSolver,
    )
    from trajectory_optimization_matrix_lie_groups_tpu_torch.tasks import al_bench

    f64 = torch.float64
    runs = {}
    lane_err = lambda us, gold: float(np.abs(us.double().cpu().numpy() - gold).max())
    tasks = [("mpc",)] + [("single", n, b) for n in EXACT_PROBLEMS for b in range(EXACT_LANES)]
    host = {t: pool.apply_async(host_task, (t,)) for t in tasks}

    # -- solve_exact's batches: LieILQR on each problem at B = 1024 ----------
    exact = {}
    for name in EXACT_PROBLEMS:
        model, params, q0s, xi0s, us0, us_g, meta, kdt = exact_problem(name, dev)
        solver = exact_solver(model, us_g, meta, kdt)
        st, sec, runs[f"solve_exact {name}"] = counted(
            lambda: solver.solve(params, (q0s, xi0s), us0))
        its = st.iteration.max().item()
        row = {"phase": "solve_exact", "problem": name, "B": EXACT_BATCH,
               "N": us_g.shape[0],
               "config": "MS, backward sequential, rollout nonlinear"
                         + (" (B14)" if kdt else "") + ", no line search",
               "tol_grad_norm": meta["grad_norm_f64"],
               "launches": runs[f"solve_exact {name}"], "iterations_max": its,
               "iterations_lanes0_3": st.iteration[:EXACT_LANES].tolist(),
               "converged_share": st.converged.double().mean().item(),
               "lane0_grad_norm": st.grad_norm[0].item(),
               "lane0_us_max_abs_err": lane_err(st.us[0], us_g), "gate": EXACT_GATE,
               "all_finite": bool(torch.isfinite(st.us).all().item()),
               "solve_s": sec, "solves_per_s": EXACT_BATCH / sec,
               "ms_per_iteration": sec * 1e3 / its}
        if name == "screw200":
            # the associative backward and the linear rollout on the same
            # batch; the sequential backward's per-stage PD read against
            # the same recursion without it ('sequential_fixed'), on the
            # final linearization
            assoc = exact_solver(model, us_g, meta, None, backward="associative",
                                 rollout="linear")
            sa, sa_s, runs["solve_exact screw200 associative"] = counted(
                lambda: assoc.solve(params, (q0s, xi0s), us0))
            lin = solver._linearize(params, st.qs, st.xis, st.us)
            on = torch.ones(EXACT_BATCH, dtype=torch.bool, device=dev)
            fixed = exact_solver(model, us_g, meta, None, backward="sequential_fixed")
            seq_s = min(timed(lambda: solver._backward(lin, st.mu, st.delta, on))[1]
                        for _ in range(3))
            fix_s = min(timed(lambda: fixed._backward(lin, st.mu, st.delta, on))[1]
                        for _ in range(3))
            row.update({
                "associative_linear_iterations_max": sa.iteration.max().item(),
                "associative_linear_converged_share": sa.converged.double().mean().item(),
                "associative_linear_vs_sequential_us_max_abs":
                    (sa.us - st.us).abs().max().item(),
                "associative_gate": 1e-8, "associative_linear_s": sa_s,
                "associative_linear_ms_per_iteration":
                    sa_s * 1e3 / sa.iteration.max().item(),
                "sequential_backward_ms": seq_s * 1e3,
                "sequential_fixed_backward_ms": fix_s * 1e3})
            del sa, lin
        exact[name] = (row, st.us[:EXACT_LANES].cpu(), st.iteration[:EXACT_LANES].tolist())
        require(row["all_finite"], f"non-finite lanes in the {name} exact solve")
        require(runs[f"solve_exact {name}"] == expect(B14=its if kdt else 0),
                f"{name} exact launch counts {runs[f'solve_exact {name}']}")
        require(row["lane0_us_max_abs_err"] <= EXACT_GATE,
                f"{name} exact lane-0 us err {row['lane0_us_max_abs_err']} > {EXACT_GATE}")
        if name == "screw200":
            require(row["associative_linear_vs_sequential_us_max_abs"] <= 1e-8,
                    f"associative/linear vs sequential "
                    f"{row['associative_linear_vs_sequential_us_max_abs']}")
            require(runs["solve_exact screw200 associative"] == expect(),
                    "the associative/linear solve launched a kernel")
        del st

    # -- solve_exact_al: ALILQR on the AL problem's first EXACT_AL_N stages ---
    al_p, lb, ub, aq0, axi0 = al_bench.build_al1400(f64, EXACT_AL_N, dev)[:5]
    dt_al = float(al_p["dyn"].dt)
    aq0s, axi0s = al_bench.screw_batch(aq0, axi0, EXACT_AL_BATCH, SEED)
    aus0 = torch.zeros((EXACT_AL_BATCH, EXACT_AL_N, 6), dtype=f64, device=dev)
    constr = cs.input_box(12, 6)
    box = cs.input_box_params(torch.tensor(lb, dtype=f64, device=dev),
                              torch.tensor(ub, dtype=f64, device=dev), 6)
    model_c, _ = make_model(dynamics.se3_dynamics(), costs.al_cost(
        costs.tracking_cost(SE3, 6), constr), al_p["dyn"], None)
    alp = costs.al_init_params(al_p["cost"], box, EXACT_AL_N, 12, dtype=f64)
    al_solver = ALILQR(LieILQR(model_c, SolverConfig(N=EXACT_AL_N,
                                                     max_iterations=EXACT_AL_INNERS),
                               pallas_rollout_dt=dt_al), constr, tol_constr=AL_TOL)
    ares, al_s, runs["solve_exact_al"] = counted(lambda: al_solver.fit(
        {"dyn": al_p["dyn"], "cost": alp}, (aq0s, axi0s), aus0,
        n_al_iters=EXACT_AL_OUTERS, n_ilqr_iters=EXACT_AL_INNERS))
    inner_its = sum(len(h["J"]) for h in ares.inner_histories)
    maxv = ares.constr_eval.flatten(1).amax(dim=1)
    # the AL fast tier in f64 on lane 0, and the tracking cost of both
    fast = ALFastSolver(F.FastBatchSolver(model_c, EXACT_AL_N, AL_FAST_ITERS,
                                          pallas_rollout_dt=dt_al), constr,
                        tol_constr=AL_TOL)
    fres = fast.solve({"dyn": al_p["dyn"], "cost": alp}, aq0s[:1], axi0s[:1], aus0[:1],
                      n_al_iters=AL_FAST_OUTERS, rescue=True)
    track, _ = make_model(dynamics.se3_dynamics(), costs.tracking_cost(SE3, 6),
                          al_p["dyn"], None)

    def J_track(qs, xis, us):
        idx = torch.arange(EXACT_AL_N, device=dev)
        return (track.stage_cost(al_p, qs[:, :-1], xis[:, :-1], us, idx).sum(-1)
                + track.term_cost(al_p, qs[:, -1], xis[:, -1], EXACT_AL_N))

    J_al = J_track(ares.qs[:1], ares.xis[:1], ares.us[:1]).item()
    J_fast = J_track(fres.qs, fres.xis, fres.us).item()
    J_rel = abs(J_al - J_fast) / abs(J_fast)
    box_g = 10.0 * (1 + 1e-3)
    max_u = ares.us.abs().max().item()
    emit({"phase": "solve_exact_al", "N": EXACT_AL_N, "B": EXACT_AL_BATCH,
          "n_al_iters": EXACT_AL_OUTERS, "n_ilqr_iters": EXACT_AL_INNERS,
          "outer_iterations": ares.outer_iterations, "converged": ares.constr_converged,
          "inner_iterations_per_outer": [len(h["J"]) for h in ares.inner_histories],
          "launches": runs["solve_exact_al"], "max_violation_max": maxv.max().item(),
          "tol": AL_TOL, "max_abs_u": max_u, "box_gate": box_g,
          "lane0_J_tracking": J_al, "al_fast_f64_lane0_J_tracking": J_fast,
          "lane0_J_rel": J_rel, "J_gate": 1e-4, "al_fast_outers": fres.outer_iterations,
          "lane0_us_vs_al_fast_max_abs": (ares.us[0] - fres.us[0]).abs().max().item(),
          "solve_s": al_s, "ms_per_inner_iteration": al_s * 1e3 / inner_its,
          "solves_per_s": EXACT_AL_BATCH / al_s})
    require(ares.constr_converged and maxv.max().item() < AL_TOL,
            f"exact AL: max violation {maxv.max().item()} after {ares.outer_iterations}")
    require(max_u <= box_g, f"exact AL controls leave the box: {max_u}")
    require(J_rel <= 1e-4, f"exact AL vs AL fast lane-0 J rel {J_rel}")
    require(runs["solve_exact_al"] == expect(B14=inner_its),
            f"exact AL launch counts {runs['solve_exact_al']}")
    del ares, fres

    # -- solve_anchored: the anchored tier in f32 on B13 -----------------------
    us_gold, meta = al_bench.load_screw200_golden()
    ameta = al_bench.load_screw200_anchored_meta()
    dyn64, cost64, q0, xi0 = al_bench.build_screw200(f64, dev, horizon=N)
    prob = build_anchored(dyn64.J, dyn64.dt, torch.block_diag(cost64.Q1, cost64.Q2),
                          cost64.R, torch.block_diag(cost64.P1, cost64.P2), cost64.q_ref,
                          cost64.xi_ref, dtype=torch.float32, device=dev)
    nq0s, nxi0s = al_bench.screw_batch(q0, xi0, ANCHORED_BATCH, SEED)
    q0_locs = torch.linalg.inv(cost64.q_ref[0])[None] @ nq0s
    us32 = torch.zeros((ANCHORED_BATCH, N, 6), dtype=torch.float32, device=dev)
    anch = AnchoredFastSolver(prob, N, ANCHORED_ITERS)
    (aqs, _, aus, aJ, ag), anch_s, runs["solve_anchored"] = counted(
        lambda: anch.solve(q0_locs, nxi0s, us32))
    a_err = lane_err(aus[0], us_gold)
    a_gate = 10 * ameta["jax_anchored_f32"]["lane0_us_max_abs_err"]
    # the f32 pipeline on the same lanes and budget: its gradient norms
    dyn32, cost32 = al_bench.build_screw200(torch.float32, dev, horizon=N)[:2]
    pipe = P.PipelineSolver(N, ANCHORED_ITERS, float(dyn64.dt)).solve(
        dyn32, cost32, nq0s.float(), nxi0s.float(), us32)
    g_a, g_p = ag.double(), pipe.grad_norm.double()
    # B13 at (12, 6) on the anchored iterate against its plain version
    s = kernel_check.anchored_inputs(AnchoredFastSolver(prob, N, 2), q0_locs, nxi0s, us32)
    kern, plain = kernel_check.fast_calls(s)["B13"]
    e13 = kernel_check.fast_compare(s)["B13"]
    b13 = {"ms": event_ms(kern, 5), "plain_ms": event_ms(plain, 1),
           "max_err": e13["max_rel"], "max_abs_err": e13["max_abs"],
           "gate": kernel_check.GATES["fast"][torch.float32]["B13"],
           **bound("B13", s, kern()), "library_ms": None,
           "launches": runs["solve_anchored"]["B13"]}
    del s
    fin = bool(torch.isfinite(aus).all().item() and torch.isfinite(aqs).all().item())
    emit({"phase": "solve_anchored", "card": card, "B": ANCHORED_BATCH, "N": N,
          "iterations": ANCHORED_ITERS, "launches": runs["solve_anchored"],
          "all_finite": fin, "lane0_us_max_abs_err": a_err, "lane0_us_gate": a_gate,
          "jax_anchored_f32_lane0_us_max_abs_err":
              ameta["jax_anchored_f32"]["lane0_us_max_abs_err"],
          "lane0_J": aJ[0].item(), "golden_J": meta["J_f64"],
          "lane0_grad_norm": g_a[0].item(), "pipeline_lane0_grad_norm": g_p[0].item(),
          "grad_norm_p50": g_a.median().item(),
          "pipeline_grad_norm_p50": g_p.median().item(),
          "grad_norm_max": g_a.max().item(), "pipeline_grad_norm_max": g_p.max().item(),
          "B13_anchored": b13, "solve_s": anch_s,
          "solves_per_s": ANCHORED_BATCH / anch_s,
          "fast_free_body_solves_per_s": rates["fast_free_body"]})
    require(fin, "non-finite lanes in the anchored solve")
    require(runs["solve_anchored"] == expect(B13=ANCHORED_ITERS),
            f"anchored launch counts {runs['solve_anchored']}")
    require(a_err <= a_gate, f"anchored lane-0 us err {a_err} > {a_gate}")
    require(g_a[0] < g_p[0] and g_a.median() < g_p.median(),
            "anchored gradient norm not below the f32 pipeline's")
    require(b13["max_err"] <= b13["gate"], f"B13 on anchored inputs: {b13['max_err']}")
    del aqs, aus, pipe

    # -- solve_refine: DFPipelineSolver (fp64 B1-B3) and HighPrecisionSolver --
    rq0s, rxi0s = al_bench.screw_batch(q0, xi0, REFINE_BATCH, SEED)
    rus0 = torch.zeros((REFINE_BATCH, N, 6), dtype=f64, device=dev)
    dfp = DFPipelineSolver(N, float(dyn64.dt), REFINE_F32_ITERS, REFINE_DF_ITERS)
    # the f32 phase and the fp64 phase (`refine`), each counted alone
    handoff, f32_s, runs["solve_refine f32"] = counted(
        lambda: dfp._solve_f32(dyn64, cost64, rq0s, rxi0s, rus0))
    rout, df_s, runs["solve_refine"] = counted(lambda: dfp.refine(dyn64, cost64, *handoff))
    del handoff
    r_us = join_us(rout)
    r_err = lane_err(r_us[0], us_gold)
    g_r = rout.grad_norm.double()
    fin = bool(torch.isfinite(r_us).all().item())
    del rout, r_us
    reps = []
    for r in range(REFINE_REPS):
        a = al_bench.screw_batch(q0, xi0, REFINE_BATCH, 900 + r)
        reps.append(timed(lambda: dfp.solve(dyn64, cost64, *a, rus0))[1])
    med_r = statistics.median(reps)
    # fp64 B1-B4 against their plain versions at the refiner's shapes
    s = kernel_check.kernel_inputs(P.PipelineSolver(N, 2, float(dyn64.dt)), dyn64, cost64,
                                   rq0s, rxi0s, rus0, kernel_gains=True)
    errs = kernel_check.compare(s, dt=float(dyn64.dt))
    k64 = {}
    for k, (kern, plain) in kernel_check.calls(s, dt=float(dyn64.dt)).items():
        if k not in ("B1", "B2", "B3", "B4"):
            continue
        k64[k] = {"ms": event_ms(kern, 5), "plain_ms": event_ms(plain, 1),
                  "max_err": errs[k]["max_rel"], "max_abs_err": errs[k]["max_abs"],
                  "gate": kernel_check.GATES[f64][k], **bound(k, s, kern()),
                  "library_ms": None, "launches": runs["solve_refine"][k]}
        k64[k]["share_of_bound"] = k64[k]["bound_ms"] / k64[k]["ms"]
    del s
    # HighPrecisionSolver: the f32 pipeline, then f64 polish iterations
    free, _ = make_model(dynamics.se3_dynamics(), costs.tracking_cost(SE3, 6), dyn64,
                         cost64)
    hp = HighPrecisionSolver(free, N, HIGHPREC_F32_ITERS, float(dyn64.dt),
                             polish_iters=HIGHPREC_POLISH_ITERS)
    hout, hp_s, runs["solve_refine highprec"] = counted(lambda: hp.solve(
        {"dyn": dyn64, "cost": cost64}, rq0s[:HIGHPREC_BATCH], rxi0s[:HIGHPREC_BATCH],
        rus0[:HIGHPREC_BATCH]))
    h_err = lane_err(hout.us[0], us_gold)
    del hout
    emit({"phase": "solve_refine", "card": card, "B": REFINE_BATCH, "N": N,
          "f32_iterations": REFINE_F32_ITERS, "df_iterations": REFINE_DF_ITERS,
          "launches": runs["solve_refine"], "launches_f32_phase": runs["solve_refine f32"],
          "all_finite": fin, "lane0_us_max_abs_err": r_err, "gate": POLISH_GATE,
          "grad_norm_p50": g_r.median().item(), "grad_norm_max": g_r.max().item(),
          "f32_phase_s_first_call": f32_s, "fp64_phase_s_first_call": df_s,
          "rep_s": reps, "median_s": med_r,
          "solves_per_s": REFINE_BATCH / med_r,
          "mixed_polish_gate_passing_solves_per_s": rates["mixed_polish"],
          "fp64_kernels": k64,
          "highprec": {"B": HIGHPREC_BATCH, "f32_iterations": HIGHPREC_F32_ITERS,
                       "polish_iterations": HIGHPREC_POLISH_ITERS,
                       "launches": runs["solve_refine highprec"],
                       "lane0_us_max_abs_err": h_err, "gate": POLISH_GATE,
                       "solve_s": hp_s, "solves_per_s": HIGHPREC_BATCH / hp_s}})
    n_f, n_d = REFINE_F32_ITERS, REFINE_DF_ITERS
    require(runs["solve_refine f32"] == expect(B1=1, B2=n_f, B3=n_f),
            f"refiner f32 phase launch counts {runs['solve_refine f32']}")
    require(runs["solve_refine"] == expect(B1=1, B2=n_d + 1, B3=n_d),
            f"refiner fp64 phase launch counts {runs['solve_refine']}")
    require(fin, "non-finite lanes in the refiner")
    require(r_err <= POLISH_GATE, f"refiner lane-0 us err {r_err} > {POLISH_GATE}")
    for k, v in k64.items():
        require(v["max_err"] <= v["gate"], f"fp64 {k} at B={REFINE_BATCH}: {v['max_err']}")
    require(runs["solve_refine highprec"] == expect(B1=1, B2=HIGHPREC_F32_ITERS,
                                                     B3=HIGHPREC_F32_ITERS),
            f"high-precision launch counts {runs['solve_refine highprec']}")
    require(h_err <= POLISH_GATE, f"high-precision lane-0 us err {h_err} > {POLISH_GATE}")

    # -- solve_mpc_exact: make_closed_loop, plant 0 against the host loop ------
    model, mp, mq0s, mxi0s, msolver = exact_mpc_setup(dev)
    mres, mpc_s, runs["solve_mpc_exact"] = counted(
        lambda: MPC.make_closed_loop(msolver, EXACT_MPC_T)(mp, mq0s, mxi0s))
    (hq, hu), wait_s = timed(lambda: host[("mpc",)].get(timeout=HOST_WAIT_S), sync=False)
    host_dev = max(np.abs(mres.qs[0].cpu().numpy() - hq).max(),
                   np.abs(mres.us[0].cpu().numpy() - hu).max())
    err = lambda q, t: torch.linalg.norm(SE3.log(q @ mp["cost"].q_ref_inv[t]), dim=-1)
    e0 = err(mq0s, 0).mean().item()
    eT = err(mres.qs[:, -1], EXACT_MPC_T).mean().item()
    fin = bool(torch.isfinite(mres.qs).all().item())
    emit({"phase": "solve_mpc_exact", "B": EXACT_MPC_B, "H": EXACT_MPC_H,
          "T": EXACT_MPC_T, "tol_grad_norm": 1e-6, "launches": runs["solve_mpc_exact"],
          "mean_tracking_err_initial": e0, "mean_tracking_err_final": eT,
          "plant0_vs_host_loop_max_abs": float(host_dev), "gate": 1e-9,
          "all_finite": fin, "mpc_s": mpc_s, "steps_per_s": EXACT_MPC_T / mpc_s,
          "plant_solves_per_s": EXACT_MPC_B * EXACT_MPC_T / mpc_s,
          "host_result_wait_s": wait_s})
    require(fin and eT < e0, f"exact MPC tracking error {eT} not below {e0}")
    require(host_dev <= 1e-9, f"exact MPC vs the host loop {host_dev} > 1e-9")
    require(runs["solve_mpc_exact"]["B14"] > 0
            and runs["solve_mpc_exact"] == expect(B14=runs["solve_mpc_exact"]["B14"]),
            f"exact MPC launch counts {runs['solve_mpc_exact']}")
    del mres

    # -- solve_exact: lanes 0..3 of each batch against their B = 1 solves ------
    t_wait = time.perf_counter()
    singles = {t: host[t].get(timeout=HOST_WAIT_S) for t in tasks[1:]}
    wait_s = time.perf_counter() - t_wait
    for name in EXACT_PROBLEMS:
        row, us_b, its_b = exact[name]
        dev_b = max(float(np.abs(us_b[b].numpy() - singles[("single", name, b)][0]).max())
                    for b in range(EXACT_LANES))
        its_1 = [singles[("single", name, b)][1] for b in range(EXACT_LANES)]
        emit({**row, "host_B1_iterations_lanes0_3": its_1,
              "batch_vs_host_B1_us_max_abs_lanes0_3": dev_b, "single_gate": 1e-9,
              "host_result_wait_s": wait_s})
        require(dev_b <= 1e-9 and its_1 == its_b,
                f"{name} batch vs B = 1 solves: {dev_b}, {its_1} vs {its_b}")
    return runs


def b13_any_phase(dev, card, counted, expect):
    """`kernels_b13_any`: B13's runtime-shape instance against its plain
    version at ANY_SHAPES (f32 B = 8192, f64 B = 1024, N = 200) with times
    (the kernel by CUDA events, mean of 3; the plain version, host-bound,
    on the host clock around the one call that the check compares) and
    bounds and the parent kernel's time, and one FastBatchSolver solve of a
    (12, 3) LieModel against use_pallas=False; B13's large-nu instance at
    LARGE_SHAPES, each row with its problems a block, and one
    FastBatchSolver solve of screw200_rcs16 at full width against its
    golden; the instances' ptxas report.  Returns ((12, 3) solve's
    launches, the runtime-shape instance's entry of the kernels line: its
    numbers at (12, 3), f32), (the rcs16 solve's launches, the large-nu
    instance's entry: its numbers at LARGE_LINE, f32))."""
    from trajectory_optimization_matrix_lie_groups_tpu_torch import _build
    from trajectory_optimization_matrix_lie_groups_tpu_torch import kernel_check
    from trajectory_optimization_matrix_lie_groups_tpu_torch.ops import riccati as RC
    from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers import batched as F
    from trajectory_optimization_matrix_lie_groups_tpu_torch.tasks import al_bench

    t_any = time.perf_counter()
    rows = {}
    for dtype, B in ANY_BATCH.items():
        gate = kernel_check.GATES["fast"][dtype]["B13"]
        for nx, nu in ANY_SHAPES:
            s = kernel_check.riccati_inputs(nx, nu, B, N, dtype, dev, seed=SEED)
            args = tuple(s[n] for n in kernel_check.READS["B13"])
            kern = RC.backward_lane_any(*args)
            plain, plain_s = timed(lambda: RC.backward_plain(*args))
            e = kernel_check._compare({"B13": (lambda: kern, lambda: plain)},
                                      kernel_check.FAST_OUTPUTS)["B13"]
            ms = event_ms(lambda: RC.backward_lane_any(*args), 3)
            row = {"max_err": e["max_rel"], "max_abs_err": e["max_abs"], "gate": gate,
                   "ms": ms, "plain_ms": plain_s * 1e3, **bound("B13", s, kern),
                   "library_ms": None}
            key = f"{nx}x{nu} {str(dtype).replace('torch.', '')} B={B}"
            rows[key] = {**row, "bound_share": row["bound_ms"] / ms,
                         "parent_ms": ANY_PARENT_MS[key],
                         "speedup_vs_parent": ANY_PARENT_MS[key] / ms}
            require(e["max_rel"] <= gate, f"B13any ({nx}, {nu}) {dtype}: {e['max_rel']} > {gate}")
            del s, args, kern, plain
    # a user's own LieModel at (12, 3): the rigid body, three torques, no gravity
    f32 = torch.float32
    model, params, q0, xi0 = al_bench.screw200_nu_model(al_bench.torques3_pu(), f32, dev,
                                                        horizon=N)
    cost = params["cost"]
    q0s, xi0s = al_bench.screw_batch(q0, xi0, ANY_SOLVE_BATCH, SEED)
    args = (params, q0s, xi0s, torch.zeros((ANY_SOLVE_BATCH, N, 3), dtype=f32, device=dev),
            cost.q_ref, cost.xi_ref)
    out, sec, launches = counted(lambda: F.FastBatchSolver(model, N, ANY_SOLVE_ITERS).solve(*args))
    ref, ref_s, ref_launches = counted(lambda: F.FastBatchSolver(
        model, N, ANY_SOLVE_ITERS, use_pallas=False).solve(*args))
    J_rel = ((out.J_opt - ref.J_opt).abs() / ref.J_opt.abs()).max().item()
    us_abs = (out.us - ref.us).abs().max().item()
    fin = bool(torch.isfinite(out.us).all().item() and torch.isfinite(out.J_opt).all().item())
    any_s = time.perf_counter() - t_any

    # -- the large-nu instance: its rows, then screw200_rcs16 at full width --
    t_large = time.perf_counter()
    large = {}
    for dtype, B in ANY_BATCH.items():
        gate = kernel_check.GATES["fast"][dtype]["B13"]
        tp = torch.finfo(dtype).bits // 8
        for nx, nu in LARGE_SHAPES:
            s = kernel_check.riccati_inputs(nx, nu, B, N, dtype, dev, seed=SEED)
            args = tuple(s[n] for n in kernel_check.READS["B13"])
            kern = RC.backward_lane_any(*args)
            ms = event_ms(lambda: RC.backward_lane_any(*args), 3)
            b = bound("B13", s, kern)
            n_plain = N if ((nx, nu) == LARGE_LINE and dtype == f32) else NU_PLAIN_N
            if n_plain != N:
                del s, args, kern
                s = kernel_check.riccati_inputs(nx, nu, B, n_plain, dtype, dev, seed=SEED)
                args = tuple(s[n] for n in kernel_check.READS["B13"])
                kern = RC.backward_lane_any(*args)
            plain, plain_s = timed(lambda: RC.backward_plain(*args))
            e = kernel_check._compare({"B13": (lambda: kern, lambda: plain)},
                                      kernel_check.FAST_OUTPUTS)["B13"]
            key = f"{nx}x{nu} {str(dtype).replace('torch.', '')} B={B}"
            large[key] = {"max_err": e["max_rel"], "max_abs_err": e["max_abs"], "gate": gate,
                          "compared_at_N": n_plain, "ms": ms, "plain_ms": plain_s * 1e3,
                          "plain_N": n_plain, **b, "bound_share": b["bound_ms"] / ms,
                          "library_ms": None,
                          "problems_per_block": _build.fast_large_problems(nx, nu, tp),
                          "smem_bytes_per_block": _build.fast_large_bytes(
                              nx, nu, tp, _build.fast_large_problems(nx, nu, tp))}
            parent = LARGE_PARENT_MS.get(key)
            if parent is not None:
                large[key].update(parent_ms=parent, speedup_vs_parent=parent / ms)
            require(e["max_rel"] <= gate, f"B13nuL ({nx}, {nu}) {dtype}: {e['max_rel']} > {gate}")
            del s, args, kern, plain
    rows_s = time.perf_counter() - t_large
    t_solve = time.perf_counter()
    us_gold, meta = al_bench.load_nu_golden("screw200_rcs16")
    jax_err = meta["jax_f32_fast"]["lane0_us_max_abs_err"]
    require(meta["jax_f32_fast"]["iterations"] == RCS16_ITERS,
            f"rcs16 golden's JAX fast-tier count {meta['jax_f32_fast']}")
    model, params, q0, xi0 = al_bench.screw200_nu_model(al_bench.rcs16_pu(), f32, dev,
                                                        horizon=N)
    cost = params["cost"]
    q0s, xi0s = al_bench.screw_batch(q0, xi0, RCS16_BATCH, SEED)
    rcs, rcs_s, rcs_launches = counted(lambda: F.FastBatchSolver(model, N, RCS16_ITERS).solve(
        params, q0s, xi0s, torch.zeros((RCS16_BATCH, N, 16), dtype=f32, device=dev),
        cost.q_ref, cost.xi_ref))
    rcs_err = float(np.abs(rcs.us[0].double().cpu().numpy() - us_gold).max())
    rcs_fin = bool(torch.isfinite(rcs.us).all().item() and torch.isfinite(rcs.J_opt).all().item())
    solve_s = time.perf_counter() - t_solve

    ptxas = {k: v for k, v in _build.ptxas_report().items()
             if "traopt::fast_riccati_any_kernel<" in k
             or "traopt::fast_riccati_large_kernel<" in k}
    emit({"phase": "kernels_b13_any", "card": card, "N": N, "metric":
          "max_rel = max|kernel - plain| / max(1, max|plain|) over outputs",
          "ptxas": ptxas, "shapes": rows, "large_nu_shapes": large,
          "solve_12x3": {"model": "rigid body, Pu = [I3; 0] (three torques), g = 0, "
                                  "screw-200 tracking, R = 1e-2 I3", "dtype": "float32",
                         "B": ANY_SOLVE_BATCH, "iterations": ANY_SOLVE_ITERS,
                         "launches": launches, "use_pallas_false_launches": ref_launches,
                         "all_finite": fin, "J_rel_vs_use_pallas_false": J_rel,
                         "us_max_abs_vs_use_pallas_false": us_abs, "J_gate": 1e-4,
                         "solve_s": sec, "use_pallas_false_s": ref_s},
          "solve_rcs16": {"problem": "screw200_rcs16 (al_bench.screw200_nu_model, rcs16_pu, "
                                     "nu = 16)", "dtype": "float32", "B": RCS16_BATCH,
                          "N": N, "iterations": RCS16_ITERS, "launches": rcs_launches,
                          "all_finite": rcs_fin, "lane0_us_max_abs_err_vs_golden": rcs_err,
                          "jax_fast_f32_err": jax_err, "gate": 10 * jax_err,
                          "solve_s": rcs_s, "solves_per_s": RCS16_BATCH / rcs_s,
                          "card": card},
          "seconds": {"runtime_shape_rows_and_12x3_solve": any_s, "large_nu_rows": rows_s,
                      "rcs16_solve": solve_s}})
    require(launches == expect(B13any=ANY_SOLVE_ITERS), f"(12, 3) solve launches {launches}")
    require(ref_launches == expect(), f"(12, 3) use_pallas=False launches {ref_launches}")
    require(fin, "non-finite lanes in the (12, 3) solve")
    require(J_rel <= 1e-4, f"(12, 3) kernel vs use_pallas=False J rel err {J_rel}")
    require(rcs_launches == expect(B13nuL=RCS16_ITERS), f"rcs16 solve launches {rcs_launches}")
    require(rcs_fin, "non-finite lanes in the rcs16 solve")
    require(rcs_err <= 10 * jax_err, f"rcs16 lane 0 {rcs_err} > 10 x {jax_err}")
    f32_ptxas = [v for k, v in ptxas.items() if "<float" in k]
    require(len(ptxas) == 8 and len(f32_ptxas) == 4
            and all(v.get("stack_frame") == 0 and v.get("spill_stores") == 0
                    and v.get("spill_loads") == 0 for v in f32_ptxas),
            f"B13any / B13nuL f32 instances keep a stack frame or spill: {ptxas}")
    line = large[f"{LARGE_LINE[0]}x{LARGE_LINE[1]} float32 B={ANY_BATCH[f32]}"]
    return ((launches, rows[f"12x3 float32 B={ANY_BATCH[f32]}"]), (rcs_launches, line))


def require_frameless_f64(ptxas):
    """B2's and the rollout's fp64 kernels keep no stack frame and spill
    nothing; returns their ptxas lines."""
    f64 = {k: v for k, v in ptxas.items() if any(n in k for n in F64_FRAMELESS)}
    require(len(f64) == 5 and all(v.get("stack_frame") == 0 and v.get("spill_stores") == 0
                                  and v.get("spill_loads") == 0 for v in f64.values()),
            f"fp64 B2 / rollout keep a stack frame or spill: {f64}")
    return f64


def refine_phase(dev, card, counted, expect):
    """`kernels_refine` (module docstring): the refiner's fp64 kernels
    against their plain versions at its shapes, with times, bounds and the
    parent kernels' times, their occupancy and ptxas lines, and one
    `DFPipelineSolver` solve.  Returns (the fp64 phase's launches, the
    rows)."""
    from trajectory_optimization_matrix_lie_groups_tpu_torch import _build, kernel_check
    from trajectory_optimization_matrix_lie_groups_tpu_torch.models import dynamics
    from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers import pipeline as P
    from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.df_pipeline import (
        DFPipelineSolver,
        join_us,
    )
    from trajectory_optimization_matrix_lie_groups_tpu_torch.tasks import al_bench

    f64, B = torch.float64, REFINE_BATCH
    rows = {}
    for kind in REFINE_MODELS:
        drone = kind == "drone"
        dyn, cost, q0, xi0 = al_bench.build_screw200(f64, dev, horizon=N)
        if drone:
            dyn = dynamics.drone_params(dyn.J, dyn.dt)
            cost.R = 1e-2 * torch.eye(4, dtype=f64, device=dev)
        nu = cost.R.shape[0]
        q0s, xi0s = al_bench.screw_batch(q0, xi0, B, SEED)
        solver = P.PipelineSolver(N, 2, float(dyn.dt), gravity=drone,
                                  exact_gravity_jacobian=drone)
        s = kernel_check.kernel_inputs(solver, dyn, cost, q0s, xi0s,
                                       torch.zeros((B, N, nu), dtype=f64, device=dev),
                                       kernel_gains=True)
        kw = dict(dt=solver.dt, gravity=drone, exact_grav=drone)
        errs = kernel_check.compare(s, **kw)
        for k, (kern, plain) in kernel_check.calls(s, **kw).items():
            key = f"{k} nu={nu}"
            ms = event_ms(kern, 5)
            parent = REFINE_PARENT_MS.get(key)
            rows[key] = {"ms": ms, "plain_ms": event_ms(plain, 1),
                         "max_err": errs[k]["max_rel"], "max_abs_err": errs[k]["max_abs"],
                         "gate": kernel_check.GATES[f64][k], **bound(k, s, kern()),
                         "library_ms": None, "parent_ms": parent,
                         "speedup_vs_parent": parent / ms if parent else None}
            rows[key]["share_of_bound"] = rows[key]["bound_ms"] / ms
        del s
    # the blocks an SM holds of B2's (8 problems a block) and the rollout's
    # (32) fp64 kernels, and the waves of blocks B = REFINE_BATCH takes
    occ = _build.function("pipeline", "occupancy", "f64", [_build.INT] * 3)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    resident = {}
    for i, (name, per) in enumerate((("B2", 8), ("rollout", 32))):
        for nu in (6, 4):
            n = occ(i, nu, 0)
            resident[f"{name} nu={nu}"] = {
                "blocks_per_sm": n, "problems_per_sm": n * per,
                "waves": math.ceil(math.ceil(B / per) / (n * sms)) if n > 0 else None}
    ptxas = {k: v for k, v in _build.ptxas_report().items()
             if any(n in k for n in ("traopt::riccati_kernel<", "traopt::riccati_mx_kernel<",
                                     "traopt::rollout_kernel<", "traopt::rollout_mx_kernel<",
                                     *F64_FRAMELESS))}
    # the refined solve: its f32 phase and its fp64 phase each counted alone
    us_gold, _ = al_bench.load_screw200_golden()
    dyn, cost, q0, xi0 = al_bench.build_screw200(f64, dev, horizon=N)
    dfp = DFPipelineSolver(N, float(dyn.dt), REFINE_F32_ITERS, REFINE_DF_ITERS)
    us0 = torch.zeros((B, N, 6), dtype=f64, device=dev)
    q0s, xi0s = al_bench.screw_batch(q0, xi0, B, SEED)
    handoff, f32_s, run_f32 = counted(lambda: dfp._solve_f32(dyn, cost, q0s, xi0s, us0))
    rout, df_s, run_df = counted(lambda: dfp.refine(dyn, cost, *handoff))
    us = join_us(rout)
    err = float(np.abs(us[0].cpu().numpy() - us_gold).max())
    fin = bool(torch.isfinite(us).all().item())
    del handoff, rout, us
    reps = []
    for r in range(REFINE_REPS):
        a = al_bench.screw_batch(q0, xi0, B, 900 + r)
        reps.append(timed(lambda: dfp.solve(dyn, cost, *a, us0))[1])
    med = statistics.median(reps)
    parent_s = REFINE_PARENT_MS.get("solve_s")
    emit({"phase": "kernels_refine", "card": card, "B": B, "N": N, "metric":
          "max_rel = max|kernel - plain| / max(1, max|plain|) over outputs",
          "rows": rows, "resident": resident, "ptxas": ptxas,
          "solve": {"f32_iterations": REFINE_F32_ITERS, "df_iterations": REFINE_DF_ITERS,
                    "launches_f32_phase": run_f32, "launches_fp64_phase": run_df,
                    "all_finite": fin, "lane0_us_max_abs_err": err, "gate": POLISH_GATE,
                    "f32_phase_s_first_call": f32_s, "fp64_phase_s_first_call": df_s,
                    "rep_s": reps, "median_s": med, "solves_per_s": B / med,
                    "parent_median_s": parent_s}})
    for k, v in rows.items():
        require(v["max_err"] <= v["gate"], f"fp64 {k} at B={B}: {v['max_err']} > {v['gate']}")
    n_f, n_d = REFINE_F32_ITERS, REFINE_DF_ITERS
    require(run_f32 == expect(B1=1, B2=n_f, B3=n_f), f"refiner f32 phase launches {run_f32}")
    require(run_df == expect(B1=1, B2=n_d + 1, B3=n_d), f"refiner fp64 phase launches {run_df}")
    require(fin, "non-finite lanes in the refiner")
    require(err <= POLISH_GATE, f"refiner lane-0 us err {err} > {POLISH_GATE}")
    require_frameless_f64(ptxas)
    return run_df, rows


def nu_phase(dev, card, counted, expect):
    """`kernels_nu` (module docstring): (a) the runtime-nu and large-nu
    instances of B1-B6 against their plain versions at NU_CHECK and
    NU_CHECK_LARGE and MAX_NU (B = NU_CHECK_BATCH) with times, bounds,
    occupancy and ptxas lines, B3 and B4 past one wave of the large-nu
    rollout's feedback slot (NU_PAST_SLOT), and B5's against the tuned B5 at
    nu = 4 and 6 on a rough iterate; (b) the full-width problems of `al_bench.NU_PROBLEMS`
    on the f32 path, the polish and the fp64 refiner, counted, lane 0
    against each golden; (c) every nu from 1 to 12 and the large ones
    through the four solvers at NU_SWEEP's size, counted.  Returns
    ({kernel: launches in (b)}, {kernel: its entry of the kernels line: the
    runtime-nu instances' at nu = 3, the large-nu ones' at nu = 16, f32
    where they have an f32 instance})."""
    from trajectory_optimization_matrix_lie_groups_tpu_torch import _build, kernel_check
    from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers import df_mixed as DM
    from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers import pipeline as P
    from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.df_pipeline import (
        DFPipelineSolver,
        join_us,
    )
    from trajectory_optimization_matrix_lie_groups_tpu_torch.tasks import al_bench

    grav = dict(gravity=True, exact_gravity_jacobian=True)
    base = {"B1": "B1", "B2": "B2", "B2_al": "B2", "B3": "B3", "B4": "B4", "B5": "B5",
            "B5_al": "B5", "B6": "B6"}
    # the counted instance at nu: runtime-nu ("nu") up to 12, large-nu past it
    sfx = lambda nu: "" if nu in _build.TUNED_NU else ("nu" if nu <= _build.MU_MAX_NU else "nuL")
    nu_pipe = ("B1", "B2", "B2_al", "B3", "B4")
    failed = []  # the checks that failed, required after the phase's line
    parts_s = {"s": time.perf_counter()}  # the start and each part's end, host clock

    def check(cond, what):
        if not cond:
            failed.append(what)

    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def slot_fits(dtype, nu, B):
        """Whether the large-nu rollout at (nu, B) takes its feedback slot's
        instance: the whole batch resident at once (`rollout_large_slot`)."""
        occ = _build.function("pipeline_nu", "occupancy_nu", _build.suffix(dtype),
                              [_build.INT] * 3)
        return occ(1, nu, 0) * sms * 32 >= B

    def g_pass(dtype, B):
        """Whether the rollout at nu <= 12 takes g_kernel's pass for a batch
        of B (`rollout_nu_g`: the build's one-warp blocks an SM)."""
        return B <= P.rollout_nu_g_warps(dtype) * 32 * sms

    def instances():
        """{scalar: {instance: launches}} of the rollout at every nu but the
        tuned ones: past 12 ("nuL slot", "nuL device"), up to it ("nu pass
        slot", "nu pass device", "nu slot", "nu device")."""
        return {t: {**{f"nuL {i}": v for i, v in P.rollout_large_instances(t).items()},
                    **{f"nu {i}": v for i, v in P.rollout_nu_instances(t).items()}}
                for t in (torch.float32, torch.float64)}

    def took(before, nu, B, dtype=None):
        """{scalar: {instance: launches}} of the rollout since ``before``
        (`instances`), each launch held to the instance that `g_pass` and
        `slot_fits` name at (nu, B); with ``dtype``, at least one launch in
        that scalar."""
        now = instances()
        d = {t: {i: now[t][i] - before[t][i] for i in now[t]} for t in now}
        for t, di in d.items():
            slot = "slot" if slot_fits(t, nu, B) else "device"
            want = (None if nu in _build.TUNED_NU else f"nuL {slot}"
                    if nu > _build.MU_MAX_NU else
                    f"nu pass {slot}" if g_pass(t, B) else f"nu {slot}")
            check(all(v == 0 for i, v in di.items() if i != want)
                  and (t != dtype or di[want] > 0),
                  f"rollout nu={nu} B={B} {t}: launches {di}, expected the {want} instance")
        return {str(t)[6:]: {i: v for i, v in di.items() if v} for t, di in d.items()}

    def row(name, nu, kern, plain, s, outputs, gate, timing=None, parent=True):
        """One kernel against its plain version: errors per output, the
        kernel's time by CUDA events (mean of 3, after the checked call), the
        plain version's on the host clock around the one call compared, the
        bound and its share.  ``timing``: (kernel call, inputs) at N = 200
        when the comparison runs at a smaller depth; the time and the bound
        are then of that call.  ``parent``: beside the parent kernel's time
        at B = NU_CHECK_BATCH where NU_LARGE_PARENT_MS has it."""
        named = lambda o: (dict(zip(outputs, kernel_check._flat(o))) if name in nu_pipe
                           else kernel_check._named(o, outputs))
        kout = kern()
        pout, plain_s = timed(plain)
        a, b = named(kout), named(pout)
        per = {o: kernel_check.rel_err(a[o], b[o]) for o in outputs}
        gates = gate if isinstance(gate, dict) else {o: gate for o in outputs}
        r = {"max_err": max(per.values()),
             "max_abs_err": max((a[o].double() - b[o].double()).abs().max().item()
                                for o in outputs),
             "per_output": per, "gate": gate, "N_check": s["us"].shape[0],
             "plain_ms": plain_s * 1e3, "library_ms": None}
        del a, b, pout
        if timing is not None:
            kern, s = timing
            kout = kern()
        r.update(ms=event_ms(kern, 3), N_timed=s["us"].shape[0], **bound(name, s, kout))
        r["bound_share"] = r["bound_ms"] / r["ms"]
        key = f"{name} nu={nu} {str(s['us'].dtype)[6:]}"
        parent = parent and (NU_LARGE_PARENT_MS.get(key) or NU_PARENT_MS.get(key))
        if parent:
            r.update(parent_ms=parent, speedup_vs_parent=parent / r["ms"])
        failed.extend(f"{base[name]}{sfx(nu)} {name} nu={nu} {o}: {per[o]} > {gates[o]}"
                      for o in outputs if not per[o] <= gates[o])
        return r

    def problem(nu, dtype, n, pu=None, B=NU_CHECK_BATCH):
        """The rigid body driven through ``pu`` (default `al_bench.nu_pu(nu)`)
        at depth n, batch B: (dyn, cost, q0s, xi0s, us0)."""
        pu = al_bench.nu_pu(nu) if pu is None else pu
        dyn, cost, q0, xi0 = al_bench.build_screw200_nu(pu, dtype, dev, horizon=n)
        q0s, xi0s = al_bench.screw_batch(q0, xi0, B, SEED)
        return dyn, cost, q0s, xi0s, torch.zeros((B, n, nu), dtype=dtype, device=dev)

    def pipe_inputs(nu, dtype, n, pu=None, B=NU_CHECK_BATCH):
        """B1-B4's real iterate at nu (two f32 iterations, B2 on its
        kernel), depth n, batch B, and its solver."""
        args = problem(nu, dtype, n, pu, B)
        solver = P.PipelineSolver(n, 2, float(args[0].dt), **grav)
        return kernel_check.kernel_inputs(solver, *args, kernel_gains=True), solver

    def polish_inputs(nu, n):
        """B5's and B6's iterate of the polish's second iteration (the f32
        phase at bench.py's full budget, ITERS, then one polish iteration)
        at nu, depth n: B5's gvec gate holds where the residuals that
        multiply its f32 roundings are small."""
        args = problem(nu, torch.float64, n)
        mx = DM.MixedDFPipelineSolver(n, float(args[0].dt), ITERS, 1, **grav)
        return kernel_check.polish_inputs(mx, *args, kernel_gains=True, polished=True), mx

    def depth(nu, kind):
        """The comparison's depth: N for the kernels line's rows (nu =
        LINE_NU: B1-B4 in f32, B5, B6), else NU_PLAIN_N."""
        return N if nu in LINE_NU and kind != "float64" else NU_PLAIN_N

    # (a) each instance against its plain version on real iterates, timed
    # at N = 200
    rows = {}
    for nu in (*NU_CHECK, *NU_CHECK_LARGE, _build.MAX_NU):
        kw = dict(gravity=True, exact_grav=True)
        for dtype in (torch.float32, torch.float64):
            tag = str(dtype).replace("torch.", "")
            n = depth(nu, tag)
            s, solver = pipe_inputs(nu, dtype, n)
            sT = timing = None
            if n != N:
                sT, solverT = pipe_inputs(nu, dtype, N)
                timing = kernel_check.calls(sT, dt=solverT.dt, **kw)
            for k, (kern, plain) in kernel_check.calls(s, dt=solver.dt, **kw).items():
                i0 = instances()
                rows[f"{k} nu={nu} {tag}"] = r = row(
                    k, nu, kern, plain, s, kernel_check.OUTPUTS[k],
                    kernel_check.GATES[dtype][k], timing and (timing[k][0], sT))
                if k in ("B3", "B4"):
                    r["instances"] = took(i0, nu, NU_CHECK_BATCH, dtype)
            del s, sT, timing
        n = depth(nu, "mixed")
        s, mx = polish_inputs(nu, n)
        sT = timing = None
        if n != N:
            sT, mxT = polish_inputs(nu, N)
            timing = kernel_check.polish_calls(sT, mxT)
        for k, (kern, plain) in kernel_check.polish_calls(s, mx).items():
            if k != "tail":
                rows[f"{k} nu={nu} mixed"] = row(
                    k, nu, kern, plain, s, kernel_check.POLISH_OUTPUTS[k],
                    kernel_check.GATES["mixed"][k], timing and (timing[k][0], sT))
        del s, sT, timing
    # the large-nu rollout past one wave of its feedback slot's blocks: the
    # device-memory instance at the paths' own shapes; the rollout at nu <=
    # 12 there, past the batch that takes g_kernel's pass
    for name, dtype in (*NU_PAST_SLOT, *NU_PAST_PASS):
        pu = al_bench.NU_PROBLEMS[name]()
        nu, tag = pu.shape[1], str(dtype).replace("torch.", "")
        if nu > _build.MU_MAX_NU:
            check(not slot_fits(dtype, nu, NU_POLISH_BATCH),
                  f"{name} {tag}: B = {NU_POLISH_BATCH} fits the rollout's feedback slot")
        else:
            check(not g_pass(dtype, NU_POLISH_BATCH),
                  f"{name} {tag}: B = {NU_POLISH_BATCH} takes g_kernel's pass")
        s, solver = pipe_inputs(nu, dtype, NU_PLAIN_N, pu, NU_POLISH_BATCH)
        pairs = kernel_check.calls(s, dt=solver.dt, gravity=True, exact_grav=True)
        for k in ("B3", "B4"):
            i0 = instances()
            rows[f"{k} {name} B={NU_POLISH_BATCH} {tag}"] = r = row(
                k, nu, *pairs[k], s, kernel_check.OUTPUTS[k], kernel_check.GATES[dtype][k],
                parent=False)
            r["instances"] = took(i0, nu, NU_POLISH_BATCH, dtype)
        del s, pairs
    # the tuned instances' times at nu = 6 on the same shapes, beside the rows
    tuned = {}
    for dtype in (torch.float32, torch.float64):
        tag = str(dtype).replace("torch.", "")
        s, solver = pipe_inputs(6, dtype, N)
        for k, (kern, _) in kernel_check.calls(s, dt=solver.dt, gravity=True,
                                               exact_grav=True).items():
            tuned[f"{k} nu=6 {tag}"] = event_ms(kern, 3)
        del s
    s, mx = polish_inputs(6, N)
    for k, (kern, _) in kernel_check.polish_calls(s, mx).items():
        if k != "tail":
            tuned[f"{k} nu=6 mixed"] = event_ms(kern, 3)
    del s
    # B5's runtime-nu instance against the tuned one at nu = 4 and 6, which
    # both take, on the same rough iterate (2 f32 iterations on the first nu
    # thrusters of rcs12_pu: under-actuated), where both miss the gvec gate
    # against plain alike (scripts/nu_instances.py): they agree bit for bit
    twins = {}
    nu_b5 = _build.function("polish_nu", "riccati_nu", "mx", DM._RICCATI_ARGS)
    for nu in _build.TUNED_NU:
        dyn, cost, q0, xi0 = al_bench.build_screw200_nu(al_bench.rcs12_pu()[:, :nu],
                                                        torch.float64, dev)
        q0s, xi0s = al_bench.screw_batch(q0, xi0, NU_CHECK_BATCH, SEED)
        mx = DM.MixedDFPipelineSolver(N, float(dyn.dt), 2, 1, **grav)
        s = kernel_check.polish_inputs(
            mx, dyn, cost, q0s, xi0s,
            torch.zeros((NU_CHECK_BATCH, N, nu), dtype=torch.float64, device=dev))
        bargs = (s["lin"], s["lu"], s["VxN"], s["VxxN"], s["consts"], s["consts32"])
        a = DM.backward_mx_lane(*bargs, glow=True)
        b = DM._backward_mx_kernel(nu_b5, torch.cuda.current_stream(dev).cuda_stream,
                                   *bargs, glow=True, luu_al=None)
        plain = DM.backward_mx_plain(*bargs, glow=True)
        twins[f"B5 nu={nu}"] = r = {
            **{f"{o}_tuned_vs_nu": kernel_check.rel_err(x, y)
               for o, x, y in zip(("k", "K", "gvec"), a, b)},
            "gvec_tuned_vs_plain": kernel_check.rel_err(a[2], plain[2]),
            "gvec_nu_vs_plain": kernel_check.rel_err(b[2], plain[2])}
        failed.extend(f"B5nu twin nu={nu} {o}: {r[o]} > {NU_TWIN_GATE}"
                      for o in r if o.endswith("_vs_nu") and not r[o] <= NU_TWIN_GATE)
        del s, bargs, a, b, plain
    resident = {}
    for tag in ("f32", "f64"):
        occ = _build.function("pipeline_nu", "occupancy_nu", tag, [_build.INT] * 3)
        for i, name in enumerate(("B2", "rollout")):
            for nu in (3, 12, 13, 24, _build.MAX_NU):
                n = occ(i, nu, 0)
                # problems a block: fp64 B2 takes 4 past nu = 12
                p = 32 if i else (4 if tag == "f64" and nu > _build.MU_MAX_NU else 8)
                inst = ("large" if i or nu > _build.MU_MAX_NU
                        else f"MU={4 if nu <= 4 else 6 if nu <= 6 else 12}")
                resident[f"{name} {tag} nu={nu} ({inst})"] = {
                    "blocks_per_sm": n, "problems_per_sm": n * p,
                    "waves_B16384": (math.ceil(math.ceil(16384 / p) / (n * sms))
                                     if n > 0 else None)}
    ptxas = {k: v for k, v in _build.ptxas_report().items()
             if "_nu_kernel<" in k or "_large_kernel" in k or "g_kernel<" in k}
    parts_s["a"] = time.perf_counter()

    # (b) the full-width problems on the f32 path, the polish and the
    # refiner: each counted, then timed on a new batch
    solves, launches_b = {}, {k: 0 for k in expect()}
    for name, pu in al_bench.NU_PROBLEMS.items():
        us_gold, meta = al_bench.load_nu_golden(name)
        nu = us_gold.shape[1]
        pol, ref = meta["polish_schedule"], meta["refine_schedule"]
        f32_gate = 10 * meta["jax_f32_pipeline"]["lane0_us_max_abs_err"]
        c = lambda **n: {f"{k}{sfx(nu)}": v for k, v in n.items()}

        def inputs(dtype, B, seed):
            dyn, cost, q0, xi0 = al_bench.build_screw200_nu(pu(), dtype, dev)
            q0s, xi0s = al_bench.screw_batch(q0, xi0, B, seed)
            return dyn, cost, q0s, xi0s, torch.zeros((B, N, nu), dtype=dtype, device=dev)

        def run(solver, dtype, B, us_of, gate, what, launches):
            a = inputs(dtype, B, SEED)
            i0 = instances()
            st, sec, n = counted(lambda: solver.solve(*a))
            check(n == expect(**launches), f"{name} {what} launches {n}")
            inst = took(i0, nu, B)
            for s_ in ("nu", "nuL"):
                m = sum(v for d in inst.values() for i, v in d.items() if i.split()[0] == s_)
                check(m == n[f"B3{s_}"] + n[f"B4{s_}"],
                      f"{name} {what}: rollout instances {inst}, B3{s_} + B4{s_} launches "
                      f"{n[f'B3{s_}'] + n[f'B4{s_}']}")
            for k, v in n.items():
                launches_b[k] += v
            us = us_of(st)
            err = float(np.abs(us[0].double().cpu().numpy() - us_gold).max())
            fin = bool(torch.isfinite(us).all().item())
            check(fin, f"{name} {what}: non-finite lanes")
            check(err <= gate, f"{name} {what}: lane-0 us err {err} > {gate}")
            del st, us, a
            a = inputs(dtype, B, SEED + 1)
            _, rep = timed(lambda: solver.solve(*a))
            return {"B": B, "launches": n, "rollout_instances": inst,
                    "lane0_us_max_abs_err": err, "gate": gate,
                    "all_finite": fin, "s_first_call": sec, "s": rep, "solves_per_s": B / rep}

        dt = float(inputs(torch.float64, 1, SEED)[0].dt)
        nf, npol = pol["f32_iterations"], pol["inner_iterations"]
        nr, ndf = ref["f32_iterations"], ref["inner_iterations"]
        solves[name] = {
            "f32": {"iterations": ITERS, **run(
                P.PipelineSolver(N, ITERS, dt, **grav), torch.float32, NU_F32_BATCH,
                lambda st: st.us, f32_gate, "f32", c(B1=1, B2=ITERS, B3=ITERS))},
            "f32_unfused": {"iterations": ITERS, **run(
                P.PipelineSolver(N, ITERS, dt, fused=False, **grav), torch.float32,
                CHECK_BATCH, lambda st: st.us, f32_gate, "f32 unfused",
                c(B1=ITERS, B2=ITERS, B4=ITERS))},
            "polish": {"f32_iterations": nf, "polish_iterations": npol, **run(
                DM.MixedDFPipelineSolver(N, dt, nf, npol, **grav), torch.float64,
                NU_POLISH_BATCH, join_us, POLISH_GATE, "polish",
                {**c(B1=1, B2=nf, B3=nf, B5=npol, B6=npol), "B7": npol, "B8": npol,
                 "B9": npol})},
            "refine": {"f32_iterations": nr, "fp64_iterations": ndf, **run(
                DFPipelineSolver(N, dt, nr, ndf, **grav), torch.float64, NU_POLISH_BATCH,
                join_us, NU_REFINE_GATE, "refiner", c(B1=2, B2=nr + ndf + 1, B3=nr + ndf))}}

    parts_s["b"] = time.perf_counter()
    # (c) every nu through the four solvers: launch counts, finite values
    sweep = {}
    B_, N_, it = NU_SWEEP
    for nu in (*range(1, _build.MU_MAX_NU + 1), *NU_CHECK_LARGE, _build.MAX_NU):
        pu = al_bench.nu_pu(nu)
        k_ = lambda k: k + sfx(nu)
        res = {"instances": {"": "tuned", "nu": "nu", "nuL": "large"}[sfx(nu)]}
        for dtype in (torch.float32, torch.float64):
            dyn, cost, q0, xi0 = al_bench.build_screw200_nu(pu, dtype, dev, horizon=N_)
            q0s, xi0s = al_bench.screw_batch(q0, xi0, B_, SEED)
            a = (dyn, cost, q0s, xi0s, torch.zeros((B_, N_, nu), dtype=dtype, device=dev))
            dt, tag = float(dyn.dt), str(dtype).replace("torch.", "")
            fu, t1, n1 = counted(lambda: P.PipelineSolver(N_, it, dt, **grav).solve(*a))
            un, t2, n2 = counted(lambda: P.PipelineSolver(N_, it, dt, fused=False,
                                                          **grav).solve(*a))
            check(n1 == expect(**{k_("B1"): 1, k_("B2"): it, k_("B3"): it}),
                  f"nu={nu} {tag} fused launches {n1}")
            check(n2 == expect(**{k_("B1"): it, k_("B2"): it, k_("B4"): it}),
                  f"nu={nu} {tag} unfused launches {n2}")
            J_rel = ((fu.J_opt - un.J_opt).abs() / un.J_opt.abs()).max().item()
            fin = all(bool(torch.isfinite(x.us).all().item()) for x in (fu, un))
            check(fin and J_rel <= (1e-4 if dtype == torch.float32 else 1e-9),
                  f"nu={nu} {tag}: finite {fin}, fused vs unfused J {J_rel}")
            res[tag] = {"fused_vs_unfused_J_rel": J_rel, "s": t1 + t2}
        # a is the f64 problem
        mx, t3, n3 = counted(lambda: DM.MixedDFPipelineSolver(N_, dt, it, 1, **grav).solve(*a))
        check(n3 == expect(**{k_("B1"): 1, k_("B2"): it, k_("B3"): it, k_("B5"): 1,
                              k_("B6"): 1}, B7=1, B8=1, B9=1), f"nu={nu} polish {n3}")
        dfp, t4, n4 = counted(lambda: DFPipelineSolver(N_, dt, it, 1, **grav).solve(*a))
        check(n4 == expect(**{k_("B1"): 2, k_("B2"): it + 2, k_("B3"): it + 1}),
              f"nu={nu} refiner {n4}")
        fin = all(bool(torch.isfinite(join_us(x)).all().item()) for x in (mx, dfp))
        check(fin, f"nu={nu}: non-finite polish / refiner lanes")
        res.update(polish_s=t3, refine_s=t4)
        sweep[nu] = res
    parts_s["c"] = time.perf_counter()

    emit({"phase": "kernels_nu", "card": card, "N": N, "B": NU_CHECK_BATCH, "metric":
          "max_rel = max|kernel - plain| / max(1, max|plain|) over outputs",
          "rows": rows, "tuned_nu6_ms": tuned, "b5_twins": twins, "resident": resident,
          "ptxas": ptxas,
          "solves": solves,
          "launches_b": launches_b,
          "sweep": {"B": B_, "N": N_, "iterations": it, "by_nu": sweep},
          "parts_s": {k: parts_s[k] - parts_s[j] for j, k in zip("sab", "abc")}})
    require(not failed, f"kernels_nu checks failed: {failed}")
    roll = {k: v for k, v in ptxas.items() if ROLLOUT_LARGE in k}
    require(len(roll) == 8 and all(v.get("stack_frame") == 0 and v.get("spill_stores") == 0
                                   and v.get("spill_loads") == 0 for v in roll.values()),
            f"the rollout keeps a stack frame or spills: {roll}")
    nu_kern = {k: v for k, v in ptxas.items() if any(n in k for n in NU_FRAMELESS)}
    require(len(nu_kern) == 8 and all(v.get("stack_frame") == 0 and v.get("spill_stores") == 0
                                      and v.get("spill_loads") == 0 for v in nu_kern.values()),
            f"B2nu / g_kernel keep a stack frame or spill: {nu_kern}")
    line = {}
    for nu, s_ in zip(LINE_NU, ("nu", "nuL")):
        for key in ("B1", "B2", "B3", "B4"):
            line[key + s_] = rows[f"{key} nu={nu} float32"]
        for key in ("B5", "B6"):
            line[key + s_] = rows[f"{key} nu={nu} mixed"]
    return launches_b, line


def split_timer(solver):
    """Time an `ErrorStateILQR`'s pieces in every iteration of its next
    fit: its linearization, backward pass and rollouts (every step size at
    once) are wrapped on the instance, each call synchronized and timed on
    the host clock.  Returns {piece: seconds so far}."""
    acc = {"linearize": 0.0, "backward": 0.0, "rollout_all_alphas": 0.0}
    for attr, key in (("_linearize", "linearize"), ("_backward", "backward"),
                      ("_rollout_nonlinear", "rollout_all_alphas"),
                      ("_rollout_linear", "rollout_all_alphas")):
        def wrapped(*args, fn=getattr(solver, attr), key=key):
            out, sec = timed(lambda: fn(*args))
            acc[key] += sec
            return out
        setattr(solver, attr, wrapped)
    return acc


def errstate_sweep_phases(dev, card, counted, expect, pool):
    """`solve_errstate`, `sweep` and `rollout_sweep` (module docstring).  The
    sweep's B = 1 reference solves run on the host in the worker processes
    of ``pool`` while the card works.  Returns {phase: launches}."""
    from trajectory_optimization_matrix_lie_groups_tpu_torch.parallel import sweep
    from trajectory_optimization_matrix_lie_groups_tpu_torch.tasks import errstate_bench as EB

    f64 = torch.float64
    runs = {}
    lanes = {name: len(v) * 3 // 4 for name, v in EB.SWEEP_RANGES.items()}
    host = {name: pool.apply_async(host_task, (("sweep", name, b),))
            for name, b in lanes.items()}

    # -- solve_errstate: the three CLI problems against their JAX goldens -------
    for name in EB.ERRSTATE_TASKS:
        us_g, meta = EB.load_errstate_golden(name)
        prob = EB.PROBLEMS[name](f64, dev)
        solver = prob.solver
        split = split_timer(solver)
        (st, J_hist, grad_hist, cp), sec, runs[f"solve_errstate {name}"] = counted(
            lambda: solver.fit(prob.cost_params, prob.params, prob.us0, x0=prob.x0))
        its = len(J_hist)
        use_nl = solver.cfg.mode == "generation_nonlinear" or (
            solver.cfg.mode == "tracking" and solver.cfg.rollout == "nonlinear")
        J_rel = (max(abs(a - b) / abs(b) for a, b in zip(J_hist, meta["J_hist"]))
                 if its == meta["iterations"] else float("inf"))
        us_err = float(np.abs(st.us.cpu().numpy() - us_g).max())
        flags = {"converged": bool(st.converged), "failed": bool(st.failed)}
        emit({"phase": "solve_errstate", "problem": name, "card": card, "N": solver.cfg.N,
              "mode": solver.cfg.mode, "rollout": solver.cfg.rollout if use_nl else "linear",
              "n_alphas": solver.cfg.n_alphas, "launches": runs[f"solve_errstate {name}"],
              "iterations": its, "golden_iterations": meta["iterations"], **flags,
              "golden_flags": {"converged": meta["converged"], "failed": meta["failed"]},
              "J_final": J_hist[-1], "golden_J_final": meta["J_final"],
              "J_hist_max_rel_err": J_rel, "J_gate": ES_J_GATE,
              "us_max_abs_err": us_err, "us_gate": ES_US_GATE,
              "final_error": EB.final_error(prob, st),
              "golden_final_error": meta.get("final_goal_err_norm", meta.get("final_err_norm")),
              "fit_s": sec, "ms_per_iteration": sec * 1e3 / its,
              "split_ms_per_iteration": {k: v * 1e3 / its for k, v in split.items()}})
        require(runs[f"solve_errstate {name}"] == expect(), f"{name} launched a kernel")
        require(its == meta["iterations"] and flags == {"converged": meta["converged"],
                                                        "failed": meta["failed"]},
                f"{name}: {its} iterations {flags} against the golden's {meta['iterations']} "
                f"{meta['converged']}/{meta['failed']}")
        require(J_rel <= ES_J_GATE, f"{name} J_hist rel err {J_rel} > {ES_J_GATE}")
        require(us_err <= ES_US_GATE, f"{name} us err {us_err} > {ES_US_GATE}")
        del st, prob

    # -- sweep: run_sweep on screw-200, four ranges, the rollout on B14 --------
    bs, params, q0, xi0 = EB.build_sweep(f64, dev)
    iters = bs.solver.cfg.max_iterations
    out, sec, runs["sweep"] = counted(
        lambda: sweep.run_sweep(bs, params, EB.SWEEP_RANGES, q0, xi0))
    n = sum(len(v) for v in EB.SWEEP_RANGES.values())
    t_wait = time.perf_counter()
    singles = {name: h.get(timeout=HOST_WAIT_S) for name, h in host.items()}
    wait_s = time.perf_counter() - t_wait
    dev_b = {name: float(np.abs(out[name].us[b] - singles[name][0]).max())
             for name, b in lanes.items()}
    fin = all(np.isfinite(r.us).all() and np.isfinite(r.J_opt).all() for r in out.values())
    emit({"phase": "sweep", "card": card, "N": N, "solves": n,
          "ranges": {k: len(v) for k, v in EB.SWEEP_RANGES.items()},
          "config": "LieILQR MS, backward sequential_fixed, rollout nonlinear (B14), "
                    f"{iters} iterations, no convergence test",
          "launches": runs["sweep"], "all_finite": fin,
          "J_range": {k: [float(r.J_opt.min()), float(r.J_opt.max())] for k, r in out.items()},
          "host_B1_lanes": lanes, "host_B1_iterations": {k: v[1] for k, v in singles.items()},
          "batch_vs_host_B1_us_max_abs": dev_b, "gate": SWEEP_GATE,
          "sweep_s": sec, "solves_per_s": n / sec, "host_result_wait_s": wait_s})
    require(runs["sweep"] == expect(B14=iters * len(EB.SWEEP_RANGES)),
            f"sweep launch counts {runs['sweep']}")
    require(fin, "non-finite lanes in the sweep")
    require(all(v[1] == iters for v in singles.values()), "a host B = 1 sweep solve stopped early")
    require(max(dev_b.values()) <= SWEEP_GATE, f"sweep vs host B = 1 solves {dev_b}")
    del out

    # -- rollout_sweep: four ranges at Nsim = 1400 -------------------------------
    dyn, dp, bq0, bxi0, nsim = EB.build_rollout_sweep(f64, dev)
    out, sec, runs["rollout_sweep"] = counted(
        lambda: sweep.run_rollout_sweep(dyn, dp, EB.ROLLOUT_RANGES, bq0, bxi0, N=nsim))
    n = sum(len(v) for v in EB.ROLLOUT_RANGES.values())
    # the middle lane of each range, the four rolled out together in a step
    # loop of their own (apart from the batches they were swept in)
    mid = {name: len(values) // 2 for name, values in EB.ROLLOUT_RANGES.items()}
    starts = [sweep.build_x0_batch(name, EB.ROLLOUT_RANGES[name][b:b + 1], bq0, bxi0)
              for name, b in mid.items()]
    q, xi = (torch.cat(x) for x in zip(*starts))
    zero = torch.zeros((len(mid), 6), dtype=f64, device=dev)
    qs, xis = [q], [xi]
    for i in range(nsim):
        q, xi = dyn.step(dp, q, xi, zero, i)
        qs.append(q)
        xis.append(xi)
    qs, xis = torch.stack(qs, dim=1).cpu().numpy(), torch.stack(xis, dim=1).cpu().numpy()
    errs = {name: max(float(np.abs(out[name].qs[b] - qs[j]).max()),
                      float(np.abs(out[name].xis[b] - xis[j]).max()))
            for j, (name, b) in enumerate(mid.items())}
    fin = all(np.isfinite(r.qs).all() and np.isfinite(r.xis).all() for r in out.values())
    emit({"phase": "rollout_sweep", "card": card, "steps": nsim, "rollouts": n,
          "ranges": {k: len(v) for k, v in EB.ROLLOUT_RANGES.items()},
          "launches": runs["rollout_sweep"], "all_finite": fin,
          "final_pos_spread": {k: float(np.ptp(r.qs[:, -1, :3, 3], axis=0).max())
                               for k, r in out.items()},
          "sweep_vs_own_loop_max_abs_middle_lane": errs, "gate": ROLLOUT_GATE,
          "rollout_sweep_s": sec, "rollouts_per_s": n / sec})
    require(runs["rollout_sweep"] == expect(), "the rollout sweep launched a kernel")
    require(fin, "non-finite rollouts")
    require(max(errs.values()) <= ROLLOUT_GATE, f"rollout sweep vs its lanes' own loop {errs}")
    return runs


def _free_port():
    import socket

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def sharded_phase(dev, card, counted, expect):
    """`sharded` (module docstring): the multi-device layer in one-rank
    NCCL groups on the card, each made by this phase in a process that had
    none and destroyed by it.  Returns {run: launches} of the batch mesh's
    sweep, the CLI's sweep, the sharded pipeline and the time-sharded
    LieILQR."""
    import contextlib
    import io

    import torch.distributed as dist

    from trajectory_optimization_matrix_lie_groups_tpu_torch import kernel_check
    from trajectory_optimization_matrix_lie_groups_tpu_torch import parallel
    from trajectory_optimization_matrix_lie_groups_tpu_torch.parallel import riccati_sharded as RS
    from trajectory_optimization_matrix_lie_groups_tpu_torch.parallel import sweep
    from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers import riccati
    from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.lie_ilqr import (
        LieILQR,
        SolverConfig,
    )
    from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.pipeline import (
        PipelineSolver,
    )
    from trajectory_optimization_matrix_lie_groups_tpu_torch.tasks import al_bench, parity
    from trajectory_optimization_matrix_lie_groups_tpu_torch.tasks import errstate_bench as EB
    from trajectory_optimization_matrix_lie_groups_tpu_torch.tasks import run as R

    t0 = time.perf_counter()
    runs = {}
    # every group of this phase is its own: it starts in a process with none
    require(not dist.is_initialized(), "a process group exists before the sharded phase")

    # -- a plain process: make_batch_mesh() joins a one-process NCCL group -----
    # the sweep task's problem (f64) and the rollout sweep, on one device first
    parity.RESULTS_DIR = parity.STANDIN_DIR
    sw_solver, sw_params, sw_q0, sw_xi0 = R.sweep_problem(
        types.SimpleNamespace(device=dev, dtype=torch.float64))
    one_sw = sweep.run_sweep(parallel.BatchSolver(sw_solver), sw_params, EB.SWEEP_RANGES, sw_q0,
                             sw_xi0)
    rdyn, rdp, rq0, rxi0, _ = EB.build_rollout_sweep(device=dev)
    one_ro = sweep.run_rollout_sweep(rdyn, rdp, EB.ROLLOUT_RANGES, rq0, rxi0,
                                     N=SHARD_ROLLOUT_STEPS)
    pmesh = parallel.make_batch_mesh()
    try:
        plain_group = f"{dist.get_backend()}, world size {dist.get_world_size()}"
        require(plain_group == "nccl, world size 1" and pmesh.device_type == "cuda",
                f"make_batch_mesh() in a plain process: {plain_group}, {pmesh.device_type}")
        one_range = {SHARD_SWEEP_RANGE: EB.SWEEP_RANGES[SHARD_SWEEP_RANGE]}
        msw, msw_s, runs["batch mesh sweep"] = counted(lambda: sweep.run_sweep(
            parallel.BatchSolver(sw_solver, mesh=pmesh), sw_params, one_range, sw_q0, sw_xi0))
        mro, mro_s, _ = counted(lambda: sweep.run_rollout_sweep(
            rdyn, rdp, EB.ROLLOUT_RANGES, rq0, rxi0, N=SHARD_ROLLOUT_STEPS, mesh=pmesh))
    finally:
        dist.destroy_process_group()
    d_msw = float(np.abs(msw[SHARD_SWEEP_RANGE].us - one_sw[SHARD_SWEEP_RANGE].us).max())
    d_mro = max(max(float(np.abs(mro[k].qs - one_ro[k].qs).max()),
                    float(np.abs(mro[k].xis - one_ro[k].xis).max())) for k in one_ro)
    # the CLI's sweep task: its own one-process group, left at its end
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _, cli_s, runs["cli sweep"] = counted(lambda: R.main(["sweep", "--x64"]))
    cli_line = json.loads(buf.getvalue().strip().splitlines()[-1])
    cli_left = not dist.is_initialized()
    d_cli = max(abs(cli_line["params"][k][f"J_{m}"] - float(getattr(one_sw[k].J_opt, m)()))
                / abs(float(getattr(one_sw[k].J_opt, m)())) for k in one_sw
                for m in ("min", "max"))
    require(cli_left, "the CLI's sweep left its process group behind")
    del one_sw, one_ro, msw, mro

    parallel.initialize_multihost(f"127.0.0.1:{_free_port()}", 1, 0)
    try:
        bmesh, tmesh = parallel.global_batch_mesh(), RS.default_time_mesh()
        group = f"{dist.get_backend()}, world size {dist.get_world_size()}"
        require(group == "nccl, world size 1" and (bmesh.size(), tmesh.size()) == (1, 1),
                f"the group: {group}, meshes {bmesh.size()} {tmesh.size()}")

        # -- the batch-sharded pipeline: f32, B = 8192, N = 200 ----------------
        us_gold, meta = al_bench.load_screw200_golden()
        dyn, cost, q0, xi0 = al_bench.build_screw200(torch.float32, dev, horizon=N)
        q0s, xi0s = al_bench.screw_batch(q0, xi0, BATCH, SEED)
        us0 = torch.zeros((BATCH, N, 6), dtype=torch.float32, device=dev)
        sp = parallel.make_sharded_pipeline(N, ITERS, float(dyn.dt), mesh=bmesh)
        one = PipelineSolver(N, ITERS, float(dyn.dt))
        out, first_s, runs["sharded pipeline"] = counted(
            lambda: sp.solve(dyn, cost, q0s, xi0s, us0))
        full = parallel.gather_to_all(out)
        ref = one.solve(dyn, cost, q0s, xi0s, us0)
        d_us = float(np.abs(full.us - ref.us.cpu().numpy()).max())
        d_J = float(np.abs(full.J_opt - ref.J_opt.cpu().numpy()).max())
        us0_err = float(np.abs(full.us[0].astype(np.float64) - us_gold).max())
        us_gate = 10 * meta["jax_f32_pipeline"]["lane0_us_max_abs_err"]
        h = BATCH // 2
        halves = [one.solve(dyn, cost, q0s[sl], xi0s[sl], us0[sl])
                  for sl in (slice(0, h), slice(h, BATCH))]
        d_half = max((x.us - ref.us[sl]).abs().max().item()
                     for x, sl in zip(halves, (slice(0, h), slice(h, BATCH))))
        del halves, full, out
        t_sh, t_one = [], []
        for r in range(SHARD_REPS):
            a = al_bench.screw_batch(q0, xi0, BATCH, 200 + r)
            for fn, acc in (((sp, t_sh), (one, t_one)) if r % 2 == 0 else
                            ((one, t_one), (sp, t_sh))):
                acc.append(timed(lambda: fn.solve(dyn, cost, *a, us0))[1])

        # -- the two-level time-sharded sweep at the AL horizon, f64 -------------
        Ns, nx, nu, Bs = SHARD_SCAN
        lane = kernel_check.riccati_inputs(nx, nu, Bs, Ns, torch.float64, dev, seed=SEED)
        prob = tuple(lane[k].movedim(-1, 0).contiguous()
                     for k in ("Fx", "Fu", "d", "Lx", "Lu", "Lxx", "Lux", "Luu"))
        want, one_s = timed(lambda: riccati.parallel_backward(*prob))
        rel = lambda got: max(((g - w).abs().max() / w.abs().max().clamp(min=1)).item()
                              for g, w in zip(got, want, strict=True))
        scan = {}
        for nb in SHARD_BLOCKS:
            got, sec = timed(lambda: RS.blocked_parallel_backward(*prob, n_blocks=nb))
            scan[f"blocked_{nb}"] = {"max_rel_err": rel(got), "s": sec}
        got, sec = timed(lambda: RS.sharded_parallel_backward(*prob, mesh=tmesh))
        scan["nccl_group_1"] = {"max_rel_err": rel(got), "s": sec}
        del got, want, prob, lane

        # -- LieILQR with the time-sharded backward: screw-200, f64 -----------------
        model, params, q0, xi0 = al_bench.screw200_model(torch.float64, dev)
        q0s, xi0s = al_bench.screw_batch(q0, xi0, SHARD_LIE_BATCH, SEED)
        us0 = torch.zeros((SHARD_LIE_BATCH, N, 6), dtype=torch.float64, device=dev)
        lie = {}
        for bw in ("associative_sharded", "associative"):
            solver = LieILQR(model, SolverConfig(N=N, backward=bw,
                                                 max_iterations=SHARD_LIE_ITERS),
                             pallas_rollout_dt=float(params["dyn"].dt))
            if bw == "associative_sharded":
                solver.backward_mesh = tmesh
            lie[bw] = counted(lambda: solver.solve(params, (q0s, xi0s), us0))
        (st, lie_s, runs["sharded LieILQR"]), (st1, lie1_s, per1) = (
            lie["associative_sharded"], lie["associative"])
        d_lie = (st.us - st1.us).abs().max().item()
        its, its1 = st.iteration.tolist(), st1.iteration.tolist()
    finally:
        dist.destroy_process_group()
    med = lambda x: statistics.median(x)
    emit({"phase": "sharded", "card": card, "group": group,
          "plain_process": {"group": plain_group, "sweep_range": SHARD_SWEEP_RANGE,
                            "sweep_launches": runs["batch mesh sweep"],
                            "mesh_vs_one_device_sweep_us_max_abs": d_msw,
                            "rollout_steps": SHARD_ROLLOUT_STEPS,
                            "mesh_vs_one_device_rollout_max_abs": d_mro,
                            "gate": SHARD_SWEEP_GATE, "sweep_s": msw_s,
                            "rollout_sweep_s": mro_s},
          "cli_sweep": {"launches": runs["cli sweep"], "line": cli_line,
                        "J_vs_one_device_max_rel": d_cli, "gate": SHARD_SWEEP_GATE,
                        "group_left": cli_left, "wall_s": cli_s},
          "pipeline": {"B": BATCH, "N": N, "iterations": ITERS, "dtype": "float32",
                       "launches": runs["sharded pipeline"],
                       "sharded_vs_one_device_us_max_abs": d_us,
                       "sharded_vs_one_device_J_max_abs": d_J, "gate": SHARD_GATE,
                       "lane0_us_max_abs_err": us0_err, "lane0_us_gate": us_gate,
                       "halves_vs_full_us_max_abs": d_half, "first_call_s": first_s,
                       "sharded_rep_s": t_sh, "one_device_rep_s": t_one,
                       "sharded_solves_per_s": BATCH / med(t_sh),
                       "one_device_solves_per_s": BATCH / med(t_one),
                       "sharded_over_one_device_time": med(t_sh) / med(t_one)},
          "time_sharded_sweep": {"N": Ns, "nx": nx, "nu": nu, "B": Bs, "dtype": "float64",
                                 "one_device_s": one_s, "gate": SHARD_SCAN_GATE, **scan},
          "lie_ilqr": {"B": SHARD_LIE_BATCH, "N": N, "dtype": "float64",
                       "max_iterations": SHARD_LIE_ITERS,
                       "launches": runs["sharded LieILQR"], "iterations": its[:4],
                       "sharded_vs_associative_us_max_abs": d_lie, "gate": SHARD_LIE_GATE,
                       "sharded_s": lie_s, "associative_s": lie1_s},
          "phase_s": time.perf_counter() - t0})
    sw_iters = sw_solver.cfg.max_iterations
    require(runs["batch mesh sweep"] == expect(B14=sw_iters)
            and runs["cli sweep"] == expect(B14=sw_iters * len(EB.SWEEP_RANGES)),
            f"sweep launch counts: mesh {runs['batch mesh sweep']}, cli {runs['cli sweep']}")
    require(d_msw <= SHARD_SWEEP_GATE and d_mro <= SHARD_SWEEP_GATE
            and d_cli <= SHARD_SWEEP_GATE,
            f"the batch mesh's sweeps vs one device: us {d_msw}, rollouts {d_mro}, cli J {d_cli}")
    require(runs["sharded pipeline"] == expect(B1=1, B2=ITERS, B3=ITERS),
            f"sharded pipeline launch counts {runs['sharded pipeline']}")
    require(d_us <= SHARD_GATE and d_J <= SHARD_GATE,
            f"sharded vs one-device pipeline us {d_us}, J {d_J}")
    require(us0_err <= us_gate, f"sharded pipeline lane-0 us err {us0_err} > {us_gate}")
    require(d_half <= SHARD_GATE, f"each half alone vs the full solve's rows {d_half}")
    for k, v in scan.items():
        require(v["max_rel_err"] <= SHARD_SCAN_GATE, f"time-sharded sweep {k}: {v}")
    require(its == its1 and max(its) == SHARD_LIE_ITERS, f"LieILQR iterations {its} vs {its1}")
    require(runs["sharded LieILQR"] == expect(B14=max(its)) and per1 == expect(B14=max(its1)),
            f"LieILQR launch counts {runs['sharded LieILQR']} {per1}")
    require(d_lie <= SHARD_LIE_GATE, f"time-sharded vs associative LieILQR us {d_lie}")
    return runs


def launch_counters():
    """(counted, expect) over every kernel's launch counter: ``counted(fn)``
    sets each counter to 0, runs ``fn`` (synchronized, timed) and returns
    (its result, seconds, {kernel: launches}); ``expect(**launches)`` is
    every kernel's count, those named and every other kernel 0."""
    from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers import batched as F
    from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers import df_mixed as DM
    from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers import pipeline as P
    from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers import pipeline_so3 as S

    counters = {**P.KERNELS, **DM.KERNELS, **S.KERNELS, **F.KERNELS}

    def counted(fn):
        for w in counters.values():
            w.launches = 0
        out, sec = timed(fn)
        return out, sec, {k: w.launches for k, w in counters.items()}

    def expect(**launches):
        return {k: launches.get(k, 0) for k in counters}

    return counted, expect


def check_cli_launches(cli_runs):
    """Each CLI task launched the kernels of `CLI_KERNELS` and no other."""
    for task, n in cli_runs.items():
        want = CLI_KERNELS.get(task, set())
        require({k for k, v in n.items() if v} == want,
                f"cli {task} launches {n}, expected {want}")


def _finite(x):
    """Every number in a JSON value is finite."""
    if isinstance(x, dict):
        return all(_finite(v) for v in x.values())
    if isinstance(x, list):
        return all(_finite(v) for v in x)
    return not isinstance(x, float) or bool(np.isfinite(x))


def cli_phase(dev, card, counted, tasks=CLI_TASKS):
    """`cli` (module docstring): each task of ``tasks`` through
    `tasks/run.main` on ``dev``, its stdout captured, the counters reset
    just before it and read just after (``counted``); the gates on its
    line.  Returns {task: its launches}; the caller holds them to
    `CLI_KERNELS`.  On the CPU (the host rehearsal) the CLI takes its CPU
    sizes and engines."""
    import contextlib
    import io

    from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.mpc import (
        make_closed_loop_batch,
    )
    from trajectory_optimization_matrix_lie_groups_tpu_torch.tasks import parity
    from trajectory_optimization_matrix_lie_groups_tpu_torch.tasks import run as R
    from trajectory_optimization_matrix_lie_groups_tpu_torch.utils import records
    from trajectory_optimization_matrix_lie_groups_tpu_torch.viz.cost_landscape import (
        pose_error_grid,
    )

    parity.RESULTS_DIR = parity.STANDIN_DIR
    # the card's MPC tasks append their performance records: into the
    # build directory, never into the checkout's tracked tree
    records.DEFAULT_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                                        "records_torch.jsonl")
    runs = {}
    for task, flags in tasks:
        buf = io.StringIO()

        def go():
            with contextlib.redirect_stdout(buf):
                R.main([task, *flags, *(["--cpu"] if dev.type == "cpu" else [])])

        _, sec, n = counted(go)
        runs[task] = n
        line = json.loads(buf.getvalue().strip().splitlines()[-1])
        row = {"phase": "cli", "task": task, "flags": list(flags), "card": card,
               "wall_s": sec, "launches": {k: v for k, v in n.items() if v}, "line": line}
        require(_finite(line), f"cli {task}: a number is not finite: {line}")
        if task.endswith("_ms"):
            require(line["converged"] and line["us_vs_reference_max_err"] <= CLI_US_GATE,
                    f"cli {task}: {line}")
        if task == "al_batch":
            require(line["max_violation"] < AL_TOL and line["constr_converged"],
                    f"cli al_batch: {line}")
        if task == "mpc_batch":
            # the task's reported run is its last, on start batch 3
            model, dp, cp, B, H, T, pipe = R._batch_mpc_setup(
                types.SimpleNamespace(device=dev, dtype=torch.float32))
            res = make_closed_loop_batch(pipe, model, T)(
                dp, cp, R.mpc_batch_starts(cp, B, 3, dev),
                cp.xi_ref[0].expand(B, 6).contiguous())
            direct = float(torch.mean(R._err_to(cp.q_ref[T], res.qs[:, -1])))
            row["direct_tracking_err_mean_final"] = direct
            require(abs(direct - line["tracking_err_mean_final"]) <= CLI_MPC_GATE,
                    f"cli mpc_batch {line['tracking_err_mean_final']} vs direct {direct}")
        if task == "cartpole":
            require(line["converged"], f"cli cartpole: {line}")
        if task == "dynamics_sim":
            require(line["vel_divergence_max"] < 1e-10 and line["pose_divergence_max"] < 0.05
                    and line["pendulum_swings"], f"cli dynamics_sim: {line}")
        if task == "cost_landscape":
            _, _, params, _, _, _ = parity.build_benchmark("se3_tracking", True, device=dev)
            cp = params["cost"]
            th = np.linspace(-180.0, 180.0, 73)
            errs = {}
            for left, name in ((True, "left"), (False, "right")):
                Z = pose_error_grid(cp.q_ref[0], th, th, cp.Q1, left=left)[0]
                Zc = pose_error_grid(cp.q_ref[0].cpu(), th, th, cp.Q1.cpu(), left=left)[0]
                errs[name] = max(float(np.abs(Z - Zc).max()),
                                 abs(line["grids"][name]["min"] - float(Zc.min())),
                                 abs(line["grids"][name]["max"] - float(Zc.max())))
            row["grid_vs_cpu_max_abs"] = errs
            require(max(errs.values()) <= CLI_GRID_GATE, f"cli cost_landscape vs CPU {errs}")
        emit(row)
    return runs


def cli_only(names):
    """``--cli [task ...]`` (module docstring)."""
    from trajectory_optimization_matrix_lie_groups_tpu_torch import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(1)
    t0 = time.perf_counter()
    build_s = _build.build()
    card = nvidia_smi()
    counted, expect = launch_counters()
    runs = cli_phase(torch.device("cuda", 0), card, counted,
                     [t for t in CLI_TASKS if not names or t[0] in names])
    check_cli_launches(runs)
    emit({"cli_launches": {k: sum(n[k] for n in runs.values()) for k in expect()},
          "build_s": build_s, "total_s": time.perf_counter() - t0})
    print(card, flush=True)


def sharded_only():
    """``--sharded`` (module docstring)."""
    from trajectory_optimization_matrix_lie_groups_tpu_torch import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(1)
    t0 = time.perf_counter()
    build_s = _build.build()
    card = nvidia_smi()
    counted, expect = launch_counters()
    runs = sharded_phase(torch.device("cuda", 0), card, counted, expect)
    emit({"sharded_launches": {k: sum(n[k] for n in runs.values()) for k in expect()},
          "build_s": build_s, "total_s": time.perf_counter() - t0})
    print(card, flush=True)


def b13_any_only():
    """``--b13-any`` (module docstring)."""
    from trajectory_optimization_matrix_lie_groups_tpu_torch import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(1)
    t0 = time.perf_counter()
    build_s = _build.build()
    card = nvidia_smi()
    counted, expect = launch_counters()
    (launches, row), (large_launches, large_row) = b13_any_phase(
        torch.device("cuda", 0), card, counted, expect)
    emit({"b13_any_launches": launches, "B13any": row, "b13_large_launches": large_launches,
          "B13nuL": large_row, "build_s": build_s, "total_s": time.perf_counter() - t0})
    print(card, flush=True)


def nu_only():
    """``--nu`` (module docstring)."""
    from trajectory_optimization_matrix_lie_groups_tpu_torch import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(1)
    t0 = time.perf_counter()
    build_s = _build.build()
    card = nvidia_smi()
    counted, expect = launch_counters()
    launches, line = nu_phase(torch.device("cuda", 0), card, counted, expect)
    emit({"nu_launches": {k: v for k, v in launches.items() if v}, "kernels_nu": line,
          "build_s": build_s, "total_s": time.perf_counter() - t0})
    print(card, flush=True)


def refine_only():
    """``--refine`` (module docstring)."""
    from trajectory_optimization_matrix_lie_groups_tpu_torch import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(1)
    t0 = time.perf_counter()
    build_s = _build.build()
    card = nvidia_smi()
    counted, expect = launch_counters()
    launches, rows = refine_phase(torch.device("cuda", 0), card, counted, expect)
    emit({"refine_fp64_launches": launches, "build_s": build_s,
          "total_s": time.perf_counter() - t0})
    print(card, flush=True)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        sys.exit(2)
    if sys.argv[1:2] == ["--cli"]:
        return cli_only(sys.argv[2:])
    if sys.argv[1:] == ["--sharded"]:
        return sharded_only()
    if sys.argv[1:] == ["--b13-any"]:
        return b13_any_only()
    if sys.argv[1:] == ["--refine"]:
        return refine_only()
    if sys.argv[1:] == ["--nu"]:
        return nu_only()
    pool = multiprocessing.get_context("spawn").Pool(HOST_WORKERS)
    try:
        run(pool)
    finally:
        pool.terminate()
        pool.join()


def run(pool):
    """Every phase, in order (module docstring); ``pool`` runs the
    host-side reference solves."""
    host = {k: pool.apply_async(host_task, (t,)) for k, t in HOST_PLAIN.items()}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the plain versions on the host run thousands of tiny ops, slower on
    # more intra-op threads
    torch.set_num_threads(1)

    from trajectory_optimization_matrix_lie_groups_tpu_torch import _build, kernel_check
    from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers import batched as F
    from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers import df_mixed as DM
    from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers import pipeline as P
    from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers import pipeline_so3 as S
    from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.df_pipeline import (
        join_us,
    )
    from trajectory_optimization_matrix_lie_groups_tpu_torch.tasks import al_bench, so3_bench

    dev = torch.device("cuda", 0)
    card = nvidia_smi()
    build_s = _build.build()
    ptxas = _build.ptxas_report()
    emit({"phase": "device", "nvidia_smi": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "device_name": torch.cuda.get_device_name(0),
          "build_s": build_s, "ptxas": ptxas})
    # the Riccati kernels keep their carry in registers: B2 f32, B5, B13 f32
    # (the group kernels at nx = 12 and the one-thread kernel at (6, 3)) and
    # B11 f32 must not spill, nor B14 f32 (its carry and the stage's
    # carry-independent compositions)
    carry = {k: v for k, v in ptxas.items()
             if "traopt::riccati_kernel<float," in k or "traopt::riccati_mx_kernel<" in k
             or "traopt::fast_riccati_kernel<float," in k
             or "traopt::fast_riccati_thread_kernel<float," in k
             or "traopt::fast_rollout_kernel<float>" in k
             or "traopt::riccati_so3_kernel<float>" in k}
    require(len(carry) == 9 and all(v.get("spill_stores") == 0 and v.get("spill_loads") == 0
                                    for v in carry.values()),
            f"B2 f32 / B5 / B11 f32 / B13 f32 / B14 f32 spill: {carry}")
    require_frameless_f64(ptxas)

    us_gold, meta = al_bench.load_screw200_golden()
    problems = {dt: al_bench.build_screw200(dt, dev, horizon=N)
                for dt in (torch.float32, torch.float64)}

    def batch(dtype, B, seed):
        dyn, cost, q0, xi0 = problems[dtype]
        q0s, xi0s = al_bench.screw_batch(q0, xi0, B, seed)
        return dyn, cost, q0s, xi0s, torch.zeros((B, N, 6), dtype=dtype, device=dev)

    # -- kernels: each kernel against its plain version -----------------------
    # B2_al is B2 with a positive AL diagonal on Quu (the `al=` solve's path)
    kerr = {}
    for dtype, tag in ((torch.float32, "f32"), (torch.float64, "f64")):
        args = batch(dtype, CHECK_BATCH, SEED)
        solver = P.PipelineSolver(N, 2, float(args[0].dt))
        s = kernel_check.kernel_inputs(solver, *args, luu_al=True, seed=SEED)
        errs = kernel_check.compare(s, dt=solver.dt)
        torch.cuda.synchronize()
        kerr[tag] = {k: {**v, "gate": kernel_check.GATES[dtype][k]}
                     for k, v in errs.items()}
    emit({"phase": "kernels", "N": N, "B": CHECK_BATCH, "metric":
          "max_rel = max|kernel - plain| / max(1, max|plain|) over outputs", **kerr})
    for tag in ("f32", "f64"):
        for k, v in kerr[tag].items():
            require(v["max_rel"] <= v["gate"], f"{k} {tag} error {v['max_rel']} > {v['gate']}")

    # -- solve_f32: the main path ----------------------------------------------
    # The counters are reset just before each run and read just after it: the
    # fused solve at B=8192 (the main path: B1, B2, B3) and the solver's
    # unfused layout at B=256 (B1, B2, B4).
    counted, expect = launch_counters()

    args = batch(torch.float32, BATCH, SEED)
    dyn = args[0]
    fused = P.PipelineSolver(N, ITERS, float(dyn.dt))
    unfused = P.PipelineSolver(N, ITERS, float(dyn.dt), fused=False)
    out, fused_s, per_fused = counted(lambda: fused.solve(*args))
    small = (args[0], args[1], args[2][:CHECK_BATCH], args[3][:CHECK_BATCH],
             args[4][:CHECK_BATCH])
    out_u, _, per_unfused = counted(lambda: unfused.solve(*small))

    # the plain solve of lanes 0..15 on the host (on the card the plain
    # versions are bound by per-op overhead: 64 s at B = 8192)
    out_p, plain_s = host_plain(host, "f32")
    us0_err = float(np.abs(out.us[0].double().cpu().numpy() - us_gold).max())
    J0 = out.J_opt[0].item()
    J_rel = abs(J0 - meta["J_f64"]) / abs(meta["J_f64"])
    us_gate = 10 * meta["jax_f32_pipeline"]["lane0_us_max_abs_err"]
    Jp_rel = ((out.J_opt[:HOST_LANES].cpu() - out_p.J_opt).abs()
              / out_p.J_opt.abs()).max().item()
    Ju_rel = ((out.J_opt[:CHECK_BATCH] - out_u.J_opt).abs()
              / out_u.J_opt.abs()).max().item()
    finite = all(torch.isfinite(t).all().item()
                 for t in (out.us, out.qs, out.xis, out.J_opt, out.grad_norm))
    emit({"phase": "solve_f32", "B": BATCH, "N": N, "iterations": ITERS,
          "launches_fused": per_fused, "launches_unfused_B256": per_unfused,
          "all_finite": finite, "lane0_J": J0, "golden_J": meta["J_f64"],
          "lane0_J_rel_err": J_rel, "lane0_us_max_abs_err": us0_err,
          "lane0_us_gate": us_gate,
          "lane0_grad_norm": out.grad_norm[0].item(),
          "grad_norm_p50": out.grad_norm.median().item(),
          "grad_norm_max": out.grad_norm.max().item(),
          f"plain_vs_kernel_J_rel_err_lanes0_{HOST_LANES - 1}": Jp_rel,
          "unfused_vs_fused_J_rel_err_lanes0_255": Ju_rel,
          "fused_solve_s_first_call": fused_s,
          f"host_plain_solve_lanes0_{HOST_LANES - 1}_s": plain_s})
    require(per_fused == expect(B1=1, B2=ITERS, B3=ITERS),
            f"fused launch counts {per_fused}")
    require(per_unfused == expect(B1=ITERS, B2=ITERS, B4=ITERS),
            f"unfused launch counts {per_unfused}")
    require(finite, "non-finite lanes in the f32 solve")
    require(J_rel <= 1e-4, f"lane-0 J rel err {J_rel}")
    require(us0_err <= us_gate, f"lane-0 us err {us0_err} > {us_gate}")
    require(Jp_rel <= 1e-4, f"kernel vs plain J rel err {Jp_rel}")
    require(Ju_rel <= 1e-4, f"unfused vs fused J rel err {Ju_rel}")
    del out_p, out_u

    # -- solve_f64 --------------------------------------------------------------
    args64 = batch(torch.float64, CHECK_BATCH, SEED)
    out64 = P.PipelineSolver(N, F64_ITERS, float(args64[0].dt)).solve(*args64)
    us64_err = float(np.abs(out64.us[0].cpu().numpy() - us_gold).max())
    emit({"phase": "solve_f64", "B": CHECK_BATCH, "iterations": F64_ITERS,
          "lane0_us_max_abs_err": us64_err, "gate": 1e-6,
          "lane0_J": out64.J_opt[0].item(), "lane0_grad_norm": out64.grad_norm[0].item(),
          "all_finite": bool(torch.isfinite(out64.us).all().item())})
    require(us64_err <= 1e-6, f"f64 lane-0 us err {us64_err}")
    del out64

    # -- timing -----------------------------------------------------------------
    fused.solve(*batch(torch.float32, BATCH, 100))  # warm-up
    reps = []
    for r in range(TIMING_REPS):
        a = batch(torch.float32, BATCH, 101 + r)
        torch.cuda.synchronize()
        _, sec = timed(lambda: fused.solve(*a))
        reps.append(sec)
    med = statistics.median(reps)

    # each kernel against its plain version at the main path's shapes
    s = kernel_check.kernel_inputs(P.PipelineSolver(N, 2, float(dyn.dt)),
                                   *batch(torch.float32, BATCH, 200))
    errs = kernel_check.compare(s, dt=fused.dt)
    per_kernel = {}
    for k, (kern, plain) in kernel_check.calls(s, dt=fused.dt).items():
        per_kernel[k] = {"ms": event_ms(kern, 5), "plain_ms": event_ms(plain, 1),
                         "max_err": errs[k]["max_rel"], "max_abs_err": errs[k]["max_abs"],
                         "gate": kernel_check.GATES[torch.float32][k],
                         **bound(k, s, kern()),
                         "library_ms": None}
    emit({"phase": "timing", "card": card, "B": BATCH, "N": N, "iterations": ITERS,
          "kernel_path_rep_s": reps, "kernel_path_median_s": med,
          "kernel_path_solves_per_s": BATCH / med,
          "kernel_path_ms_per_iteration": med * 1e3 / ITERS,
          "per_kernel": per_kernel,
          "B3_ms": per_kernel["B3"]["ms"],
          "B4_plus_B1_ms": per_kernel["B4"]["ms"] + per_kernel["B1"]["ms"],
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    for k, v in per_kernel.items():
        require(v["max_err"] <= v["gate"], f"{k} at B={BATCH}: {v['max_err']}")
    del s

    # -- kernels_polish: B5-B9 on the polish's handoff iterate (7 f32
    # iterations), fp64 problem ---------------------------------------------------
    dyn64, cost64 = problems[torch.float64][:2]
    dt64 = float(dyn64.dt)
    pol_check = DM.MixedDFPipelineSolver(N, dt64, POLISH_F32_ITERS, POLISH_ITERS)
    s = kernel_check.polish_inputs(pol_check, *batch(torch.float64, CHECK_BATCH, SEED),
                                   luu_al=True, seed=SEED)
    perr = kernel_check.polish_compare(s, pol_check)
    torch.cuda.synchronize()
    del s
    perr = {k: {**v, "gate": kernel_check.GATES["mixed"][k]} for k, v in perr.items()}
    emit({"phase": "kernels_polish", "N": N, "B": CHECK_BATCH, "metric":
          "max|kernel - plain| / max(1, max|plain|) per output", "mixed": perr})
    for k, v in perr.items():
        for o, e in v["per_output"].items():
            require(e <= v["gate"][o], f"{k} output {o} error {e} > {v['gate'][o]}")

    # -- solve_polish: the polish path --------------------------------------------
    mixed = lambda f32_it, **kw: DM.MixedDFPipelineSolver(N, dt64, f32_it, POLISH_ITERS, **kw)
    pargs = batch(torch.float64, POLISH_BATCH, SEED)
    torch.cuda.reset_peak_memory_stats()
    f32_it = POLISH_F32_ITERS
    mx = mixed(f32_it)
    outp, polish_s, per_polish = counted(lambda: mx.solve(*pargs))
    usp = join_us(outp)
    err0 = float(np.abs(usp[0].cpu().numpy() - us_gold).max())
    fallback = err0 > POLISH_GATE
    if fallback:
        # bench.py's fallback: the full f32 budget
        f32_it = POLISH_FALLBACK_F32_ITERS
        mx = mixed(f32_it)
        outp, polish_s, per_polish = counted(lambda: mx.solve(*pargs))
        usp = join_us(outp)
        err0 = float(np.abs(usp[0].cpu().numpy() - us_gold).max())
    Jp0 = outp.J_opt[0].item()
    Jp_rel = abs(Jp0 - meta["J_f64"]) / abs(meta["J_f64"])
    gn = outp.grad_norm.double()
    finite_p = all(torch.isfinite(t).all().item() for t in
                   (usp, outp.qs, outp.xis, outp.J_opt, outp.grad_norm))
    peak_polish = torch.cuda.max_memory_allocated() / 1e9
    # kernel and plain polish of one handoff (lanes 0..255 of the batch)
    small_p = tuple(x[:CHECK_BATCH] for x in pargs[2:])
    handoff = mx.f32_phase(dyn64, cost64, *small_p)
    kern_small = mx.polish(dyn64, cost64, *handoff)
    plain_small, plain_polish_small_s = timed(
        lambda: mixed(f32_it, plain=True).polish(dyn64, cost64, *handoff))
    agree = (join_us(kern_small) - join_us(plain_small)).abs().max().item()
    agree_J = ((kern_small.J_opt - plain_small.J_opt).abs()
               / plain_small.J_opt.abs()).max().item()
    # fx_mode='hybrid' at B=256
    hyb = mixed(f32_it, fx_mode="hybrid").solve(dyn64, cost64, *small_p)
    hyb_err = float(np.abs(join_us(hyb)[0].cpu().numpy() - us_gold).max())
    emit({"phase": "solve_polish", "B": POLISH_BATCH, "N": N,
          "f32_iterations": f32_it, "polish_iterations": POLISH_ITERS,
          "fx_mode": "df", "fallback_to_12_f32_iterations": fallback,
          "launches": per_polish, "all_finite": finite_p,
          "lane0_us_max_abs_err": err0, "gate": POLISH_GATE,
          "lane0_J": Jp0, "golden_J": meta["J_f64"], "lane0_J_rel_err": Jp_rel,
          "grad_norm_p50": gn.quantile(0.5).item(), "grad_norm_p95": gn.quantile(0.95).item(),
          "grad_norm_max": gn.max().item(),
          "kernel_vs_plain_polish_lanes0_255_us_max_abs": agree,
          "kernel_vs_plain_polish_lanes0_255_J_rel": agree_J,
          "agreement_gate": POLISH_AGREE,
          "plain_polish_lanes0_255_s": plain_polish_small_s,
          "hybrid_B256_lane0_us_max_abs_err": hyb_err,
          "solve_s_first_call": polish_s, "peak_mem_gb": peak_polish})
    require(per_polish == expect(B1=1, B2=f32_it, B3=f32_it, B5=POLISH_ITERS,
                                 B6=POLISH_ITERS, B7=POLISH_ITERS, B8=POLISH_ITERS,
                                 B9=POLISH_ITERS),
            f"polish launch counts {per_polish}")
    require(finite_p, "non-finite lanes in the polish solve")
    require(err0 <= POLISH_GATE, f"polish lane-0 us err {err0} > {POLISH_GATE}")
    require(Jp_rel <= 1e-4, f"polish lane-0 J rel err {Jp_rel}")
    require(agree <= POLISH_AGREE, f"kernel vs plain polish us {agree} > {POLISH_AGREE}")
    require(agree_J <= 1e-6, f"kernel vs plain polish J rel {agree_J}")
    require(hyb_err <= POLISH_GATE, f"hybrid lane-0 us err {hyb_err} > {POLISH_GATE}")
    del outp, usp, kern_small, plain_small, hyb, handoff

    # the polish path: a new batch each rep, the two phases timed apart
    mx.solve(*batch(torch.float64, POLISH_BATCH, 300))  # warm-up
    f32_reps, pol_reps = [], []
    for r in range(POLISH_REPS):
        a = batch(torch.float64, POLISH_BATCH, 301 + r)
        handoff, t_f32 = timed(lambda: mx.f32_phase(*a))
        _, t_pol = timed(lambda: mx.polish(a[0], a[1], *handoff))
        f32_reps.append(t_f32)
        pol_reps.append(t_pol)
    del handoff
    tot = [x + y for x, y in zip(f32_reps, pol_reps)]
    med_p = statistics.median(tot)
    # B2 at B=16384, the shape at which the polish path's f32 phase launches
    # it, on a real f32 iterate of that batch
    s = kernel_check.kernel_inputs(P.PipelineSolver(N, 2, float(dyn.dt)),
                                   *batch(torch.float32, POLISH_BATCH, 400))
    kern, plain = kernel_check.calls(s, dt=fused.dt)["B2"]
    err2 = kernel_check.compare(s, dt=fused.dt)["B2"]
    b2_polish = {"ms": event_ms(kern, 5), "plain_ms": event_ms(plain, 1),
                 "max_err": err2["max_rel"], "max_abs_err": err2["max_abs"],
                 "gate": kernel_check.GATES[torch.float32]["B2"],
                 "launches": per_polish["B2"], **bound("B2", s, kern()), "library_ms": None}
    del s
    # B5, B6 and the B7-B9 tail against their plain versions at B=16384
    s = kernel_check.polish_inputs(mx, *batch(torch.float64, POLISH_BATCH, 400))
    perr = kernel_check.polish_compare(s, mx)
    pol_kernel = {}
    for k, (kern, plain) in kernel_check.polish_calls(s, mx).items():
        pol_kernel[k] = {"ms": event_ms(kern, 5), "plain_ms": event_ms(plain, 1),
                         **bound(k, s, kern()), "library_ms": None}
    hand = tuple(s[n] for n in ("qR", "qp", "xi", "us"))
    del s
    _, plain_polish_s = timed(lambda: mixed(f32_it, plain=True).polish(dyn64, cost64, *hand))
    del hand
    for k in ("B5", "B6", "B7", "B8", "B9"):
        src = pol_kernel["tail" if k in kernel_check.TAIL else k]
        per_kernel[k] = {**src, "max_err": perr[k]["max_rel"], "max_abs_err": perr[k]["max_abs"],
                         "per_output": perr[k]["per_output"]}
    emit({"phase": "timing_polish", "card": card, "B": POLISH_BATCH, "N": N,
          "f32_iterations": f32_it, "polish_iterations": POLISH_ITERS,
          "rep_s": tot, "f32_phase_rep_s": f32_reps, "polish_rep_s": pol_reps,
          "median_s": med_p, "f32_phase_median_ms": statistics.median(f32_reps) * 1e3,
          "polish_median_ms": statistics.median(pol_reps) * 1e3,
          "gate_passing_solves_per_s": POLISH_BATCH / med_p,
          "plain_polish_s": plain_polish_s,
          "per_kernel": {f"B2 B={POLISH_BATCH} f32 phase": b2_polish,
                         **{k: per_kernel[k] for k in ("B5", "B6", "B7", "B8", "B9")}},
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    require(b2_polish["max_err"] <= b2_polish["gate"],
            f"B2 at B={POLISH_BATCH}: {b2_polish['max_err']}")
    for k in ("B5", "B6", "B7", "B8", "B9"):
        for o, e in per_kernel[k]["per_output"].items():
            gate = kernel_check.GATES["mixed"][k][o]
            require(e <= gate, f"{k} output {o} at B={POLISH_BATCH}: {e} > {gate}")

    # -- kernels_so3: B10-B12 on a real iterate of each family ------------------
    so3 = {}
    for name in SO3_PROBLEMS:
        pendulum, dt_p, n_p = so3_bench.PROBLEMS[name][:3]
        build = (so3_bench.build_pendulum_swingup80 if pendulum
                 else so3_bench.build_so3_track249)
        so3[name] = dict(pendulum=pendulum, dt=dt_p, N=n_p, gold=so3_bench.load_so3_golden(name),
                         problem={dt: build(dt, dev) for dt in (torch.float32, torch.float64)})

    def so3_batch(name, dtype, B, seed):
        dyn, cost, q0, xi0 = so3[name]["problem"][dtype]
        q0s, xi0s = so3_bench.so3_batch(q0, xi0, B, seed)
        return dyn, cost, q0s, xi0s, torch.zeros((B, so3[name]["N"], 3), dtype=dtype, device=dev)

    def so3_solver(name, iterations, **kw):
        p = so3[name]
        return S.SO3PipelineSolver(p["N"], iterations, p["dt"], pendulum=p["pendulum"], **kw)

    serr = {}
    for name in SO3_PROBLEMS:
        for dtype, tag in ((torch.float32, "f32"), (torch.float64, "f64")):
            s = kernel_check.so3_inputs(so3_solver(name, 2), *so3_batch(name, dtype, CHECK_BATCH, SEED))
            e = kernel_check.so3_compare(s, dt=so3[name]["dt"], pendulum=so3[name]["pendulum"])
            torch.cuda.synchronize()
            serr[f"{name} {tag}"] = {k: {**v, "gate": kernel_check.GATES["so3"][dtype][k]}
                                     for k, v in e.items()}
    del s
    emit({"phase": "kernels_so3", "B": CHECK_BATCH, "metric":
          "max_rel = max|kernel - plain| / max(1, max|plain|) over outputs", **serr})
    for run, errs in serr.items():
        for k, v in errs.items():
            require(v["max_rel"] <= v["gate"], f"{k} {run} error {v['max_rel']} > {v['gate']}")

    # -- solve_so3: the SO(3) path, each family ------------------------------------
    per_so3 = {}
    for name in SO3_PROBLEMS:
        us_g, meta_g = so3[name]["gold"]
        args = so3_batch(name, torch.float32, BATCH, SEED)
        out, sec, per_so3[name] = counted(lambda: so3_solver(name, SO3_ITERS).solve(*args))
        # the plain solve of lanes 0..15 runs on the host: the plain
        # versions are bound by per-op overhead, which is ~3x the host's on
        # the card (96 s there for the free attitude)
        out_p, plain_s = host_plain(host, name)
        us0_err = float(np.abs(out.us[0].double().cpu().numpy() - us_g).max())
        J_rel = abs(out.J_opt[0].item() - meta_g["J_f64"]) / abs(meta_g["J_f64"])
        us_gate = 10 * meta_g["jax_f32_pipeline"]["lane0_us_max_abs_err"]
        Jp_rel = ((out.J_opt[:HOST_LANES].cpu() - out_p.J_opt).abs()
                  / out_p.J_opt.abs()).max().item()
        finite = all(torch.isfinite(t).all().item()
                     for t in (out.us, out.qs, out.xis, out.J_opt, out.grad_norm))
        a64 = so3_batch(name, torch.float64, CHECK_BATCH, SEED)
        out64 = so3_solver(name, meta_g["iterations_f64"]).solve(*a64)
        us64_err = float(np.abs(out64.us[0].cpu().numpy() - us_g).max())
        finite64 = bool(torch.isfinite(out64.us).all().item())
        emit({"phase": "solve_so3", "problem": name, "B": BATCH, "N": so3[name]["N"],
              "iterations": SO3_ITERS, "launches": per_so3[name], "all_finite": finite,
              "lane0_J": out.J_opt[0].item(), "golden_J": meta_g["J_f64"],
              "lane0_J_rel_err": J_rel, "lane0_us_max_abs_err": us0_err,
              "lane0_us_gate": us_gate, "lane0_grad_norm": out.grad_norm[0].item(),
              "grad_norm_p50": out.grad_norm.median().item(),
              "grad_norm_max": out.grad_norm.max().item(),
              f"plain_vs_kernel_J_rel_err_lanes0_{HOST_LANES - 1}": Jp_rel,
              f"host_plain_solve_lanes0_{HOST_LANES - 1}_s": plain_s, "solve_s_first_call": sec,
              "f64_iterations": meta_g["iterations_f64"],
              "f64_lane0_us_max_abs_err": us64_err, "f64_gate": 1e-6,
              "f64_all_finite": finite64})
        require(per_so3[name] == expect(B10=1, B11=SO3_ITERS, B12=SO3_ITERS),
                f"{name} launch counts {per_so3[name]}")
        require(finite and finite64, f"non-finite lanes in the {name} solves")
        require(J_rel <= 1e-4, f"{name} lane-0 J rel err {J_rel}")
        require(us0_err <= us_gate, f"{name} lane-0 us err {us0_err} > {us_gate}")
        require(Jp_rel <= 1e-4, f"{name} kernel vs plain J rel err {Jp_rel}")
        require(us64_err <= 1e-6, f"{name} f64 lane-0 us err {us64_err}")
        del out, out_p, out64

    # -- timing_so3: each family, then B10-B12 against their plain versions -----
    so3_kernel = {}
    for name in SO3_PROBLEMS:
        solver = so3_solver(name, SO3_ITERS)
        solver.solve(*so3_batch(name, torch.float32, BATCH, 500))  # warm-up
        reps = []
        for r in range(TIMING_REPS):
            a = so3_batch(name, torch.float32, BATCH, 501 + r)
            _, sec = timed(lambda: solver.solve(*a))
            reps.append(sec)
        med_s = statistics.median(reps)
        s = kernel_check.so3_inputs(so3_solver(name, 2), *so3_batch(name, torch.float32, BATCH, 600))
        kw = dict(dt=so3[name]["dt"], pendulum=so3[name]["pendulum"])
        errs = kernel_check.so3_compare(s, **kw)
        kern_t = {}
        for k, (kern, plain) in kernel_check.so3_calls(s, **kw).items():
            kern_t[k] = {"ms": event_ms(kern, 5), "plain_ms": event_ms(plain, 1),
                         "max_err": errs[k]["max_rel"], "max_abs_err": errs[k]["max_abs"],
                         "gate": kernel_check.GATES["so3"][torch.float32][k],
                         **bound(k, s, kern()), "library_ms": None}
        # B12's first phase alone: the rollout, without B10 on its trajectory
        fn = S._launch("rollout_so3", s["us"])
        rargs = (s["qR"], s["xi"], s["us"], s["k"], s["K"], s["lin"], s["refs"], s["consts"])
        rollout_ms = event_ms(lambda: S._rollout_so3_kernel(*fn, *rargs, linearize=False,
                                                            **kw), 5)
        del s
        so3_kernel[name] = kern_t
        emit({"phase": "timing_so3", "problem": name, "card": card, "B": BATCH,
              "N": so3[name]["N"], "iterations": SO3_ITERS, "rep_s": reps, "median_s": med_s,
              "solves_per_s": BATCH / med_s, "ms_per_iteration": med_s * 1e3 / SO3_ITERS,
              "per_kernel": kern_t, "B12_ms": kern_t["B12"]["ms"],
              "B12_rollout_phase_ms": rollout_ms,
              "B12_rollout_phase_plus_B10_ms": rollout_ms + kern_t["B10"]["ms"],
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
        for k, v in kern_t.items():
            require(v["max_err"] <= v["gate"], f"{k} {name} at B={BATCH}: {v['max_err']}")
    per_kernel.update(so3_kernel[SO3_PROBLEMS[0]])

    # -- kernels_fast: B13 at each (nx, nu) and B14 on a real iterate ----------
    # the generic fast tier: the free body on B1, B13 and B14 (screw-200), the
    # drone (screw-200, nu = 4) and the free attitude (so3_track249) on B13
    fast = {}
    for kind in FAST_KINDS:
        if kind == "so3_track249":
            make = lambda dtype, device: so3_bench.so3_track249_model(dtype, device)
            fbatch, n_k, it_k = so3_bench.so3_batch, so3["so3_track249"]["N"], SO3_ITERS
        else:
            make = lambda dtype, device, kind=kind: al_bench.screw200_model(
                dtype, device, horizon=N, drone=kind == "drone")
            fbatch, n_k, it_k = al_bench.screw_batch, N, ITERS
        fast[kind] = dict(problem={dt: make(dt, dev) for dt in (torch.float32, torch.float64)},
                          batch=fbatch, N=n_k, iterations=it_k)

    def fast_args(kind, dtype, B, seed, scale=0.05):
        model, params, q0, xi0 = fast[kind]["problem"][dtype]
        q0s, xi0s = fast[kind]["batch"](q0, xi0, B, seed, scale=scale)
        cp = params["cost"]
        return (params, q0s, xi0s, torch.zeros((B, fast[kind]["N"], model.nu), dtype=dtype,
                                               device=dev), cp.q_ref, cp.xi_ref)

    def fast_solver(kind, iterations, dtype=torch.float32, **kw):
        model, params = fast[kind]["problem"][dtype][:2]
        if kind == "free_body":
            kw = dict(pallas_rollout_dt=float(params["dyn"].dt), use_pallas_linearize=True,
                      **kw)
        return F.FastBatchSolver(model, fast[kind]["N"], iterations, **kw)

    ferr = {}
    for kind in FAST_KINDS:
        for dtype, tag in ((torch.float32, "f32"), (torch.float64, "f64")):
            s = kernel_check.fast_inputs(fast_solver(kind, FAST_CHECK_ITERS, dtype),
                                         *fast_args(kind, dtype, CHECK_BATCH, SEED)[:4])
            e = kernel_check.fast_compare(s)
            torch.cuda.synchronize()
            ferr[f"{kind} {tag}"] = {k: {**v, "gate": kernel_check.GATES["fast"][dtype][k]}
                                     for k, v in e.items()}
    del s
    emit({"phase": "kernels_fast", "B": CHECK_BATCH, "metric":
          "max_rel = max|kernel - plain| / max(1, max|plain|) over outputs", **ferr})
    require(all(set(v) == ({"B13", "B14"} if run.startswith("free_body") else {"B13"})
                for run, v in ferr.items()), "kernels_fast: a kernel was not checked")
    for run, errs in ferr.items():
        for k, v in errs.items():
            require(v["max_rel"] <= v["gate"], f"{k} {run} error {v['max_rel']} > {v['gate']}")

    # -- solve_fast: the generic fast tier, each path ------------------------------
    def j_rel(a, b):
        return ((a.cpu() - b.cpu()).abs() / b.cpu().abs()).max().item()

    def finite(out):
        return all(torch.isfinite(t).all().item()
                   for t in (out.us, out.qs, out.xis, out.J_opt, out.grad_norm))

    per_fast = {}
    # the free body: the main path of the generic tier
    fargs = fast_args("free_body", torch.float32, BATCH, SEED)
    out, fast_s, per_fast["free_body"] = counted(
        lambda: fast_solver("free_body", ITERS).solve(*fargs))
    us0_err = float(np.abs(out.us[0].double().cpu().numpy() - us_gold).max())
    J_rel = abs(out.J_opt[0].item() - meta["J_f64"]) / abs(meta["J_f64"])
    us_gate = 10 * meta["jax_f32_pipeline"]["lane0_us_max_abs_err"]
    dyn, cost = problems[torch.float32][:2]
    pipe = P.PipelineSolver(N, ITERS, float(dyn.dt)).solve(
        dyn, cost, fargs[1][:CHECK_BATCH], fargs[2][:CHECK_BATCH], fargs[3][:CHECK_BATCH])
    Jpipe_rel = j_rel(out.J_opt[:CHECK_BATCH], pipe.J_opt)
    out_p, plain_s = host_plain(host, "fast free_body")
    Jp_rel = j_rel(out.J_opt[:HOST_LANES], out_p.J_opt)
    fin = finite(out)
    emit({"phase": "solve_fast", "path": "free_body", "B": BATCH, "N": N,
          "iterations": ITERS, "launches": per_fast["free_body"], "all_finite": fin,
          "lane0_J": out.J_opt[0].item(), "golden_J": meta["J_f64"], "lane0_J_rel_err": J_rel,
          "lane0_us_max_abs_err": us0_err, "lane0_us_gate": us_gate,
          "grad_norm_p50": out.grad_norm.median().item(),
          "pipeline_vs_fast_J_rel_err_lanes0_255": Jpipe_rel,
          f"plain_vs_kernel_J_rel_err_lanes0_{HOST_LANES - 1}": Jp_rel,
          f"host_plain_solve_lanes0_{HOST_LANES - 1}_s": plain_s, "solve_s_first_call": fast_s})
    require(per_fast["free_body"] == expect(B1=ITERS, B13=ITERS, B14=ITERS),
            f"free-body fast launch counts {per_fast['free_body']}")
    require(fin, "non-finite lanes in the free-body fast solve")
    require(J_rel <= 1e-4, f"fast lane-0 J rel err {J_rel}")
    require(us0_err <= us_gate, f"fast lane-0 us err {us0_err} > {us_gate}")
    require(Jpipe_rel <= 1e-4, f"fast vs pipeline J rel err {Jpipe_rel}")
    require(Jp_rel <= 1e-4, f"fast kernel vs plain J rel err {Jp_rel}")
    del out, pipe, out_p

    # the drone (nu = 4) on B13
    dargs = fast_args("drone", torch.float32, BATCH, SEED)
    out, drone_s, per_fast["drone"] = counted(
        lambda: fast_solver("drone", DRONE_ITERS).solve(*dargs))
    out_p, plain_s = host_plain(host, "fast drone")
    Jp_rel = j_rel(out.J_opt[:HOST_LANES], out_p.J_opt)
    fin = finite(out)
    emit({"phase": "solve_fast", "path": "drone", "B": BATCH, "N": N,
          "iterations": DRONE_ITERS,
          "launches": per_fast["drone"], "all_finite": fin, "lane0_J": out.J_opt[0].item(),
          "grad_norm_p50": out.grad_norm.median().item(),
          f"plain_vs_kernel_J_rel_err_lanes0_{HOST_LANES - 1}": Jp_rel,
          f"host_plain_solve_lanes0_{HOST_LANES - 1}_s": plain_s, "solve_s_first_call": drone_s})
    require(per_fast["drone"] == expect(B13=DRONE_ITERS),
            f"drone launch counts {per_fast['drone']}")
    require(fin, "non-finite lanes in the drone fast solve")
    require(Jp_rel <= 1e-4, f"drone kernel vs plain J rel err {Jp_rel}")
    del out, out_p

    # the free attitude (nx = 6, nu = 3) on B13
    us_g, meta_g = so3["so3_track249"]["gold"]
    sargs = fast_args("so3_track249", torch.float32, BATCH, SEED)
    out, so3f_s, per_fast["so3_track249"] = counted(
        lambda: fast_solver("so3_track249", SO3_ITERS).solve(*sargs))
    us0_err = float(np.abs(out.us[0].double().cpu().numpy() - us_g).max())
    J_rel = abs(out.J_opt[0].item() - meta_g["J_f64"]) / abs(meta_g["J_f64"])
    us_gate = 10 * meta_g["jax_f32_pipeline"]["lane0_us_max_abs_err"]
    fin = finite(out)
    emit({"phase": "solve_fast", "path": "so3_track249", "B": BATCH,
          "N": fast["so3_track249"]["N"], "iterations": SO3_ITERS,
          "launches": per_fast["so3_track249"], "all_finite": fin,
          "lane0_J": out.J_opt[0].item(), "golden_J": meta_g["J_f64"],
          "lane0_J_rel_err": J_rel, "lane0_us_max_abs_err": us0_err, "lane0_us_gate": us_gate,
          "solve_s_first_call": so3f_s})
    require(per_fast["so3_track249"] == expect(B13=SO3_ITERS),
            f"so3_track249 fast launch counts {per_fast['so3_track249']}")
    require(fin, "non-finite lanes in the so3_track249 fast solve")
    require(J_rel <= 1e-4, f"so3_track249 fast lane-0 J rel err {J_rel}")
    require(us0_err <= us_gate, f"so3_track249 fast lane-0 us err {us0_err} > {us_gate}")
    del out

    # the per-lane merit line search, f64, from poses perturbed by Exp(0.4 n)
    largs = fast_args("free_body", torch.float64, LS_BATCH, SEED, scale=LS_SCALE)
    out, ls_s, per_ls = counted(lambda: fast_solver(
        "free_body", LS_ITERS, torch.float64, line_search=True).solve(*largs))
    out_p, ls_plain_s = host_plain(host, "fast line_search")
    ls_agree = (out.us[:HOST_LANES].cpu() - out_p.us).abs().max().item()
    fin = finite(out)
    emit({"phase": "solve_fast", "path": "line_search", "dtype": "float64", "B": LS_BATCH,
          "N": N, "iterations": LS_ITERS, "pose_perturbation": LS_SCALE,
          "launches": per_ls, "all_finite": fin,
          f"kernel_vs_plain_us_max_abs_lanes0_{HOST_LANES - 1}": ls_agree, "gate": 1e-9,
          f"host_plain_solve_lanes0_{HOST_LANES - 1}_s": ls_plain_s, "solve_s_first_call": ls_s})
    require(per_ls == expect(B1=LS_ITERS, B13=LS_ITERS, B14=LS_ITERS),
            f"line-search launch counts {per_ls}")
    require(fin, "non-finite lanes in the line-search solve")
    require(ls_agree <= 1e-9, f"line search kernel vs plain us {ls_agree} > 1e-9")
    del out, out_p

    # -- timing_fast: each path, then B13 at each shape and B14 against plain -----
    solver = fast_solver("free_body", ITERS)
    solver.solve(*fast_args("free_body", torch.float32, BATCH, 700))  # warm-up
    reps = []
    for r in range(TIMING_REPS):
        a = fast_args("free_body", torch.float32, BATCH, 701 + r)
        _, sec = timed(lambda: solver.solve(*a))
        reps.append(sec)
    med_f = statistics.median(reps)
    fast_kernel = {}
    for kind in FAST_KINDS:
        s = kernel_check.fast_inputs(fast_solver(kind, FAST_CHECK_ITERS),
                                     *fast_args(kind, torch.float32, BATCH, 720)[:4])
        errs = kernel_check.fast_compare(s)
        for k, (kern, plain) in kernel_check.fast_calls(s).items():
            fast_kernel[f"{k} {kind}"] = {
                "ms": event_ms(kern, 5), "plain_ms": event_ms(plain, 1),
                "max_err": errs[k]["max_rel"], "max_abs_err": errs[k]["max_abs"],
                "gate": kernel_check.GATES["fast"][torch.float32][k],
                **bound(k, s, kern()), "library_ms": None}
        del s
    emit({"phase": "timing_fast", "card": card, "B": BATCH, "N": N, "iterations": ITERS,
          "free_body_rep_s": reps, "free_body_median_s": med_f,
          "free_body_solves_per_s": BATCH / med_f,
          "free_body_ms_per_iteration": med_f * 1e3 / ITERS,
          # the drone and the free attitude: their solve_fast runs (host-bound
          # loops of 18-40 s; a second run of each read the same to 2-90%)
          "drone_s": drone_s, "drone_solves_per_s": BATCH / drone_s,
          "drone_ms_per_iteration": drone_s * 1e3 / DRONE_ITERS,
          "so3_track249_s": so3f_s, "so3_track249_solves_per_s": BATCH / so3f_s,
          "so3_track249_ms_per_iteration": so3f_s * 1e3 / SO3_ITERS,
          "per_kernel": {"B1": {**per_kernel["B1"], "launches": per_fast["free_body"]["B1"],
                                "run": "free_body fast B=8192"}, **fast_kernel},
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    for k, v in fast_kernel.items():
        require(v["max_err"] <= v["gate"], f"{k} at B={BATCH}: {v['max_err']}")
    per_kernel["B13"] = fast_kernel["B13 free_body"]
    per_kernel["B14"] = fast_kernel["B14 free_body"]

    constrained_phases(dev, card, counted, expect)
    exact_runs = exact_phases(dev, card, counted, expect, {
        "fast_free_body": BATCH / med_f, "mixed_polish": POLISH_BATCH / med_p}, pool)
    ((per_any, per_kernel["B13any"]),
     (per_large, per_kernel["B13nuL"])) = b13_any_phase(dev, card, counted, expect)
    per_nu, nu_line = nu_phase(dev, card, counted, expect)
    per_kernel.update(nu_line)
    exact_runs.update(errstate_sweep_phases(dev, card, counted, expect, pool))
    cli_runs = cli_phase(dev, card, counted)
    check_cli_launches(cli_runs)
    exact_runs["cli"] = {k: sum(n[k] for n in cli_runs.values()) for k in expect()}
    shard_runs = sharded_phase(dev, card, counted, expect)
    exact_runs["sharded"] = {k: sum(n[k] for n in shard_runs.values()) for k in expect()}

    # launches: B1-B3 from the fused f32 solve, B4 from the unfused one,
    # B5-B9 from the polish solve, B10-B12 from the free-attitude solve (the
    # pendulum's read the same, solve_so3); "launches_in" names every phase
    # of the reference-exact, anchored and refiner paths that launched the
    # kernel, with its count
    runs = {k: ("fused B=8192", per_fused) for k in ("B1", "B2", "B3")}
    runs["B4"] = ("unfused B=256", per_unfused)
    runs.update({k: (f"polish B={POLISH_BATCH}", per_polish) for k in DM.KERNELS})
    runs.update({k: (f"{SO3_PROBLEMS[0]} B={BATCH}", per_so3[SO3_PROBLEMS[0]])
                 for k in S.KERNELS})
    runs.update({k: (f"free_body fast B={BATCH}", per_fast["free_body"])
                 for k in ("B13", "B14")})
    runs["B13any"] = (f"(12, 3) rigid body fast B={ANY_SOLVE_BATCH}", per_any)
    runs["B13nuL"] = (f"screw200_rcs16 fast B={RCS16_BATCH}", per_large)
    runs.update({k: ("kernels_nu (b): the four problems, f32 path, polish and refiner",
                     per_nu) for k in nu_line})
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    emit({"kernels": [
        {"name": f"{k} {KERNELS[k][0]}", "route": "cuda",
         "source": f"{PKG}/{KERNELS[k][1]}", "replaces": KERNELS[k][2],
         "launches": runs[k][1][k], "run": runs[k][0],
         "launches_in": {ph: n[k] for ph, n in exact_runs.items() if n[k]},
         **{key: per_kernel[k][key] for key in keys}}
        for k in KERNELS]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
