"""Profiling (counterpart of the JAX `utils/profiling.py`'s `trace`): the
analog of the reference's `run_profiler.py` (cProfile wrapper), on
`torch.profiler`.  The JAX module's `PhaseTimer` has no caller there and
is not ported.
"""

import contextlib
import os

import torch


@contextlib.contextmanager
def trace(log_dir="traopt_trace"):
    """Capture a `torch.profiler` trace of the block (host ops, and the
    card's kernels when CUDA is available) and write it to ``log_dir`` as a
    Chrome trace (`trace.json`, viewable in chrome://tracing or Perfetto).
    Yields the profiler; its ``key_averages()`` summarise the run."""
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
