"""Committed performance-record log (counterpart of the JAX
`utils/records.py`).

A measurement is appended as one JSON line, carrying its payload plus the
exact invocation (argv) and time, to ``bench_records/records_torch.jsonl``
at the repository root: a file of the port's own, beside (never into) the
JAX package's ``records.jsonl``.

Usage, right after printing a JSON result::

    from trajectory_optimization_matrix_lie_groups_tpu_torch.utils.records import record
    record("mpc_batch", result_dict)
"""

import datetime
import json
import os
import sys

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_PATH = os.path.join(_REPO_ROOT, "bench_records", "records_torch.jsonl")


def _default(o):
    """Stray numpy/torch scalars and arrays become numbers and lists,
    anything else a string."""
    if hasattr(o, "item") and (not hasattr(o, "__len__") or getattr(o, "ndim", 1) == 0):
        return o.item()
    if hasattr(o, "tolist"):
        return o.tolist()
    return str(o)


def record(name, payload, path=None):
    """Append {name, when, invocation, **payload} as one JSON line to
    ``path`` (default `DEFAULT_PATH`).

    Returns the path written.  Failures to write (read-only checkout, a
    payload that is not a mapping) are reported to stderr but never raise:
    a record must not be able to kill the measurement that produced it.
    """
    path = path or DEFAULT_PATH
    try:
        entry = dict(
            name=name,
            when=datetime.datetime.now(datetime.timezone.utc).isoformat(
                timespec="seconds"),
            invocation=" ".join([os.path.basename(sys.executable)]
                                + [os.path.relpath(a, _REPO_ROOT)
                                   if os.path.isabs(a) and a.startswith(_REPO_ROOT)
                                   else a for a in sys.argv]),
        )
        # payload keys that collide with the envelope keep the payload value
        # under a "payload_" prefix
        for k, v in dict(payload).items():
            entry[f"payload_{k}" if k in entry else k] = v
        line = json.dumps(entry, default=_default)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "a") as f:
            f.write(line + "\n")
    except Exception as e:  # environment-dependent
        print(f"records.record: could not write {path}: {e}", file=sys.stderr)
    return path
