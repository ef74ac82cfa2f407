"""CUDA-graph replay of the host-bound loops of the reference-exact tier.

The Euclidean `ILQR`'s backward pass and candidate rollout and `LieILQR`'s
nonlinear rollout are Python loops over stages of a handful of small ops
each: on the card their time is the host's launch overhead (~10 µs an op
under `torch.func.vmap`), not the device's work.  `GraphCache` runs such a
function once eagerly on a side stream (lazy library initialization stays
out of the capture), captures its next call as a CUDA graph, and from then
on copies the call's tensors into the captured inputs and replays the
graph: the same kernels on the same values, so the results are those of
the eager call, launched at once.

A function is captured per signature:

- the structure of its arguments (dicts, tuples, NamedTuples and
  dataclasses, walked to their tensors) with every non-tensor value in it,
  which must be None, a bool, an int, a float, a str, a dtype or a device
  (anything else raises: it could not be told apart reliably);
- each argument tensor's shape, dtype, strides and device;
- the tensors the function reads from its closure (a model's cost weights
  and targets, found by walking the bound solver, its model and the
  closures of their functions), by identity and storage address.  A graph
  reads such a tensor where it lay at capture: changed in place, the
  replay sees the new values; replaced by another tensor, the signature
  changes and the function is captured anew.

The function must not read a device value back to the host.  A cache keeps
its `MAX_ENTRIES` most recently used graphs (each holds its own memory
pool).  CPU tensors never reach a cache: the solvers call it only on CUDA
tensors.
"""

import collections
import dataclasses
import functools
import types

import torch

MAX_ENTRIES = 16

_VALUES = (type(None), bool, int, float, str, torch.dtype, torch.device)


def _flatten(x, leaves):
    """``x``'s structure, every tensor in it appended to ``leaves`` and
    replaced by its index there."""
    if isinstance(x, torch.Tensor):
        leaves.append(x)
        return ("tensor", len(leaves) - 1)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return ("dataclass", type(x), tuple((f.name, _flatten(getattr(x, f.name), leaves))
                                            for f in dataclasses.fields(x)))
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return ("namedtuple", type(x), tuple(_flatten(v, leaves) for v in x))
    if isinstance(x, (tuple, list)):
        return ("sequence", type(x), tuple(_flatten(v, leaves) for v in x))
    if isinstance(x, dict):
        return ("dict", tuple((k, _flatten(v, leaves)) for k, v in x.items()))
    if not isinstance(x, _VALUES):
        raise TypeError(f"a graphed function's argument holds a {type(x).__name__}: "
                        "only tensors, containers of them and scalars are allowed")
    return ("value", type(x), x)


def _unflatten(spec, leaves):
    kind = spec[0]
    if kind == "tensor":
        return leaves[spec[1]]
    if kind == "dataclass":
        return spec[1](**{k: _unflatten(s, leaves) for k, s in spec[2]})
    if kind == "namedtuple":
        return spec[1](*(_unflatten(s, leaves) for s in spec[2]))
    if kind == "sequence":
        return spec[1](_unflatten(s, leaves) for s in spec[2])
    if kind == "dict":
        return {k: _unflatten(s, leaves) for k, s in spec[1]}
    return spec[2]


def closure_tensors(fn):
    """The tensors ``fn`` can reach outside its arguments: through a bound
    method's object, a partial's arguments, a function's closure cells and
    defaults, and the attributes and items of the objects found there
    (module globals and classes are not walked; a `GraphCache` is skipped)."""
    found, seen, todo = [], set(), [fn]
    while todo:
        x = todo.pop()
        if id(x) in seen or isinstance(x, (_VALUES, type, types.ModuleType, GraphCache)):
            continue
        seen.add(id(x))
        if isinstance(x, torch.Tensor):
            found.append(x)
        elif isinstance(x, types.MethodType):
            todo += [x.__self__, x.__func__]
        elif isinstance(x, types.FunctionType):
            todo += [c.cell_contents for c in (x.__closure__ or ())
                     if c.cell_contents is not None]
            todo += list(x.__defaults__ or ()) + list((x.__kwdefaults__ or {}).values())
        elif isinstance(x, functools.partial):
            todo += [x.func, *x.args, *x.keywords.values()]
        elif isinstance(x, (tuple, list, set, frozenset)):
            todo += list(x)
        elif isinstance(x, dict):
            todo += list(x.values())
        elif hasattr(x, "__dict__"):
            todo += list(vars(x).values())
    return found


def _meta(t):
    return (t.shape, t.dtype, t.stride(), t.device)


class GraphCache:
    """Captured CUDA graphs of functions of tensors, one per name and
    signature (module docstring)."""

    def __init__(self):
        self._entries = collections.OrderedDict()

    @staticmethod
    def signature(name, fn, args):
        """(key, spec, leaves): the cache key of ``fn(*args)`` under
        ``name``, the arguments' structure and their tensors."""
        leaves = []
        spec = _flatten(args, leaves)
        held = tuple((id(t), t.data_ptr()) + _meta(t) for t in closure_tensors(fn))
        return (name, spec, tuple(_meta(t) for t in leaves), held), spec, leaves

    def __call__(self, name, fn, *args):
        """``fn(*args)``, replayed from its graph (captured at the first
        call with this signature).  Returns fresh tensors."""
        key, spec, leaves = self.signature(name, fn, args)
        entry = self._entries.get(key)
        if entry is None:
            entry = self._capture(fn, spec, leaves)
            # the eager warm-up may create tensors the function keeps
            # (a lazily built constant): key the graph by what it read
            key = self.signature(name, fn, args)[0]
            self._entries[key] = entry
            while len(self._entries) > MAX_ENTRIES:
                self._entries.popitem(last=False)
        self._entries.move_to_end(key)
        graph, static_in, out_spec, static_out, _ = entry
        for s, t in zip(static_in, leaves):
            s.copy_(t)
        graph.replay()
        return _unflatten(out_spec, [t.clone() for t in static_out])

    @staticmethod
    def _capture(fn, spec, leaves):
        static_in = [t.clone() for t in leaves]
        args = _unflatten(spec, static_in)
        side = torch.cuda.Stream(device=static_in[0].device)
        side.wait_stream(torch.cuda.current_stream(static_in[0].device))
        with torch.cuda.stream(side):
            fn(*args)
        torch.cuda.current_stream(static_in[0].device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = fn(*args)
        static_out = []
        out_spec = _flatten(out, static_out)
        # the closure tensors stay alive while their graph may read them
        return graph, static_in, out_spec, static_out, closure_tensors(fn)
