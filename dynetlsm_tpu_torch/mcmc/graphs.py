"""One sweep replayed from a CUDA graph (``mcmc/sweeps.py::_attach``).

A north-star sweep issues about 1,400 small kernels, and their eager
dispatch on the host, not their device time, sets its pace (PERF.md §5).
Where the sweep allows it (:func:`engages`: on a CUDA device, on one card,
with no read of device data by the host inside it) the sweep is captured
once into a ``torch.cuda.CUDAGraph`` and replayed on every later call:

* per (generator, the state's fields: which are set, their shapes, dtypes
  and devices) the first call runs eager (kernel attributes, the cuBLAS
  workspace, the kernels' scratch and cached layouts are made there), the
  second captures the sweep on a side stream with the generator
  registered with the graph (``register_generator_state``), then replays
  it; a call with another generator or other shapes captures again; at
  most :data:`MAX_GRAPHS` graphs are kept, the least recently used
  dropped;
* the incoming state is copied into the graph's static inputs and the
  returned state holds copies of its static outputs: no state a sweep
  returned is ever written by a later one, so a caller may keep or rerun
  any state;
* the kernels' launch counters (``sweeps.launch_counts``) advance at every
  replay by the deltas recorded over the capture, and :func:`counts`
  holds the graphs' own counts, ``graph_replays`` (calls that replayed a
  graph captured before) and ``graph_captures``;
* a profile's start and stop drop every graph (``tracing.on_profile``), so
  the next sweep captures anew: a trace sees the kernels of a graph made
  while it records, with whatever the sweep's blocks were wrapped in then.

The sweeps draw every random number from the explicit generator and make
every decision on the device (fixed-round samplers, masks, ``torch.where``
on the sweep counter), so nothing is decided on the host from a tensor's
value and baked into the graph; a read of device data by the host would
fail the capture.  A replayed sweep equals the eager sweep bit for bit,
the generator's state included (``chip_smoke.py``'s graph phase).
"""
import collections
import dataclasses
import weakref

import torch

from .. import tracing

MAX_GRAPHS = 4
_COUNTS = {'graph_replays': 0, 'graph_captures': 0}
# every sweep's graphs, dropped together when a profile starts or stops
_CACHES = weakref.WeakSet()
# a side stream a card to capture on
_STREAMS = {}


def engages(device, node_shards, host_reads):
    """Whether a sweep is replayed from a CUDA graph: its state lives on a
    CUDA device, its network on that one card (``node_shards`` 1), and no
    read of device data by the host happens inside it (``host_reads``:
    the case-control sweeps read the sweep count to redraw their
    controls, the LSM's Procrustes SVD copies its matrices to the
    host)."""
    return (torch.device(device).type == 'cuda' and node_shards == 1
            and not host_reads)


def counts():
    """The running counts ``graph_replays`` and ``graph_captures``."""
    return dict(_COUNTS)


def drop_all():
    """Drop every sweep's graphs; the next call of each captures anew."""
    for cache in list(_CACHES):
        cache.graphs.clear()


tracing.on_profile(drop_all)


def layout(state, gen):
    """The key of a state's graph: the generator, the state's class and,
    per field, its name and (shape, dtype, device), or None when unset."""
    key = [gen, type(state)]
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        key.append((f.name, None) if v is None else
                   (f.name, tuple(v.shape), v.dtype, v.device))
    return tuple(key)


def _tensor_fields(state):
    return [f.name for f in dataclasses.fields(state)
            if getattr(state, f.name) is not None]


def _stream(device):
    if device not in _STREAMS:
        _STREAMS[device] = torch.cuda.Stream(device)
    return _STREAMS[device]


class Captured:
    """One captured sweep: the graph (``replay()``), its static inputs
    (``inputs``, the fields ``names`` of the state), the state it returns
    (``out``, in the graph's memory; its set fields ``out_names``) and the
    launch counters' deltas over one sweep (``deltas``)."""
    __slots__ = ('graph', 'names', 'inputs', 'out', 'out_names', 'deltas')

    def __init__(self, graph, names, inputs, out, deltas):
        self.graph = graph
        self.names = names
        self.inputs = inputs
        self.out = out
        self.out_names = _tensor_fields(out)
        self.deltas = deltas


class GraphCache:
    """The graphs of one sweep.  ``eager(state, gen)`` is the sweep;
    ``launch_counts()`` reads the kernels' launch counters and
    ``add_launch_counts(deltas)`` advances them."""

    def __init__(self, eager, launch_counts, add_launch_counts):
        self.eager = eager
        self.launch_counts = launch_counts
        self.add_launch_counts = add_launch_counts
        self.graphs = collections.OrderedDict()
        self.warm = set()
        _CACHES.add(self)

    def __call__(self, state, gen):
        key = layout(state, gen)
        entry = self.graphs.get(key)
        if entry is None:
            if key not in self.warm:
                self.warm.add(key)
                return self.eager(state, gen)
            entry = self.capture(key, state, gen)
            self.replay(entry, state)
        else:
            self.graphs.move_to_end(key)
            self.replay(entry, state)
            self.add_launch_counts(entry.deltas)
            _COUNTS['graph_replays'] += 1
        outs = [getattr(entry.out, n) for n in entry.out_names]
        copies = [torch.empty_like(v) for v in outs]
        torch._foreach_copy_(copies, outs)
        return entry.out.replace(**dict(zip(entry.out_names, copies)))

    @staticmethod
    def replay(entry, state):
        """Copy ``state`` into the graph's inputs and replay it (on the
        current stream of the card it was captured on)."""
        torch._foreach_copy_(entry.inputs,
                             [getattr(state, n) for n in entry.names])
        entry.graph.replay()

    def capture(self, key, state, gen):
        """Capture the sweep from static copies of ``state`` (counting its
        launches once, as the eager sweep does); keep the graph."""
        device = state.X.device
        names = _tensor_fields(state)
        inputs = [getattr(state, n).clone() for n in names]
        static = state.replace(**dict(zip(names, inputs)))
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(gen)
        before = self.launch_counts()
        with torch.cuda.device(device):
            with torch.cuda.graph(graph, stream=_stream(device)):
                out = self.eager(static, gen)
        after = self.launch_counts()
        deltas = {k: after[k] - before[k] for k in after
                  if after[k] != before[k]}
        entry = Captured(graph, names, inputs, out, deltas)
        self.graphs[key] = entry
        while len(self.graphs) > MAX_GRAPHS:
            self.graphs.popitem(last=False)
        _COUNTS['graph_captures'] += 1
        return entry
