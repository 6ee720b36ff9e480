"""The program's own spans and counters, recorded while a
``torch.profiler.profile`` records (whatever its activities) and never
otherwise.

Open a profile around a fit or a run of sweeps and read :func:`spans`
after it: one :class:`Span` a call of each instrumented boundary, in the
order the spans ended, with its name, its start and end, the span it ran
in (``parent``, an ``id``) and the sweep it belongs to (``sweep``, a
count of the sweeps started since the profile began, on the host; None
outside a sweep), and the counts raised inside it (``counts``).  The
boundaries:

* ``sweep``, every sweep call (``mcmc/sweeps.py::_attach``), with the
  deltas of the kernels' launch counters over it and its CUDA graph's
  ``graph_replays`` or ``graph_captures`` (``mcmc/graphs.py``: a sweep
  replayed from a graph counts its capture's launches and runs no
  block's Python, so it has no block spans);
* each block of :data:`BLOCKS` under its own name (the decorator
  :func:`traced` where the block is defined), ``replica_exchange``
  (``mcmc/tempering.py``), ``cc_class`` (one colour class's step of the
  chromatic scan, ``mcmc/latent.py::cc_colored_scan``), ``chunk`` (a
  runner's chunk of sweeps, ``mcmc/driver.py``);
* ``host_sync``, each read of device data by the host that the program
  makes inside a sweep or a run (:func:`host_sync`), which adds 1 to the
  count ``host_syncs``.

Spans are stamped with ``time.time_ns``, the Unix-epoch clock on which
the profiler stamps the device's activity (``KinetoEvent.start_ns()``),
so a span lines up with the device trace without an offset.  Nothing is
written into the profiler's trace (no ``record_function``, no NVTX range,
no kernel), no random number is drawn and nothing waits on the device: a
traced sweep is the untraced one, bit for bit.  With no profile open a
boundary costs one read of the profiler's flag and a call.

The recorder keeps at most :data:`CAP` spans (more are counted in
:func:`dropped`) and clears itself when a profile starts; functions
registered with :func:`on_profile` run when a profile starts or stops.
"""
import functools
import time
from typing import NamedTuple, Optional

import torch.autograd.profiler as _profiler

# the blocks of the sweeps, each a function that the sweep calls through
# mcmc.sweeps' namespace (where profile_blocks and the benchmark patch
# them by name) and a span under its own name
BLOCKS = (
    'sample_latent_positions', 'longitudinal_procrustes_rotation',
    'sample_intercept_undirected', 'sample_intercepts_directed',
    'sample_radii', 'sample_labels_block', 'sample_labels_block_lpcm',
    'sample_tables', 'sample_mbar', 'sample_dirichlet',
    'sample_cluster_means', 'sample_cluster_variances', 'sample_lambda',
    'sample_mean_variance_hyper', 'sample_sigma_scale_hyper',
    'sample_concentration_param', 'sample_alpha_kappa_rho',
    '_missing_dyad_step', '_cc_structures', '_hdp_weights_logp',
    '_lpcm_weights_logp', '_count_chain_loglik', '_mixture_common_logp',
    '_lsm_logp', '_finish_tuning')
CAP = 1 << 19
_clock = time.time_ns


class Span(NamedTuple):
    id: int
    name: str
    start_ns: int
    end_ns: int
    parent: Optional[int]
    sweep: Optional[int]
    counts: dict


class _Recorder:
    def __init__(self):
        self.clear()

    def clear(self):
        self.done, self.stack = [], []
        self.next_id = self.sweeps = self.dropped = 0
        self.sweep = None

    def open(self, name, root=False):
        if root:
            self.sweep, self.sweeps = self.sweeps, self.sweeps + 1
        parent = self.stack[-1][0] if self.stack else None
        rec = [self.next_id, name, _clock(), parent, self.sweep, {}]
        self.next_id += 1
        self.stack.append(rec)
        return rec

    def close(self, rec, root=False):
        end = _clock()
        if not self.stack or self.stack[-1] is not rec:
            return          # opened before the profile that cleared us
        self.stack.pop()
        if root:
            self.sweep = None
        if len(self.done) >= CAP:
            self.dropped += 1
            return
        ident, name, start, parent, sweep, counts = rec
        self.done.append(Span(ident, name, start, end, parent, sweep,
                              counts))

    def count(self, name, k):
        for rec in self.stack:
            rec[5][name] = rec[5].get(name, 0) + k


_REC = _Recorder()


def spans():
    """The spans recorded since the current or last profile started, in
    the order they ended (not cleared by reading)."""
    return list(_REC.done)


def dropped():
    """The spans not kept since the profile started (past :data:`CAP`)."""
    return _REC.dropped


class span:
    """``with span(name):`` records the block as a span ``name``."""
    __slots__ = ('name', 'rec')

    def __init__(self, name):
        self.name = name
        self.rec = None

    def __enter__(self):
        if _profiler._is_profiler_enabled:
            self.rec = _REC.open(self.name)
        return self

    def __exit__(self, *exc):
        if self.rec is not None:
            _REC.close(self.rec)
            self.rec = None


class host_sync(span):
    """``with host_sync():`` around a read of device data by the host: a
    span ``host_sync`` that adds 1 to the count ``host_syncs``."""
    __slots__ = ()

    def __init__(self):
        span.__init__(self, 'host_sync')

    def __enter__(self):
        span.__enter__(self)
        if self.rec is not None:
            _REC.count('host_syncs', 1)
        return self


def traced(fn, name=None, counters=None):
    """``fn`` recorded as a span under its own name (or ``name``).  With
    ``counters`` (a function returning a dict of running totals) the span
    is a sweep's root: it starts a new sweep id and carries the totals'
    nonzero deltas over the call as its counts."""
    label = name or fn.__name__
    root = counters is not None

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if not _profiler._is_profiler_enabled:
            return fn(*args, **kwargs)
        before = counters() if root else None
        rec = _REC.open(label, root)
        try:
            return fn(*args, **kwargs)
        finally:
            if root:
                for k, v in counters().items():
                    if v != before[k]:
                        rec[5][k] = rec[5].get(k, 0) + v - before[k]
            _REC.close(rec, root)
    return wrapper


_ON_PROFILE = []


def on_profile(fn):
    """Call ``fn()`` whenever a profile starts (before it records) or
    stops (``mcmc/graphs.py`` drops the sweeps' CUDA graphs there)."""
    _ON_PROFILE.append(fn)


def _hook_profiler():
    """Make a profile's start clear the recorder, and its start and stop
    run the :func:`on_profile` functions (once a process)."""
    start = _profiler._run_on_profiler_start
    stop = _profiler._run_on_profiler_stop
    if getattr(start, 'clears_spans', False):
        return

    def run_on_profiler_start():
        _REC.clear()
        for fn in _ON_PROFILE:
            fn()
        start()

    def run_on_profiler_stop():
        stop()
        for fn in _ON_PROFILE:
            fn()
    run_on_profiler_start.clears_spans = True
    _profiler._run_on_profiler_start = run_on_profiler_start
    _profiler._run_on_profiler_stop = run_on_profiler_stop


_hook_profiler()
