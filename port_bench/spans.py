"""The traced run's instruments, put around calls into the program by the
benchmark's own files (the program has no spans of its own yet).

* Host spans: each block function the sweep calls through
  ``dynetlsm_tpu_torch.mcmc.sweeps``' namespace (the list of
  ``dynetlsm_tpu_torch/profile_blocks.py``) is wrapped with a host clock,
  without a synchronisation, while the traced window is open.
* Device markers: a one-cycle ``torch.cuda._sleep`` kernel before and
  after each latent update, and at the window's two ends, so the profiler's
  trace of the device says which kernels belong to the latent update and
  where the window begins and ends on the device's clock.
* The profiler records the device's activity alone (kernels, copies,
  fills): tracing the host's operations too slows a launch-bound sweep
  many times over.
"""
import contextlib
import time

import torch

# the block functions of mcmc.sweeps (profile_blocks.BLOCKS); none calls
# another through that namespace, so no time is counted twice
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
LATENT = 'sample_latent_positions'
MARKER = 'spin_kernel'


class Tracer:
    """Host spans (name, start ns, end ns) on ``time.perf_counter_ns`` and
    device markers on ``device``."""

    def __init__(self, device):
        self.device = device
        self.spans = []
        self.window_launch_ns = None

    def span(self, name, t0):
        self.spans.append((name, t0, time.perf_counter_ns()))

    def marker(self):
        if self.device.type == 'cuda':
            torch.cuda._sleep(1)

    @contextlib.contextmanager
    def blocks(self):
        """Wrap the sweep's blocks while the context is open."""
        from dynetlsm_tpu_torch.mcmc import sweeps
        saved = {name: getattr(sweeps, name) for name in BLOCKS
                 if hasattr(sweeps, name)}

        def wrap(name, fn):
            def traced(*args, **kwargs):
                if name == LATENT:
                    self.marker()
                t0 = time.perf_counter_ns()
                out = fn(*args, **kwargs)
                self.span(name, t0)
                if name == LATENT:
                    self.marker()
                return out
            return traced

        for name, fn in saved.items():
            setattr(sweeps, name, wrap(name, fn))
        try:
            yield self
        finally:
            for name, fn in saved.items():
                setattr(sweeps, name, fn)


def device_activity(prof):
    """(name, start ns, end ns) of every device activity in a profiler's
    trace, in start order."""
    from torch.autograd import DeviceType
    out = []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == DeviceType.CUDA:
            out.append((ev.name(), ev.start_ns(), ev.end_ns()))
    out.sort(key=lambda e: e[1])
    return out


def union(intervals):
    """Merged (start, end) intervals of a list of intervals."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return [tuple(m) for m in merged]


def read_trace(activity, tracer):
    """What the per-layer readers take from a traced window: the device's
    window (between the two window markers), its kernels, the latent
    updates' intervals (between their marker pairs), the busy seconds and
    the idle gaps, each gap named by the host span it overlaps most.
    None when the trace holds no markers."""
    marks = [e for e in activity if MARKER in e[0]]
    if len(marks) < 2:
        return None
    w0, w1 = marks[0][2], marks[-1][1]
    inner = marks[1:-1]
    latent = [(inner[k][2], inner[k + 1][1])
              for k in range(0, len(inner) - 1, 2)]
    kernels = [e for e in activity if MARKER not in e[0]
               and e[1] >= w0 and e[2] <= w1]
    busy = union([(s, e) for _, s, e in kernels])
    gaps, prev = [], w0
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if w1 > prev:
        gaps.append((prev, w1))
    offset = marks[0][1] - tracer.window_launch_ns
    named = [[name_gap(tracer.spans, g0 - offset, g1 - offset),
              (g1 - g0) / 1e9]
             for g0, g1 in sorted(gaps, key=lambda g: g[0] - g[1])[:10]]
    return {'window_ns': (w0, w1), 'kernels': kernels, 'latent': latent,
            'busy_s': sum(e - s for s, e in busy) / 1e9,
            'window_s': (w1 - w0) / 1e9, 'idle_gaps': named}


def name_gap(spans, h0, h1):
    """What the host was doing during [h0, h1] (host ns): the block it
    overlaps most; else 'sweep_other' (in a sweep, outside every block),
    'chunk_copy' (waiting for a chunk's traces) or 'driver'."""
    overlap = {}
    for name, s, e in spans:
        o = min(e, h1) - max(s, h0)
        if o > 0:
            overlap[name] = overlap.get(name, 0) + o
    blocks = {k: v for k, v in overlap.items() if k in BLOCKS}
    if blocks:
        return max(blocks, key=blocks.get)
    if 'sweep' in overlap:
        return 'sweep_other'
    return 'chunk_copy' if 'chunk_copy' in overlap else 'driver'


def top_kernels(kernels, top=10):
    """[[name, seconds]] of the ``top`` kernels by total device time."""
    totals = {}
    for name, s, e in kernels:
        totals[name] = totals.get(name, 0) + (e - s)
    ranked = sorted(totals.items(), key=lambda kv: -kv[1])[:top]
    return [[name[:160], ns / 1e9] for name, ns in ranked]
