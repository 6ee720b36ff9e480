"""One run of a cell: set-up (network, state, sweep, burn-in), the measured
window, the per-layer readings of a traced window, and the check that
decides ``correct``.

Everything that belongs to one cell is data, or a module found by a name
in the data: ``BENCHMARK.json`` names the cell's configuration and
traffic; ``configs/<config>.json`` holds the model's sizes and constants,
the program's keyword arguments (``"program"``) and the network's
generator (``networks/<generator>.py``) and parameters;
``traffic/<traffic>.json`` the chains and the keyword arguments it adds
(``"program"``: the latent update, the start, the controls, and any other
argument of ``entry.build_state_and_sweep``); ``workloads/<cell>.json``
the burn-in, the chunk, the reference module that judges the run
(``reference/<name>.py``, its ``judge_capture``), the counting module
(``sweep_counts/<name>.py``) and the limits of the check; and
``metrics/<name>.py`` reads each per-layer metric.  The program under test
is ``dynetlsm_tpu_torch`` alone.
"""
import contextlib
import importlib
import json
import math
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

from .spans import Tracer, device_activity, read_trace, top_kernels

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'dynetlsm_tpu')
NOT_FINITE = 1e30
# the state's fields the check reads
FIELDS = ('it', 'X', 'intercept', 'step_X', 'step_int', 'z', 'mu',
          'sigma', 'lmbda', 'mean_var', 'b_scale', 'logp', 'weights', 'beta',
          'gamma', 'alpha_init', 'alpha', 'kappa', 'ctrl_out', 'radii')


def forbidden_modules():
    """The loaded modules whose whole top-level name is JAX's or the JAX
    package's."""
    return sorted({m.split('.')[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _json(path):
    with open(path) as f:
        return json.load(f)


def load_spec(workload, root=ROOT):
    """The cell ``workload``: its BENCHMARK.json entry, configuration,
    traffic and parameters, and the metrics it reports."""
    bench = _json(root / 'BENCHMARK.json')
    cells = {w['name']: w for w in bench['workloads']}
    if workload not in cells:
        raise SystemExit('no workload %r in BENCHMARK.json' % (workload,))
    cell = cells[workload]
    config_file = {c['name']: c['file'] for c in bench['configs']}[
        cell['config']]

    def reports(metric):
        return workload in metric.get('workloads', [workload])

    return {'name': workload, 'cell': cell,
            'config': _json(root / config_file),
            'traffic': _json(BENCH / 'traffic' / (cell['traffic'] + '.json')),
            'params': _json(BENCH / 'workloads' / (workload + '.json')),
            'end_to_end': [m for m in bench['end_to_end'] if reports(m)],
            'per_layer': [m for m in bench['per_layer'] if reports(m)]}


def quantity(name):
    """What a metric measures: its name up to the first dot.  A quantity
    reported by cells of two classes is two metrics, ``q`` and
    ``q.device_bound``, each with its own bound or end-to-end metric; the
    reader of ``q`` is ``metrics/q.py``."""
    return name.split('.')[0]


def derive_seeds(seed):
    """(network seed, program seed, check seed) of a run's ``--seed``,
    any whole number: the program's seed fits NumPy's RandomState."""
    s = np.random.SeedSequence(int(seed)).generate_state(3)
    return int(s[0]), int(s[1]) % (2 ** 31 - 16), int(s[2])


def program_kwargs(config, traffic):
    """The keyword arguments of ``entry.build_state_and_sweep`` (all but
    the network, the chains, the seed and the device): the configuration's
    ``"program"`` then the traffic's."""
    return dict(config.get('program', {}), **traffic.get('program', {}))


def check_config(cfg, config, traffic):
    """Raise unless the program's sweep configuration is the one the
    configuration and traffic files state (each of their keys that names
    a field of the program's ``SweepConfig``)."""
    kwargs = program_kwargs(config, traffic)
    want = dict(config['sweep'], n_components=kwargs.get('K'),
                **{k: v for k, v in kwargs.items() if k != 'K'})
    for key, value in want.items():
        if hasattr(cfg, key) and getattr(cfg, key) != value:
            raise RuntimeError('the program runs %s=%r, the configuration '
                               'states %r' % (key, getattr(cfg, key), value))


class Recorder:
    """The sweep handed to the runner: it keeps the state entering and
    leaving the latest sweep and the generator's state before it (the
    check's inputs), and marks each sweep's end, with a CUDA event on the
    card (no synchronisation) or the host clock elsewhere."""

    def __init__(self, sweep, device):
        self.sweep = sweep
        self.cuda = device.type == 'cuda'
        self.marks = []
        self.spans = None
        self.before = self.after = self.gen_state = self.gen_prev = None

    def __call__(self, state, gen):
        self.gen_prev = self.gen_state
        self.before, self.gen_state = state, gen.get_state()
        t0 = time.perf_counter_ns()
        out = self.sweep(state, gen)
        if self.spans is not None:
            self.spans.append(('sweep', t0, time.perf_counter_ns()))
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())
        self.after = out
        return out


def power_limit_w(device):
    """The card's power limit in watts (``nvidia-smi``), printed beside the
    shares of the float32 peak, which assume 700 W; None off the card or
    when it cannot be read."""
    if device.type != 'cuda':
        return None
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=power.limit',
             '--format=csv,noheader,nounits', '-i', str(device.index or 0)],
            capture_output=True, text=True, timeout=30)
        return float(out.stdout.strip())
    except (OSError, ValueError, subprocess.SubprocessError):
        return None


def _sync(device):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def build(spec, seed, device):
    """(the network on the host, {'edges': its nonzero entries}, state,
    sweep, generator) of a run."""
    from dynetlsm_tpu_torch.entry import build_state_and_sweep
    config, traffic = spec['config'], spec['traffic']
    net_seed, prog_seed, _ = derive_seeds(seed)
    params = dict(config['network'])
    generator = importlib.import_module(
        'port_bench.networks.' + params.pop('generator'))
    Y = generator.draw(config['T'], config['n'], net_seed, device, **params)
    net = {'edges': int(torch.count_nonzero(Y))}
    Y_host = Y.cpu().numpy()
    del Y
    if device.type == 'cuda':
        # the peak is the program's: the generator's tensors are freed
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    state, sweep, gen = build_state_and_sweep(
        Y_host, traffic['chains'], seed=prog_seed, device=device,
        **program_kwargs(config, traffic))
    check_config(sweep.cfg, config, traffic)
    return Y_host, net, state, sweep, gen


def _fields(state):
    return {k: getattr(state, k) for k in FIELDS
            if getattr(state, k, None) is not None}


def _sweep_intervals_ms(recorder, start):
    """Each window sweep's time, from the previous sweep's end (the
    window's start for the first)."""
    marks = recorder.marks
    if recorder.cuda:
        out, prev = [], start
        for ev in marks:
            out.append(prev.elapsed_time(ev))
            prev = ev
        return out
    return list(1e3 * np.diff([start] + marks))


def measure(spec, seed, seconds, trace, device, t_start):
    """Set-up, burn-in and the window of one run.  Returns (the result's
    keys but ``correct``, ``failed`` and ``check``; the check's inputs:
    the network on the host, the fields of the state entering and leaving
    the last sweep, the generator's states before the previous sweep,
    before the last and after it, and the run's seeds)."""
    from dynetlsm_tpu_torch.mcmc.driver import make_scan_runner
    params, traffic, config = spec['params'], spec['traffic'], spec['config']
    C, chunk = traffic['chains'], params['chunk']
    Y_host, net, state, sweep, gen = build(spec, seed, device)
    recorder = Recorder(sweep, device)
    runner = make_scan_runner(recorder, lambda s: {'logp': s.logp},
                              chunk=chunk)
    # set-up: the burn-in (at least one chunk, which warms every shape the
    # window uses), in the window's chunks
    for _ in range(max(1, math.ceil(params['burn_in'] / chunk))):
        state, bufs = runner(state, gen, chunk)
        bufs['logp'].cpu()
    tracer = Tracer(device) if trace else None
    prof = None
    if trace:
        recorder.spans = tracer.spans
        if device.type == 'cuda':
            from torch.profiler import ProfilerActivity, profile
            prof = profile(activities=[ProfilerActivity.CUDA])
            prof.__enter__()
    _sync(device)
    recorder.marks = []
    start = torch.cuda.Event(enable_timing=True) if recorder.cuda else None
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    logps = []
    with (tracer.blocks() if trace else contextlib.nullcontext()):
        if trace:
            tracer.window_launch_ns = time.perf_counter_ns()
            tracer.marker()
        if start is not None:
            start.record()
        else:
            start = t0
        while True:
            state, bufs = runner(state, gen, chunk)
            c0 = time.perf_counter_ns()
            logps.append(bufs['logp'].cpu())
            if trace:
                tracer.spans.append(('chunk_copy', c0,
                                     time.perf_counter_ns()))
            t1 = time.perf_counter()
            if t1 - t0 >= seconds:
                break
        if trace:
            tracer.marker()
    _sync(device)
    if prof is not None:
        prof.__exit__(None, None, None)
    gen_after = gen.get_state()
    window_s = t1 - t0
    N = sum(c.shape[0] for c in logps)              # sweeps a chain
    values = {'setup_s': setup_s,
              'chain_sweeps_per_s': C * N / window_s}
    # the 95th percentile of every window sweep's time (numpy's linear
    # interpolation between order statistics)
    values['sweep_p95_ms'] = float(np.percentile(
        _sweep_intervals_ms(recorder, start), 95))
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == 'cuda' else 0)
    device_info = {'platform': 'gpu', 'kind': (
        torch.cuda.get_device_name(device) if device.type == 'cuda'
        else 'cpu'), 'count': 1, 'memory_peak_bytes': int(peak),
        'power_limit_w': power_limit_w(device)}
    result = {'attempted': C * N}
    if trace:
        readings = layer_context(spec, net, tracer, prof, N, window_s)
        device_info['busy_s'] = readings.get('busy_s')
        device_info['window_s'] = readings.get('device_window_s')
        metrics = {}
        for m in spec['per_layer']:
            reader = importlib.import_module(
                'port_bench.metrics.' + quantity(m['name']))
            v = reader.read(readings)
            if v is not None:
                metrics[m['name']] = {'value': v, 'unit': m['unit']}
        result['breakdown'] = readings.get('breakdown')
    else:
        metrics = {m['name']: {'value': values[quantity(m['name'])],
                               'unit': m['unit']}
                   for m in spec['end_to_end']}
    result.update(metrics=metrics, device=device_info)
    if result.get('breakdown') is None:
        result.pop('breakdown', None)
    capture = {'Y': Y_host, 'before': _fields(recorder.before),
               'after': _fields(recorder.after),
               'gen_prev': recorder.gen_prev,
               'gen_state': recorder.gen_state, 'gen_after': gen_after,
               'seeds': derive_seeds(seed)}
    return result, capture


def run(spec, seed, seconds, trace, device, t_start):
    """One run; returns the result dict (the last line's keys) and the
    lines for standard error."""
    result, capture = measure(spec, seed, seconds, trace, device, t_start)
    found = forbidden_modules()
    if found:
        raise SystemExit('the run loaded %s' % ', '.join(found))
    # the check runs once the program's sweep and state are freed
    if device.type == 'cuda':
        torch.cuda.empty_cache()
    numbers, failed, _ = check_run(spec, capture, device)
    result.update(correct=failed == 0, failed=failed)
    result['check'] = numbers
    lines = ['%s %r limit %r' % (k, v['value'], v['limit'])
             for k, v in numbers.items()]
    return result, lines


def reference(spec):
    """The module that judges the cell's runs (``reference/<name>.py``,
    named by ``workloads/<cell>.json``)."""
    return importlib.import_module(
        'port_bench.reference.' + spec['params']['reference'])


def summarize(numbers, limits, chains):
    """({name: {'value': the widest reading, 'limit': limit}}, the number
    of chains over some limit) of a reference's numbers: per chain (C,),
    or one for the run, which fails every chain when over its limit."""
    out, bad = {}, torch.zeros(chains, dtype=torch.bool)
    for name, limit in limits.items():
        # a number that is not finite (a log joint of -inf) fails as the
        # largest finite reading, which JSON can carry
        v = torch.nan_to_num(torch.as_tensor(numbers[name]).cpu(),
                             nan=NOT_FINITE, posinf=NOT_FINITE,
                             neginf=NOT_FINITE)
        out[name] = {'value': float(torch.max(v)), 'limit': limit}
        bad |= (v > limit).expand(chains)
    return out, int(bad.sum())


def check_run(spec, capture, device, control=False, fault=None):
    """(the compared numbers with their limits, the chains over a limit,
    each mixture block's score) of a run's last sweep."""
    numbers = reference(spec).judge_capture(
        spec, capture, capture['seeds'], device, control=control,
        fault=fault)
    out, failed = summarize(numbers, spec['params']['check']['limits'],
                            capture['before']['X'].shape[0])
    return out, failed, numbers.get('blocks', {})


def layer_context(spec, net, tracer, prof, sweeps, window_s):
    """What the per-layer readers read (``metrics/<name>.py``): host spans
    by name, the device trace's kernels, latent intervals, busy and window
    seconds, the operation counts of the cell (``sweep_counts/<name>.py``,
    named by ``workloads/<cell>.json``), and the breakdown."""
    C = spec['traffic']['chains']
    spans = {}
    for name, s, e in tracer.spans:
        spans.setdefault(name, []).append((s, e))
    ctx = {'sweeps': sweeps, 'chains': C, 'window_s': window_s,
           'spans': spans,
           'latent_update': spec['traffic']['program'].get('latent_update',
                                                           'exact')}
    ctx.update(importlib.import_module(
        'port_bench.sweep_counts.' + spec['params']['counts']).count(
            spec, net))
    if prof is None:
        return ctx
    trace = read_trace(device_activity(prof), tracer)
    if trace is None:
        return ctx
    ctx.update(kernels=trace['kernels'], latent=trace['latent'],
               busy_s=trace['busy_s'], device_window_s=trace['window_s'])
    ctx['breakdown'] = {'device_ops': top_kernels(trace['kernels']),
                        'idle_gaps': trace['idle_gaps']}
    return ctx
