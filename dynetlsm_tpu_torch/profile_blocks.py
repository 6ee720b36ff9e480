"""Where the sweeps' time goes, block by block, on one GPU.

    python3 -m dynetlsm_tpu_torch.profile_blocks [--sweeps 10] [--only cc]

For the HDP-LPCM slices that ``chip_smoke.py`` drives (the north star and
Sampson, undirected and directed), its LSM and LPCM slices at the north
star (undirected and directed), its tempered HDP-LPCM north star (8
ladders x 4 rungs, ``n_temps=4``) and its missing-dyad slices (the north
star with 10% of the dyads coded -1: the HDP-LPCM undirected and directed
and the LSM) and its case-control slices (bench.py's ``cc_*`` rows: the
HDP-LPCM at K=25 with n_control controls a node, directed and undirected
at the north star, 64 chains, m=145; directed at n=2048, 128 chains,
m=145; directed at n=20,000 from ``datasets.northstar_edge_lists`` with no
dense network, 8 chains, m=64), all built by
``entry.build_state_and_sweep``, it prints one JSON line per slice
(``--only`` keeps the slices whose name contains it) with:

* ``sweep_ms``: ms per sweep with no instrumentation;
* ``sweep_synced_ms`` and ``blocks_ms``: ms per sweep when every block
  function the sweep calls from ``mcmc.sweeps`` is wrapped with a device
  synchronisation and a host clock, the sweep run eager (``other`` is the
  rest of the sweep);
  a tempered step also times its replica exchange (``replica_exchange``,
  the swap's log-likelihood launch included) as one block, and a sweep
  with missing dyads their resample and the log-likelihood on the new
  network (``_missing_dyad_step``) as one block; under case-control
  ``sample_latent_positions`` is the chromatic scan, ``_cc_structures``
  the control refresh, edge lists and validity masks, and the coefficient
  blocks the case-control estimator's evaluations;
* ``kernels_ms``: device time per sweep of the largest kernels, from the
  ``torch.profiler`` trace of the same number of sweeps, and
  ``device_busy``: the union of all kernel intervals over the span from
  the first kernel's start to the last one's end, and
  ``launches_per_sweep``, the kernels (not copies or fills) the device
  ran per sweep.  The trace records the device's activity only; it still
  slows the host's dispatch a little, so the busy share is a lower bound.

Every slice is timed before any is traced: timed after three traced
slices, directed Sampson read 23.5 ms/sweep on an H100 where
``chip_smoke.py`` read 17.1 ms; timed before any tracing, it read 18.6
ms where ``chip_smoke.py`` read 16.0 ms.
"""
import argparse
import contextlib
import json
import time

import torch

from .mcmc import sweeps as _sweeps
from .mcmc import tempering as _tempering
# the functions the sweep calls through mcmc.sweeps' namespace; none of
# them calls another one of them through it, so no time is counted twice
from .tracing import BLOCKS

# the swap of a parallel-tempering step, called through mcmc.tempering's
# namespace after the sweep returns
SWAP_BLOCKS = ('replica_exchange',)


def _sync(device):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def timed_blocks(device):
    """Wrap each of ``BLOCKS`` in ``mcmc.sweeps`` and ``SWAP_BLOCKS`` in
    ``mcmc.tempering`` with a synchronisation and a host clock while the
    context is open.  Yields a dict that accumulates seconds by block
    name."""
    totals = {}
    saved = {(module, name): getattr(module, name)
             for module, names in ((_sweeps, BLOCKS),
                                   (_tempering, SWAP_BLOCKS))
             for name in names}

    def wrap(name, fn):
        def timed(*args, **kwargs):
            _sync(device)
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            _sync(device)
            totals[name] = totals.get(name, 0.0) + time.perf_counter() - t0
            return out
        return timed

    for (module, name), fn in saved.items():
        setattr(module, name, wrap(name, fn))
    try:
        yield totals
    finally:
        for (module, name), fn in saved.items():
            setattr(module, name, fn)


def _run(sweep, state, gen, n):
    device = state.X.device
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(n):
        state = sweep(state, gen)
    _sync(device)
    return state, time.perf_counter() - t0


def _union_us(intervals):
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def device_times(sweep, state, gen, n, top=8):
    """Kernel device time per sweep (ms) of the ``top`` largest kernels,
    and the device's busy share, over ``n`` profiled sweeps."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    # the device's activity alone: tracing the host's ops too slowed a
    # 7,900-launch sweep from 0.36 s to 7.6 s on an H100, with the same
    # kernels
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _run(sweep, state, gen, n)
    per_name, intervals, kernels = {}, [], 0
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        s, e = ev.time_range.start, ev.time_range.end
        intervals.append((s, e))
        per_name[ev.name] = per_name.get(ev.name, 0) + (e - s)
        kernels += not ev.name.startswith(('Memcpy', 'Memset'))
    if not intervals:
        return {'kernels_ms': [], 'device_busy': None,
                'launches_per_sweep': 0}
    span = max(e for _, e in intervals) - min(s for s, _ in intervals)
    largest = sorted(per_name.items(), key=lambda kv: -kv[1])[:top]
    # a list, not a dict: templated kernels share long name prefixes
    return {'kernels_ms': [[k[:100], v / 1e3 / n] for k, v in largest],
            'kernel_ms_total': sum(per_name.values()) / 1e3 / n,
            'device_busy': _union_us(intervals) / span,
            'launches_per_sweep': kernels / n}


def profile_slice(sweep, state, gen, sweeps=10, warm=2):
    """Time ``sweeps`` sweeps plain, then with the blocks timed, the
    sweep run eager (``sweep.eager``: a sweep replayed from a CUDA graph
    runs no block's Python).  Returns (a dict of ms per sweep, the state
    after them)."""
    state, _ = _run(sweep, state, gen, warm)
    state, plain = _run(sweep, state, gen, sweeps)
    with timed_blocks(state.X.device) as totals:
        state, synced = _run(getattr(sweep, 'eager', sweep), state, gen,
                             sweeps)
    blocks = {k: 1e3 * v / sweeps for k, v in totals.items()}
    blocks['other'] = 1e3 * synced / sweeps - sum(blocks.values())
    return {'sweep_ms': 1e3 * plain / sweeps,
            'sweep_synced_ms': 1e3 * synced / sweeps,
            'blocks_ms': blocks}, state


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--sweeps', type=int, default=10)
    parser.add_argument('--only', default='',
                        help='keep the slices whose name contains this')
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print('profile_blocks: no CUDA device')
        return 1
    from .datasets import (
        load_dynamic_monks, northstar_edge_lists, northstar_network,
        with_missing_dyads)
    from .entry import build_state_and_sweep
    dev = torch.device('cuda', 0)
    ns, ns_dir = northstar_network(), northstar_network(directed=True)
    ns_miss = with_missing_dyads(ns, 0.1, seed=5)
    ns_dir_miss = with_missing_dyads(ns_dir, 0.1, seed=5, directed=True)
    def cc(directed, n, m, C):
        """bench.py's case-control row at n: (Y, K, chains, directed,
        model, n_temps, the case-control keywords)."""
        if n > 2048:
            lists, shape = northstar_edge_lists(n=n, directed=directed)
            kw = dict(n_control=m, edge_lists=lists, shape=shape)
            return None, 25, C, directed, 'hdp', None, kw
        return (northstar_network(n=n, directed=directed), 25, C, directed,
                'hdp', None, dict(n_control=m))
    # (name, Y, K, chains, directed, model, n_temps[, keywords])
    slices = [('northstar', ns, 25, 32, False, 'hdp', None),
              ('northstar tempered', ns, 25, 32, False, 'hdp', 4),
              ('sampson', load_dynamic_monks(), 10, 512, False, 'hdp', None),
              ('northstar directed', ns_dir, 25, 32, True, 'hdp', None),
              ('sampson directed', load_dynamic_monks(is_directed=True), 10,
               512, True, 'hdp', None),
              ('lsm northstar', ns, None, 32, False, 'lsm', None),
              ('lsm northstar directed', ns_dir, None, 32, True, 'lsm', None),
              ('lpcm northstar', ns, 8, 32, False, 'lpcm', None),
              ('lpcm northstar directed', ns_dir, 8, 32, True, 'lpcm', None),
              ('northstar missing', ns_miss, 25, 32, False, 'hdp', None),
              ('northstar directed missing', ns_dir_miss, 25, 32, True,
               'hdp', None),
              ('lsm northstar missing', ns_miss, None, 32, False, 'lsm',
               None)]
    cc_rows = [('cc directed northstar', True, 500, 145, 64),
               ('cc undirected northstar', False, 500, 145, 64),
               ('cc directed n2048', True, 2048, 145, 128),
               ('cc directed n20000', True, 20000, 64, 8)]
    runs = []
    for name, *row in slices + [(name,) + (directed, n, m, C)
                                for name, directed, n, m, C in cc_rows]:
        if args.only not in name:
            continue
        if len(row) == 4:
            row = cc(*row)
        Y, K, C, directed, model, n_temps, *kw = row
        state, sweep, gen = build_state_and_sweep(
            Y, C, K=K, device=dev, is_directed=directed, model=model,
            n_temps=n_temps, **(kw[0] if kw else {}))
        out, state = profile_slice(sweep, state, gen, sweeps=args.sweeps)
        runs.append((name, C, out, sweep, state, gen))
    for name, C, out, sweep, state, gen in runs:
        out.update(device_times(sweep, state, gen, args.sweeps))
        print(json.dumps({'slice': name, 'chains': C, **out}), flush=True)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
