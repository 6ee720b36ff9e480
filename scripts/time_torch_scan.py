"""Time the node-scan kernel of one checkout.

    python3 scripts/time_torch_scan.py [--root DIR] [--repeats 50]
                                       [--cluster 1,2,4] [--chains 32]
                                       [--n 500] [--mode split]
    python3 scripts/time_torch_scan.py --slices [--root DIR] [--repeats 5]
                                       [--cluster 2,4,8,16]

Imports ``dynetlsm_tpu_torch`` from the checkout at DIR (default: the one
that holds this script), builds its kernels, and prints one JSON line per
chain count (``--chains``, comma-separated): the card and its power
limit, DIR, and the median CUDA-event milliseconds of one
``node_scan_cuda`` launch at T=10, n=500 (``--n``), d=2 and that many
chains (numpy-seeded inputs, as ``chip_smoke.py`` makes them; past
n = 2048 the network is drawn on the card from a seeded generator, at the
north star's expected degree) in each mode the checkout's wrapper takes:
the mixture prior, undirected and directed, and, where the wrapper takes
``mixture=``, the random-walk prior; where it takes ``temper=``, each of
those modes again with per-chain inverse temperatures (4-rung ladders from
1 to 0.2 tiled over the chains, ``, tempered``), on the same inputs.
Where the checkout pads the adjacency's rows for the kernel
(``pad_partners``), the padded adjacency is passed, as its sweeps pass
it.  Where the wrapper takes ``cluster=``, ``--cluster`` also times every
mode at each listed cluster size (``, cluster B``; a size the checkout
refuses is null); the plain keys are the launch rule's.  ``--mode``
('resident' or 'split') forces the wrapper's mode.  ``--slices`` times
the four slices past the resident mode's n = 2048 (chip_smoke.py's
LARGE_SLICES: the HDP-LPCM's mixture prior at n = 8,192, 16 chains,
undirected and directed; the LSM's random-walk prior at n = 4,096, 32
chains, and n = 16,384, 4 chains), one line each, at the launch rule and
at each ``--cluster`` in the split-field mode.  To compare two checkouts
on one card, run it on both in turns (A, B, B, A) in one command.
"""
import argparse
import inspect
import json
import os
import subprocess
import sys

import numpy as np

T, N, D, K = 10, 500, 2, 25
# (n, chains, mode) of the slices past n = 2048
SLICES = [(8192, 16, 'undirected, mixture prior'),
          (8192, 16, 'directed, mixture prior'),
          (4096, 32, 'undirected, random-walk prior'),
          (16384, 4, 'undirected, random-walk prior')]


def _network(torch, n, directed, rng):
    """(T, n, n) uint8: numpy's draw at the north star's density, or past
    n = 2048 a draw on the card (a generator seeded from ``rng``) at its
    expected degree (0.05 x 500), one time at a time."""
    dev = torch.device('cuda', 0)
    if n <= 2048:
        Y = rng.binomial(1, 0.05, (T, n, n))
        if directed:
            Y[:, np.arange(n), np.arange(n)] = 0
        else:
            Y = np.triu(Y, 1)
            Y = Y + Y.transpose(0, 2, 1)
        return torch.as_tensor(Y.astype(np.uint8), device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(rng.randint(2 ** 31)))
    Y = torch.empty((T, n, n), dtype=torch.uint8, device=dev)
    for t in range(T):
        y = (torch.rand((n, n), generator=gen, device=dev)
             < 0.05 * 500 / n).to(torch.uint8)
        y = y.triu(1) if not directed else y.fill_diagonal_(0)
        Y[t] = y if directed else y + y.T
    return Y


def _inputs(torch, node_scan, C, directed, seed=1, n=N):
    rng = np.random.RandomState(seed)
    Y = _network(torch, n, directed, rng)
    dev = torch.device('cuda', 0)

    def f32(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    if directed:
        Y = node_scan.pack_directed(Y)
    if hasattr(node_scan, 'pad_partners'):
        Y = node_scan.pad_partners(Y)
    b = 1.0 + 0.1 * rng.randn(C, 2 if directed else 1)
    args = [Y,
            f32(rng.randn(C, T, n, D)), f32(b if directed else b[:, 0]),
            f32(np.full((C, T, n), 0.1)), f32(rng.randn(C, 2, n, T, D)),
            f32(np.log(rng.rand(C, 2, n, T)))]
    z = torch.as_tensor(rng.randint(0, K, (C, T, n)), device=dev)
    mu_z, sig_z = node_scan.site_cluster_params(
        f32(rng.randn(C, K, D)), f32(rng.rand(C, K) + 0.3), z)
    radii = f32(0.5 + rng.rand(C, n)) if directed else None
    return args, (mu_z, sig_z, f32(np.full(C, 0.9))), radii


def _median_ms(torch, fn, repeats):
    fn()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _time_modes(torch, node_scan, C, has_rw, has_temper, clusters,
                repeats, n=N, mode=None, only=None):
    """Median ms of each mode (and each cluster size) at C chains."""
    ladder = torch.as_tensor(np.resize(np.geomspace(1.0, 0.2, 4), C),
                             dtype=torch.float32, device='cuda')
    forced = {} if mode is None else {'mode': mode}
    ms = {}
    for directed in (False, True):
        name = 'directed' if directed else 'undirected'
        modes = {', mixture prior': 'mix'}
        if has_rw:
            modes[', random-walk prior'] = 'rw'
        if has_temper:
            modes.update({m + ', tempered': p + ' tempered'
                          for m, p in list(modes.items())})
        modes = {m: p for m, p in modes.items()
                 if only is None or name + m in only}
        if not modes:
            continue
        scan_args, mixture, radii = _inputs(torch, node_scan, C, directed,
                                            n=n)
        for m, p in modes.items():
            prior = mixture if p.startswith('mix') else ()
            kw = dict(forced)
            if not p.startswith('mix'):
                kw.update(mixture=False, tau_sq=2.0, sigma_sq=0.1)
            if p.endswith('tempered'):
                kw['temper'] = ladder
            for cluster in [None] + clusters:
                extra = {} if cluster is None else {'cluster': cluster}
                key = name + m + ('' if cluster is None
                                  else ', cluster %d' % cluster)
                try:
                    ms[key] = _median_ms(
                        torch, lambda: node_scan.node_scan_cuda(
                            *scan_args, *prior, radii=radii, **kw, **extra),
                        repeats)
                except ValueError:
                    ms[key] = None   # a cluster this checkout refuses
        del scan_args, mixture, radii
        torch.cuda.empty_cache()
    return ms


def main(argv=None):
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--root', default=here)
    parser.add_argument('--repeats', type=int, default=None,
                        help='timed launches a mode (default 50; 5 with '
                        '--slices)')
    parser.add_argument('--cluster', default='',
                        help='comma-separated cluster sizes to time too')
    parser.add_argument('--chains', default='32',
                        help='comma-separated chain counts')
    parser.add_argument('--n', type=int, default=N)
    parser.add_argument('--mode', default=None,
                        choices=('resident', 'split'))
    parser.add_argument('--slices', action='store_true',
                        help='the four slices past n = 2048')
    args = parser.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print('time_torch_scan: no CUDA device')
        return 1
    from dynetlsm_tpu_torch.ops import node_scan
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    params = inspect.signature(node_scan.node_scan_cuda).parameters
    has_rw, has_temper = 'mixture' in params, 'temper' in params
    clusters = ([int(b) for b in args.cluster.split(',') if b]
                if 'cluster' in params else [])
    repeats = args.repeats or (5 if args.slices else 50)
    if args.slices:
        runs = [(n, C, 'split', [m]) for n, C, m in SLICES]
    else:
        runs = [(args.n, int(c), args.mode, None)
                for c in args.chains.split(',') if c]
    for n, C, mode, only in runs:
        ms = _time_modes(torch, node_scan, C, has_rw, has_temper, clusters,
                         repeats, n=n, mode=mode, only=only)
        print(json.dumps({'card': card, 'root': root, 'repeats': repeats,
                          'shape': 'T=%d n=%d d=%d chains=%d' % (T, n, D, C),
                          'mode': mode, 'ms': ms}), flush=True)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
