"""Time the node-scan kernel of one checkout at the north-star shape.

    python3 scripts/time_torch_scan.py [--root DIR] [--repeats 50]
                                       [--cluster 1,2,4] [--chains 32]

Imports ``dynetlsm_tpu_torch`` from the checkout at DIR (default: the one
that holds this script), builds its kernels, and prints one JSON line per
chain count (``--chains``, comma-separated): the card and its power
limit, DIR, and the median CUDA-event milliseconds of one
``node_scan_cuda`` launch at T=10, n=500, d=2 and that many chains
(numpy-seeded inputs, as ``chip_smoke.py`` makes them) in each mode the
checkout's wrapper takes: the mixture prior, undirected and directed, and,
where the
wrapper takes ``mixture=``, the random-walk prior; where it takes
``temper=``, each of those modes again with per-chain inverse temperatures
(4-rung ladders from 1 to 0.2 tiled over the chains, ``, tempered``), on
the same inputs.  Where the checkout pads the adjacency's rows for the
kernel (``pad_partners``), the padded adjacency is passed, as its sweeps
pass it.  Where the wrapper takes ``cluster=``, ``--cluster`` also times
every mode at each listed cluster size (``, cluster B``); the plain keys
are the launch rule's.  To compare two checkouts on one card, run it on
both in turns (A, B, B, A) in one command.
"""
import argparse
import inspect
import json
import os
import subprocess
import sys

import numpy as np

T, N, D, K = 10, 500, 2, 25


def _inputs(torch, node_scan, C, directed, seed=1):
    rng = np.random.RandomState(seed)
    Y = rng.binomial(1, 0.05, (T, N, N))
    if directed:
        Y[:, np.arange(N), np.arange(N)] = 0
    else:
        Y = np.triu(Y, 1)
        Y = Y + Y.transpose(0, 2, 1)
    dev = torch.device('cuda', 0)

    def f32(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    Y = torch.as_tensor(Y.astype(np.uint8), device=dev)
    if directed:
        Y = node_scan.pack_directed(Y)
    if hasattr(node_scan, 'pad_partners'):
        Y = node_scan.pad_partners(Y)
    b = 1.0 + 0.1 * rng.randn(C, 2 if directed else 1)
    args = [Y,
            f32(rng.randn(C, T, N, D)), f32(b if directed else b[:, 0]),
            f32(np.full((C, T, N), 0.1)), f32(rng.randn(C, 2, N, T, D)),
            f32(np.log(rng.rand(C, 2, N, T)))]
    z = torch.as_tensor(rng.randint(0, K, (C, T, N)), device=dev)
    mu_z, sig_z = node_scan.site_cluster_params(
        f32(rng.randn(C, K, D)), f32(rng.rand(C, K) + 0.3), z)
    radii = f32(0.5 + rng.rand(C, N)) if directed else None
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
                repeats):
    """Median ms of each mode (and each cluster size) at C chains."""
    ladder = torch.as_tensor(np.resize(np.geomspace(1.0, 0.2, 4), C),
                             dtype=torch.float32, device='cuda')
    ms = {}
    for directed in (False, True):
        scan_args, mixture, radii = _inputs(torch, node_scan, C, directed)
        name = 'directed' if directed else 'undirected'
        modes = {', mixture prior': (mixture, {})}
        if has_rw:
            modes[', random-walk prior'] = ((), dict(
                mixture=False, tau_sq=2.0, sigma_sq=0.1))
        if has_temper:
            modes.update({mode + ', tempered': (prior, dict(kw, temper=ladder))
                          for mode, (prior, kw) in list(modes.items())})
        for mode, (prior, kw) in modes.items():
            for cluster in [None] + clusters:
                extra = {} if cluster is None else {'cluster': cluster}
                key = name + mode + ('' if cluster is None
                                     else ', cluster %d' % cluster)
                ms[key] = _median_ms(
                    torch, lambda: node_scan.node_scan_cuda(
                        *scan_args, *prior, radii=radii, **kw, **extra),
                    repeats)
    return ms


def main(argv=None):
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--root', default=here)
    parser.add_argument('--repeats', type=int, default=50)
    parser.add_argument('--cluster', default='',
                        help='comma-separated cluster sizes to time too')
    parser.add_argument('--chains', default='32',
                        help='comma-separated chain counts')
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
    for C in [int(c) for c in args.chains.split(',') if c]:
        ms = _time_modes(torch, node_scan, C, has_rw, has_temper, clusters,
                         args.repeats)
        print(json.dumps({'card': card, 'root': root,
                          'repeats': args.repeats,
                          'shape': 'T=%d n=%d d=%d chains=%d' % (T, N, D, C),
                          'ms': ms}), flush=True)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
