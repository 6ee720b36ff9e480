"""Time and check the two log-likelihood kernels of one checkout.

    python3 scripts/time_torch_loglik.py [--root DIR] [--repeats 50]
                                         [--blocks 9,37,148]

Imports ``dynetlsm_tpu_torch`` from the checkout at DIR (default: the one
that holds this script), builds its kernels, and prints one JSON line per
shape, the north star (T=10, n=500, d=2, 32 chains) and Sampson's (T=3,
n=18, 512 chains): the card and its power limit, DIR, and for
``pair_loglik_cuda`` at two intercepts and at one, and ``dir_loglik_cuda``
at 1, 2 and 3 candidates (numpy-seeded inputs, as ``chip_smoke.py`` makes
them):

* ``ms``: the median CUDA-event milliseconds of one call (for a kernel of
  a few microseconds this is the host's time to issue the call);
* ``graph_ms``: the milliseconds per call of 20 calls captured in one CUDA
  graph and replayed (the device's time without the host's gaps; the
  replay's result must equal the eager call's bit for bit);
* ``kernels_per_call``: the device kernels one call launches, counted from
  a ``torch.profiler`` trace of one call (null if the trace shows none);
* ``err64``: the largest absolute error of any column against a dense
  float64 evaluation on the card;
* ``diff_err64``: the same for column 1 minus column 0, the difference an
  MH step consumes (null with one column);
* ``rerun_identical``: whether a second call gave the same bits.

Where the checkout cuts a chain's work into blocks by a rule
(``ops/loglik_tiles.py::blocks_per_chain``), ``--blocks`` also times every
case with each listed count of blocks a chain forced (capped at the work
list's length), under ``forced_blocks``, as ``graph_ms``.

A checkout whose pair wrapper needs both intercepts is timed "at one" as
its swap called it, with b_prop = b_cur.  To compare two checkouts on one
card, run it on both in turns (A, B, B, A) in one command.
"""
import argparse
import inspect
import json
import os
import subprocess
import sys

import numpy as np

SHAPES = [dict(T=10, n=500, C=32), dict(T=3, n=18, C=512)]


def _pair_inputs(torch, dev, C, T, n, seed):
    rng = np.random.RandomState(seed)
    Y = rng.binomial(1, 0.05, (T, n, n))
    Y = np.triu(Y, 1)
    Y = (Y + Y.transpose(0, 2, 1)).astype(np.uint8)
    b = 1.0 + 0.1 * rng.randn(C)
    f = dict(dtype=torch.float32, device=dev)
    return (torch.as_tensor(Y, device=dev),
            torch.as_tensor(rng.randn(C, T, n, 2), **f),
            torch.as_tensor(b, **f), torch.as_tensor(b + 0.05, **f))


def _dir_inputs(torch, pack_directed, dev, C, T, n, n_cand, seed):
    rng = np.random.RandomState(seed)
    Y = rng.binomial(1, 0.05, (T, n, n))
    Y[:, np.arange(n), np.arange(n)] = 0
    b = 0.3 + 0.5 * rng.randn(C, n_cand, 2)
    b[:, 0, 0] = -np.abs(b[:, 0, 0]) - 0.1
    f = dict(dtype=torch.float32, device=dev)
    return (pack_directed(torch.as_tensor(Y.astype(np.uint8), device=dev)),
            torch.as_tensor(rng.randn(C, T, n, 2), **f),
            torch.as_tensor(0.5 + rng.rand(C, n_cand, n), **f),
            torch.as_tensor(b, **f))


def _distances64(torch, X):
    X = X.double()
    return torch.sqrt(((X[:, :, :, None] - X[:, :, None]) ** 2).sum(-1))


def _softplus(torch, eta):
    return torch.logaddexp(eta, torch.zeros((), dtype=eta.dtype,
                                            device=eta.device))


def _oracle_pair(torch, Y, X, *bs):
    """sum_{t, i<j} y eta - softplus(eta), eta = b - dist, in float64."""
    dist = _distances64(torch, X)
    upper = torch.triu(torch.ones(Y.shape[1:], dtype=torch.float64,
                                  device=X.device), 1)
    y = Y.double()
    out = []
    for b in bs:
        eta = b.double()[:, None, None, None] - dist
        out.append(((y * eta - _softplus(torch, eta)) * upper).sum((1, 2, 3)))
    return torch.stack(out, -1)


def _oracle_dir(torch, Yp, X, radii, b):
    """sum_{t, i != j} y eta - softplus(eta), eta = B - dist (u_j + v_i),
    in float64 from the float32 u = b_in / r and v = b_out / r the kernel
    forms."""
    dist = _distances64(torch, X)
    n = X.shape[2]
    off = 1.0 - torch.eye(n, dtype=torch.float64, device=X.device)
    y = (Yp & 1).double()
    u = (b[..., 0:1] / radii).double()
    v = (b[..., 1:2] / radii).double()
    B = (b[..., 0] + b[..., 1]).double()
    out = []
    for k in range(b.shape[1]):
        s = u[:, k, None, None, :] + v[:, k, None, :, None]
        eta = B[:, k, None, None, None] - dist * s
        out.append(((y * eta - _softplus(torch, eta)) * off).sum((1, 2, 3)))
    return torch.stack(out, -1)


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


def _graph_ms(torch, fn, repeats, calls=20):
    """(ms per call of ``calls`` calls replayed from one CUDA graph, the
    last call's result)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            out = fn()
    ms = _median_ms(torch, graph.replay, repeats) / calls
    torch.cuda.synchronize()
    return ms, out


def _kernels_per_call(torch, fn):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA
             and not e.name.startswith(('Memcpy', 'Memset'))]
    return len(names) or None


def _forced(torch, fn, blocks, repeats):
    """{G: graph ms per call} with G blocks a chain forced."""
    from dynetlsm_tpu_torch.ops import loglik_tiles
    rule = loglik_tiles.blocks_per_chain
    out = {}
    try:
        for G in blocks:
            loglik_tiles.blocks_per_chain = (
                lambda C, items, resident, G=G: min(G, items))
            out[str(G)] = _graph_ms(torch, fn, repeats)[0]
    finally:
        loglik_tiles.blocks_per_chain = rule
    return out


def _measure(torch, fn, exact, repeats, blocks=()):
    got = fn()
    again = fn()
    torch.cuda.synchronize()
    err = float((got.double() - exact).abs().max())
    diff = None
    if got.shape[1] > 1:
        diff = float(((got[:, 1] - got[:, 0]).double()
                      - (exact[:, 1] - exact[:, 0])).abs().max())
    graph_ms, replayed = _graph_ms(torch, fn, repeats)
    if not torch.equal(replayed, got):
        raise SystemExit('time_torch_loglik: the CUDA graph replay differs '
                         'from the eager call')
    extra = ({'forced_blocks': _forced(torch, fn, blocks, repeats)}
             if blocks else {})
    return dict(extra, ms=_median_ms(torch, fn, repeats), graph_ms=graph_ms,
                kernels_per_call=_kernels_per_call(torch, fn), err64=err,
                diff_err64=diff, rerun_identical=bool(torch.equal(got,
                                                                  again)))


def main(argv=None):
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--root', default=here)
    parser.add_argument('--repeats', type=int, default=50)
    parser.add_argument('--blocks', default='',
                        help='comma-separated blocks a chain to force too')
    args = parser.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print('time_torch_loglik: no CUDA device')
        return 1
    from dynetlsm_tpu_torch.ops.dir_loglik import dir_loglik_cuda
    from dynetlsm_tpu_torch.ops.node_scan import pack_directed
    from dynetlsm_tpu_torch.ops.pair_loglik import pair_loglik_cuda
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device('cuda', 0)
    blocks = [int(g) for g in args.blocks.split(',') if g]
    if blocks and not os.path.exists(os.path.join(
            root, 'dynetlsm_tpu_torch', 'ops', 'loglik_tiles.py')):
        blocks = []
    one_intercept = (inspect.signature(pair_loglik_cuda)
                     .parameters['b_prop'].default is None)
    for shape in SHAPES:
        C, T, n = shape['C'], shape['T'], shape['n']
        res = {}
        Y, X, b_cur, b_prop = _pair_inputs(torch, dev, C, T, n, seed=3)
        res['pair_loglik, 2 intercepts'] = _measure(
            torch, lambda: pair_loglik_cuda(Y, X, b_cur, b_prop),
            _oracle_pair(torch, Y, X, b_cur, b_prop), args.repeats, blocks)
        if one_intercept:
            def one():
                return pair_loglik_cuda(Y, X, b_cur)
        else:
            def one():
                return pair_loglik_cuda(Y, X, b_cur, b_cur)[:, :1]
        res['pair_loglik, 1 intercept'] = _measure(
            torch, one, _oracle_pair(torch, Y, X, b_cur), args.repeats,
            blocks)
        for n_cand in (1, 2, 3):
            d_args = _dir_inputs(torch, pack_directed, dev, C, T, n, n_cand,
                                 seed=6 + n_cand)
            res['dir_loglik, %d candidates' % n_cand] = _measure(
                torch, lambda: dir_loglik_cuda(*d_args),
                _oracle_dir(torch, *d_args), args.repeats, blocks)
        print(json.dumps({'card': card, 'root': root,
                          'repeats': args.repeats,
                          'shape': 'T=%d n=%d d=2 chains=%d' % (T, n, C),
                          'results': res}), flush=True)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
