"""Drive the PyTorch port (dynetlsm_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each of which fails the run (exit code 1) when it fails:

1. the card (``nvidia-smi`` name and power limit) and the torch / CUDA
   versions;
2. the build of the CUDA kernels from ``dynetlsm_tpu_torch/csrc`` (nvcc,
   first use), with its time and ptxas report;
3. the node-scan kernel against its plain PyTorch version on the card, on
   one numpy-seeded proposal stream, at the north-star shape (T=10, n=500,
   d=2, 32 chains, K=25) and the Sampson shape (T=3, n=18, 512 chains,
   K=10): identical accept indicators, positions within 1e-5;
4. the pair log-likelihood kernel against its plain version at 32 chains,
   T=10, n=500: rtol 1e-5 per candidate, and bit-identical on rerun;
5. the slice: the HDP-LPCM sweep built by ``entry.build_state_and_sweep``
   at the north star (synthetic network, K=25, 32 chains) and on Sampson's
   monastery (K=10, 512 chains), 2 warm-up and 20 timed sweeps through the
   port's runner; every logp finite, ``it`` = 22, each kernel launched once
   per sweep, and the final logp equal to the log joint recomputed densely
   from the final state (rtol 1e-5);
6. each kernel's time beside its plain version's at the slice's shapes
   (CUDA events, median of repeats).

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or outside a
checkout, the script exits 1 and prints no result.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
NS = dict(T=10, n=500, K=25, C=32)
SAMPSON = dict(T=3, n=18, K=10, C=512)
WARM, TIMED = 2, 20


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(*args):
    print(*args, flush=True)


def card_line():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, 'nvidia-smi failed: %s' % out.stderr.strip())
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, repeats, warmup=1):
    """Median milliseconds of fn() on the card, CUDA events around each
    call."""
    import torch
    for _ in range(warmup):
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


# ---------------------------------------------------------------------------
# phase 3: node scan
# ---------------------------------------------------------------------------

def scan_inputs(C, T, n, K, dev, seed, d=2):
    import torch
    from dynetlsm_tpu_torch.ops.node_scan import site_cluster_params
    rng = np.random.RandomState(seed)
    Y = rng.binomial(1, 0.05, (T, n, n))
    Y = np.triu(Y, 1)
    Y = (Y + Y.transpose(0, 2, 1)).astype(np.uint8)
    arrs = dict(
        X=rng.randn(C, T, n, d), step=np.full((C, T, n), 0.1),
        eps=rng.randn(C, 2, n, T, d), log_u=np.log(rng.rand(C, 2, n, T)),
        b=1.0 + 0.1 * rng.randn(C), mu=rng.randn(C, K, d),
        sig=rng.rand(C, K) + 0.3, lmbda=np.full(C, 0.9))
    t = {k: torch.as_tensor(v, dtype=torch.float32, device=dev)
         for k, v in arrs.items()}
    t['Y'] = torch.as_tensor(Y, device=dev)
    z = torch.as_tensor(rng.randint(0, K, (C, T, n)), device=dev)
    t['mu_z'], t['sig_z'] = site_cluster_params(t['mu'], t['sig'], z)
    return t


def scan_args(t):
    return (t['Y'], t['X'], t['b'], t['step'], t['eps'], t['log_u'])


def first_mismatch(t, acc_k, acc_p, X_k):
    """The first differing site in scan order and its margin
    |log_u - ratio|, recomputed with the plain formulas from the field at
    that moment (identical in both runs up to that site)."""
    import torch
    from dynetlsm_tpu_torch.ops.node_scan import (
        _mixture_prior_per_t, _partial_loglik_terms, _tree_sum, partner_pad)
    diff = (acc_k != acc_p).nonzero().tolist()          # (c, t, j)
    c, t_, j = min(diff, key=lambda s: (s[0], s[2], s[1] % 2, s[1]))
    phase = t_ % 2
    X = t['X'][c:c + 1].clone()
    X[:, :, :j] = X_k[c:c + 1, :, :j]
    if phase == 1:
        X[:, 0::2, j] = X_k[c:c + 1, 0::2, j]
    x_cur = X[:, :, j]
    x_prop = x_cur + t['step'][c:c + 1, :, j, None] * t['eps'][c:c + 1,
                                                              phase, j]
    Yf = t['Y'][:, j].to(torch.float32)
    mask = (torch.arange(X.shape[2], device=X.device) != j).float()
    b = t['b'][c:c + 1]
    delta = _tree_sum((_partial_loglik_terms(Yf, X, x_prop, b)
                       - _partial_loglik_terms(Yf, X, x_cur, b)) * mask,
                      partner_pad(X.shape[2]))
    mz, sz, lam = t['mu_z'][c:c + 1, :, j], t['sig_z'][c:c + 1, :, j], \
        t['lmbda'][c:c + 1]
    ratio = (delta + _mixture_prior_per_t(x_prop, x_cur, mz, sz, lam)
             - _mixture_prior_per_t(x_cur, x_cur, mz, sz, lam))[0, t_]
    margin = abs(float(t['log_u'][c, phase, j, t_]) - float(ratio))
    return dict(chain=c, node=j, phase=phase, t=t_, margin=margin)


def check_node_scan(shape, dev, seed):
    import torch
    from dynetlsm_tpu_torch.ops.node_scan import (
        node_scan_cuda, node_scan_plain)
    t = scan_inputs(shape['C'], shape['T'], shape['n'], shape['K'], dev,
                    seed)
    X_k, acc_k = node_scan_cuda(*scan_args(t), t['mu_z'], t['sig_z'],
                                t['lmbda'])
    X_p, acc_p = node_scan_plain(*scan_args(t), mu_z=t['mu_z'],
                                 sig_z=t['sig_z'], lmbda=t['lmbda'])
    torch.cuda.synchronize()
    check(bool(torch.isfinite(X_k).all()), 'node_scan: non-finite X')
    if not torch.equal(acc_k, acc_p):
        raise SmokeFailure('node_scan accept mismatch at %s (%d sites)'
                           % (first_mismatch(t, acc_k, acc_p, X_k),
                              int((acc_k != acc_p).sum())))
    err = float((X_k - X_p).abs().max())
    check(err <= 1e-5, 'node_scan: max |dX| = %g > 1e-5' % err)
    rate = float(acc_k.mean())
    check(0.0 < rate < 1.0, 'node_scan: acceptance rate %g' % rate)
    log('node_scan %s: accepts identical (rate %.4f), max |dX| %g'
        % (shape, rate, err))
    return t, err


# ---------------------------------------------------------------------------
# phase 4: pair log-likelihood
# ---------------------------------------------------------------------------

def pair_inputs(C, T, n, dev, seed):
    import torch
    rng = np.random.RandomState(seed)
    Y = rng.binomial(1, 0.05, (T, n, n))
    Y = np.triu(Y, 1)
    Y = (Y + Y.transpose(0, 2, 1)).astype(np.uint8)
    b = 1.0 + 0.1 * rng.randn(C)
    f = dict(dtype=torch.float32, device=dev)
    return (torch.as_tensor(Y, device=dev),
            torch.as_tensor(rng.randn(C, T, n, 2), **f),
            torch.as_tensor(b, **f), torch.as_tensor(b + 0.05, **f))


def check_pair(shape, dev, seed):
    import torch
    from dynetlsm_tpu_torch.ops.pair_loglik import (
        pair_loglik_cuda, pair_loglik_plain)
    args = pair_inputs(shape['C'], shape['T'], shape['n'], dev, seed)
    got = pair_loglik_cuda(*args)
    again = pair_loglik_cuda(*args)
    want = pair_loglik_plain(*args)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), 'pair_loglik: non-finite')
    check(torch.equal(got, again), 'pair_loglik: rerun not bit-identical')
    rel = float(((got - want).abs() / want.abs()).max())
    check(rel <= 1e-5, 'pair_loglik: max rel err %g > 1e-5' % rel)
    err = float((got - want).abs().max())
    log('pair_loglik %s: max rel err %g (abs %g), rerun bit-identical'
        % (shape, rel, err))
    return args, err


# ---------------------------------------------------------------------------
# phase 5: the slice
# ---------------------------------------------------------------------------

def run_slice(name, Y, shape, dev):
    import torch
    from dynetlsm_tpu_torch.entry import build_state_and_sweep
    from dynetlsm_tpu_torch.mcmc.driver import make_scan_runner
    from dynetlsm_tpu_torch.mcmc.sweeps import hdp_logp_at_state
    from dynetlsm_tpu_torch.ops.node_scan import node_scan_cuda
    from dynetlsm_tpu_torch.ops.pair_loglik import pair_loglik_cuda
    C = shape['C']
    state, sweep, gen = build_state_and_sweep(Y, C, K=shape['K'],
                                              device=dev)
    runner = make_scan_runner(sweep, lambda s: {'logp': s.logp},
                              chunk=TIMED)
    node_scan_cuda.launches = 0
    pair_loglik_cuda.launches = 0
    state, warm = runner(state, gen, WARM)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, traced = runner(state, gen, TIMED)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {'node_scan': node_scan_cuda.launches,
                'pair_loglik': pair_loglik_cuda.launches}
    logps = torch.cat([warm['logp'][:WARM], traced['logp'][:TIMED]])
    check(bool(torch.isfinite(logps).all()), '%s: non-finite logp' % name)
    check(bool((state.it == WARM + TIMED).all()), '%s: it != %d'
          % (name, WARM + TIMED))
    for k, v in launches.items():
        check(v == WARM + TIMED, '%s: %s launched %d times in %d sweeps'
              % (name, k, v, WARM + TIMED))
    T, n = Y.shape[:2]
    check(tuple(state.X.shape) == (C, T, n, 2), '%s: X shape' % name)
    acc_rate = float(state.acc_X.mean()) / (WARM + TIMED)
    check(0.0 < acc_rate < 1.0, '%s: X acceptance %g' % (name, acc_rate))
    s = state
    dense = hdp_logp_at_state(
        sweep.cfg, torch.as_tensor(Y, device=dev), np.zeros(1, np.float32),
        s.X, s.intercept, s.z, s.mu, s.sigma, s.lmbda, s.weights, s.beta,
        s.gamma, s.alpha_init, s.alpha, s.kappa, s.mean_var, s.b_scale)
    gap = (dense - s.logp).abs()
    rel = float((gap / s.logp.abs()).max())
    check(bool((gap <= 1e-5 * s.logp.abs() + 1e-3).all()),
          '%s: sweep logp vs dense log joint rel err %g' % (name, rel))
    ms = 1e3 * elapsed / TIMED
    log('slice %s (T=%d, n=%d, K=%d, %d chains): %.3f ms/sweep, %.1f '
        'sweeps/s x chains, X acceptance %.3f, logp mean %.2f, '
        'dense-logp rel err %g, launches %s'
        % (name, T, n, shape['K'], C, ms, C / (ms / 1e3), acc_rate,
           float(s.logp.mean()), rel, launches))
    return launches, ms


def main():
    if not os.path.isdir(os.path.join(ROOT, 'dynetlsm_tpu_torch')):
        log('chip_smoke: no dynetlsm_tpu_torch package beside this script; '
            'run it from the root of a checkout')
        return 1
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        log('chip_smoke: torch.cuda.is_available() is False; this script '
            'measures the port on an NVIDIA GPU only')
        return 1
    dev = torch.device('cuda', 0)
    try:
        log(card_line())
        log('torch %s, CUDA %s, python %s' % (
            torch.__version__, torch.version.cuda, sys.version.split()[0]))

        from dynetlsm_tpu_torch.ops import cuda_lib
        t0 = time.perf_counter()
        lib = cuda_lib.library()
        log('kernel build: %.1f s (nvcc %.1f s) -> %s'
            % (time.perf_counter() - t0, lib.build_seconds, lib.path))
        for line in lib.build_log.splitlines():
            if 'registers' in line or 'smem' in line or 'Compiling' in line:
                log('  ptxas: ' + line.strip())

        scan_ns, err_scan_ns = check_node_scan(NS, dev, seed=1)
        scan_sa, err_scan_sa = check_node_scan(SAMPSON, dev, seed=2)
        pair_ns, err_pair_ns = check_pair(NS, dev, seed=3)
        pair_sa, err_pair_sa = check_pair(SAMPSON, dev, seed=4)

        from dynetlsm_tpu_torch.datasets import (
            load_dynamic_monks, northstar_network)
        launch_ns, ms_ns = run_slice('northstar', northstar_network(), NS,
                                     dev)
        launch_sa, ms_sa = run_slice('sampson', load_dynamic_monks(),
                                     SAMPSON, dev)

        from dynetlsm_tpu_torch.ops.node_scan import (
            node_scan_cuda, node_scan_plain)
        from dynetlsm_tpu_torch.ops.pair_loglik import (
            pair_loglik_cuda, pair_loglik_plain)

        def scan_times(t):
            k = cuda_ms(lambda: node_scan_cuda(*scan_args(t), t['mu_z'],
                                               t['sig_z'], t['lmbda']), 10)
            p = cuda_ms(lambda: node_scan_plain(
                *scan_args(t), mu_z=t['mu_z'], sig_z=t['sig_z'],
                lmbda=t['lmbda']), 3)
            return k, p

        def pair_times(args):
            return (cuda_ms(lambda: pair_loglik_cuda(*args), 20),
                    cuda_ms(lambda: pair_loglik_plain(*args), 5))

        kernels = []
        rows = [
            ('node_scan', 'dynetlsm_tpu_torch/csrc/node_scan.cu',
             'dynetlsm_tpu/ops/pallas_scan.py:157', NS, launch_ns,
             err_scan_ns, scan_times(scan_ns)),
            ('node_scan', 'dynetlsm_tpu_torch/csrc/node_scan.cu',
             'dynetlsm_tpu/ops/pallas_scan.py:637', SAMPSON, launch_sa,
             err_scan_sa, scan_times(scan_sa)),
            ('pair_loglik', 'dynetlsm_tpu_torch/csrc/pair_loglik.cu',
             'dynetlsm_tpu/ops/pallas_loglik.py:25', NS, launch_ns,
             err_pair_ns, pair_times(pair_ns)),
            ('pair_loglik', 'dynetlsm_tpu_torch/csrc/pair_loglik.cu',
             'dynetlsm_tpu/ops/pallas_loglik.py:25', SAMPSON, launch_sa,
             err_pair_sa, pair_times(pair_sa)),
        ]
        for name, source, replaces, shape, launches, err, (ms, pms) in rows:
            log('%s %s: kernel %.4f ms, plain %.4f ms'
                % (name, shape, ms, pms))
            kernels.append({
                'name': name, 'route': 'cuda', 'source': source,
                'replaces': replaces, 'launches': launches[name],
                'max_abs_err': err, 'ms': ms, 'plain_ms': pms,
                'shape': 'T=%(T)d n=%(n)d K=%(K)d chains=%(C)d' % shape})
        log('slice ms/sweep: northstar %.3f, sampson %.3f'
            % (ms_ns, ms_sa))
    except SmokeFailure as e:
        log('chip_smoke FAILED: %s' % e)
        return 1

    print(json.dumps({'kernels': kernels}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
