"""Two readings of the estimators' fits that calibrate ``chip_smoke.py``'s
phase-13 checks.

    python3 scripts/fit_checks.py [--part radius|auc|all] [--seeds 0,1,2]
                                  [--device cuda] [--out FILE] [--quick]
                                  [--package port|jax]

``radius``: the directed Sampson LSM with one chain at the JAX suite's
slow budget (2000 + 1000 + 1000 samples, tests/test_equivalence_directed.py
:60-65), one fit per seed of ``--seeds``; per seed the posterior means
that the suite checks (``equivalence.posterior_stats``), the largest
radius among them, and the wall seconds.  ``--package jax`` fits the JAX
package's estimator instead, on the host CPU (the reference for the
port's readings; this branch alone imports JAX).

``auc``: ``auc_`` of the north-star HDP-LPCM fit of ``chip_smoke.py``
(``NS_FIT``), beside the AUC of the probabilities the network was drawn
from and of faulty fits and readings:

- ``start``: the probabilities of the fit's initial sample (the nested
  LSM's positions and intercept): what a sampler that never moved would
  read;
- ``no nested lsm``: the fit with its nested LSM cut to one sweep, so
  that it starts from GMDS and the intercept MLE;
- ``intercept at 0``: the fit with the intercept step replaced by one
  that holds the intercept at 0;
- ``random positions``: positions drawn from a normal of the start's
  spread, with the start's intercept;
- ``nodes permuted``: the sound fit's ``probas_`` with its nodes in a
  random order on both axes.

One JSON line per reading goes to standard output and to ``--out``
(default ``chiprun_out/fit_checks.jsonl``), with the card's name and power
limit.  ``--quick`` cuts every budget and the north-star network to a few
sweeps and 60 nodes, to try the script on the CPU (``--device cpu``).
"""
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(1, os.path.join(ROOT, 'scripts'))

import chip_smoke  # noqa: E402

SLOW_DIRECTED = dict(n_iter=2000, tune=1000, burn=1000)


def card():
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True)
    except OSError:
        return 'no nvidia-smi'
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else (
        'nvidia-smi failed')


def emit(out, row):
    line = json.dumps(row)
    print(line, flush=True)
    out.write(line + '\n')
    out.flush()


def radius_part(args, out, base):
    from dynetlsm_tpu_torch import equivalence
    from dynetlsm_tpu_torch.datasets import load_dynamic_monks
    Y = load_dynamic_monks(is_directed=True)
    budget = (dict(n_iter=20, tune=10, burn=10) if args.quick
              else SLOW_DIRECTED)
    kw = dict(budget)
    if args.package == 'jax':
        import jax
        jax.config.update('jax_platforms', 'cpu')
        from dynetlsm_tpu import DynamicNetworkLSM
        base = dict(base, device='cpu (JAX package)')
    else:
        from dynetlsm_tpu_torch import DynamicNetworkLSM
        kw['device'] = args.device
    for seed in args.seeds:
        t0 = time.perf_counter()
        m = DynamicNetworkLSM(is_directed=True, random_state=seed,
                              **kw).fit(Y)
        seconds = time.perf_counter() - t0
        ok, stats, _ = equivalence.posterior_stats('lsm directed', m, False)
        emit(out, dict(base, part='radius', seed=seed, chains=1,
                       budget=budget, passes_slow_limits=ok,
                       seconds=seconds, **stats))


def auc_part(args, out, base):
    import torch
    from dynetlsm_tpu_torch import DynamicNetworkHDPLPCM
    from dynetlsm_tpu_torch import datasets
    from dynetlsm_tpu_torch.mcmc import sweeps
    from dynetlsm_tpu_torch.metrics import network_auc
    from dynetlsm_tpu_torch.models import mixture_base
    from dynetlsm_tpu_torch.models.lsm import network_probas

    n = 60 if args.quick else 500
    Y = datasets.northstar_network(n=n)
    oracle = network_auc(Y, np.broadcast_to(datasets.northstar_probas(n=n),
                                            Y.shape))
    fit_kw = dict(chip_smoke.NS_FIT, device=args.device)
    nested_kw = None
    if args.quick:
        fit_kw.update(n_components=6, n_chains=4, n_iter=10, tune=5, burn=5)
        nested_kw = dict(n_iter=10, tune=5, burn=5)
    init = mixture_base.init_from_lsm
    intercept_step = sweeps.sample_intercept_undirected

    def fit(fault=None):
        def nested(*a, **k):
            k['lsm_kwargs'] = (dict(n_iter=2, tune=0, burn=0)
                               if fault == 'no nested lsm' else nested_kw)
            return init(*a, **k)

        def zero_intercept(gen, Y, X, intercept, step, *a, **k):
            return intercept_step(gen, Y, X, torch.zeros_like(intercept),
                                  torch.zeros_like(step), *a, **k)
        mixture_base.init_from_lsm = nested
        if fault == 'intercept at 0':
            sweeps.sample_intercept_undirected = zero_intercept
        try:
            t0 = time.perf_counter()
            m = DynamicNetworkHDPLPCM(**fit_kw).fit(Y)
            return m, time.perf_counter() - t0
        finally:
            mixture_base.init_from_lsm = init
            sweeps.sample_intercept_undirected = intercept_step

    def row(reading, auc, **extra):
        emit(out, dict(base, part='auc', reading=reading, auc=float(auc),
                       oracle_auc=float(oracle), n=n, **extra))

    m, seconds = fit()
    row('sound fit', m.auc_, seconds=seconds)
    X0, b0 = m.Xs_[0, 0], np.atleast_1d(m.intercepts_[0, 0])
    row('start', network_auc(Y, network_probas(X0, b0, None, False)))
    rng = np.random.RandomState(0)
    X_rand = X0.std() * rng.randn(*X0.shape)
    row('random positions',
        network_auc(Y, network_probas(X_rand, b0, None, False)))
    perm = rng.permutation(n)
    row('nodes permuted', network_auc(Y, m.probas_[:, perm][:, :, perm]))
    for fault in ('no nested lsm', 'intercept at 0'):
        m, seconds = fit(fault)
        row(fault, m.auc_, seconds=seconds,
            intercept_mean=float(np.mean(m.intercepts_[:, m.n_burn_:])))


def main():
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--part', default='all', choices=('radius', 'auc', 'all'))
    p.add_argument('--seeds', default='0,1,2,3,4,5,6,7,42')
    p.add_argument('--device', default='cuda')
    p.add_argument('--out', default=os.path.join(ROOT, 'chiprun_out',
                                                 'fit_checks.jsonl'))
    p.add_argument('--quick', action='store_true')
    p.add_argument('--package', default='port', choices=('port', 'jax'))
    args = p.parse_args()
    args.seeds = [int(s) for s in args.seeds.split(',')]
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    base = {'card': card(), 'device': args.device}
    with open(args.out, 'a') as out:
        if args.part in ('auc', 'all'):
            auc_part(args, out, base)
        if args.part in ('radius', 'all'):
            radius_part(args, out, base)
    return 0


if __name__ == '__main__':
    sys.exit(main())
