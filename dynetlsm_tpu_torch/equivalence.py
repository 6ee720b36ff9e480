"""Posterior-equivalence checks of the estimators against the reference
sampler's statistics, at the budgets of the JAX package's equivalence
suite: the undirected Sampson LSM and HDP-LPCM, the directed Sampson LSM
and the LPCM on a simulated community network.

``make_fit(name, device, fast)`` builds one case's estimator and network;
``posterior_stats(name, m, fast, z_true)`` reads the fitted estimator's
posterior statistics and says whether they are within the suite's limits.
``chip_smoke.py`` runs the fast budgets on the card and
``tests/test_torch_equivalence.py`` the full ones.
"""
import numpy as np

__all__ = ['BUDGETS', 'REF_LSM', 'REF_HDP', 'REF_DIRECTED', 'REF_LPCM',
           'make_fit', 'posterior_stats']

# the JAX suite's reference posterior statistics (the reference sampler
# with NumPy shims, scripts/reference_shim.py):
# tests/test_equivalence_sampson.py:29-36 (LSM) and :40-53 (HDP-LPCM),
# tests/test_equivalence_directed.py:28-38 and
# tests/test_equivalence_lpcm.py:25-29
REF_LSM = {'auc': 0.8624, 'intercept_mean': 1.6896, 'intercept_sd': 0.1786,
           'logp_mean': -248.488, 'logp_sd': 6.805, 'x_norm_mean': 2.2358}
REF_HDP = {'lambda_mean': 0.8489, 'lambda_sd': 0.0849,
           'intercept_mean': 1.4487, 'intercept_sd': 0.2804,
           'mode_clusters': 3}
REF_DIRECTED = {'auc': 0.8835, 'intercept_in_mean': 0.0446,
                'intercept_in_sd': 0.0067, 'intercept_out_mean': -0.0003,
                'intercept_out_sd': 0.0036, 'logp_mean': -365.625,
                'logp_sd': 7.682, 'radii_max_mean': 0.1217,
                'radii_max_sd': 0.0085}
REF_LPCM = {'lambda_mean': 0.8200, 'lambda_sd': 0.0819,
            'intercept_mean': 2.0868, 'intercept_sd': 0.1321,
            'sigma_mean': 0.4234}
# each case's budgets: the JAX suite's fast test (4 chains where it has
# them) and its slow one (tests/test_equivalence_sampson.py:93-115 and
# :57-73 HDP-LPCM, :118-137 and :76-90 LSM; test_equivalence_directed.py
# :68-75 and :60-65; test_equivalence_lpcm.py:54-73 and :32-51).  The
# slow tests run one chain; here they run the fast tests' 4 at the same
# budget a chain: one chain's mean of the directed LSM's largest radius
# moves between seeds by as much as the 3-sd band around 0.1217 (PERF.md,
# section 7)
BUDGETS = {
    'lsm': dict(fast=dict(n_iter=1000, tune=500, burn=500, n_chains=4),
                full=dict(n_iter=2000, tune=1000, burn=1000, n_chains=4)),
    'hdp': dict(fast=dict(n_iter=800, tune=400, burn=400, n_chains=4),
                full=dict(n_iter=3000, tune=1000, burn=1000, n_chains=4)),
    'lsm directed': dict(
        fast=dict(n_iter=1000, tune=500, burn=500, n_chains=4),
        full=dict(n_iter=2000, tune=1000, burn=1000, n_chains=4)),
    'lpcm': dict(fast=dict(n_iter=400, tune=200, burn=200),
                 full=dict(n_iter=600, tune=300, burn=300, n_chains=4))}


def _post(arr, m):
    """The post-burn samples of a trace, single- or multi-chain."""
    return arr[m.n_burn_:] if m.n_chains == 1 else arr[:, m.n_burn_:]


def posterior_stats(name, m, fast, z_true=None):
    """(whether the fitted model ``m`` passes the JAX suite's checks of
    case ``name``, the statistics checked, the reference), at its fast
    test's limits when ``fast``, else its slow test's."""
    sd = 4.0 if fast else 3.0
    if name == 'lsm':
        ref = REF_LSM
        stats = {'auc': m.auc_,
                 'intercept': _post(m.intercepts_, m).mean(),
                 'logp': _post(m.logps_, m).mean(),
                 'x_norm': np.linalg.norm(_post(m.Xs_, m), axis=-1).mean()}
        ok = (abs(stats['auc'] - ref['auc']) < 0.05
              and abs(stats['intercept'] - ref['intercept_mean'])
              < 3 * ref['intercept_sd']
              and abs(stats['logp'] - ref['logp_mean']) < 3 * ref['logp_sd']
              and abs(stats['x_norm'] - ref['x_norm_mean']) < 0.3)
    elif name == 'hdp':
        ref = REF_HDP
        vals, freqs = np.unique(m.counts_, return_counts=True)
        stats = {'lambda': np.ravel(_post(m.lambdas_, m)).mean(),
                 'intercept': _post(m.intercepts_, m).mean(),
                 'mode_clusters': int(vals[np.argmax(freqs)]),
                 'auc': m.auc_}
        # at the fast budget extra clusters may not have merged yet
        modes = ((ref['mode_clusters'], ref['mode_clusters'] + 1) if fast
                 else (ref['mode_clusters'],))
        ok = (abs(stats['lambda'] - ref['lambda_mean'])
              < sd * ref['lambda_sd']
              and abs(stats['intercept'] - ref['intercept_mean'])
              < sd * ref['intercept_sd']
              and stats['mode_clusters'] in modes and stats['auc'] > 0.75)
    elif name == 'lsm directed':
        ref = REF_DIRECTED
        b = _post(m.intercepts_, m).reshape(-1, 2)
        stats = {'auc': m.auc_, 'intercept_in': b[:, 0].mean(),
                 'intercept_out': b[:, 1].mean(),
                 'logp': _post(m.logps_, m).mean(),
                 'radii_max': _post(m.radiis_, m).max(axis=-1).mean()}
        ok = (abs(stats['auc'] - ref['auc']) < 0.05
              and all(abs(stats[k] - ref[k + '_mean']) < sd * ref[k + '_sd']
                      for k in ('intercept_in', 'intercept_out', 'logp',
                                'radii_max')))
    elif name == 'lpcm':
        from .metrics import adjusted_rand_score
        ref = REF_LPCM
        stats = {'ari': adjusted_rand_score(z_true[0], m.z_[0]),
                 'auc': m.auc_,
                 'lambda': np.ravel(_post(m.lambdas_, m)).mean(),
                 'intercept': _post(m.intercepts_, m).mean(),
                 'sigma': _post(m.sigmas_, m).mean()}
        ok = ((stats['ari'] > 0.9 if fast else stats['ari'] == 1.0)
              and stats['auc'] > (0.85 if fast else 0.88)
              and abs(stats['lambda'] - ref['lambda_mean'])
              < sd * ref['lambda_sd']
              and abs(stats['intercept'] - ref['intercept_mean'])
              < sd * ref['intercept_sd']
              and abs(stats['sigma'] - ref['sigma_mean'])
              < (0.3 if fast else 0.25))
    else:
        raise ValueError('no equivalence case %r' % (name,))
    return bool(ok), {k: float(v) for k, v in stats.items()}, ref


def make_fit(name, device, fast=True):
    """(the unfitted estimator, its network, the true labels or None) of
    one equivalence case on ``device``, at the fast or the full budget."""
    from . import DynamicNetworkHDPLPCM, DynamicNetworkLPCM, DynamicNetworkLSM
    from .datasets import (
        load_dynamic_monks, synthetic_static_community_dynamic_network)
    budget = BUDGETS[name]['fast' if fast else 'full']
    z_true = None
    if name == 'lpcm':
        Y, _, z_true = synthetic_static_community_dynamic_network(
            n_nodes=40, n_time_steps=2, n_groups=3, simulation_type='easy',
            random_state=42)
        est = DynamicNetworkLPCM(n_components=3, random_state=7,
                                 device=device, **budget)
    elif name == 'hdp':
        Y = load_dynamic_monks()
        est = DynamicNetworkHDPLPCM(n_components=10, random_state=42,
                                    device=device, **budget)
    else:
        directed = name == 'lsm directed'
        Y = load_dynamic_monks(is_directed=directed)
        est = DynamicNetworkLSM(is_directed=directed, random_state=42,
                                device=device, **budget)
    return est, Y, z_true
