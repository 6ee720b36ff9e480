"""The posterior-equivalence checks of ``dynetlsm_tpu_torch/equivalence.py``
on stand-in fitted models whose traces sit at the reference sampler's
statistics: they pass at both budgets, and a statistic moved well outside
its limit fails them.  The fits themselves run on the card
(``tests/test_torch_equivalence.py``, ``chip_smoke.py`` phase 13)."""
import types

import numpy as np
import pytest

from dynetlsm_tpu_torch import (
    DynamicNetworkHDPLPCM, DynamicNetworkLPCM, DynamicNetworkLSM, equivalence)

C, S, BURN, T, N = 4, 6, 2, 3, 18


def _trace(value, *shape):
    return np.full((C, S) + shape, value, dtype=np.float64)


def stand_in(name):
    """(a fitted-model stand-in at the reference's statistics, true labels
    or None)."""
    m = types.SimpleNamespace(n_chains=C, n_burn_=BURN)
    if name == 'lsm':
        ref = equivalence.REF_LSM
        m.auc_ = ref['auc']
        m.intercepts_ = _trace(ref['intercept_mean'])
        m.logps_ = _trace(ref['logp_mean'])
        m.Xs_ = np.zeros((C, S, T, N, 2))
        m.Xs_[..., 0] = ref['x_norm_mean']
        return m, None
    if name == 'hdp':
        ref = equivalence.REF_HDP
        m.lambdas_ = _trace(ref['lambda_mean'])
        m.intercepts_ = _trace(ref['intercept_mean'])
        m.counts_ = np.full(C * (S - BURN), ref['mode_clusters'])
        m.auc_ = 0.8
        return m, None
    if name == 'lsm directed':
        ref = equivalence.REF_DIRECTED
        m.auc_ = ref['auc']
        m.intercepts_ = np.stack([_trace(ref['intercept_in_mean']),
                                  _trace(ref['intercept_out_mean'])], -1)
        m.logps_ = _trace(ref['logp_mean'])
        m.radiis_ = _trace(0.01, N)
        m.radiis_[..., 0] = ref['radii_max_mean']
        return m, None
    ref = equivalence.REF_LPCM
    z = np.repeat(np.arange(3), 6)[None].repeat(2, 0)
    m.z_ = z.copy()
    m.auc_ = 0.9
    m.lambdas_ = _trace(ref['lambda_mean'])
    m.intercepts_ = _trace(ref['intercept_mean'])
    m.sigmas_ = _trace(ref['sigma_mean'], 3)
    return m, z


@pytest.mark.parametrize('name', sorted(equivalence.BUDGETS))
def test_reference_statistics_pass_and_a_shift_fails(name):
    m, z = stand_in(name)
    for fast in (True, False):
        ok, stats, _ = equivalence.posterior_stats(name, m, fast, z)
        assert ok, (name, fast, stats)
    # the intercept (directed: b_in) moved by 5 reference sd, post-burn
    ref = {'lsm': equivalence.REF_LSM, 'hdp': equivalence.REF_HDP,
           'lsm directed': equivalence.REF_DIRECTED,
           'lpcm': equivalence.REF_LPCM}[name]
    sd = ref.get('intercept_sd', ref.get('intercept_in_sd'))
    shifted = m.intercepts_.copy()
    shifted[:, BURN:, ...] += 5 * sd
    m.intercepts_ = shifted
    ok, stats, _ = equivalence.posterior_stats(name, m, True, z)
    assert not ok, (name, stats)


def test_burn_in_samples_are_not_read():
    m, _ = stand_in('lsm')
    m.intercepts_[:, :BURN] = 100.0
    assert equivalence.posterior_stats('lsm', m, True)[0]


def test_unknown_case_raises():
    with pytest.raises(ValueError):
        equivalence.posterior_stats('lsm tempered', stand_in('lsm')[0], True)


@pytest.mark.parametrize('name, cls', [
    ('lsm', DynamicNetworkLSM), ('hdp', DynamicNetworkHDPLPCM),
    ('lsm directed', DynamicNetworkLSM), ('lpcm', DynamicNetworkLPCM)])
@pytest.mark.parametrize('fast', [True, False])
def test_make_fit_builds_the_case_at_its_budget(name, cls, fast):
    est, Y, z = equivalence.make_fit(name, 'cpu', fast)
    assert isinstance(est, cls) and est.device == 'cpu'
    budget = equivalence.BUDGETS[name]['fast' if fast else 'full']
    assert all(getattr(est, k) == v for k, v in budget.items())
    assert est.is_directed == (name == 'lsm directed')
    assert Y.ndim == 3 and Y.shape[1] == Y.shape[2]
    assert (z is not None) == (name == 'lpcm')
