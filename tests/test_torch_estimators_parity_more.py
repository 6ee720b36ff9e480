"""Whole-fit parity of the port's estimators with the JAX package's, with
the sampler's output injected: the LSM, the LPCM, missing dyads and
thinning (the HDP-LPCM's selection types, directed model and tempering
are in ``test_torch_estimators_parity.py``).

The JAX fit runs at a tiny budget (its nested LSM initialisation at 10 + 5
+ 5 sweeps, through ``init_from_lsm``'s own ``lsm_kwargs``), and wrappers
in the JAX modules' namespaces capture its nested-LSM embedding and its
``collect_traces`` output (traces and final state); nothing in the JAX
package changes.  The port's fit then runs with the same ``random_state``
on the CPU, with ``init_from_lsm`` returning the captured embedding and
``collect_traces`` returning the captured traces and final state (carried
across by ``states.state_from_numpy``).  Everything else is the port's
own: the validation, k-means and Dirichlet initial values and the initial
log joint, BFGS and GMDS for the LSM, and all of the post-processing.

Every fitted attribute of the JAX estimator exists on the port's and
agrees: labels, counts and indices exactly, float32-derived values to
rtol 1e-5 (at 1e-5 of the array's largest magnitude near zero), and in
the LSM the values that follow from the BFGS start (sample 0 of the
traces and the 'auto' intercept prior) to the MLE test's 1e-3.
"""
import pytest

from dynetlsm_tpu.models import hdp_lpcm as jhdp, lpcm as jlpcm, lsm as jlsm

from dynetlsm_tpu_torch.datasets import with_missing_dyads
from dynetlsm_tpu_torch.models import (
    hdp_lpcm as phdp, lpcm as plpcm, lsm as plsm)

from .torch_fit_parity import BUDGET, compare, fit_pair, monks


def test_lpcm(monkeypatch):
    jm, pm = fit_pair(monkeypatch, jlpcm, plpcm.DynamicNetworkLPCM,
                      monks(), dict(BUDGET, n_components=4, n_chains=2,
                                    selection_type='vi'))
    compare(jm, pm)


@pytest.mark.parametrize('directed', [False, True])
def test_lsm(monkeypatch, directed):
    jm, pm = fit_pair(monkeypatch, jlsm, plsm.DynamicNetworkLSM,
                      monks(directed), dict(BUDGET, n_chains=2,
                                            is_directed=directed))
    compare(jm, pm, lsm=True)


def test_hdp_missing_dyads(monkeypatch):
    Y = with_missing_dyads(monks(), 0.1, seed=3)
    jm, pm = fit_pair(monkeypatch, jhdp, phdp.DynamicNetworkHDPLPCM, Y,
                      dict(BUDGET, n_components=5, n_chains=2))
    assert pm.missings_.shape == Y.shape
    compare(jm, pm)


def test_lsm_missing_dyads(monkeypatch):
    Y = with_missing_dyads(monks(), 0.1, seed=4)
    jm, pm = fit_pair(monkeypatch, jlsm, plsm.DynamicNetworkLSM, Y,
                      dict(BUDGET))
    compare(jm, pm, lsm=True)


def test_lpcm_thinned(monkeypatch):
    jm, pm = fit_pair(monkeypatch, jlpcm, plpcm.DynamicNetworkLPCM,
                      monks(), dict(BUDGET, n_components=3, thin=2,
                                    selection_type='map'))
    assert pm.Xs_.shape[0] == (40 - 1) // 2 + 1
    compare(jm, pm)
