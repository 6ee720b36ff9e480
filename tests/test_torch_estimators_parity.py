"""Whole-fit parity of the port's estimators with the JAX package's, with
the sampler's output injected: the HDP-LPCM's three selection types, its
directed model and tempering (the rest in
``test_torch_estimators_parity_more.py``).

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
import jax
import pytest

from dynetlsm_tpu.models import hdp_lpcm as jhdp

from dynetlsm_tpu_torch.models import hdp_lpcm as phdp

from .torch_fit_parity import BUDGET, compare, fit_pair, monks


@pytest.mark.parametrize('selection_type', ['vi', 'bic', 'map'])
def test_hdp_undirected(monkeypatch, selection_type):
    jm, pm = fit_pair(monkeypatch, jhdp, phdp.DynamicNetworkHDPLPCM,
                      monks(), dict(BUDGET, n_components=6, n_chains=2,
                                    selection_type=selection_type))
    compare(jm, pm)
    if selection_type == 'vi':
        compare(jm.set_best_model('bic'), pm.set_best_model('bic'))


def test_hdp_directed(monkeypatch):
    jm, pm = fit_pair(monkeypatch, jhdp, phdp.DynamicNetworkHDPLPCM,
                      monks(True), dict(BUDGET, n_components=5,
                                        is_directed=True))
    compare(jm, pm)


def test_hdp_tempered(monkeypatch):
    jm, pm = fit_pair(monkeypatch, jhdp, phdp.DynamicNetworkHDPLPCM,
                      monks(), dict(BUDGET, n_components=5, n_chains=2,
                                    n_temps=3, beta_min=0.3))
    assert pm.temper_ladder_.shape == (6,)
    compare(jm, pm)


def test_jax_on_cpu():
    assert jax.default_backend() == 'cpu'
