"""The port's tempered and MALA statistical checks
(``dynetlsm_tpu_torch/geweke.py``), counterparts of the JAX package's
``tests/test_tempering.py::test_pt_hdp_joint_distribution``,
``::test_pt_samples_metastable_joint`` and
``tests/test_mala.py::test_mala_lsm_matches_exact_posterior``.

The two tempered checks need the JAX tests' sweeps: their hot slots start
from draws of the untempered joint, so the cold slots are exact only once
the ladders have equilibrated, and the metastable target's mixing gain
shows only over long chains.  At those budgets they take one to three
minutes on the CPU, so they run on the card (``cuda``; ``chip_smoke.py``
phase 12 runs them too), and the CPU runs their machinery at a few sweeps.
The MALA check runs on the CPU at 400 + 200 + 200 samples of 4 chains (its
bars held with wide margins at random states 11, 12 and 13), and at the
JAX test's budget on the card.  On the card, without the suite's
conftest:

    python3 -m pytest --noconftest -m cuda tests/test_torch_geweke_tempered.py
"""
import numpy as np
import pytest
import torch

from dynetlsm_tpu_torch import geweke


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    """One intra-op thread: the chains' tensors are small, and the test
    workers that run beside this one have the other cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the tempered checks run the JAX '
                    "tests' thousands of sweeps")
    return torch.device('cuda')


def _ladder(n_ladders, rungs_and_beta_min):
    n_temps, beta_min = rungs_and_beta_min
    return np.tile(np.geomspace(1.0, beta_min, n_temps),
                   n_ladders).astype(np.float32)


def test_pt_hdp_machinery():
    """The tempered HDP check at 3 ladders x 6 steps: finite cold-slot
    statistics of the HDP's twelve, one row a ladder, block z-scores
    finite, the ladder unchanged (no adaptation)."""
    mc, sc, ladder = geweke.pt_hdp_samples(3, 6, geweke.SEEDS['pt hdp'],
                                           'cpu')
    assert mc.shape == (geweke.N_MC, 12) and sc.shape == (3, 6, 12)
    assert np.isfinite(sc).all()
    assert np.isfinite(geweke.block_z(mc, sc.mean(1))).all()
    np.testing.assert_array_equal(ladder, _ladder(3, geweke.PT_HDP))


def test_metastable_machinery():
    """The metastable check at 2 ladders of 10 rungs x 6 steps: the hard
    regime's iid draws and chains, the directed statistics, the density
    spreads and the ladder unchanged."""
    mc, cold, plain, ladder = geweke.metastable_samples(
        2, 6, geweke.SEEDS[geweke.METASTABLE], 'cpu')
    assert mc.shape == (geweke.N_MC, 8)
    assert cold.shape == plain.shape == (2, 6, 8)
    assert np.isfinite(cold).all() and np.isfinite(plain).all()
    assert np.isfinite(geweke.block_z(mc, cold.mean(1))).all()
    assert geweke.density_spread(cold) >= 0
    np.testing.assert_array_equal(ladder,
                                  _ladder(2, geweke.PT_METASTABLE))
    # the hard regime: distances far beyond the O(1/n) radii, so most
    # iid networks are nearly empty or nearly full
    dens = mc[:, 3]
    assert ((dens < 0.05) | (dens > 0.95)).mean() > 0.5


def test_mala_matches_exact_posterior():
    """MALA and the exact scan sample one posterior on Sampson's monastery
    (the JAX test's four bars, at 800 samples of 4 chains)."""
    rows = geweke.mala_posterior_check('cpu', n_iter=400, tune=200,
                                       burn=200)
    assert all(ok for *_, ok in rows), rows


@pytest.mark.cuda
def test_pt_hdp_joint_distribution(card):
    """The JAX test's 10 ladders x 4 rungs (beta_min 0.25) x 2,500 steps:
    every cold-slot block |z| < 4.5."""
    mc, sc, _ = geweke.pt_hdp_samples(10, 2500, geweke.SEEDS['pt hdp'],
                                      card)
    z = geweke.block_z(mc, sc.mean(1))
    assert np.all(np.abs(z) < geweke.PT_LIMIT), 'block z-scores %s' % z


@pytest.mark.cuda
def test_pt_samples_metastable_joint(card):
    """The JAX test's 8 ladders x 10 rungs (beta_min 0.02) x 4,000 steps
    in the hard regime: cold-slot block |z| < 4.5, and the edge density's
    spread over ladders 1.5 times below that of 8 untempered chains."""
    mc, cold, plain, _ = geweke.metastable_samples(
        8, 4000, geweke.SEEDS[geweke.METASTABLE], card)
    z = geweke.block_z(mc, cold.mean(1))
    assert np.all(np.abs(z) < geweke.PT_LIMIT), 'block z-scores %s' % z
    assert (geweke.density_spread(cold) * geweke.SPREAD_GAIN
            < geweke.density_spread(plain))


@pytest.mark.cuda
def test_mala_matches_exact_posterior_at_full_budget(card):
    rows = geweke.mala_posterior_check(card)
    assert all(ok for *_, ok in rows), rows
