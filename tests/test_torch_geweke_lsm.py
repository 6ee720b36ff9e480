"""Geweke joint-distribution tests of the port's LSM sweeps, undirected
and directed, and of its replica swap (``dynetlsm_tpu_torch/geweke.py``;
the JAX package's ``tests/test_geweke_joint.py`` and
``tests/test_tempering.py::test_pt_swap_preserves_distribution``).

The sweep runs with every dyad missing, so its missing-dyad Gibbs step
redraws Y from the model after each parameter update; iff every block
targets its full conditional, every statistic's chain mean matches its
iid-prior mean (|z| < 5).  Each chain starts from an exact prior draw, so
256 chains of 100 sweeps (25,600 chain-sweeps; the JAX tests run 8 of
3,000) test the same joint.  Seeds are fixed, so the outcome is
deterministic.
"""
import numpy as np
import pytest
import torch

from dynetlsm_tpu_torch import geweke

N_CHAINS, N_SWEEPS = 256, 100


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    """One intra-op thread: the chains' tensors are small, and the test
    workers that run beside this one have the other cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope='module')
def lsm_samples():
    return geweke.geweke_samples('lsm', N_CHAINS, N_SWEEPS,
                                 geweke.SEEDS['lsm'], 'cpu')


def test_lsm_joint_distribution(lsm_samples):
    z = geweke.compare(*lsm_samples)
    assert np.all(np.abs(z) < geweke.LIMIT), 'Geweke z-scores %s' % z


def test_lsm_geweke_has_power(lsm_samples):
    """The comparison notices a different joint: iid draws with 1.8 times
    the innovation variance move the temporal-smoothness moment by more
    than 8 standard errors (guards against vacuously large errors)."""
    z = geweke.lsm_power_z(lsm_samples[1])
    assert abs(z[4]) > geweke.POWER_LIMIT, 'not detected: %s' % z


def test_directed_lsm_joint_distribution():
    """The social-radii likelihood, the directed intercepts' sequential MH
    and the Dirichlet-proposal radii MH (its asymmetry correction), at the
    directed joint's scales."""
    mc, sc = geweke.geweke_samples('directed', N_CHAINS, N_SWEEPS,
                                   geweke.SEEDS['directed'], 'cpu')
    z = geweke.compare(mc, sc)
    assert np.all(np.abs(z) < geweke.LIMIT), 'Geweke z-scores %s' % z


def test_pt_swap_preserves_distribution():
    """Replica exchange at equal temperatures only relabels
    configurations: each slot's marginal matches the iid draws.  Drives
    the partner pairing, the shared pair uniforms and the swapped fields
    (the network ``Y`` among them) under the real directed sweep; block
    z-scores over 64 ladders of 4 rungs, 100 steps."""
    mc, sc = geweke.pt_swap_samples(64, N_SWEEPS, geweke.SEEDS['swap'],
                                    'cpu')
    z = geweke.pt_block_z(mc, sc)
    assert np.all(np.abs(z) < geweke.PT_LIMIT), 'block z-scores %s' % z


def test_lsm_case_control_joint_distribution():
    """The LSM with the case-control likelihood at its full-control limit
    (every other node a control, masked per time to the current
    non-edges: the estimator equals the exact likelihood), every dyad
    missing, so each sweep rebuilds every chain's edge lists: the
    chromatic scan, the padded lists, the validity masks and the
    case-control coefficient and log-joint terms inside the joint check
    (the JAX package's test_lsm_case_control_joint_distribution)."""
    mc, sc = geweke.geweke_samples(geweke.CC, N_CHAINS, N_SWEEPS,
                                   geweke.SEEDS[geweke.CC], 'cpu')
    z = geweke.compare(mc, sc)
    assert np.all(np.abs(z) < geweke.LIMIT), 'Geweke z-scores %s' % z


def test_lsm_mala_joint_distribution():
    """The LSM with the joint MALA latent update (JAX
    ``test_lsm_mala_joint_distribution``): the Langevin proposal's drift
    from the autograd gradient of the joint density and its reversal
    correction, inside the joint check at the JAX test's step 0.12."""
    mc, sc = geweke.geweke_samples(geweke.MALA, N_CHAINS, N_SWEEPS,
                                   geweke.SEEDS[geweke.MALA], 'cpu')
    z = geweke.compare(mc, sc)
    assert np.all(np.abs(z) < geweke.LIMIT), 'Geweke z-scores %s' % z


def test_directed_case_control_joint_distribution():
    """The directed LSM with the case-control likelihood at its
    full-control limit (every other node an in- and an out-control; JAX
    ``test_directed_case_control_joint_distribution``): the directed
    case-control branches of the intercept and radii steps and of the
    chromatic scan inside the directed joint check."""
    mc, sc = geweke.geweke_samples(geweke.DIRECTED_CC, N_CHAINS, N_SWEEPS,
                                   geweke.SEEDS[geweke.DIRECTED_CC], 'cpu')
    z = geweke.compare(mc, sc)
    assert np.all(np.abs(z) < geweke.LIMIT), 'Geweke z-scores %s' % z
