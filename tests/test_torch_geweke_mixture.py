"""Geweke joint-distribution tests of the port's LPCM and sticky HDP-LPCM
sweeps (``dynetlsm_tpu_torch/geweke.py``; the JAX package's
``tests/test_geweke_joint.py``): the FFBS labels, the Dirichlet weights,
the conjugate cluster blocks and, in the HDP, the CRF tables, m-bar and
the stick weights, with the concentrations fixed (their Escobar-West
updates are approximate under the weak-limit prior, in the reference too)
and every dyad missing.  256 chains of 100 sweeps from exact prior draws;
every |z| < 5.  Seeds are fixed, so the outcome is deterministic.
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


def test_lpcm_joint_distribution():
    mc, sc = geweke.geweke_samples('lpcm', N_CHAINS, N_SWEEPS,
                                   geweke.SEEDS['lpcm'], 'cpu')
    z = geweke.compare(mc, sc)
    assert np.all(np.abs(z) < geweke.LIMIT), 'Geweke z-scores %s' % z


def test_hdp_joint_distribution():
    mc, sc = geweke.geweke_samples('hdp', N_CHAINS, N_SWEEPS,
                                   geweke.SEEDS['hdp'], 'cpu')
    z = geweke.compare(mc, sc)
    assert np.all(np.abs(z) < geweke.LIMIT), 'Geweke z-scores %s' % z
