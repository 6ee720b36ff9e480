"""The port's chromatic case-control scan
(``dynetlsm_tpu_torch/mcmc/latent.py::cc_colored_scan``) against the JAX
package's ``cc_colored_scan`` on identical numpy-seeded inputs: the same
network, colour classes, controls, masks and proposal stream, in all four
modes (directed and undirected, mixture and random-walk prior),
untempered and tempered, with identical accept indicators and positions
within 1e-5.  Also, as in ``tests/test_cc_colored.py``: a class update
equals its nodes updated one after another, and per-chain edge lists that
all equal the shared ones give the shared lists' result.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dynetlsm_tpu.mcmc.latent import cc_colored_scan as jax_scan
from dynetlsm_tpu.ops import case_control as jcc
from dynetlsm_tpu_torch.mcmc.latent import cc_colored_scan
from dynetlsm_tpu_torch.ops import case_control as pcc

T, N, M, K, C = 3, 24, 5, 4, 3


def _net(rng, directed, p=0.15):
    Y = rng.binomial(1, p, size=(T, N, N)).astype(np.float32)
    if not directed:
        Y = np.triu(Y, 1)
        Y = Y + np.swapaxes(Y, 1, 2)
    for t in range(T):
        np.fill_diagonal(Y[t], 0)
    return Y


def structures(rng, Y, directed, seed=1):
    """(the JAX cc dict, the port's cc dict, groups): the JAX host lists,
    colouring and control draw, the masks of each package."""
    lists_h = jcc.build_edge_lists(Y)
    colors, groups = jcc.color_conflict_graph(lists_h, N, seed=seed)
    ci, co = jcc.sample_controls_colored(jax.random.PRNGKey(seed),
                                         jnp.asarray(colors), N, M,
                                         directed=directed)
    lists = {k: jnp.asarray(v) for k, v in lists_h.items()}
    civ, cov = jcc.control_masks(ci, co, lists, directed)
    jc = dict(lists, ctrl_out=co, ctrl_out_valid=cov, colors=colors,
              color_groups=jnp.asarray(groups))
    if directed:
        jc.update(ctrl_in=ci, ctrl_in_valid=civ)
    pc = port_cc(lists_h, groups, None if ci is None else np.asarray(ci),
                 np.asarray(co), directed)
    return jc, pc, groups


def port_cc(lists_h, groups, ci, co, directed, n_chains=None):
    """The port's cc dict from host lists and injected controls; with
    ``n_chains`` the lists are given to every chain as its own."""
    lists = {k: torch.as_tensor(v).long() for k, v in lists_h.items()}
    if n_chains:
        lists = {k: v.expand((n_chains,) + v.shape).clone()
                 for k, v in lists.items()}
    ci = None if ci is None else torch.as_tensor(np.array(ci)).long()
    co = torch.as_tensor(np.array(co)).long()
    civ, cov = pcc.control_masks(ci, co, lists, directed)
    return dict(lists, ctrl_in=ci, ctrl_out=co, ctrl_in_valid=civ,
                ctrl_out_valid=cov, color_groups=torch.as_tensor(
                    groups).long(),
                group_sizes=tuple(int(v) for v in (groups >= 0).sum(1)))


def inputs(rng, directed, mixture):
    X = rng.randn(C, T, N, 2).astype(np.float32)
    a = dict(X=X, eps=rng.randn(C, 2, N, T, 2).astype(np.float32),
             log_u=np.log(rng.uniform(size=(C, 2, N, T))).astype(np.float32),
             step=np.full((C, T, N), 0.3, np.float32),
             b=np.tile(np.asarray([0.5, 0.8] if directed else [0.5],
                                  np.float32), (C, 1)),
             radii=rng.dirichlet(np.ones(N), size=C).astype(np.float32))
    if mixture:
        a.update(mu=rng.randn(C, K, 2).astype(np.float32),
                 sigma=rng.uniform(0.5, 2.0, (C, K)).astype(np.float32),
                 lmbda=rng.uniform(0.6, 0.9, C).astype(np.float32),
                 z=rng.randint(0, K, (C, T, N)))
    return a


def run_port(a, cc, directed, mixture, temper=None):
    t = {k: torch.as_tensor(v) for k, v in a.items()}
    kw = dict(radii=t['radii'] if directed else None, cc=cc,
              is_directed=directed, mixture=mixture,
              temper=None if temper is None else torch.as_tensor(
                  temper, dtype=torch.float32))
    if mixture:
        kw.update(mu=t['mu'], sigma=t['sigma'], lmbda=t['lmbda'],
                  z=t['z'].long())
    else:
        kw.update(tau_sq=2.0, sigma_sq=0.1)
    X, acc = cc_colored_scan(t['X'], t['b'], t['step'], t['eps'],
                             t['log_u'], **kw)
    return X.numpy(), acc.numpy()


def run_jax(a, jc, directed, mixture, temper=None):
    Xs, accs = [], []
    for c in range(C):
        kw = dict(radii=jnp.asarray(a['radii'][c]) if directed else None,
                  cc=jc, is_directed=directed, mixture=mixture,
                  temper=None if temper is None else jnp.asarray(
                      temper[c], jnp.float32))
        if mixture:
            kw.update(mu=jnp.asarray(a['mu'][c]),
                      sigma=jnp.asarray(a['sigma'][c]),
                      lmbda=jnp.asarray(a['lmbda'][c]),
                      z=jnp.asarray(a['z'][c], jnp.int32))
        else:
            kw.update(tau_sq=2.0, sigma_sq=0.1)
        X, acc = jax_scan(jnp.asarray(a['X'][c]), jnp.asarray(a['b'][c]),
                          jnp.asarray(a['step'][c]), jnp.asarray(a['eps'][c]),
                          jnp.asarray(a['log_u'][c]), **kw)
        Xs.append(np.asarray(X))
        accs.append(np.asarray(acc))
    return np.stack(Xs), np.stack(accs)


@pytest.mark.parametrize('tempered', [False, True])
@pytest.mark.parametrize('mixture', [True, False])
@pytest.mark.parametrize('directed', [True, False])
def test_colored_scan_matches_jax(directed, mixture, tempered):
    rng = np.random.RandomState(3 + 2 * directed + mixture)
    Y = _net(rng, directed)
    jc, pc, _ = structures(rng, Y, directed)
    a = inputs(rng, directed, mixture)
    temper = np.array([1.0, 0.35, 0.0], np.float32) if tempered else None
    Xp, accp = run_port(a, pc, directed, mixture, temper)
    Xj, accj = run_jax(a, jc, directed, mixture, temper)
    np.testing.assert_array_equal(accp, accj)
    np.testing.assert_allclose(Xp, Xj, rtol=0, atol=1e-5)
    assert 0.05 < accp.mean() < 0.95      # both branches exercised
    if tempered:
        # the inverse temperature reaches the ratio: the prior-only chain
        # differs from its untempered run
        X1, _ = run_port(a, pc, directed, mixture)
        assert np.abs(X1[2] - Xp[2]).max() > 0
        np.testing.assert_array_equal(X1[0], Xp[0])


@pytest.mark.parametrize('directed', [True, False])
def test_class_update_equals_sequential_within_class(directed):
    """The classes as they are, and each class's nodes as singleton
    classes in slot order (their sequential execution): identical
    results, so the simultaneous update has no cross-site dependencies
    (tests/test_cc_colored.py:158)."""
    rng = np.random.RandomState(11 + directed)
    Y = _net(rng, directed, p=0.1)
    _, pc, groups = structures(rng, Y, directed)
    a = inputs(rng, directed, False)
    single = groups.reshape(-1, 1)
    pc1 = dict(pc, color_groups=torch.as_tensor(single).long(),
               group_sizes=tuple(int(v) for v in (single >= 0).sum(1)))
    X0, acc0 = run_port(a, pc, directed, False)
    X1, acc1 = run_port(a, pc1, directed, False)
    assert groups.shape[1] > 1
    np.testing.assert_array_equal(X0, X1)
    np.testing.assert_array_equal(acc0, acc1)
    assert acc0.mean() > 0.05


@pytest.mark.parametrize('directed', [True, False])
def test_per_chain_lists_equal_shared_lists(directed):
    """Edge lists and masks given to each chain as its own (the
    missing-dyad path) give the shared lists' result bit for bit."""
    rng = np.random.RandomState(21 + directed)
    Y = _net(rng, directed)
    _, pc, groups = structures(rng, Y, directed)
    lists_h = pcc.build_edge_lists(Y)
    ci = None if pc['ctrl_in'] is None else pc['ctrl_in'].numpy()
    pcC = port_cc(lists_h, groups, ci, pc['ctrl_out'].numpy(), directed,
                  n_chains=C)
    a = inputs(rng, directed, True)
    X0, acc0 = run_port(a, pc, directed, True)
    X1, acc1 = run_port(a, pcC, directed, True)
    np.testing.assert_array_equal(X0, X1)
    np.testing.assert_array_equal(acc0, acc1)
