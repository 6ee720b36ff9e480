"""The port's case-control path without colour classes (the sequential
scan of JAX ``xla_exact_scan``'s case-control branch, with one control
draw a chain) against the JAX package.

* The scan: on injected eps / log_u and on controls replayed from JAX's
  ``sample_control_nodes`` (one key a chain), the port's exact update of
  an uncoloured ``cc`` gives JAX's accepts, and positions within 1e-5, in
  all four modes (directed and undirected, mixture and random-walk prior).
* The draw: the port's per-chain controls follow JAX's rules, and their
  per-time validity masks equal JAX's ``control_masks`` chain by chain.
* One sweep of 512 chains of the uncoloured LSM sweep against JAX's
  jitted, vmapped sweep by per-statistic KS tests at level 1e-3.
* The sweep state: the log joint is the case-control log joint of each
  chain's own controls; the redraw cadence; per-chain controls through
  ``replicate_state``, a replica swap and a checkpoint round-trip.
"""
import numpy as np
import pytest
import torch
from scipy import stats

import jax
import jax.numpy as jnp

from dynetlsm_tpu.mcmc.driver import replicate_state as jax_replicate
from dynetlsm_tpu.mcmc.latent import xla_exact_scan
from dynetlsm_tpu.mcmc.states import LSMState as JaxLSMState
from dynetlsm_tpu.mcmc.sweeps import (
    SweepConfig as JaxSweepConfig, make_lsm_sweep as jax_make_lsm_sweep)
from dynetlsm_tpu.ops import case_control as jcc

from dynetlsm_tpu_torch import checkpoint
from dynetlsm_tpu_torch.datasets import northstar_network
from dynetlsm_tpu_torch.entry import build_state_and_sweep
from dynetlsm_tpu_torch.mcmc import sweeps
from dynetlsm_tpu_torch.mcmc.driver import replicate_state
from dynetlsm_tpu_torch.mcmc.latent import sample_latent_positions
from dynetlsm_tpu_torch.mcmc.states import state_from_numpy, state_to_numpy
from dynetlsm_tpu_torch.mcmc.tempering import replica_exchange
from dynetlsm_tpu_torch.ops import case_control as pcc

T, N, M, K, C = 3, 20, 5, 4, 3


def _net(rng, directed, n=N, p=0.2):
    Y = rng.binomial(1, p, size=(T, n, n)).astype(np.float32)
    if not directed:
        Y = np.triu(Y, 1)
        Y = Y + np.swapaxes(Y, 1, 2)
    for t in range(T):
        np.fill_diagonal(Y[t], 0)
    return Y


def _jax_controls(Y, directed, n_chains=C, seed=5):
    """JAX's per-chain draws: ``sample_control_nodes`` on one key a
    chain, as the vmapped JAX sweep draws them."""
    keys = jax.random.split(jax.random.PRNGKey(seed), n_chains)
    draws = [jcc.sample_control_nodes(k, jnp.asarray(Y), M,
                                      directed=directed) for k in keys]
    ci = (np.stack([np.asarray(d[0]) for d in draws]) if directed
          else None)
    return ci, np.stack([np.asarray(d[1]) for d in draws])


def _port_cc(lists_h, ci, co, directed):
    lists = {k: torch.as_tensor(v).long() for k, v in lists_h.items()}
    ci = None if ci is None else torch.as_tensor(ci).long()
    co = torch.as_tensor(co).long()
    civ, cov = pcc.control_masks(ci, co, lists, directed)
    return dict(lists, ctrl_in=ci, ctrl_out=co, ctrl_in_valid=civ,
                ctrl_out_valid=cov)


def _jax_cc(lists_h, ci, co, c, directed):
    """Chain c's uncoloured JAX dict: the shared lists, its controls and
    their masks."""
    lists = {k: jnp.asarray(v) for k, v in lists_h.items()}
    ci_c = None if ci is None else jnp.asarray(ci[c], jnp.int32)
    co_c = jnp.asarray(co[c], jnp.int32)
    civ, cov = jcc.control_masks(ci_c, co_c, lists, directed)
    out = dict(lists, ctrl_out=co_c, ctrl_out_valid=cov)
    if directed:
        out.update(ctrl_in=ci_c, ctrl_in_valid=civ)
    return out


def _inputs(rng, directed, mixture):
    a = dict(X=rng.randn(C, T, N, 2).astype(np.float32),
             eps=rng.randn(C, 2, N, T, 2).astype(np.float32),
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


@pytest.mark.parametrize('mixture', [True, False])
@pytest.mark.parametrize('directed', [True, False])
def test_sequential_scan_matches_xla_exact_scan(directed, mixture):
    rng = np.random.RandomState(11 + 2 * directed + mixture)
    Y = _net(rng, directed)
    lists_h = jcc.build_edge_lists(Y)
    ci, co = _jax_controls(Y, directed)
    a = _inputs(rng, directed, mixture)
    t = {k: torch.as_tensor(v) for k, v in a.items()}
    kw = dict(radii=t['radii'] if directed else None,
              is_directed=directed, mixture=mixture)
    if mixture:
        kw.update(mu=t['mu'], sigma=t['sigma'], lmbda=t['lmbda'],
                  z=t['z'].long())
    else:
        kw.update(tau_sq=2.0, sigma_sq=0.1)
    Xp, accp = sample_latent_positions(
        None, None, t['X'], t['b'], t['step'],
        cc=_port_cc(lists_h, ci, co, directed),
        noise=(t['eps'], t['log_u']), **kw)
    for c in range(C):
        jkw = dict(radii=jnp.asarray(a['radii'][c]) if directed else None,
                   cc=_jax_cc(lists_h, ci, co, c, directed),
                   is_directed=directed, mixture=mixture)
        if mixture:
            jkw.update(mu=jnp.asarray(a['mu'][c]),
                       sigma=jnp.asarray(a['sigma'][c]),
                       lmbda=jnp.asarray(a['lmbda'][c]),
                       z=jnp.asarray(a['z'][c], jnp.int32))
        else:
            jkw.update(tau_sq=2.0, sigma_sq=0.1)
        Xj, accj = xla_exact_scan(
            jnp.asarray(Y), jnp.asarray(a['X'][c]), jnp.asarray(a['b'][c]),
            jnp.asarray(a['step'][c]), jnp.asarray(a['eps'][c]),
            jnp.asarray(a['log_u'][c]), **jkw)
        np.testing.assert_array_equal(accp[c].numpy(), np.asarray(accj))
        np.testing.assert_allclose(Xp[c].numpy(), np.asarray(Xj), rtol=1e-5,
                                   atol=1e-5)
    assert 0.05 < float(accp.mean()) < 0.95


@pytest.mark.parametrize('directed', [True, False])
def test_per_chain_controls_and_masks_match_jax(directed):
    """The port's draw: (C, n, m) in [0, n), -1 exactly at the node
    itself, the chains' draws distinct; and masks of JAX's draws equal
    JAX's chain by chain."""
    rng = np.random.RandomState(2)
    Y = _net(rng, directed)
    gen = torch.Generator().manual_seed(3)
    ci, co = pcc.sample_control_nodes(gen, torch.as_tensor(Y), 400,
                                      directed=directed, n_chains=C)
    node = torch.arange(N)[None, :, None]
    for ctrl in ([ci, co] if directed else [co]):
        assert ctrl.shape == (C, N, 400) and ctrl.dtype == torch.int64
        assert ctrl.max() < N and ctrl.min() >= -1
        assert not (ctrl == node).any()
        assert (ctrl == -1).float().mean() == pytest.approx(1 / N, abs=0.01)
        assert not torch.equal(ctrl[0], ctrl[1])
    if not directed:
        assert ci is None
    lists_h = jcc.build_edge_lists(Y)
    jci, jco = _jax_controls(Y, directed)
    pc = _port_cc(lists_h, jci, jco, directed)
    for c in range(C):
        jc = _jax_cc(lists_h, jci, jco, c, directed)
        np.testing.assert_array_equal(pc['ctrl_out_valid'][c].numpy(),
                                      np.asarray(jc['ctrl_out_valid']))
        if directed:
            np.testing.assert_array_equal(pc['ctrl_in_valid'][c].numpy(),
                                          np.asarray(jc['ctrl_in_valid']))


@pytest.mark.parametrize('directed', [True, False])
def test_per_chain_evaluators_equal_chain_by_chain(directed):
    """The network log-likelihood and the 'parallel' update's per-node
    terms with (C, n, m) controls equal each chain's with its own (n, m)
    draw."""
    rng = np.random.RandomState(4)
    Y = _net(rng, directed)
    lists_h = jcc.build_edge_lists(Y)
    ci, co = _jax_controls(Y, directed)
    a = _inputs(rng, directed, False)
    X, Xq = torch.as_tensor(a['X']), torch.as_tensor(a['X'] + 0.1)
    b, radii = torch.as_tensor(a['b']), torch.as_tensor(a['radii'])
    pc = _port_cc(lists_h, ci, co, directed)
    full = pcc.cc_network_loglik(X, b, radii, pc, directed)
    part = pcc.approx_partial_loglik_all(X, Xq, pc, b, radii, directed)
    for c in range(C):
        one = _port_cc(lists_h, None if ci is None else ci[c], co[c],
                       directed)
        sl = slice(c, c + 1)
        np.testing.assert_allclose(
            full[sl].numpy(), pcc.cc_network_loglik(
                X[sl], b[sl], radii[sl], one, directed).numpy(), rtol=1e-6)
        np.testing.assert_allclose(
            part[sl].numpy(), pcc.approx_partial_loglik_all(
                X[sl], Xq[sl], one, b[sl], radii[sl], directed).numpy(),
            rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# sweeps
# ---------------------------------------------------------------------------


def uncolored_static(Y):
    """A ``cc_static`` of edge lists alone (JAX's legacy dict)."""
    return {k: torch.as_tensor(v).long()
            for k, v in pcc.build_edge_lists(Y).items()}


def uncolored_lsm(Y, n_chains, m, directed=False, n_resample=10, seed=0):
    """An LSM state with one control draw a chain and its uncoloured
    sweep, from ``build_state_and_sweep``'s start."""
    state, sweep, gen = build_state_and_sweep(
        Y, n_chains, model='lsm', device='cpu', is_directed=directed,
        n_control=m, seed=seed)
    cfg = sweeps.SweepConfig(**dict(sweep.cfg.__dict__,
                                    n_resample_control=n_resample))
    ci, co = pcc.sample_control_nodes(gen, Y, m, directed=directed,
                                      n_chains=n_chains)
    state = state.replace(ctrl_in=ci, ctrl_out=co)
    sweep = sweeps.make_lsm_sweep(
        None, np.zeros(2 if directed else 1, np.float32), cfg,
        device='cpu', cc_static=uncolored_static(Y))
    return state, sweep, gen


def test_uncolored_sweep_redraws_per_chain_on_cadence():
    Y = northstar_network(T=2, n=16, seed=4)
    state, sweep, gen = uncolored_lsm(Y, 3, 5, n_resample=3)
    seen = [state.ctrl_out]
    for _ in range(7):
        state = sweep(state, gen)
        assert state.ctrl_out.shape == (3, 16, 5)
        seen.append(state.ctrl_out)
    for s in range(1, 8):
        changed = not torch.equal(seen[s], seen[s - 1])
        assert changed == ((s - 1) % 3 == 0), s
    assert not torch.equal(seen[1][0], seen[1][1])


@pytest.mark.parametrize('directed', [False, True])
def test_uncolored_sweep_logp_is_the_cc_log_joint(directed):
    """After 3 sweeps each chain's logp is the case-control log joint of
    its state and its own controls, recomputed from scratch."""
    Y = northstar_network(T=3, n=30, seed=6, directed=directed)
    state, sweep, gen = uncolored_lsm(Y, 3, 6, directed=directed)
    for _ in range(3):
        state = sweep(state, gen)
    cc = sweeps.build_cc_dict(sweep.cfg, None, uncolored_static(Y),
                              state.ctrl_in, state.ctrl_out)
    assert cc['ctrl_out_valid'].shape == (3, 3, 30, 6)
    prior = torch.zeros(2 if directed else 1)
    want = sweeps._lsm_logp(sweep.cfg, None, state.X, state.intercept,
                            state.radii, None, prior, cc=cc)
    assert torch.isfinite(state.logp).all()
    np.testing.assert_allclose(state.logp.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-3)


def test_uncolored_controls_replicate_swap_and_checkpoint(tmp_path):
    """Per-chain controls keep their chain axis through replicate_state
    (shared=()), stay with their slot in a replica swap (JAX swaps only
    the model configuration) and survive a checkpoint round-trip: the
    resumed sweeps equal the uninterrupted ones bit for bit."""
    Y = northstar_network(T=2, n=16, seed=4)
    state, sweep, gen = uncolored_lsm(Y, 4, 5, n_resample=2)
    one = {k: v[0] for k, v in state_to_numpy(state).items()}
    rep = replicate_state(one, 4, 'cpu', shared=())
    assert rep.ctrl_out.shape == (4, 16, 5)
    assert torch.equal(rep.ctrl_out[3], state.ctrl_out[0])
    assert replicate_state(one, 4, 'cpu').ctrl_out.shape == (16, 5)

    state = sweep(state, gen)
    swapped = replica_exchange(
        sweep.cfg, torch.as_tensor(Y, dtype=torch.uint8),
        state.replace(temper=torch.tensor([1.0, 0.5, 1.0, 0.5])),
        torch.tensor([1, 0, 3, 2]), torch.full((4,), -1e9))
    assert torch.equal(swapped.X, state.X[[1, 0, 3, 2]])
    assert torch.equal(swapped.ctrl_out, state.ctrl_out)

    path = str(tmp_path / 'state.npz')
    checkpoint.save_state(path, state, gen)
    back, gen_state = checkpoint.load_state(path, 'cpu')
    assert back.ctrl_out.shape == (4, 16, 5)
    assert torch.equal(back.ctrl_out, state.ctrl_out)
    gen2 = torch.Generator().manual_seed(0)
    gen2.set_state(gen_state)
    for _ in range(3):
        state, back = sweep(state, gen), sweep(back, gen2)
    for name, v in state_to_numpy(state).items():
        np.testing.assert_array_equal(state_to_numpy(back)[name], v,
                                      err_msg=name)


# one sweep of 512 chains against JAX's by distribution

N_CHAINS, LEVEL, NK = 512, 1e-3, 12


def _ks_problem():
    rng = np.random.RandomState(0)
    Y = _net(rng, False, n=NK)
    f = np.float32
    X = jnp.asarray(rng.randn(T, NK, 2), f)
    b = jnp.asarray([1.0], f)
    ci, co = jcc.sample_control_nodes(jax.random.PRNGKey(1), jnp.asarray(Y),
                                      4, directed=False)
    s0 = JaxLSMState(
        key=jax.random.PRNGKey(0), it=jnp.zeros((), jnp.int32), X=X,
        intercept=b, radii=None, Y=None, step_X=jnp.full((T, NK), 0.3, f),
        acc_X=jnp.zeros((T, NK), f), step_int=jnp.full((1,), 0.1, f),
        acc_int=jnp.zeros((1,), f), step_radii=None, acc_radii=None,
        logp=jnp.zeros((), f), logp_map=jnp.full((), -1e30, f), X_map=X,
        intercept_map=b, radii_map=None, logp_ref=jnp.full((), -1e30, f),
        X_ref=X, missing_sum=None, ctrl_in=None, ctrl_out=co)
    return Y, s0


@pytest.fixture(scope='module')
def one_sweep_each():
    Y, s0 = _ks_problem()
    cfg = dict(n_burn=0, center=False, tau_sq=2.0, sigma_sq=0.1,
               n_control=4, n_resample_control=10)
    state = jax_replicate(s0, N_CHAINS, jax.random.PRNGKey(11))
    jax_static = {k: jnp.asarray(v)
                  for k, v in jcc.build_edge_lists(Y).items()}
    sweep = jax_make_lsm_sweep(jnp.asarray(Y), None, np.zeros(1, np.float32),
                               JaxSweepConfig(**cfg), cc_static=jax_static)
    jax_out = {k: np.asarray(v) for k, v in
               jax.jit(jax.vmap(sweep))(state)._asdict().items()
               if v is not None and k != 'key'}
    start = {k: np.asarray(v) for k, v in state._asdict().items()
             if v is not None and k != 'key'}
    port_sweep = sweeps.make_lsm_sweep(
        None, np.zeros(1, np.float32), sweeps.SweepConfig(**cfg),
        device='cpu', cc_static=uncolored_static(Y))
    gen = torch.Generator().manual_seed(12)
    port_out = state_to_numpy(port_sweep(state_from_numpy(start, 'cpu'),
                                         gen))
    return jax_out, port_out


def _summaries(d):
    return {'logp': d['logp'], 'intercept': d['intercept'][:, 0],
            'mean_X': d['X'].mean(axis=(1, 2, 3)),
            'acc_X': d['acc_X'].mean(axis=(1, 2)),
            'void_controls': (d['ctrl_out'] < 0).mean(axis=(1, 2))}


@pytest.mark.parametrize('name', ['logp', 'intercept', 'mean_X', 'acc_X',
                                  'void_controls'])
def test_one_uncolored_sweep_matches_jax_in_distribution(one_sweep_each,
                                                         name):
    jax_out, port_out = one_sweep_each
    assert port_out['ctrl_out'].shape == (N_CHAINS, NK, 4)
    a, b = _summaries(jax_out)[name], _summaries(port_out)[name]
    assert np.isfinite(a).all() and np.isfinite(b).all()
    assert np.std(a) > 0 and np.std(b) > 0
    p = stats.ks_2samp(a, b).pvalue
    assert p > LEVEL, '%s: KS p = %g (jax mean %g, port mean %g)' % (
        name, p, a.mean(), b.mean())
