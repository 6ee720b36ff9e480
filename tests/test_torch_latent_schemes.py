"""The port's 'parallel' and 'mala' latent updates against the JAX
package's, on JAX's own draws.

Each JAX function draws its proposal from a key: ``_parallel_site_update``
splits it into (k_eps, k_u) and draws eps (T, n, d) and log_u (T, n);
``_mala_update`` draws eps (T, n, d) and one log-uniform.  The tests draw
the same numbers from the same keys, inject them into the port's
chain-batched functions and compare chain by chain: identical accepts,
positions within rtol 1e-5 (float32 sums in another order), and the MALA
target ``_joint_latent_logp`` and its gradient against
``jax.value_and_grad`` within rtol 1e-5.  Undirected and directed,
mixture and random-walk priors, untempered and tempered, the port's
network in the packed, row-padded form the sweeps pass; and 'parallel'
under the case-control likelihood.  Then the oracles of JAX
``tests/test_mala.py``, the schemes' errors and sweeps and fits that run
them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynetlsm_tpu.mcmc import latent as jl
from dynetlsm_tpu.mcmc.metropolis import tune_step_size_mala as jax_tune
from dynetlsm_tpu.ops import case_control as jcc
from dynetlsm_tpu_torch import DynamicNetworkHDPLPCM, DynamicNetworkLSM
from dynetlsm_tpu_torch.datasets import load_dynamic_monks
from dynetlsm_tpu_torch.entry import build_state_and_sweep
from dynetlsm_tpu_torch.mcmc import latent as pl
from dynetlsm_tpu_torch.mcmc.metropolis import (
    maybe_tune, tune_step_size_mala)
from dynetlsm_tpu_torch.ops import case_control as pcc
from dynetlsm_tpu_torch.ops.likelihoods import (
    directed_loglik_full, undirected_loglik_full)
from dynetlsm_tpu_torch.ops.distances import pairwise_distances
from dynetlsm_tpu_torch.ops.node_scan import pack_directed, pad_partners

T, N, K, C, D = 3, 14, 4, 3, 2
TAU_SQ, SIGMA_SQ = 2.0, 0.1
MODES = [(False, False), (False, True), (True, False), (True, True)]


def _network(rng, directed, p=0.3):
    Y = (rng.uniform(size=(T, N, N)) < p).astype(np.float32)
    if not directed:
        Y = np.triu(Y, 1)
        Y = Y + Y.transpose(0, 2, 1)
    for t in range(T):
        np.fill_diagonal(Y[t], 0.0)
    return Y


def _inputs(seed, directed, mixture, step=(0.05, 0.3)):
    rng = np.random.RandomState(seed)
    a = dict(Y=_network(rng, directed),
             X=rng.randn(C, T, N, D).astype(np.float32),
             step=rng.uniform(*step, (C, T, N)).astype(np.float32),
             b=(np.stack([rng.uniform(0.2, 0.8, C), rng.uniform(-0.3, 0.5, C)],
                         1) if directed else rng.uniform(-0.5, 1.0, (C, 1))
                ).astype(np.float32),
             radii=(rng.dirichlet(np.ones(N), size=C) * N / 3).astype(
                 np.float32),
             temper=np.geomspace(1.0, 0.3, C).astype(np.float32))
    if mixture:
        a.update(mu=rng.randn(C, K, D).astype(np.float32),
                 sigma=rng.uniform(0.5, 2.0, (C, K)).astype(np.float32),
                 lmbda=rng.uniform(0.6, 0.95, C).astype(np.float32),
                 z=rng.randint(0, K, (C, T, N)))
    return a


def _jax_prior(a, c, mixture):
    if mixture:
        return (None, None, jnp.asarray(a['mu'][c]),
                jnp.asarray(a['sigma'][c]), jnp.asarray(a['lmbda'][c]),
                jnp.asarray(a['z'][c], jnp.int32))
    return TAU_SQ, SIGMA_SQ, None, None, None, None


def _port_kw(a, directed, mixture, tempered):
    t = {k: torch.as_tensor(v) for k, v in a.items()}
    kw = dict(radii=t['radii'] if directed else None, is_directed=directed,
              mixture=mixture, temper=t['temper'] if tempered else None)
    if mixture:
        kw.update(mu=t['mu'], sigma=t['sigma'], lmbda=t['lmbda'],
                  z=t['z'].long())
    else:
        kw.update(tau_sq=TAU_SQ, sigma_sq=SIGMA_SQ)
    return t, kw


def _port_network(Y, directed):
    """The network as the sweeps pass it: uint8, packed when directed, its
    rows padded for the node scan."""
    Y8 = torch.as_tensor(Y).to(torch.uint8)
    return pad_partners(pack_directed(Y8) if directed else Y8)


def _keys(seed):
    return [jax.random.PRNGKey(1000 * seed + c) for c in range(C)]


def _parallel_draws(key):
    k_eps, k_u = jax.random.split(key)
    eps = jax.random.normal(k_eps, (T, N, D), jnp.float32)
    log_u = jnp.log(jax.random.uniform(k_u, (T, N), jnp.float32))
    return np.asarray(eps), np.asarray(log_u)


def _mala_draws(key):
    k_eps, k_u = jax.random.split(key)
    eps = jax.random.normal(k_eps, (T, N, D), jnp.float32)
    log_u = jnp.log(jax.random.uniform(k_u, (), jnp.float32))
    return np.asarray(eps), np.asarray(log_u)


def _compare(X_p, acc_p, X_j, acc_j):
    """Identical accepts, some taken and some not, and positions within
    rtol 1e-5."""
    np.testing.assert_array_equal(acc_p.numpy(), acc_j)
    assert 0.0 < acc_j.mean() < 1.0
    np.testing.assert_allclose(X_p.numpy(), X_j, rtol=1e-5, atol=1e-6)


def _run_jax(fn, a, directed, mixture, tempered, cc=None):
    Xs, accs = [], []
    for c, key in enumerate(_keys(a['seed'])):
        extra = {} if cc is None else dict(cc=cc)
        X, acc = fn(key, jnp.asarray(a['Y']), jnp.asarray(a['X'][c]),
                    jnp.asarray(a['b'][c]), jnp.asarray(a['step'][c]),
                    jnp.asarray(a['radii'][c]) if directed else None,
                    *_jax_prior(a, c, mixture), directed, mixture,
                    temper=(jnp.asarray(a['temper'][c]) if tempered
                            else None), **extra)
        Xs.append(np.asarray(X))
        accs.append(np.asarray(acc))
    return np.stack(Xs), np.stack(accs)


def _check_parallel(directed, mixture, tempered):
    seed = 1 + 4 * directed + 2 * mixture + tempered
    a = dict(_inputs(seed, directed, mixture), seed=seed)
    draws = [_parallel_draws(k) for k in _keys(seed)]
    t, kw = _port_kw(a, directed, mixture, tempered)
    X_p, acc_p = pl._parallel_site_update(
        None, _port_network(a['Y'], directed), t['X'], t['b'], t['step'],
        eps=torch.as_tensor(np.stack([e for e, _ in draws])),
        log_u=torch.as_tensor(np.stack([u for _, u in draws])), **kw)
    X_j, acc_j = _run_jax(jl._parallel_site_update, a, directed, mixture,
                          tempered)
    _compare(X_p, acc_p, X_j, acc_j)


def _check_mala(directed, mixture, tempered):
    # a joint move of every site: chain 0's small steps accept, chain 2's
    # large ones do not
    seed = 11 + 4 * directed + 2 * mixture + tempered
    a = dict(_inputs(seed, directed, mixture, step=(0.5, 1.0)), seed=seed)
    a['step'] *= np.array([0.02, 0.1, 2.0], np.float32)[:, None, None]
    draws = [_mala_draws(k) for k in _keys(seed)]
    t, kw = _port_kw(a, directed, mixture, tempered)
    X_p, acc_p = pl._mala_update(
        None, _port_network(a['Y'], directed), t['X'], t['b'], t['step'],
        eps=torch.as_tensor(np.stack([e for e, _ in draws])),
        log_u=torch.as_tensor(np.stack([u for _, u in draws])), **kw)
    X_j, acc_j = _run_jax(jl._mala_update, a, directed, mixture, tempered)
    assert acc_p.shape == (C, T, N)
    _compare(X_p, acc_p, X_j, acc_j)


def _check_joint(directed, mixture, tempered):
    seed = 21 + 4 * directed + 2 * mixture + tempered
    a = _inputs(seed, directed, mixture)
    a['X'][0, :, 1] = a['X'][0, :, 0]        # a coincident pair
    t, kw = _port_kw(a, directed, mixture, tempered)
    logp, grad = pl._joint_value_and_grad(
        t['X'], Y=_port_network(a['Y'], directed), intercept=t['b'], **kw)
    for c in range(C):
        prior = _jax_prior(a, c, mixture)

        def f(Xq):
            return jl._joint_latent_logp(
                jnp.asarray(a['Y']), Xq, jnp.asarray(a['b'][c]),
                jnp.asarray(a['radii'][c]) if directed else None, *prior,
                directed, mixture,
                temper=(jnp.asarray(a['temper'][c]) if tempered else None))
        v, g = jax.value_and_grad(f)(jnp.asarray(a['X'][c]))
        np.testing.assert_allclose(float(logp[c]), float(v), rtol=1e-5)
        np.testing.assert_allclose(grad[c].numpy(), np.asarray(g),
                                   rtol=1e-5, atol=1e-4)
    assert torch.isfinite(grad).all()


@pytest.mark.parametrize('tempered', [False, True])
@pytest.mark.parametrize('directed, mixture', MODES)
def test_parallel_site_update_matches_jax(directed, mixture, tempered):
    _check_parallel(directed, mixture, tempered)


@pytest.mark.parametrize('tempered', [False, True])
@pytest.mark.parametrize('directed, mixture', MODES)
def test_mala_update_matches_jax(directed, mixture, tempered):
    _check_mala(directed, mixture, tempered)


@pytest.mark.parametrize('tempered', [False, True])
@pytest.mark.parametrize('directed, mixture', MODES)
def test_joint_latent_logp_and_gradient_match_jax(directed, mixture,
                                                  tempered):
    _check_joint(directed, mixture, tempered)


# forced block sizes in dyads: one site a block, five sites (rows cut
# mid-field), two chains' whole fields
BLOCKS = [1, 5 * N, 2 * T * N * N]
CHECKS = {'parallel': _check_parallel, 'mala': _check_mala,
          'joint': _check_joint}


@pytest.mark.parametrize('block_elems', BLOCKS)
@pytest.mark.parametrize('check', sorted(CHECKS))
@pytest.mark.parametrize('directed, mixture', MODES)
def test_schemes_in_site_blocks_match_jax(monkeypatch, directed, mixture,
                                          check, block_elems):
    """The three parity checks above, tempered, with the dense passes cut
    into many blocks of (chains, times, sites): the same inputs and
    tolerances."""
    monkeypatch.setattr(pl, '_BLOCK_ELEMS', block_elems)
    assert len(pl._site_blocks(C, T, N)) > 1
    CHECKS[check](directed, mixture, True)


@pytest.mark.parametrize('shape', [(3, 3, 14), (2, 5, 9), (1, 1, 1),
                                   (4, 2, 7)])
@pytest.mark.parametrize('block_elems', [1, 6, 30, 81, 200, 1 << 26])
def test_site_blocks_cover_each_site_once(monkeypatch, shape, block_elems):
    """Each (chain, time, site) in exactly one block, a block at most
    ``_BLOCK_ELEMS`` dyads or one site; one block where the whole field
    fits."""
    monkeypatch.setattr(pl, '_BLOCK_ELEMS', block_elems)
    C_, T_, n = shape
    seen = np.zeros(shape, int)
    blocks = pl._site_blocks(C_, T_, n)
    for c, t, r in blocks:
        seen[c, t, r] += 1
        dyads = ((c.stop - c.start) * (t.stop - t.start)
                 * (r.stop - r.start) * n)
        assert dyads <= block_elems or r.stop - r.start == 1
    assert (seen == 1).all()
    assert (len(blocks) == 1) == (C_ * T_ * n * n <= block_elems)


def _cc_structures(Y, directed, seed, m=5):
    """(the JAX cc dict, the port's): the JAX host lists, colouring and
    control draw, the masks of each package."""
    lists_h = jcc.build_edge_lists(Y)
    colors, groups = jcc.color_conflict_graph(lists_h, N, seed=seed)
    ci, co = jcc.sample_controls_colored(jax.random.PRNGKey(seed),
                                         jnp.asarray(colors), N, m,
                                         directed=directed)
    lists = {k: jnp.asarray(v) for k, v in lists_h.items()}
    civ, cov = jcc.control_masks(ci, co, lists, directed)
    jc = dict(lists, ctrl_out=co, ctrl_out_valid=cov)
    if directed:
        jc.update(ctrl_in=ci, ctrl_in_valid=civ)
    plists = {k: torch.as_tensor(v).long() for k, v in lists_h.items()}
    pci = None if ci is None else torch.as_tensor(np.array(ci)).long()
    pco = torch.as_tensor(np.array(co)).long()
    pciv, pcov = pcc.control_masks(pci, pco, plists, directed)
    pc = dict(plists, ctrl_in=pci, ctrl_out=pco, ctrl_in_valid=pciv,
              ctrl_out_valid=pcov)
    return jc, pc


@pytest.mark.parametrize('directed', [False, True])
def test_parallel_site_update_case_control_matches_jax(directed):
    """'parallel' under the case-control likelihood: every node's terms by
    ``approx_partial_loglik_all`` (the port's in node blocks), tempered,
    with the mixture prior."""
    seed = 31 + directed
    a = dict(_inputs(seed, directed, True), seed=seed)
    jc, pc = _cc_structures(a['Y'], directed, seed)
    draws = [_parallel_draws(k) for k in _keys(seed)]
    t, kw = _port_kw(a, directed, True, True)
    X_p, acc_p = pl._parallel_site_update(
        None, None, t['X'], t['b'], t['step'], cc=pc,
        eps=torch.as_tensor(np.stack([e for e, _ in draws])),
        log_u=torch.as_tensor(np.stack([u for _, u in draws])), **kw)
    X_j, acc_j = _run_jax(jl._parallel_site_update, a, directed, True, True,
                          cc=jc)
    _compare(X_p, acc_p, X_j, acc_j)


@pytest.mark.parametrize('directed', [False, True])
def test_approx_partial_loglik_all_in_node_blocks(monkeypatch, directed):
    """Node blocks of any size give the one-block values (within float32
    rounding: a sum's vector path depends on the block's shape): each
    node's terms are its own."""
    a = _inputs(41 + directed, directed, False)
    _, pc = _cc_structures(a['Y'], directed, 41 + directed)
    t = {k: torch.as_tensor(v) for k, v in a.items()}
    Xq = t['X'] + 0.1
    args = (t['X'], Xq, pc, t['b'], t['radii'] if directed else None,
            directed)
    want = pcc.approx_partial_loglik_all(*args)
    monkeypatch.setattr(pcc, '_BLOCK_ELEMS', 1)
    torch.testing.assert_close(pcc.approx_partial_loglik_all(*args), want,
                               rtol=1e-6, atol=1e-5)


# ---- the oracles of JAX tests/test_mala.py --------------------------------


def test_mala_gradient_safe_at_coincident_positions():
    """JAX test_mala.py:53: two nodes at the same position keep the joint
    gradient finite and the update usable."""
    rng = np.random.RandomState(0)
    X = rng.randn(1, 2, 8, D).astype(np.float32)
    X[:, :, 1] = X[:, :, 0]
    Y = (rng.uniform(size=(2, 8, 8)) < 0.4).astype(np.float32)
    Y = np.triu(Y, 1)
    Y = Y + Y.transpose(0, 2, 1)
    Yt = torch.as_tensor(Y).to(torch.uint8)
    kw = dict(Y=Yt, intercept=torch.tensor([[0.5]]), tau_sq=1.0,
              sigma_sq=0.1, mixture=False)
    _, g = pl._joint_value_and_grad(torch.as_tensor(X), **kw)
    assert torch.isfinite(g).all()
    gen = torch.Generator().manual_seed(0)
    X_new, acc = pl.sample_latent_positions(
        gen, Yt, torch.as_tensor(X), torch.tensor([[0.5]]),
        torch.full((1, 2, 8), 0.05), tau_sq=1.0, sigma_sq=0.1,
        mixture=False, scheme='mala')
    assert torch.isfinite(X_new).all() and acc.shape == (1, 2, 8)


def test_mala_joint_logp_matches_sweep_terms():
    """JAX test_mala.py:77: the MALA target is the network log-likelihood
    plus the joint random-walk prior, as the sweep's own pieces give
    them."""
    rng = np.random.RandomState(2)
    X = torch.as_tensor(rng.randn(1, 3, 12, D).astype(np.float32))
    Y = (rng.uniform(size=(3, 12, 12)) < 0.4).astype(np.float32)
    Y = np.triu(Y, 1)
    Y = torch.as_tensor(Y + Y.transpose(0, 2, 1))
    tau_sq, sigma_sq = 2.0, 0.15
    got = float(pl._joint_latent_logp(Y.to(torch.uint8), X,
                                      torch.tensor([[0.3]]), tau_sq=tau_sq,
                                      sigma_sq=sigma_sq, mixture=False)[0])
    ll = float(undirected_loglik_full(Y, pairwise_distances(X[0]), 0.3))
    prior = float(-0.5 * torch.sum(X[0, 0] ** 2) / tau_sq
                  - 0.5 * torch.sum((X[0, 1:] - X[0, :-1]) ** 2) / sigma_sq)
    assert np.isclose(got, ll + prior, rtol=1e-5)


def test_mala_rejects_case_control_and_bad_scheme():
    """JAX test_mala.py:99, with JAX's messages; and neither scheme takes
    the exact scan's injected noise."""
    X = torch.zeros((1, 2, 10, D))
    Y = torch.zeros((2, 10, 10), dtype=torch.uint8)
    step = torch.full((1, 2, 10), 0.1)
    b = torch.zeros((1, 1))
    kw = dict(tau_sq=1.0, sigma_sq=1.0, mixture=False)
    with pytest.raises(ValueError, match='case-control'):
        pl.sample_latent_positions(None, Y, X, b, step, cc={'dummy': 1},
                                   scheme='mala', **kw)
    with pytest.raises(ValueError, match='latent_update'):
        pl.sample_latent_positions(None, Y, X, b, step,
                                   scheme='hamiltonian', **kw)
    noise = (torch.zeros((1, 2, 10, 2, D)), torch.zeros((1, 2, 10, 2)))
    for scheme in ('parallel', 'mala'):
        with pytest.raises(ValueError, match='cannot be honoured'):
            pl.sample_latent_positions(None, Y, X, b, step, noise=noise,
                                       scheme=scheme, **kw)


def test_mala_tuner_moves_toward_band():
    """JAX test_mala.py:114, and the schedule equal to JAX's at every
    branch; ``maybe_tune(kind='mala')`` applies it when the window
    closes."""
    s = torch.tensor(1.0)
    assert float(tune_step_size_mala(s, torch.tensor(0.1))) < 1.0
    assert float(tune_step_size_mala(s, torch.tensor(0.9))) > 1.0
    assert float(tune_step_size_mala(s, torch.tensor(0.55))) == 1.0
    rates = np.array([0.0, 0.0005, 0.1, 0.2, 0.3, 0.45, 0.55, 0.7, 0.8,
                      0.95, 0.99], np.float32)
    got = tune_step_size_mala(torch.ones(rates.shape), torch.as_tensor(rates))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_tune(jnp.ones(rates.shape), rates)))
    step, acc = maybe_tune(torch.tensor([99, 98]), 1000, 100,
                           torch.ones((2, 3)), torch.full((2, 3), 10.0),
                           kind='mala')
    assert torch.equal(step, torch.tensor([[0.5] * 3, [1.0] * 3]))
    assert torch.equal(acc, torch.tensor([[0.0] * 3, [10.0] * 3]))


def test_mala_directed_joint_logp_and_fit():
    """JAX test_mala.py:137: the directed target is the directed network
    log-likelihood plus the random-walk prior, and a directed MALA fit
    runs finite."""
    rng = np.random.RandomState(6)
    X = torch.as_tensor(rng.randn(1, 2, 12, D).astype(np.float32))
    Y = (rng.uniform(size=(2, 12, 12)) < 0.3).astype(np.float32)
    for t in range(2):
        np.fill_diagonal(Y[t], 0.0)
    radii = torch.as_tensor(rng.uniform(0.5, 1.5, 12).astype(np.float32))
    b = torch.tensor([[0.4, -0.1]])
    Y8 = torch.as_tensor(Y).to(torch.uint8)
    got = float(pl._joint_latent_logp(
        pack_directed(Y8), X, b, radii[None], tau_sq=2.0, sigma_sq=0.1,
        is_directed=True, mixture=False)[0])
    ll = float(directed_loglik_full(torch.as_tensor(Y),
                                    pairwise_distances(X[0]), radii, 0.4,
                                    -0.1))
    prior = float(-0.5 * torch.sum(X[0, 0] ** 2) / 2.0
                  - 0.5 * torch.sum((X[0, 1:] - X[0, :-1]) ** 2) / 0.1)
    assert np.isclose(got, ll + prior, rtol=1e-5)
    m = DynamicNetworkLSM(n_iter=60, tune=60, burn=60, is_directed=True,
                          latent_update='mala', random_state=2,
                          device='cpu').fit(
                              load_dynamic_monks(is_directed=True))
    assert np.isfinite(m.logps_).all() and m.auc_ > 0.6


def test_mala_mixture_joint_logp_oracle():
    """JAX test_mala.py:168: the mixture target is the network
    log-likelihood plus the AR(1)-to-cluster-mean prior (without the
    X-free -0.5 log sigma_z terms, which cancel in the ratio)."""
    rng = np.random.RandomState(8)
    X = rng.randn(3, 10, D).astype(np.float32)
    Y = (rng.uniform(size=(3, 10, 10)) < 0.4).astype(np.float32)
    Y = np.triu(Y, 1)
    Y = Y + Y.transpose(0, 2, 1)
    z = rng.randint(0, K, size=(3, 10))
    mu = rng.randn(K, D).astype(np.float32)
    sigma = rng.uniform(0.5, 1.5, size=K).astype(np.float32)
    lam = 0.85
    got = float(pl._joint_latent_logp(
        torch.as_tensor(Y).to(torch.uint8), torch.as_tensor(X)[None],
        torch.tensor([[0.3]]), mu=torch.as_tensor(mu)[None],
        sigma=torch.as_tensor(sigma)[None],
        lmbda=torch.tensor([lam]), z=torch.as_tensor(z)[None],
        mixture=True)[0])
    ll = float(undirected_loglik_full(torch.as_tensor(Y),
                                      pairwise_distances(torch.as_tensor(X)),
                                      0.3))
    mu_z, sig_z = mu[z], sigma[z]
    prior = -0.5 * np.sum(((X[0] - mu_z[0]) ** 2).sum(-1) / sig_z[0])
    dft = X[1:] - (1 - lam) * X[:-1] - lam * mu_z[1:]
    prior -= 0.5 * np.sum((dft ** 2).sum(-1) / sig_z[1:])
    assert np.isclose(got, ll + prior, rtol=1e-4)


# ---- the schemes in sweeps and fits ---------------------------------------


@pytest.mark.parametrize('scheme', ['parallel', 'mala'])
@pytest.mark.parametrize('model', ['hdp', 'lpcm', 'lsm'])
@pytest.mark.parametrize('directed', [False, True])
def test_sweeps_run_the_scheme(directed, model, scheme):
    """Each model's sweep, undirected and directed, runs the scheme
    (``build_state_and_sweep(..., latent_update=)``): finite logp, moves
    accepted; MALA accepts a chain's whole field or none of it, so each
    chain's acceptance count is one number over its sites."""
    Y = load_dynamic_monks(is_directed=directed)
    state, sweep, gen = build_state_and_sweep(
        Y, 4, K=3, model=model, is_directed=directed, device='cpu',
        latent_update=scheme)
    assert sweep.cfg.latent_update == scheme
    for _ in range(3):
        state = sweep(state, gen)
    assert torch.isfinite(state.logp).all()
    acc = state.acc_X
    assert float(acc.sum()) > 0
    if scheme == 'mala':
        assert torch.equal(acc, acc[:, :1, :1].expand_as(acc))
    else:
        assert float(acc.std()) > 0


def test_tempered_and_case_control_sweeps():
    """A tempered MALA step (the ladder's temperatures scale the joint
    likelihood) and a case-control 'parallel' sweep run; MALA refuses
    case-control with JAX's message."""
    Y = load_dynamic_monks()
    state, pt_step, gen = build_state_and_sweep(
        Y, 8, K=3, n_temps=4, device='cpu', latent_update='mala')
    for _ in range(2):
        state = pt_step(state, gen)
    assert torch.isfinite(state.logp).all()
    state, sweep, gen = build_state_and_sweep(
        Y, 4, K=3, n_control=6, device='cpu', latent_update='parallel')
    for _ in range(2):
        state = sweep(state, gen)
    assert torch.isfinite(state.logp).all() and float(state.acc_X.sum()) > 0
    state, sweep, gen = build_state_and_sweep(
        Y, 4, K=3, n_control=6, device='cpu', latent_update='mala')
    with pytest.raises(ValueError, match='case-control'):
        sweep(state, gen)


def test_mala_hdp_fit_runs(monkeypatch):
    """JAX test_mala.py:43 at the Sampson shape: an HDP-LPCM fit with
    latent_update='mala' (a short nested LSM) runs finite."""
    from dynetlsm_tpu_torch.models import mixture_base
    init = mixture_base.init_from_lsm

    def short(*args, **kw):
        kw['lsm_kwargs'] = dict(n_iter=20, tune=10, burn=10)
        return init(*args, **kw)
    monkeypatch.setattr(mixture_base, 'init_from_lsm', short)
    m = DynamicNetworkHDPLPCM(n_iter=40, tune=40, burn=40, n_components=4,
                              random_state=3, latent_update='mala',
                              device='cpu').fit(load_dynamic_monks())
    assert np.isfinite(m.logps_).all() and m.auc_ > 0.6
