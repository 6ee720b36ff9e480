"""Missing-dyad resampling in the port (dynetlsm_tpu_torch) against the JAX
package, on NumPy-seeded inputs.

* ``validate_network`` and the imputer: outputs identical to JAX's on
  -1- and NaN-coded networks, undirected and directed; the Geyer ESS to
  rtol 1e-12.
* ``resample_missing`` on JAX's own uniforms (``jax.random.uniform`` from
  the key handed to JAX's ``_resample_missing``): the same network dyad for
  dyad, except where |u - p| < 1e-6 (expit in another library), undirected,
  directed and tempered (beta = 0.3).
* The kernels' plain versions with one network a chain: the node scan's
  accepts identical to ``xla_exact_scan`` vmapped over the chains' networks
  on an injected proposal stream, the log-likelihoods to rtol 1e-5.
* One HDP-LPCM sweep with missing dyads over 512 chains against JAX's by
  two-sample KS tests at level 1e-3 (fixed seeds), the missing dyads' edge
  density among the marginals; the replica swap moves ``Y`` with the
  configuration on JAX's replayed uniforms and leaves ``missing_sum``.
* Tests marked ``cuda`` hold each kernel with one network a chain to its
  plain version on the card.
"""
import numpy as np
import pytest
import torch
from scipy import stats

import jax
import jax.numpy as jnp

from dynetlsm_tpu import diagnostics as jdiag
from dynetlsm_tpu.imputer import SimpleNetworkImputer as JaxImputer
from dynetlsm_tpu.mcmc import tempering as jtemp
from dynetlsm_tpu.mcmc.driver import replicate_state as jax_replicate
from dynetlsm_tpu.mcmc.latent import xla_exact_scan
from dynetlsm_tpu.mcmc.sweeps import (
    SweepConfig as JaxSweepConfig, _resample_missing as jax_resample,
    make_hdp_sweep as jax_make_hdp_sweep)
from dynetlsm_tpu.models.base import validate_network as jax_validate
from dynetlsm_tpu.ops import likelihoods as jlik
from dynetlsm_tpu.ops.distances import (
    pairwise_distances as jax_pairwise_distances)

from dynetlsm_tpu_torch import diagnostics as tdiag
from dynetlsm_tpu_torch.entry import build_state_and_sweep
from dynetlsm_tpu_torch.imputer import SimpleNetworkImputer
from dynetlsm_tpu_torch.mcmc import tempering as ttemp
from dynetlsm_tpu_torch.mcmc.driver import replicate_state
from dynetlsm_tpu_torch.mcmc.states import state_from_numpy, state_to_numpy
from dynetlsm_tpu_torch.mcmc.sweeps import (
    SweepConfig, make_hdp_sweep, make_lsm_sweep, missing_dyads,
    resample_missing)
from dynetlsm_tpu_torch.models.base import validate_network
from dynetlsm_tpu_torch.ops.dir_loglik import (
    dir_loglik, dir_loglik_cuda, dir_loglik_plain)
from dynetlsm_tpu_torch.ops.likelihoods import directed_network_probas
from dynetlsm_tpu_torch.ops.node_scan import (
    node_scan_cuda, node_scan_plain, pack_directed, site_cluster_params)
from dynetlsm_tpu_torch.ops.pair_loglik import (
    pair_loglik, pair_loglik_cuda, pair_loglik_plain)

from tests.test_torch_sweep import CFG as HDP_CFG
from tests.test_torch_sweep import _problem as hdp_problem
from tests.test_torch_tempering import (
    N_TEMPS, _to_numpy, _trusted, swap_problem)

T, N, D, K = 3, 10, 2, 3
NEAR = 1e-6
RTOL = 1e-5
LEVEL = 1e-3


def _coded_network(seed, directed, n=N, frac=0.25):
    """A 0/1 network with a ``frac`` of its dyads coded -1, a few of them
    NaN instead, and some diagonal entries -1 (never missing)."""
    rng = np.random.RandomState(seed)
    Y = rng.binomial(1, 0.3, (T, n, n)).astype(np.float64)
    Y[:, np.arange(n), np.arange(n)] = 0.0
    if not directed:
        Y = np.triu(Y, 1)
        Y = Y + Y.transpose(0, 2, 1)
    Y[rng.uniform(size=Y.shape) < frac] = -1.0
    Y[rng.uniform(size=Y.shape) < 0.03] = np.nan
    Y[0, 0, 0] = -1.0
    return Y


# ---------------------------------------------------------------------------
# host-side modules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('directed', [False, True])
def test_validate_network_matches_jax(directed):
    Y = _coded_network(1 + directed, directed)
    got = validate_network(Y, directed)
    want = jax_validate(Y, directed)
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got[3] is want[3] is True
    miss = got[2]
    assert not miss[:, np.arange(N), np.arange(N)].any()
    if not directed:
        assert (miss == miss.transpose(0, 2, 1)).all()
    assert not validate_network(np.nan_to_num(np.abs(Y)), directed)[3]


@pytest.mark.parametrize('strategy', ['random', 'most_frequent'])
@pytest.mark.parametrize('directed', [False, True])
def test_imputer_matches_jax(directed, strategy):
    Y = validate_network(_coded_network(3 + directed, directed), directed)[0]
    for seed in (123, 7):
        got = SimpleNetworkImputer(strategy=strategy, random_state=seed)
        want = JaxImputer(strategy=strategy, random_state=seed)
        np.testing.assert_array_equal(got.fit_transform(Y),
                                      want.fit_transform(Y))
        np.testing.assert_array_equal(got.statistics_, want.statistics_)
    rs = np.random.RandomState(5)
    np.testing.assert_array_equal(
        SimpleNetworkImputer(strategy='random',
                             random_state=rs).fit_transform(Y),
        JaxImputer(strategy='random',
                   random_state=np.random.RandomState(5)).fit_transform(Y))


def test_effective_n_geyer_matches_jax():
    rng = np.random.RandomState(0)
    series = [rng.randn(500), np.zeros(50), np.arange(30.0)]
    for phi in (0.3, 0.9, -0.5):
        x = np.zeros(800)
        for i in range(1, 800):
            x[i] = phi * x[i - 1] + rng.randn()
        series.append(x)
    for x in series:
        for maxlags in (10, 100, 200):
            got = tdiag.effective_n_geyer(x, maxlags=maxlags)
            want = jdiag.effective_n_geyer(x, maxlags=maxlags)
            np.testing.assert_allclose(got, want, rtol=1e-12)
            np.testing.assert_allclose(
                tdiag.autocorrelation(x, maxlags),
                jdiag.autocorrelation(x, maxlags), rtol=1e-12, atol=0)


def test_directed_network_probas_matches_jax():
    rng = np.random.RandomState(4)
    X = rng.randn(T, N, D).astype(np.float32)
    radii = rng.dirichlet(np.ones(N)).astype(np.float32)
    dist = jax_pairwise_distances(jnp.asarray(X))
    want = jlik.directed_network_probas(dist, jnp.asarray(radii), 0.4, -0.3)
    got = directed_network_probas(torch.as_tensor(np.array(dist)),
                                  torch.as_tensor(radii), 0.4, -0.3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)
    assert not got[:, np.arange(N), np.arange(N)].any()


# ---------------------------------------------------------------------------
# the resample on JAX's uniforms
# ---------------------------------------------------------------------------

def _resample_inputs(seed, C, directed):
    """Per-chain filled networks (C, T, n, n), their shared mask, positions,
    intercepts and radii."""
    rng = np.random.RandomState(seed)
    Yc, _, miss, _ = validate_network(_coded_network(seed, directed),
                                      directed)
    # the coded diagonal is not missing: it reads 0
    Y = np.broadcast_to(np.maximum(Yc, 0.0), (C, T, N, N)).copy()
    fill = rng.binomial(1, 0.5, Y.shape)
    if not directed:
        fill = np.triu(fill, 1)
        fill = fill + np.swapaxes(fill, -1, -2)
    Y = np.where(miss, fill, Y).astype(np.float32)
    X = rng.randn(C, T, N, D).astype(np.float32)
    if directed:
        b = (np.array([0.5, 0.3]) + 0.3 * rng.randn(C, 2)).astype(np.float32)
        radii = rng.dirichlet(np.ones(N), size=C).astype(np.float32) * 4.0
    else:
        b = (0.5 + rng.randn(C, 1)).astype(np.float32)
        radii = np.ones((C, N), np.float32)
    return Y, miss, X, b, radii


@pytest.mark.parametrize('tempered', [False, True])
@pytest.mark.parametrize('directed', [False, True])
def test_resample_matches_jax_on_its_uniforms(directed, tempered):
    C = 6
    Y, miss, X, b, radii = _resample_inputs(20 + directed, C, directed)
    temper = np.full(C, 0.3, np.float32) if tempered else None
    cfg_j = JaxSweepConfig(is_directed=directed, sample_missing=True)
    keys = jax.random.split(jax.random.PRNGKey(9), C)
    dist = jax.vmap(jax_pairwise_distances)(jnp.asarray(X))
    beta = jnp.asarray(temper if tempered else np.ones(C, np.float32))

    def one(key, Yc, dc, bc, rc, tc):
        return jax_resample(cfg_j, key, Yc, dc, bc,
                            rc if directed else None, jnp.asarray(miss),
                            temper=tc if tempered else None)

    want = np.asarray(jax.vmap(one)(keys, jnp.asarray(Y), dist,
                                    jnp.asarray(b), jnp.asarray(radii),
                                    beta))
    u = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (T, N, N)))(keys))
    cfg_t = SweepConfig(is_directed=directed, sample_missing=True)
    f = torch.as_tensor
    got = resample_missing(
        cfg_t, None, f(Y).to(torch.uint8), f(X), f(b),
        f(radii) if directed else None, missing_dyads(f(miss), directed),
        temper=f(temper) if tempered else None, u=f(u)).numpy()
    # the probabilities in float64, to mark the near-ties
    d = np.asarray(dist, np.float64)
    if directed:
        eta = (b[:, 0, None, None, None] * (1 - d / radii[:, None, None, :])
               + b[:, 1, None, None, None]
               * (1 - d / radii[:, None, :, None]))
    else:
        eta = b[:, 0, None, None, None] - d
    beta64 = np.asarray(beta, np.float64)[:, None, None, None]
    p = 1.0 / (1.0 + np.exp(-(beta64 * eta)))
    near = np.abs(u - p) < NEAR
    if not directed:
        near = np.triu(near, 1)
        near = near | np.swapaxes(near, -1, -2)
    assert got.dtype == np.uint8
    assert near.mean() < 1e-3
    np.testing.assert_array_equal(got[~near], want[~near])
    np.testing.assert_array_equal(got[:, ~miss], Y[:, ~miss])
    assert (got[:, miss] != Y[:, miss]).any()
    assert not got[..., np.arange(N), np.arange(N)].any()
    if not directed:
        np.testing.assert_array_equal(got, np.swapaxes(got, -1, -2))


def test_resample_draws_from_the_generator():
    """Without ``u`` the draw comes from the generator: two calls from the
    same seed agree, two seeds differ, and only missing dyads move."""
    Y, miss, X, b, _ = _resample_inputs(30, 4, False)
    cfg = SweepConfig(sample_missing=True)
    args = (torch.as_tensor(Y).to(torch.uint8), torch.as_tensor(X),
            torch.as_tensor(b), None,
            missing_dyads(torch.as_tensor(miss), False))
    a = resample_missing(cfg, torch.Generator().manual_seed(1), *args)
    again = resample_missing(cfg, torch.Generator().manual_seed(1), *args)
    other = resample_missing(cfg, torch.Generator().manual_seed(2), *args)
    assert torch.equal(a, again) and not torch.equal(a, other)
    assert torch.equal(a[:, ~torch.as_tensor(miss)],
                       args[0][:, ~torch.as_tensor(miss)])


# ---------------------------------------------------------------------------
# the kernels' plain versions with one network a chain
# ---------------------------------------------------------------------------

def _chain_networks(rng, C, n, directed):
    Y = rng.binomial(1, rng.uniform(0.1, 0.4, (C, 1, 1, 1)),
                     (C, T, n, n)).astype(np.float32)
    Y[..., np.arange(n), np.arange(n)] = 0.0
    if not directed:
        Y = np.triu(Y, 1)
        Y = Y + np.swapaxes(Y, -1, -2)
    return Y


@pytest.mark.parametrize('mixture', [False, True])
@pytest.mark.parametrize('directed', [False, True])
def test_node_scan_plain_per_chain_matches_jax(directed, mixture):
    """The plain scan with one network a chain against ``xla_exact_scan``
    vmapped over the chains' networks, on one injected proposal stream:
    identical accepts, positions to atol 1e-6."""
    C, n = 4, 24
    rng = np.random.RandomState(40 + 2 * directed + mixture)
    a = dict(Y=_chain_networks(rng, C, n, directed),
             X=rng.randn(C, T, n, D).astype(np.float32),
             step=np.full((C, T, n), 0.05 if directed else 0.3, np.float32),
             eps=rng.randn(C, 2, n, T, D).astype(np.float32),
             log_u=np.log(rng.rand(C, 2, n, T)).astype(np.float32),
             mu=rng.randn(C, K, D).astype(np.float32),
             sig=(rng.rand(C, K) + 0.3).astype(np.float32),
             z=rng.randint(0, K, (C, T, n)),
             lmbda=np.full(C, 0.8, np.float32),
             radii=rng.dirichlet(np.ones(n), size=C).astype(np.float32))
    a['b'] = ((np.array([0.4, 0.8]) + 0.1 * rng.randn(C, 2)) if directed
              else 1.0 + 0.2 * rng.randn(C)).astype(np.float32)

    def one(Y, X, b, step, eps, log_u, mu, sig, z, lmbda, r):
        kw = (dict(mu=mu, sigma=sig, z=z, lmbda=lmbda, mixture=True)
              if mixture else dict(tau_sq=2.0, sigma_sq=0.1, mixture=False))
        return xla_exact_scan(Y, X, b if directed else b[None], step, eps,
                              log_u, radii=r if directed else None,
                              is_directed=directed, **kw)

    jX, jacc = jax.jit(jax.vmap(one))(
        *(jnp.asarray(a[k]) for k in ('Y', 'X', 'b', 'step', 'eps', 'log_u',
                                      'mu', 'sig')),
        jnp.asarray(a['z'], jnp.int32), jnp.asarray(a['lmbda']),
        jnp.asarray(a['radii']))
    t = {k: torch.as_tensor(v) for k, v in a.items()}
    Y8 = t['Y'].to(torch.uint8)
    Yk = pack_directed(Y8) if directed else Y8
    prior = (dict(zip(('mu_z', 'sig_z'), site_cluster_params(
        t['mu'], t['sig'], t['z'])), lmbda=t['lmbda']) if mixture
        else dict(tau_sq=2.0, sigma_sq=0.1, mixture=False))
    X, acc = node_scan_plain(Yk, t['X'], t['b'], t['step'], t['eps'],
                             t['log_u'],
                             radii=t['radii'] if directed else None, **prior)
    assert 0.0 < float(acc.mean()) < 1.0
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
    np.testing.assert_allclose(X.numpy(), np.asarray(jX), atol=1e-6)
    # a shared network broadcast to every chain gives the shared scan
    shared = node_scan_plain(Yk[0], t['X'], t['b'], t['step'], t['eps'],
                             t['log_u'],
                             radii=t['radii'] if directed else None, **prior)
    same = node_scan_plain(Yk[:1].expand(C, -1, -1, -1), t['X'], t['b'],
                           t['step'], t['eps'], t['log_u'],
                           radii=t['radii'] if directed else None, **prior)
    assert torch.equal(shared[0], same[0]) and torch.equal(shared[1],
                                                           same[1])


@pytest.mark.parametrize('directed', [False, True])
def test_plain_logliks_per_chain_match_jax(directed):
    """``pair_loglik_plain`` (two intercepts) and ``dir_loglik_plain`` (three
    candidates) with one network a chain against JAX's dense
    ``undirected_loglik_pair`` / ``directed_loglik_full`` vmapped over the
    chains' networks, rtol 1e-5; the dispatchers take the plain versions on
    CPU tensors."""
    C, n = 5, 37
    rng = np.random.RandomState(50 + directed)
    Y = _chain_networks(rng, C, n, directed)
    X = rng.randn(C, T, n, D).astype(np.float32)
    dist = jax.vmap(jax_pairwise_distances)(jnp.asarray(X))
    Y8 = torch.as_tensor(Y).to(torch.uint8)
    if directed:
        radii = (0.5 + rng.rand(C, 3, n)).astype(np.float32)
        b = (0.3 + 0.5 * rng.randn(C, 3, 2)).astype(np.float32)
        want = np.stack([np.asarray(jax.vmap(jlik.directed_loglik_full)(
            jnp.asarray(Y), dist, jnp.asarray(radii[:, k]),
            jnp.asarray(b[:, k, 0]), jnp.asarray(b[:, k, 1])))
            for k in range(3)], axis=-1)
        args = (pack_directed(Y8), torch.as_tensor(X),
                torch.as_tensor(radii), torch.as_tensor(b))
        got = dir_loglik_plain(*args)
        assert torch.equal(dir_loglik(*args), got)
    else:
        b = rng.randn(C, 2).astype(np.float32)
        cur, prop = jax.vmap(jlik.undirected_loglik_pair)(
            jnp.asarray(Y), dist, jnp.asarray(b[:, 0]), jnp.asarray(b[:, 1]))
        want = np.stack([np.asarray(cur), np.asarray(prop)], axis=-1)
        args = (Y8, torch.as_tensor(X), torch.as_tensor(b[:, 0]),
                torch.as_tensor(b[:, 1]))
        got = pair_loglik_plain(*args)
        assert torch.equal(pair_loglik(*args), got)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)


# ---------------------------------------------------------------------------
# one HDP-LPCM sweep with missing dyads, against JAX by distribution
# ---------------------------------------------------------------------------

N_CHAINS = 512


@pytest.fixture(scope='module')
def missing_sweep_each():
    """One JAX and one port HDP-LPCM sweep with a quarter of the dyads
    missing, from one replicated state."""
    Y, s0 = hdp_problem()
    rng = np.random.RandomState(3)
    Yc = Y.astype(np.float64)
    lost = np.triu(rng.uniform(size=Y.shape) < 0.25, 1)
    Yc[lost | np.swapaxes(lost, 1, 2)] = -1.0
    miss = validate_network(Yc, False)[2]
    Y0 = np.where(miss, Y, Yc).astype(np.float32)
    s0 = s0._replace(Y=jnp.asarray(Y0), missing_sum=jnp.zeros_like(Y0))
    cfg = dict(HDP_CFG, sample_missing=True)
    state = jax_replicate(s0, N_CHAINS, jax.random.PRNGKey(11))
    sweep = jax_make_hdp_sweep(None, jnp.asarray(miss),
                               np.zeros(1, np.float32), JaxSweepConfig(**cfg))
    jax_out = _to_numpy(jax.jit(jax.vmap(sweep))(state))
    start = _to_numpy(state)
    port_sweep = make_hdp_sweep(Yc, np.zeros(1, np.float32),
                                SweepConfig(**cfg), device='cpu')
    assert port_sweep.Y is None
    assert torch.equal(port_sweep.miss_mask, torch.as_tensor(miss))
    port_out = state_to_numpy(port_sweep(
        state_from_numpy(start, 'cpu'), torch.Generator().manual_seed(12)))
    return start, jax_out, port_out, miss


def _missing_summaries(d, miss):
    return {'intercept': d['intercept'][:, 0], 'logp': d['logp'],
            'lmbda': d['lmbda'], 'acc_X': d['acc_X'].mean(axis=(1, 2)),
            'missing_density': d['Y'][:, miss].astype(np.float64).mean(-1)}


@pytest.mark.parametrize('name', ['intercept', 'logp', 'lmbda', 'acc_X',
                                  'missing_density'])
def test_one_missing_sweep_matches_jax_in_distribution(missing_sweep_each,
                                                       name):
    start, jax_out, port_out, miss = missing_sweep_each
    assert port_out['Y'].dtype == np.uint8
    np.testing.assert_array_equal(port_out['Y'][:, ~miss],
                                  start['Y'][:, ~miss])
    a = _missing_summaries(jax_out, miss)[name]
    b = _missing_summaries(port_out, miss)[name]
    assert np.std(a) > 0 and np.std(b) > 0
    p = stats.ks_2samp(a, b).pvalue
    assert p > LEVEL, '%s: KS p = %g (jax mean %g, port mean %g)' % (
        name, p, a.mean(), b.mean())


def test_missing_sweep_state_and_sum(missing_sweep_each):
    """The state carries JAX's fields: Y (uint8 in the port, JAX's float
    0/1), and ``missing_sum`` zero before burn-in is over (``n_burn`` = 0:
    the first sweep counts) and equal to the draw on the mask."""
    start, jax_out, port_out, miss = missing_sweep_each
    assert set(port_out) == set(jax_out)
    for d in (jax_out, port_out):
        np.testing.assert_array_equal(d['missing_sum'][:, ~miss], 0.0)
        np.testing.assert_array_equal(d['missing_sum'][:, miss],
                                      d['Y'][:, miss])
    back = state_to_numpy(state_from_numpy(jax_out, 'cpu'))
    np.testing.assert_array_equal(back['Y'], jax_out['Y'])
    assert back['Y'].dtype == np.uint8


def test_missing_sum_waits_for_burn_in():
    """``missing_sum`` adds a chain's draws only once its sweep count
    passes ``n_burn``."""
    Yc = _coded_network(8, False)
    state, sweep, gen = build_state_and_sweep(Yc, 4, device='cpu',
                                              model='lsm')
    assert sweep.cfg.sample_missing and sweep.cfg.n_burn == 0
    lsm = make_lsm_sweep(Yc, np.zeros(1, np.float32),
                         SweepConfig(sample_missing=True, n_burn=2),
                         device='cpu')
    state = state.replace(it=torch.tensor([0, 1, 2, 5]))
    out = lsm(state, gen)
    miss = torch.as_tensor(validate_network(Yc, False)[2])
    assert not out.missing_sum[:2].any()
    assert torch.equal(out.missing_sum[2:, miss], out.Y[2:, miss].float())


# ---------------------------------------------------------------------------
# the replica swap moves the network
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('it0, beta_min', [(0, 0.97), (1, 1.0)])
def test_swap_moves_the_network_with_the_configuration(it0, beta_min):
    """One swap of each package (identity sweeps, JAX's uniforms replayed)
    on slots with differing networks, directed LSM, each partner phase
    (close rungs; equal ones, where every pair swaps): the swap scores each
    slot on its own network, ``Y`` moves with the configuration as in JAX,
    and ``missing_sum`` stays with its slot."""
    _, _, _, _, prior, jstate, d = swap_problem('lsm directed')
    C = d['X'].shape[0]
    rng = np.random.RandomState(60 + it0)
    Y = _chain_networks(rng, C, d['X'].shape[2], True)
    miss = np.ones(Y.shape[1:], bool)
    miss[:, np.arange(Y.shape[2]), np.arange(Y.shape[2])] = False
    temper = (np.ones(C, np.float32) if beta_min == 1.0 else
              np.asarray(jtemp.temper_ladder(N_TEMPS, beta_min, 2)))
    d = dict(d, Y=Y, missing_sum=rng.rand(*Y.shape).astype(np.float32),
             it=np.full(C, it0, np.int32), temper=temper)
    jstate = jstate._replace(**{k: jnp.asarray(d[k]) for k in
                                ('Y', 'missing_sum', 'it', 'temper')})
    cfg = dict(is_directed=True, sample_missing=True, n_burn=0,
               center=False, tau_sq=2.0, sigma_sq=0.1)
    cfg_j, cfg_t = JaxSweepConfig(**cfg), SweepConfig(**cfg)
    jpt = jtemp.make_pt_step(lambda s, it: s, cfg_j, None, N_TEMPS)
    jax_out = _to_numpy(jax.jit(jpt)(jstate))
    u = jax.random.uniform(jax.random.fold_in(jstate.key[0], 0x7e3a), (C,))
    log_u = np.log(np.asarray(u))
    tpt = ttemp.make_pt_step(lambda s, gen: s, cfg_t, None, N_TEMPS)
    port_state = state_from_numpy(d, 'cpu')
    ll = ttemp.swap_loglik(cfg_t, None, port_state).numpy()
    ll_dense = np.asarray(jax.vmap(
        lambda Yc, X, b, r: jlik.directed_loglik_full(
            Yc, jax_pairwise_distances(X), r, b[0], b[1]))(
        *(jnp.asarray(d[k]) for k in ('Y', 'X', 'intercept', 'radii'))))
    np.testing.assert_allclose(ll, ll_dense, rtol=RTOL)
    port_out = state_to_numpy(tpt(port_state, None,
                                  log_u=torch.as_tensor(log_u)))
    partner = np.asarray(jtemp._swap_partners(C, N_TEMPS)[it0 % 2])
    ok, _ = _trusted(d, log_u, ll_dense, partner)
    assert ok.sum() >= C - 2
    moved = ~np.all(jax_out['Y'] == d['Y'], axis=(1, 2, 3))
    assert moved[ok].any()
    assert 'Y' in ttemp._SWAP_FIELDS and 'missing_sum' not in \
        ttemp._SWAP_FIELDS
    for k in ('Y', 'X', 'intercept', 'radii', 'logp'):
        np.testing.assert_array_equal(port_out[k][ok], jax_out[k][ok],
                                      err_msg=k)
    np.testing.assert_array_equal(port_out['missing_sum'], d['missing_sum'])
    np.testing.assert_array_equal(jax_out['missing_sum'], d['missing_sum'])


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('model', ['hdp', 'lpcm', 'lsm'])
@pytest.mark.parametrize('directed', [False, True])
def test_entry_takes_a_coded_network(directed, model):
    """``build_state_and_sweep`` on a -1/NaN-coded network: every chain
    starts from the imputer's fill (JAX's random imputation, the same
    draws) on the missing dyads and the observed dyads elsewhere, and two
    sweeps (tempered for the HDP) keep the observed dyads, resample the
    missing ones and carry a finite logp."""
    Yc = _coded_network(70 + directed, directed)
    Yv, _, miss, _ = jax_validate(Yc, directed)
    n_temps = 2 if model == 'hdp' else None
    state, step, gen = build_state_and_sweep(
        Yc, 4, K=3, device='cpu', is_directed=directed, model=model,
        n_temps=n_temps)
    fill = JaxImputer(strategy='random').fit_transform(Yv)
    want = np.where(miss, fill, Yv)
    want[:, np.arange(N), np.arange(N)] = 0.0
    np.testing.assert_array_equal(state.Y.numpy(),
                                  np.broadcast_to(want, (4, T, N, N)))
    assert not state.missing_sum.any()
    Y0 = state.Y.clone()
    for _ in range(2):
        state = step(state, gen)
    obs = torch.as_tensor(~miss)
    assert torch.equal(state.Y[:, obs], Y0[:, obs])
    assert bool(torch.isfinite(state.logp).all())
    assert torch.equal(state.missing_sum[:, ~obs] > 0,
                       state.missing_sum[:, ~obs] > 0)
    assert not state.missing_sum[:, obs].any()
    if not directed:
        assert torch.equal(state.Y, state.Y.transpose(-1, -2))


def test_fixed_network_path_is_unchanged():
    """A network without missing dyads keeps the fixed-network sweep: no
    ``Y`` or ``missing_sum`` in the state and the stored network on the
    sweep."""
    Yc = np.nan_to_num(np.abs(_coded_network(80, False)))
    Yc[Yc > 1] = 1.0
    state, sweep, _ = build_state_and_sweep(Yc, 2, K=3, device='cpu')
    assert state.Y is None and state.missing_sum is None
    assert not sweep.cfg.sample_missing and sweep.Y is not None
    with pytest.raises(ValueError, match='sample_missing'):
        make_hdp_sweep(_coded_network(80, False), np.zeros(1, np.float32),
                       SweepConfig(n_components=3), device='cpu')


def test_replicate_state_gives_each_chain_its_network():
    Y0 = np.eye(4, dtype=np.float32)[None].repeat(2, 0)
    s = replicate_state({'it': 0, 'X': np.zeros((2, 4, 2)), 'intercept': [1.],
                         'z': np.zeros((2, 4), int), 'mu': np.zeros((2, 2)),
                         'sigma': np.ones(2), 'lmbda': 0.9, 'mean_var': 1.,
                         'b_scale': 1., 'step_X': np.ones((2, 4)),
                         'acc_X': np.zeros((2, 4)), 'step_int': [0.1],
                         'acc_int': [0.], 'logp': 0., 'Y': Y0}, 3, 'cpu')
    assert s.Y.dtype == torch.uint8 and s.Y.shape == (3, 2, 4, 4)
    assert s.missing_sum.dtype == torch.float32 and not s.missing_sum.any()
    s.Y[0, 0, 0, 1] = 1
    assert s.Y[1, 0, 0, 1] == 0


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernels have no CPU mode')
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('mixture', [False, True])
@pytest.mark.parametrize('directed', [False, True])
def test_node_scan_kernel_per_chain_matches_plain_on_card(directed, mixture):
    """Needs an NVIDIA card with nvcc: the node-scan kernel with one
    network a chain against its plain version (identical accepts and
    positions), and a per-chain network whose chains all equal the shared
    one gives the shared launch's bits."""
    dev = _card()
    C, n = 6, 45
    rng = np.random.RandomState(90 + 2 * directed + mixture)
    Y8 = torch.as_tensor(_chain_networks(rng, C, n, directed),
                         device=dev).to(torch.uint8)
    Yk = pack_directed(Y8) if directed else Y8
    f = dict(dtype=torch.float32, device=dev)
    X = torch.as_tensor(rng.randn(C, T, n, D), **f)
    b = torch.as_tensor(rng.randn(C, 2) if directed else rng.randn(C), **f)
    step = torch.full((C, T, n), 0.2, **f)
    eps = torch.as_tensor(rng.randn(C, 2, n, T, D), **f)
    log_u = torch.as_tensor(np.log(rng.rand(C, 2, n, T)), **f)
    radii = torch.as_tensor(0.5 + rng.rand(C, n), **f) if directed else None
    mu_z, sig_z = site_cluster_params(
        torch.as_tensor(rng.randn(C, K, D), **f),
        torch.as_tensor(rng.rand(C, K) + 0.3, **f),
        torch.as_tensor(rng.randint(0, K, (C, T, n)), device=dev))
    prior = (dict(mu_z=mu_z, sig_z=sig_z, lmbda=torch.full((C,), 0.8, **f))
             if mixture else dict(mixture=False, tau_sq=2.0, sigma_sq=0.1))
    args = (X, b, step, eps, log_u)
    got = node_scan_cuda(Yk, *args, radii=radii, **prior)
    want = node_scan_plain(Yk, *args, radii=radii, **prior)
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    shared = node_scan_cuda(Yk[0], *args, radii=radii, **prior)
    same = node_scan_cuda(Yk[:1].expand(C, -1, -1, -1).contiguous(), *args,
                          radii=radii, **prior)
    assert torch.equal(shared[0], same[0]) and torch.equal(shared[1],
                                                           same[1])


@pytest.mark.cuda
@pytest.mark.parametrize('n', [45, 76])
@pytest.mark.parametrize('directed', [False, True])
def test_loglik_kernels_per_chain_match_plain_on_card(directed, n):
    """Needs an NVIDIA card with nvcc: each log-likelihood kernel with one
    network a chain (bytes at n = 45, 32-bit words at n = 76) against its
    plain version, rtol 1e-5, bit-identical on rerun; all chains equal to
    the shared network give the shared launch's bits."""
    dev = _card()
    C = 5
    rng = np.random.RandomState(95 + n + directed)
    Y8 = torch.as_tensor(_chain_networks(rng, C, n, directed),
                         device=dev).to(torch.uint8)
    f = dict(dtype=torch.float32, device=dev)
    X = torch.as_tensor(rng.randn(C, T, n, D), **f)
    if directed:
        kernel, plain = dir_loglik_cuda, dir_loglik_plain
        rest = (torch.as_tensor(0.5 + rng.rand(C, 3, n), **f),
                torch.as_tensor(0.3 + 0.5 * rng.randn(C, 3, 2), **f))
        Yk = pack_directed(Y8)
    else:
        kernel, plain = pair_loglik_cuda, pair_loglik_plain
        b = torch.as_tensor(rng.randn(C), **f)
        rest = (b, b + 0.3)
        Yk = Y8
    got = kernel(Yk, X, *rest)
    again = kernel(Yk, X, *rest)
    torch.testing.assert_close(got, plain(Yk, X, *rest), rtol=RTOL, atol=0.0)
    assert torch.equal(got, again)
    same = Yk[:1].expand(C, -1, -1, -1).contiguous()
    assert torch.equal(kernel(same, X, *rest), kernel(Yk[0], X, *rest))


def test_missing_dyads_run_without_jax():
    """The port's missing-dyad path imports no jax: with jax blocked, a
    -1-coded network goes through ``validate_network``, the imputer and
    two sweeps of each model, and the Geweke and diagnostics modules
    import."""
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['dynetlsm_tpu'] = None\n"
        "import numpy as np\n"
        "from dynetlsm_tpu_torch import diagnostics, geweke, imputer\n"
        "from dynetlsm_tpu_torch.datasets import (\n"
        "    load_dynamic_monks, with_missing_dyads)\n"
        "from dynetlsm_tpu_torch.entry import build_state_and_sweep\n"
        "for model in ('hdp', 'lpcm', 'lsm'):\n"
        "    for directed in (False, True):\n"
        "        Y = with_missing_dyads(load_dynamic_monks(directed), 0.2,\n"
        "                               seed=1, directed=directed)\n"
        "        state, sweep, gen = build_state_and_sweep(\n"
        "            Y, 4, K=3, device='cpu', is_directed=directed,\n"
        "            model=model)\n"
        "        state = sweep(sweep(state, gen), gen)\n"
        "        assert sweep.cfg.sample_missing, model\n"
        "        assert bool(state.logp.isfinite().all()), model\n"
        "assert not any(m == 'jax' or m.startswith('jax.')\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=root)
    proc = subprocess.run([sys.executable, '-c', code], cwd=root, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith('ok')
