"""The plain reference against the port on the CPU at a tiny size, and the
control (the reference in TF32 in the program's place) failing the limits
the program keeps."""
import numpy as np
import torch

from dynetlsm_tpu_torch.mcmc.sweeps import SweepConfig, hdp_logp_at_state
from port_bench import core
from port_bench.reference import mixture
from port_bench.reference.hdp_lpcm import (
    Arith, DenseLik, log_joint, network_loglik, tf32_round)

from .helpers import tiny_run, tiny_spec


def test_tf32_round_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      -3.0 - 2 ** -12], dtype=torch.float32)
    got = tf32_round(x).tolist()
    # ties go to the even mantissa
    assert got == [1.0 + 2 ** -10, 1.0, 1.0 + 2 ** -9, -3.0]


def _random_state(C=3, T=4, n=12, K=4, d=2, seed=0):
    rng = np.random.RandomState(seed)
    w = rng.dirichlet(np.ones(K), size=(C, T, K))
    w[:, 0] = 0.0
    w[:, 0, 0] = rng.dirichlet(np.ones(K), size=C)
    f = {'X': rng.randn(C, T, n, d), 'intercept': rng.randn(C, 1),
         'z': rng.randint(0, K, size=(C, T, n)), 'mu': rng.randn(C, K, d),
         'sigma': rng.uniform(0.5, 2.0, (C, K)),
         'lmbda': rng.uniform(0.6, 0.99, C),
         'mean_var': rng.uniform(0.5, 2.0, C),
         'b_scale': rng.uniform(0.5, 2.0, C), 'weights': w,
         'beta': rng.dirichlet(np.ones(K), size=C),
         'gamma': rng.uniform(0.5, 2.0, C),
         'alpha_init': rng.uniform(0.5, 2.0, C),
         'alpha': rng.uniform(0.5, 2.0, C),
         'kappa': rng.uniform(0.5, 5.0, C)}
    return {k: torch.as_tensor(v, dtype=torch.int64 if k == 'z'
                               else torch.float32) for k, v in f.items()}


def test_log_joint_matches_the_port():
    spec = core.load_spec('hdp_ns_exact')
    sw, K = spec['config']['sweep'], 4
    s = _random_state(K=K)
    rng = np.random.RandomState(1)
    Y = np.triu(rng.binomial(1, 0.3, size=(4, 12, 12)), 1)
    Y = torch.as_tensor(Y + Y.transpose(0, 2, 1), dtype=torch.uint8)
    cfg = SweepConfig(n_components=K, a0=sw['a0'], b0=sw['b0'],
                      c0=sw['c0'], d0=sw['d0'])
    port = hdp_logp_at_state(cfg, Y, np.zeros(1, np.float32), s['X'],
                             s['intercept'], s['z'], s['mu'], s['sigma'],
                             s['lmbda'], s['weights'], s['beta'], s['gamma'],
                             s['alpha_init'], s['alpha'], s['kappa'],
                             s['mean_var'], s['b_scale'])
    ref, mag = log_joint(Arith('float64'), DenseLik(Y), s, sw, K)
    np.testing.assert_allclose(port.double().numpy(), ref.numpy(),
                               rtol=2e-6)
    # the control's log joint is the same quantity in TF32
    ctl, _ = log_joint(Arith('tf32'), DenseLik(Y), s, sw, K)
    np.testing.assert_allclose(ctl.double().numpy(), ref.numpy(),
                               rtol=5e-3)


def test_network_loglik_counts_each_dyad_once():
    X = torch.zeros((1, 1, 3, 2))
    Y = torch.zeros((1, 3, 3), dtype=torch.uint8)
    Y[0, 0, 1] = Y[0, 1, 0] = 1
    ll = network_loglik(Arith('float64'), DenseLik(Y), X,
                        torch.zeros((1, 1)))
    # three dyads at eta = 0: one edge, two non-edges, each -log 2
    assert float(ll[0, 0]) == np.float64(-3 * np.log(2.0))


def test_tiny_run_is_correct():
    result, lines = tiny_run(tiny_spec(n=40))
    assert result['correct'], lines
    assert result['check']['mh_gap']['value'] == 0.0
    assert list(result)[-1] == 'check'


def test_tiny_parallel_run_is_correct():
    result, lines = tiny_run(tiny_spec(n=40, scheme='parallel'))
    assert result['correct'], lines


def test_the_control_fails_where_the_program_passes():
    spec = tiny_spec(n=150, chains=8, start='random')
    torch.set_num_threads(2)
    limits = core.load_spec('hdp_ns_exact')['params']['check']['limits']
    judge = core.reference(spec).judge_capture
    for seed in (1, 2):
        _, capture = core.measure(spec, seed, 0.05, False,
                                  torch.device('cpu'), 0.0)
        program = judge(spec, capture, capture['seeds'], 'cpu')
        control = judge(spec, capture, capture['seeds'], 'cpu',
                        control=True)
        assert all(float(program[k].max()) <= v for k, v in limits.items())
        assert any(float(control[k].max()) > v for k, v in limits.items())


def test_tiny_case_control_run_is_correct():
    """The chromatic scan's decisions, the controls redrawn at sweep 100
    and the case-control log joint, against the reference."""
    spec = tiny_spec('hdp_ns_cc', n=40, n_control=8)
    spec['params'] = dict(spec['params'], chunk=10, burn_in=100)
    result, lines = tiny_run(spec, seconds=0.3)
    assert result['correct'], lines


def _mixture_state(C=6, T=4, n=60, K=4, seed=3):
    """A state and positions for the mixture conditionals, on the CPU."""
    s = _random_state(C=C, T=T, n=n, K=K, seed=seed)
    return {k: v.double() if v.is_floating_point() else v
            for k, v in s.items()}


def test_draws_from_the_reference_conditionals_score_as_uniform():
    """The labels and means drawn from the reference's own conditionals,
    and Dirichlet rows from their laws, score as standard normal; the
    same draws from a wrong law do not."""
    rng = np.random.default_rng(5)
    s = _mixture_state()
    z = mixture.draw_labels(s['X'], s['mu'], s['sigma'], s['lmbda'],
                            s['weights'], rng)
    v = torch.as_tensor(rng.random(z.shape))
    u, score = mixture.label_pits(s['X'], s['mu'], s['sigma'], s['lmbda'],
                                  s['weights'], z, v)
    assert max(mixture.pit_scores(u)) < 5 and abs(score) < 5
    flat = torch.ones_like(s['weights']) / s['weights'].shape[-1]
    z_bad = mixture.draw_labels(s['X'], s['mu'], s['sigma'], s['lmbda'],
                                flat, rng)
    _, bad = mixture.label_pits(s['X'], s['mu'], s['sigma'], s['lmbda'],
                                s['weights'], z_bad, v)
    assert bad < score
    mean, var = mixture.mean_conditional(s['X'], s['z'], s['sigma'],
                                         s['lmbda'], s['mean_var'])
    draw = mean + torch.sqrt(var)[..., None] * torch.as_tensor(
        rng.standard_normal(mean.shape))
    u = torch.special.ndtr((draw - mean) / torch.sqrt(var)[..., None])
    assert max(mixture.pit_scores(u)) < 5
    conc = torch.as_tensor(rng.uniform(0.6, 30.0, (400, 6)))
    w = mixture.draw_dirichlet(conc, rng)
    assert max(mixture.pit_scores(mixture.dirichlet_pits(w, conc))) < 5
    w = mixture.draw_dirichlet(4.0 * conc, rng)
    assert max(mixture.pit_scores(mixture.dirichlet_pits(w, conc))) > 8


def test_the_port_draws_its_variances_from_the_reference_conditional():
    """The port's variance and hyper-parameter draws on a fixed state,
    scored by the reference's conditionals, over many draws."""
    from dynetlsm_tpu_torch.mcmc import conjugate
    from dynetlsm_tpu_torch.mcmc.labels import _label_statistics
    s = _mixture_state(C=200, K=4)
    spec = core.load_spec('hdp_ns_exact')
    sw = spec['config']['sweep']
    f32 = {k: v.float() if v.is_floating_point() else v for k, v in s.items()}
    _, nk, resp = _label_statistics(s['z'], 4)
    gen = torch.Generator().manual_seed(9)
    sigma = conjugate.sample_cluster_variances(
        gen, f32['X'], resp, nk, f32['mu'], f32['lmbda'], sw['a'],
        f32['b_scale'])
    shape, scale = mixture.variance_conditional(
        s['X'], s['z'], s['mu'], s['lmbda'], sw['a'], s['b_scale'])
    u = torch.special.gammaincc(shape, scale / sigma.double())
    assert max(mixture.pit_scores(u)) < 5


def test_lambda_on_a_bound_is_not_scored_or_stale():
    """A lambda whose conditional lies past 1 sits on the bound's margin
    sweep after sweep: it is neither scored nor counted stale."""
    s = _mixture_state(C=4, K=3)
    X = s['X'].clone()
    # every step pulls fully toward its mean: lambda's conditional far
    # past 1 at a small deviation
    mu_z = s['mu'][torch.arange(4)[:, None, None], s['z']]
    for t in range(1, X.shape[1]):
        X[:, t] = X[:, t - 1] + 3.0 * (mu_z[:, t] - X[:, t - 1])
    after = dict(s, lmbda=torch.full((4,), 1.0 - 1e-6, dtype=torch.float64))
    u = mixture.hyper_pits(X, s['z'], s, after, core.load_spec(
        'hdp_ns_exact')['config']['sweep'])
    assert u.numel() == 8
    from port_bench.reference.hdp_undirected import stale_fields
    gens = (torch.tensor([0]), torch.tensor([1]), torch.tensor([2]))
    before = dict(after, X=s['X'] + 1.0)
    assert stale_fields(before, after, gens).tolist() == [10.0] * 4
