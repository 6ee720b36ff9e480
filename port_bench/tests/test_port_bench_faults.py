"""The harness's run, its look for a card skipped, with the timed path
broken underneath: ``correct`` comes out false for each fault the cells
can have (one card: no exchange between chips to leave out)."""
import pytest
import torch

from dynetlsm_tpu_torch.math.distributions import normal
from dynetlsm_tpu_torch.mcmc import conjugate, sweeps
from dynetlsm_tpu_torch.ops import node_scan
from port_bench import core

from .helpers import tiny_run, tiny_spec


def _wrap_build(monkeypatch, wrap_sweep):
    build = core.build

    def broken(spec, seed, device):
        Y, net, state, sweep, gen = build(spec, seed, device)
        return Y, net, state, wrap_sweep(sweep), gen

    monkeypatch.setattr(core, 'build', broken)


def _unchanged(sweep):
    """A step that returns its state unchanged."""
    def step(state, gen):
        sweep(state, gen)
        return state
    return step


def _altered_site(sweep):
    """One position altered where the sweep produces it."""
    def step(state, gen):
        out = sweep(state, gen)
        X = out.X.clone()
        X[0, 1, 2, 0] += 0.25
        return out.replace(X=X)
    return step


def _altered_logp(sweep):
    """The recorded log joint of one chain altered."""
    def step(state, gen):
        out = sweep(state, gen)
        return out.replace(logp=out.logp + torch.tensor(
            [1.0] + [0.0] * (out.logp.shape[0] - 1)))
    return step


@pytest.mark.parametrize('fault', [_unchanged, _altered_site,
                                   _altered_logp])
def test_broken_sweep_is_not_correct(monkeypatch, fault):
    _wrap_build(monkeypatch, fault)
    result, lines = tiny_run(tiny_spec(n=40))
    assert not result['correct'], lines
    assert result['failed'] >= 1


def test_half_the_partners_left_out(monkeypatch):
    """Half of the batch left out, the mean taken over the rest: the
    latent update's partner sum from every other partner, doubled."""
    terms = node_scan._partial_loglik_terms

    def half(Y_row, X, x, b):
        out = terms(Y_row, X, x, b)
        keep = torch.zeros(out.shape[-1], dtype=out.dtype)
        keep[::2] = 2.0
        return out * keep
    monkeypatch.setattr(node_scan, '_partial_loglik_terms', half)
    result, lines = tiny_run(tiny_spec(n=40))
    assert not result['correct'], lines


def test_half_the_chains_left_out(monkeypatch):
    """Half of the batch left out: the latent update moves the first half
    of the chains and returns the rest as they were."""
    latent = sweeps.sample_latent_positions

    def half(gen, Y, X, *args, **kwargs):
        X_new, acc = latent(gen, Y, X, *args, **kwargs)
        h = X.shape[0] // 2
        X_new = torch.cat([X_new[:h], X[h:]])
        return X_new, torch.cat([acc[:h], torch.zeros_like(acc[h:])])
    monkeypatch.setattr(sweeps, 'sample_latent_positions', half)
    result, lines = tiny_run(tiny_spec(n=40))
    assert not result['correct'], lines


def test_case_control_controls_altered(monkeypatch):
    """The case-control sweep scores its sites on controls other than the
    draw its state records."""
    draw = sweeps.draw_controls

    def other(cfg, cc_static, it):
        return draw(cfg, cc_static, it + 1)
    monkeypatch.setattr(sweeps, 'draw_controls', other)
    result, lines = tiny_run(tiny_spec('hdp_ns_cc', n=40, n_control=8))
    assert not result['correct'], lines


# the fields the mixture blocks draw
MIXTURE = ('z', 'mu', 'sigma', 'lmbda', 'weights', 'beta', 'gamma',
           'alpha_init', 'alpha', 'kappa', 'mean_var', 'b_scale')


def _mixture_unchanged(sweep):
    """The mixture blocks skipped: every field they draw leaves the sweep
    as it entered."""
    def step(state, gen):
        out = sweep(state, gen)
        return out.replace(**{k: getattr(state, k) for k in MIXTURE})
    return step


def _generator_not_advanced(sweep):
    """A sweep that replays one random stream: the generator is put back
    to its state before the sweep."""
    def step(state, gen):
        saved = gen.get_state()
        out = sweep(state, gen)
        gen.set_state(saved)
        return out
    return step


@pytest.mark.parametrize('fault', [_mixture_unchanged,
                                   _generator_not_advanced])
def test_stale_sweep_is_not_correct(monkeypatch, fault):
    _wrap_build(monkeypatch, fault)
    result, lines = tiny_run(tiny_spec(n=40))
    assert not result['correct'], lines
    assert result['check']['stale']['value'] >= 1


def _labels_without_transitions(monkeypatch):
    """Labels drawn from a wrong conditional: the transitions ignored
    (uniform), so the emissions alone decide."""
    labels = sweeps.sample_labels_block

    def wrong(gen, X, mu, sigma, lmbda, weights):
        return labels(gen, X, mu, sigma, lmbda,
                      torch.ones_like(weights) / weights.shape[-1])
    monkeypatch.setattr(sweeps, 'sample_labels_block', wrong)


def _means_too_wide(monkeypatch):
    """The cluster means drawn at three times their conditional's
    deviation."""
    def wrong(gen, X, resp, nk, sigma, lmbda, mean_var):
        noise = 3.0 * normal(gen, sigma.shape + X.shape[-1:], X.device)
        return conjugate.cluster_means_from_draws(X, resp, nk, sigma, lmbda,
                                                  mean_var, noise)
    monkeypatch.setattr(sweeps, 'sample_cluster_means', wrong)


def _weights_too_concentrated(monkeypatch):
    """Every Dirichlet draw of the sweep from four times its
    concentrations."""
    dirichlet = sweeps.sample_dirichlet
    monkeypatch.setattr(sweeps, 'sample_dirichlet',
                        lambda gen, alphas: dirichlet(gen, 4.0 * alphas))


@pytest.mark.parametrize('fault', [_labels_without_transitions,
                                   _means_too_wide,
                                   _weights_too_concentrated])
def test_mixture_block_from_a_wrong_conditional(monkeypatch, fault):
    fault(monkeypatch)
    result, lines = tiny_run(tiny_spec(n=300, chains=16), seconds=0.1)
    assert not result['correct'], lines
    assert result['check']['mix_pit_z']['value'] > result['check'][
        'mix_pit_z']['limit']
