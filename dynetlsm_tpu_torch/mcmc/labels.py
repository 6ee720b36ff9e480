"""Blocked HMM label sampling, forward-filter backward-sample (counterpart
of ``dynetlsm_tpu/mcmc/labels.py``), chain-batched.

The recursion over T is a Python loop of batched (C, K, K) @ (C, K, n)
matmuls; the forward pass draws every node's label per time with one
Gumbel-argmax (``torch.argmax`` takes the first index on ties, as
``jnp.argmax`` does).
"""
import torch

from ..config import LOG_GUARD, SMALL_EPS
from ..math.distributions import gumbel
from ..ops.emissions import emission_likelihoods_kn, emission_logliks_kn
from ..tracing import traced


def _backward_messages(lik, w):
    """lik (C, T, K, n) emission likelihoods; w (C, T, K, K) transitions
    (w[:, t] for the t-1 -> t step).  Returns the partial marginals
    pm (C, T, K, n) = lik[:, t] * bwds_msg[:, t], bwds_msg[:, T-1] = 1
    (reference sample_labels.py:164-170)."""
    T = lik.shape[1]
    bwds = torch.ones_like(lik[:, 0])
    pm = [None] * T
    for t in range(T - 1, 0, -1):
        pm[t] = lik[:, t] * bwds
        b = torch.matmul(w[:, t], pm[t])
        bwds = b / torch.clamp_min(torch.sum(b, dim=1, keepdim=True),
                                   SMALL_EPS)
    pm[0] = lik[:, 0] * bwds
    return torch.stack(pm, dim=1)


def _forward_sample_from_gumbel(pm, w0, w, g):
    """Labels forward in time from the partial marginals pm (C, T, K, n),
    initial weights w0 (C, K), transitions w (C, T, K, K) and Gumbel
    noise g (C, T, K, n) (reference sample_labels.py:173-188).
    Returns z (C, T, n) int64."""
    C, T, K, n = pm.shape
    logits0 = torch.log(torch.clamp_min(w0[:, :, None] * pm[:, 0],
                                        SMALL_EPS))
    z_t = torch.argmax(logits0 + g[:, 0], dim=1)
    zs = [z_t]
    for t in range(1, T):
        # w[t, z_prev, :] for every node, (C, n, K) -> (C, K, n)
        rows = torch.gather(w[:, t], 1, z_t[:, :, None].expand(C, n, K))
        probas = rows.transpose(1, 2) * pm[:, t]
        logits = torch.log(torch.clamp_min(probas, SMALL_EPS))
        z_t = torch.argmax(logits + g[:, t], dim=1)
        zs.append(z_t)
    return torch.stack(zs, dim=1)


def _forward_sample(gen, pm, w0, w):
    return _forward_sample_from_gumbel(pm, w0, w,
                                       gumbel(gen, pm.shape, pm.device))


def _label_statistics(z, K):
    """(n_trans (C, T, K, K), nk (C, T, K), resp (C, T, n, K)) from labels
    z (C, T, n); n_trans[:, 0, 0] holds the initial counts (reference
    sample_labels.py:146-152)."""
    C, T, n = z.shape
    resp = torch.nn.functional.one_hot(z, K).to(torch.float32)
    nk = torch.sum(resp, dim=2)
    trans = torch.einsum('ctij,ctik->ctjk', resp[:, :-1], resp[:, 1:])
    init = torch.zeros((C, 1, K, K), dtype=torch.float32, device=z.device)
    init[:, 0, 0] = nk[:, 0]
    return torch.cat([init, trans], dim=1), nk, resp


@traced
def sample_labels_block(gen, X, mu, sigma, lmbda, weights):
    """Blocked FFBS with time-inhomogeneous transitions.  weights
    (C, T, K, K), weights[:, 0, 0] the initial distribution.
    Returns (z, n_trans, nk, resp)."""
    K = sigma.shape[-1]
    lik = emission_likelihoods_kn(X, mu, sigma, lmbda, normalize=True)
    pm = _backward_messages(lik, weights)
    z = _forward_sample(gen, pm, weights[:, 0, 0], weights)
    n_trans, nk, resp = _label_statistics(z, K)
    return z, n_trans, nk, resp


@traced
def sample_labels_block_lpcm(gen, X, mu, sigma, lmbda, init_weights,
                             trans_weights):
    """Blocked FFBS with one time-constant transition matrix (LPCM,
    reference sample_labels.py:73-131).  init_weights (C, K);
    trans_weights (C, K, K), broadcast over T.
    Returns (z, n_trans, nk, resp)."""
    C, T = X.shape[:2]
    K = sigma.shape[-1]
    w = trans_weights[:, None].expand(C, T, K, K)
    lik = emission_likelihoods_kn(X, mu, sigma, lmbda, normalize=True)
    pm = _backward_messages(lik, w)
    z = _forward_sample(gen, pm, init_weights, w)
    n_trans, nk, resp = _label_statistics(z, K)
    return z, n_trans, nk, resp


def labels_gibbs_from_gumbel(X, mu, sigma, lmbda, w0, w, g):
    """Labels drawn forward in time, each site from its emission
    likelihood times the transition from its previous label, with no
    backward messages (reference sample_labels.py:22-70): X (C, T, n, d),
    mu (C, K, d), sigma (C, K), lmbda (C,), w0 (C, K) the initial
    distribution, w (C, K, K) the transitions, g (C, T, n, K) Gumbel
    noise.  Returns z (C, T, n) int64."""
    C, T, n, _ = X.shape
    K = sigma.shape[-1]
    loglik = emission_logliks_kn(X, mu, sigma, lmbda).transpose(2, 3)
    logits = torch.log(w0 + LOG_GUARD)[:, None, :] + loglik[:, 0]
    z_t = torch.argmax(logits + g[:, 0], dim=-1)
    zs = [z_t]
    for t in range(1, T):
        rows = torch.gather(w, 1, z_t[:, :, None].expand(C, n, K))
        logits = torch.log(rows + LOG_GUARD) + loglik[:, t]
        z_t = torch.argmax(logits + g[:, t], dim=-1)
        zs.append(z_t)
    return torch.stack(zs, dim=1)


def sample_labels_gibbs(gen, X, mu, sigma, lmbda, w0, w):
    """Per-site forward label sampling (JAX ``sample_labels_gibbs``, kept
    for parity; the fits use the blocked samplers above): shapes as
    :func:`labels_gibbs_from_gumbel`, the Gumbel noise drawn from ``gen``.
    Returns (z, n_trans, nk, resp)."""
    C, T, n, _ = X.shape
    K = sigma.shape[-1]
    z = labels_gibbs_from_gumbel(X, mu, sigma, lmbda, w0, w,
                                 gumbel(gen, (C, T, n, K), X.device))
    n_trans, nk, resp = _label_statistics(z, K)
    return z, n_trans, nk, resp


def log_normalize(log_probas, axis=-1):
    """Probabilities from unnormalised log-probabilities along ``axis``
    (reference sample_labels.py:8-13)."""
    x = torch.exp(log_probas - torch.amax(log_probas, dim=axis,
                                          keepdim=True))
    return x / torch.sum(x, dim=axis, keepdim=True)


def latent_marginal_loglikelihood(X, init_w, trans_w, mu, sigma, lmbda):
    """Forward-algorithm marginal log-likelihood of the latent positions
    under the mixture HMM, summed over nodes (reference
    model_selection/approx_bic.py:56-76), for one sample: X (T, n, d),
    init_w (K,), trans_w (T, K, K) (entry 0 unused), mu (K, d), sigma
    (K,), lmbda a float.  float32 matmuls (TF32 is off, ``config.py``).
    Returns a 0-d tensor."""
    X = torch.as_tensor(X, dtype=torch.float32)
    dev = X.device

    def f32(v):
        return torch.as_tensor(v, dtype=torch.float32, device=dev)

    init_w, trans_w, mu, sigma = (f32(init_w), f32(trans_w), f32(mu),
                                  f32(sigma))
    lik = emission_likelihoods_kn(X[None], mu[None], sigma[None],
                                  f32(lmbda).reshape(1),
                                  normalize=False)[0].transpose(1, 2)
    fwd = init_w[None, :] * lik[0]                      # (n, K)
    c = torch.clamp_min(torch.sum(fwd, dim=-1), SMALL_EPS)
    loglik = torch.sum(torch.log(c))
    fwd = fwd / c[:, None]
    for t in range(1, X.shape[0]):
        f = lik[t] * torch.matmul(fwd, trans_w[t])
        c = torch.clamp_min(torch.sum(f, dim=-1), SMALL_EPS)
        loglik = loglik + torch.sum(torch.log(c))
        fwd = f / c[:, None]
    return loglik
