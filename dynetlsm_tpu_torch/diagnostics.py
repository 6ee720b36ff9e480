"""MCMC convergence diagnostics (counterpart of
``dynetlsm_tpu/diagnostics.py``, reference dynetlsm/trace_utils.py), a copy
in NumPy and SciPy: the JAX package's module cannot be imported without
jax.

ESS via normalised autocorrelation, spectral density at zero via
Yule-Walker AR fits on the autocovariances, Geweke's
autocorrelation-corrected z-score, split-R-hat and the Geyer-truncated
ESS summed over chains.
"""
import numpy as np
import scipy.stats as stats

from math import floor, ceil


def mean_detrend(x):
    """(reference trace_utils.py:9-10)"""
    return x - np.mean(x)


def xcorr(x, y, normed=True, detrend=mean_detrend, maxlags=10):
    """Cross-correlation at lags -maxlags..maxlags
    (reference trace_utils.py:13-36).  Returns (lags, correls)."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    n = x.shape[0]
    if n != y.shape[0]:
        raise ValueError('x and y must be equal length')
    x = detrend(x)
    y = detrend(y)
    correls = np.correlate(x, y, mode='full')
    if normed:
        denom = np.sqrt(np.dot(x, x) * np.dot(y, y))
        if denom > 0:
            correls = correls / denom
    if maxlags is None:
        maxlags = n - 1
    if maxlags >= n or maxlags < 1:
        raise ValueError('maxlags must be None or strictly positive < %d' % n)
    lags = np.arange(-maxlags, maxlags + 1)
    return lags, correls[n - 1 - maxlags:n + maxlags]


def autocorrelation(x, maxlags=100):
    """Normalised autocorrelation at lags 0..maxlags."""
    x = np.asarray(x, dtype=np.float64)
    x = x - x.mean()
    n = x.shape[0]
    maxlags = min(maxlags, n - 1)
    c = np.correlate(x, x, mode='full')[n - 1:n + maxlags]
    denom = np.dot(x, x)
    if denom == 0:
        return np.zeros(maxlags + 1)
    return c / denom


def effective_n(x, maxlags=100):
    """Effective sample size n / (1 + 2 sum_k rho_k)
    (reference trace_utils.py:39-45).

    Strongly anti-correlated traces can drive the denominator to (or
    below) zero, where the estimator is meaningless; clamp the result to
    (0, n] so short noisy traces report at most n independent samples
    rather than inf/negative.
    """
    rho = autocorrelation(x, maxlags=maxlags)
    denom = 1.0 + 2.0 * np.sum(rho[1:])
    n = x.shape[0]
    if denom <= 0.0:
        return float(n)
    return float(min(n / denom, n))


def _yule_walker(x, order):
    """AR(order) coefficients + innovation std via the adjusted Yule-Walker
    equations on the demeaned series."""
    x = np.asarray(x, dtype=np.float64)
    x = x - x.mean()
    n = x.shape[0]
    order = min(order, n - 1)      # lags >= n have no overlapping samples
    r = np.zeros(order + 1)
    r[0] = np.dot(x, x) / n
    for k in range(1, order + 1):
        r[k] = np.dot(x[:-k], x[k:]) / (n - k)
    R = np.array([[r[abs(i - j)] for j in range(order)] for i in range(order)])
    try:
        coefs = np.linalg.solve(R, r[1:])
    except np.linalg.LinAlgError:
        coefs = np.linalg.lstsq(R, r[1:], rcond=None)[0]
    sigma_sq = r[0] - np.dot(coefs, r[1:])
    return coefs, np.sqrt(max(sigma_sq, 0.0))


def aic_ar(sigma, n, p):
    """AIC of an AR(p) fit with innovation std ``sigma`` on a demeaned
    series of ``n`` samples (reference trace_utils.py:48-52)."""
    return 2 * n * np.log(sigma) + 2 * (p + 1)


def spec0_ar(sigma, coefs):
    """Spectral density at frequency zero of an AR process
    (reference trace_utils.py:55-56)."""
    return (sigma ** 2) / ((1 - np.sum(coefs)) ** 2)


def spectrum0_ar(x, max_order='auto'):
    """f(0) of the spectral density via the AIC-best AR fit
    (reference trace_utils.py:59-79)."""
    x = np.asarray(x, dtype=np.float64)
    n = x.shape[0]
    if np.allclose(np.var(x), 0.0):
        return 0.0, 0.0
    if max_order == 'auto':
        max_order = max(1, floor(10 * np.log10(n)))

    best = None
    for p in range(1, max_order + 1):
        coefs, sigma = _yule_walker(x, p)
        if sigma <= 0:
            continue
        aic = aic_ar(sigma, n, p)
        var0 = spec0_ar(sigma, coefs)
        if best is None or aic < best[0]:
            best = (aic, var0, p)
    if best is None:
        return 0.0, 0.0
    _, var0, order = best
    return var0 / n, order


def geweke_corrected(x, first=0.1, last=0.5):
    """Geweke z-score with AR-spectral variance correction
    (reference trace_utils.py:82-99)."""
    n = x.shape[0]
    x1 = x[:ceil(first * n)]
    x2 = x[n - floor(last * n):]
    v1, _ = spectrum0_ar(x1)
    v2, _ = spectrum0_ar(x2)
    denom = np.sqrt(v1 + v2)
    if denom == 0:
        return 0.0
    return (np.mean(x1) - np.mean(x2)) / denom


def geweke_diag(x, first=0.1, last=0.5, n_burn=None):
    """(z_score, two-sided p-value) (reference trace_utils.py:102-115)."""
    x = np.asarray(x, dtype=np.float64)
    if n_burn is not None:
        x = x[n_burn:]
    z = geweke_corrected(x, first=first, last=last)
    p = 2 * (1 - stats.norm.cdf(np.abs(z)))
    return z, p


def potential_scale_reduction(chains):
    """Gelman-Rubin split-R-hat over parallel chains.

    New capability enabled by the multi-chain sampler (the single-chain
    reference has no between-chain diagnostics).  ``chains`` is
    (n_chains, n_samples); each chain is split in half, and R-hat compares
    between- to within-half variances.
    """
    x = np.asarray(chains, dtype=np.float64)
    if x.ndim != 2:
        raise ValueError('chains must be (n_chains, n_samples)')
    m, n = x.shape
    half = n // 2
    splits = np.concatenate([x[:, :half], x[:, half:2 * half]], axis=0)
    M, N = splits.shape
    chain_means = splits.mean(axis=1)
    B = N * np.var(chain_means, ddof=1)
    W = np.mean(np.var(splits, axis=1, ddof=1))
    if W == 0:
        return 1.0
    var_plus = (N - 1) / N * W + B / N
    return float(np.sqrt(var_plus / W))


def effective_n_geyer(x, maxlags=100):
    """ESS with Geyer's initial-positive-sequence truncation.

    The plain ``effective_n`` (reference parity) sums all maxlags
    autocorrelations, which can produce negative or > n estimates from a
    noisy tail; truncating at the first negative even/odd lag pair keeps
    the estimate in (0, n]."""
    x = np.asarray(x, dtype=np.float64)
    n = x.shape[0]
    rho = autocorrelation(x, maxlags=maxlags)
    tau = 1.0
    for k in range(1, rho.shape[0] - 1, 2):
        pair = rho[k] + rho[k + 1]
        if pair < 0:
            break
        tau += 2.0 * pair
    return float(np.clip(n / tau, 1.0, n))


def multichain_effective_n(chains, maxlags=100):
    """Total ESS summed over parallel chains (Geyer-truncated per chain)."""
    x = np.asarray(chains, dtype=np.float64)
    return float(sum(effective_n_geyer(c, maxlags=maxlags) for c in x))
