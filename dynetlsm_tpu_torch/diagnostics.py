"""MCMC diagnostics (counterpart of part of ``dynetlsm_tpu/diagnostics.py``,
reference dynetlsm/trace_utils.py), in NumPy alone: the normalised
autocorrelation and the Geyer-truncated effective sample size that the
Geweke joint-distribution checks use."""
import numpy as np


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


def effective_n_geyer(x, maxlags=100):
    """ESS with Geyer's initial-positive-sequence truncation: the sum of
    autocorrelations stops at the first negative even/odd lag pair, which
    keeps the estimate in (0, n]."""
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
