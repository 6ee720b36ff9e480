"""Initial fill of missing (-1 coded) dyads (counterpart of
``dynetlsm_tpu/imputer.py``, reference dynetlsm/imputer.py), in NumPy
alone: the reference draws from scikit-learn's ``check_random_state``, and
an int seed gives the same ``np.random.RandomState`` stream here.

After this initial fill the samplers Gibbs-resample the missing dyads every
sweep (``mcmc/sweeps.py::resample_missing``).  The ``'random'`` fill draws
the upper triangle and mirrors it, whatever the network: on a directed
network it overwrites the observed lower triangle too, as the reference
does, so a caller that must keep observed dyads takes only the fill's
missing entries (``entry.build_state_and_sweep`` does).
"""
import numbers

import numpy as np


def _random_state(seed):
    """A ``np.random.RandomState`` from an int seed, or the RandomState
    given, as scikit-learn's ``check_random_state`` makes them."""
    if isinstance(seed, numbers.Integral):
        return np.random.RandomState(seed)
    if isinstance(seed, np.random.RandomState):
        return seed
    raise ValueError('random_state must be an int or a '
                     'numpy.random.RandomState, got %r' % (seed,))


class SimpleNetworkImputer:
    """Fill missing dyads by per-time-step mode ('most_frequent') or a
    Bernoulli(density) draw ('random')."""

    def __init__(self, missing_value=-1, strategy='most_frequent',
                 random_state=123, copy=True):
        if strategy not in ('most_frequent', 'random'):
            raise ValueError(
                "strategy must be 'most_frequent' or 'random', got %r"
                % (strategy,))
        self.missing_value = missing_value
        self.strategy = strategy
        self.random_state = random_state
        self.copy = copy

    def fit(self, Y):
        Y = np.asarray(Y, dtype=np.float64)
        T, n, _ = Y.shape
        self.statistics_ = np.zeros(T)
        for t in range(T):
            observed = Y[t][Y[t] != self.missing_value]
            if observed.size == Y[t].size:
                continue
            if self.strategy == 'most_frequent':
                vals, counts = np.unique(observed, return_counts=True)
                self.statistics_[t] = vals[np.argmax(counts)]
            else:
                self.statistics_[t] = observed.sum() / (n * (n - 1))
        return self

    def transform(self, Y):
        Y = np.array(Y, dtype=np.float64, copy=True)
        if Y.shape[0] != self.statistics_.shape[0]:
            raise ValueError('time-step mismatch with fitted statistics')
        rng = _random_state(self.random_state)
        for t in range(Y.shape[0]):
            if self.strategy == 'random':
                # impute the upper triangle and symmetrise
                iu = np.triu_indices(Y.shape[1], k=1)
                vec = Y[t][iu]
                miss = vec == self.missing_value
                vec[miss] = rng.binomial(1, self.statistics_[t], miss.sum())
                out = np.zeros_like(Y[t])
                out[iu] = vec
                Y[t] = out + out.T
            else:
                Y[t][Y[t] == self.missing_value] = self.statistics_[t]
        return Y

    def fit_transform(self, Y):
        return self.fit(Y).transform(Y)
