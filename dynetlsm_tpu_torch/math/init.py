"""Initial values of the sampler state, in NumPy (counterpart of
``dynetlsm_tpu/math/init.py``; only the social radii so far)."""
import numpy as np


def initialize_radii(Y, reg=1e-5):
    """Degree-normalised social radii (reference latent_space.py:140-153)."""
    Y = np.asarray(Y, dtype=np.float64)
    radii = 0.5 * (Y.sum(axis=(0, 1)) + Y.sum(axis=(0, 2)))
    radii /= Y.sum()
    if np.any(radii == 0.0):
        radii += reg
        radii /= radii.sum()
    return radii
