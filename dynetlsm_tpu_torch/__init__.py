"""PyTorch port of ``dynetlsm_tpu`` for NVIDIA Hopper GPUs.

The package mirrors the JAX package's layout (``config``, ``ops``,
``math``, ``mcmc``) and function names.  It imports ``torch`` and never
``jax``: on a CUDA tensor the hot loops run hand-written CUDA kernels
(``csrc/``, built with ``nvcc`` on first use); on a CPU tensor every
kernel's plain PyTorch version runs instead.

The first slice ports the sticky HDP-LPCM Gibbs sweep on a dense
undirected network with the exact latent update:
``mcmc.sweeps.make_hdp_sweep``, driven by ``mcmc.driver.make_scan_runner``
and built by ``entry.build_state_and_sweep``.
"""
from . import config  # noqa: F401  (sets the float32 matmul policy)

__version__ = '0.1.0'
