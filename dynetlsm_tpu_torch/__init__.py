"""PyTorch port of ``dynetlsm_tpu`` for NVIDIA Hopper GPUs.

The package mirrors the JAX package's layout (``config``, ``ops``,
``math``, ``mcmc``) and function names.  It imports ``torch`` and never
``jax``: on a CUDA tensor the hot loops run hand-written CUDA kernels
(``csrc/``, built with ``nvcc`` on first use); on a CPU tensor every
kernel's plain PyTorch version runs instead.

Its public surface is the JAX package's three estimators,
:class:`DynamicNetworkLSM`, :class:`DynamicNetworkLPCM` and
:class:`DynamicNetworkHDPLPCM`: ``Model(...).fit(Y)`` runs on the card
unless given ``device='cpu'``.  Importing them builds nothing; the CUDA
kernels are built on their first launch.  ``entry.build_state_and_sweep``
builds a chain state and a sweep without an estimator.
"""
from . import config  # noqa: F401  (sets the float32 matmul policy)
from .models.hdp_lpcm import DynamicNetworkHDPLPCM
from .models.lpcm import DynamicNetworkLPCM
from .models.lsm import DynamicNetworkLSM

__all__ = ['DynamicNetworkLSM', 'DynamicNetworkLPCM',
           'DynamicNetworkHDPLPCM']

__version__ = '0.1.0'
