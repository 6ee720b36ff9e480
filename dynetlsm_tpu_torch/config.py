"""Global numeric configuration of the PyTorch port
(counterpart of ``dynetlsm_tpu/config.py``), and the device rule of its
entry points (:func:`resolve_device`).

The sampler runs in float32.  The JAX reference pins its float32
contractions to full precision (``precision='highest'`` in the label,
conjugate and one-hot gathers), so TF32 is switched off for both matmuls
and cuDNN: TF32 keeps about three decimal digits.
"""
import numpy as np
import torch

DTYPE = torch.float32

# label dtype of the port (the JAX package stores int32 labels; the
# state converters cast)
ITYPE = torch.int64

# Small positive constant guarding logs / Dirichlet concentrations
# (reference hdp_lpcm.py:42 uses float64 tiny; scaled to float32).
SMALL_EPS = float(np.finfo(np.float32).tiny)

# log-of-weight guard used by the HMM label samplers.
LOG_GUARD = 1e-5

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device='cuda'):
    """The ``torch.device`` the entry points and sweep factories build on:
    the card unless the caller asks for the CPU.  Raises if a CUDA device
    is asked for (the default) and none is available; there is no
    fallback to the CPU."""
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the card by "
            "default, pass device='cpu' to run it on the CPU")
    return device
