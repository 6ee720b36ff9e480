"""Posterior expected Variation-of-Information model selection
(counterpart of ``dynetlsm_tpu/model_selection/posterior_vi.py``,
reference model_selection/posterior_vi.py).

The batched form runs in chunks of samples: the co-clustering mass of
each node's own cluster is a float32 matmul of the co-occurrence matrix
with one chunk's one-hot labels (on the given device; TF32 is off,
``config.py``), and the sums around it are the JAX package's NumPy float32
expressions, so no (S, T, n, K) tensor of all samples is ever built.
"""
import numpy as np
import torch

__all__ = ['posterior_expected_vi', 'time_averaged_posterior_expected_vi',
           'minimize_posterior_expected_vi', 'batched_posterior_expected_vi',
           'nonvectorized_posterior_expected_vi']


def nonvectorized_posterior_expected_vi(labels, cooccurrence_proba):
    """Per-node-loop expected VI, the testing oracle of the vectorised
    forms (reference posterior_vi.py:10-20)."""
    vi = 0.0
    n = labels.shape[0]
    for i in range(n):
        same = labels == labels[i]
        vi += np.log2(np.sum(same))
        vi -= 2 * np.log2(np.sum(same * cooccurrence_proba[i, :]))
        vi += np.log2(np.sum(cooccurrence_proba[i, :]))
    return vi / n


def posterior_expected_vi(labels, cooccurrence_proba):
    """Lower bound of E[VI(z, z')] under the posterior co-occurrence matrix
    (reference posterior_vi.py:23-43) for a single label vector."""
    n = labels.shape[0]
    n_groups = int(labels.max()) + 1
    resp = np.zeros((n, n_groups))
    resp[np.arange(n), labels] = 1
    nk = resp.sum(axis=0)

    vi = np.sum(nk[nk != 0] * np.log2(nk[nk != 0]))
    same = resp[:, labels].T            # same[i, j] = 1[z_i == z_j]
    vi -= 2 * np.log2((cooccurrence_proba * same).sum(axis=1)).sum()
    vi += np.log2(cooccurrence_proba.sum(axis=1)).sum()
    return vi / n


def time_averaged_posterior_expected_vi(labels, cooccurrence_proba):
    """(reference posterior_vi.py:46-53)"""
    T = labels.shape[0]
    return sum(posterior_expected_vi(labels[t], cooccurrence_proba[t])
               for t in range(T)) / T


def _own_cluster_mass(zs, C, n_groups, device, chunk):
    """picked[s, t, i] = sum_j C[t, i, j] 1[z_stj = z_sti], float32
    (S, T, n), ``chunk`` samples at a time on ``device``: per time one
    (n, n) x (n, s K) product over the chunk's one-hot labels (a batched
    product broadcasting C over the samples would copy it s times)."""
    Ct = torch.as_tensor(C, device=device)
    T, n = C.shape[:2]
    out = np.empty(zs.shape, np.float32)
    for s0 in range(0, zs.shape[0], chunk):
        z = torch.as_tensor(zs[s0:s0 + chunk], dtype=torch.int64,
                            device=device)
        s = z.shape[0]
        onehot = torch.nn.functional.one_hot(z, n_groups).to(torch.float32)
        co_mass = torch.matmul(Ct, onehot.permute(1, 2, 0, 3).reshape(
            T, n, s * n_groups)).reshape(T, n, s, n_groups)
        out[s0:s0 + s] = torch.gather(
            co_mass, -1, z.permute(1, 2, 0)[..., None])[..., 0].permute(
                2, 0, 1).cpu().numpy()
    return out


def batched_posterior_expected_vi(zs, cooccurrence_probas, n_groups=None,
                                  device='cpu', chunk=256):
    """Time-averaged expected VI of every posterior sample.

    zs : (S, T, n) int labels; cooccurrence_probas : (T, n, n).
    Returns (S,) float32.
    """
    zs = np.asarray(zs)
    S, T, n = zs.shape
    if n_groups is None:
        n_groups = int(zs.max()) + 1
    flat = zs.reshape(S * T, n).astype(np.int64)
    offsets = flat + n_groups * np.arange(S * T)[:, None]
    nk = np.bincount(offsets.ravel(), minlength=S * T * n_groups).reshape(
        S, T, n_groups).astype(np.float32)                 # (S, T, K)
    with np.errstate(divide='ignore', invalid='ignore'):
        ent = np.where(nk > 0, nk * np.log2(np.where(nk > 0, nk, 1.0)), 0.0)
    term1 = ent.sum(axis=-1)                                 # (S, T)

    C = np.asarray(cooccurrence_probas, dtype=np.float32)
    picked = _own_cluster_mass(zs, C, n_groups, device, chunk)
    term2 = 2 * np.log2(np.clip(picked, 1e-20, None)).sum(axis=-1)

    term3 = np.log2(np.clip(C.sum(axis=-1), 1e-20, None)).sum(axis=-1)[None]
    return ((term1 - term2 + term3) / n).mean(axis=1)        # (S,)


def minimize_posterior_expected_vi(zs, cooccurrence_probas, tie_break=None,
                                   n_groups=None, device='cpu'):
    """Index of the posterior sample minimising the time-averaged expected
    VI (reference posterior_vi.py:56-82).  ``tie_break`` is an optional (S,)
    score (higher better) that resolves exact ties."""
    vis = batched_posterior_expected_vi(zs, cooccurrence_probas, n_groups,
                                        device=device)
    min_ids = np.where(vis == vis.min())[0]
    if min_ids.shape[0] > 1 and tie_break is not None:
        return int(min_ids[np.argmax(np.asarray(tie_break)[min_ids])])
    return int(min_ids[0])
