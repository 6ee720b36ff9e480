"""Bernoulli network log-likelihoods, undirected and directed social-radii
(counterpart of ``dynetlsm_tpu/ops/likelihoods.py``), on dense distances.

``softplus`` is ``logaddexp(eta, 0)``, the formula ``jax.nn.softplus``
computes; ``torch.nn.functional.softplus`` switches to the identity above
``threshold=20`` and would change the sum.  The dyad sums accumulate in
float64 and return float32: the kernels in ``ops/pair_loglik.py`` and
``ops/dir_loglik.py`` do the same, so each agrees with its dense
counterpart to float32 rounding of the total.
"""
import torch

from .distances import distances_to_point, pairwise_distances

# values of one (times, n, n) block of :func:`dense_network_loglik`
# (float32: 256 MB a temporary)
_BLOCK_ELEMS = 1 << 26


def site_blocks(C, T, n, rows=None, limit=_BLOCK_ELEMS):
    """(chains, times, sites) slices that cover (C, T, rows) of n-node
    fields, ``rows`` = (a, b) the sites [a, b) (all n by default), each
    block at most ``limit`` dyads (its sites times their n partners) and
    at least one site: whole (time, site) fields of several chains where
    they fit, then whole fields of several times, then rows of sites."""
    a, b = (0, n) if rows is None else rows
    m = b - a
    rb = min(m, max(1, limit // n))
    tb = min(T, max(1, limit // (m * n))) if rb == m else 1
    cb = max(1, limit // (T * m * n)) if tb == T else 1
    return [(slice(c0, min(c0 + cb, C)), slice(t0, min(t0 + tb, T)),
             slice(r0, min(r0 + rb, b)))
            for c0 in range(0, C, cb) for t0 in range(0, T, tb)
            for r0 in range(a, b, rb)]


def softplus(eta):
    return torch.logaddexp(eta, torch.zeros((), dtype=eta.dtype,
                                            device=eta.device))


def _offdiag_mask(n, dtype, device=None):
    return 1.0 - torch.eye(n, dtype=dtype, device=device)


def _dyad_sum(ll, n, scale=0.5):
    mask = _offdiag_mask(n, ll.dtype, ll.device)
    s = torch.sum(ll * mask, dim=(-3, -2, -1), dtype=torch.float64)
    return (scale * s).to(ll.dtype)


def undirected_loglik_full(Y, dist, intercept):
    """sum_{t, i<j} Y_tij * eta - softplus(eta), eta = intercept - dist.

    Y (T, n, n), or one network a chain (..., T, n, n); dist
    (..., T, n, n); intercept (...,).  Returns (...,)."""
    n = Y.shape[-1]
    eta = torch.as_tensor(intercept, dtype=dist.dtype,
                          device=dist.device)[..., None, None, None] - dist
    ll = Y.to(dist.dtype) * eta - softplus(eta)
    return _dyad_sum(ll, n)


def directed_eta(dist, radii, intercept_in, intercept_out):
    """eta_tij = b_in (1 - d_tij / r_j) + b_out (1 - d_tij / r_i)
    (reference directed_likelihoods_fast.pyx:199-202).

    dist (..., T, n, n); radii (..., n); intercepts (...,)."""
    d_in = 1.0 - dist / radii[..., None, None, :]    # divide by r_j (receiver)
    d_out = 1.0 - dist / radii[..., None, :, None]   # divide by r_i (sender)
    b_in = torch.as_tensor(intercept_in, dtype=dist.dtype,
                           device=dist.device)[..., None, None, None]
    b_out = torch.as_tensor(intercept_out, dtype=dist.dtype,
                            device=dist.device)[..., None, None, None]
    return b_in * d_in + b_out * d_out


def directed_network_probas(dist, radii, intercept_in, intercept_out):
    """Directed connection probabilities expit(directed_eta) with a zeroed
    diagonal (reference directed_likelihoods_fast.pyx:273-294).

    dist (..., T, n, n); radii (..., n).  Returns (..., T, n, n)."""
    n = dist.shape[-1]
    probas = torch.sigmoid(directed_eta(dist, radii, intercept_in,
                                        intercept_out))
    return probas * _offdiag_mask(n, probas.dtype, probas.device)


def directed_loglik_full(Y, dist, radii, intercept_in, intercept_out):
    """sum_{t, i != j} Y_tij * eta - softplus(eta), eta = directed_eta.

    Y (T, n, n) 0/1 (edge i -> j at Y[t, i, j]), or one network a chain
    (..., T, n, n); dist (..., T, n, n); radii (..., n).  Returns
    (...,)."""
    n = Y.shape[-1]
    eta = directed_eta(dist, radii, intercept_in, intercept_out)
    ll = Y.to(dist.dtype) * eta - softplus(eta)
    return _dyad_sum(ll, n, scale=1.0)


def undirected_network_probas(dist, intercept):
    """expit(intercept - dist) with a zeroed diagonal (reference
    lsm.py:290-308).  dist (..., T, n, n); intercept (...,)."""
    n = dist.shape[-1]
    b = torch.as_tensor(intercept, dtype=dist.dtype,
                        device=dist.device)[..., None, None, None]
    probas = torch.sigmoid(b - dist)
    return probas * _offdiag_mask(n, probas.dtype, probas.device)


def undirected_loglik_pair(Y, dist, b_cur, b_prop):
    """(:func:`undirected_loglik_full` at ``b_cur``, at ``b_prop``) on the
    given distances: the intercept MH step's two candidates (JAX
    ``undirected_loglik_pair``)."""
    return (undirected_loglik_full(Y, dist, b_cur),
            undirected_loglik_full(Y, dist, b_prop))


def directed_loglik_pair(Y, dist, radii, bs_cur, bs_prop):
    """(:func:`directed_loglik_full` at the (b_in, b_out) pair ``bs_cur``,
    at ``bs_prop``) on the given distances (JAX ``directed_loglik_pair``)."""
    return (directed_loglik_full(Y, dist, radii, *bs_cur),
            directed_loglik_full(Y, dist, radii, *bs_prop))


def undirected_partial_loglik(Y_rows, X, x_new, intercept):
    """The Bernoulli terms (..., n) of one node at position x_new (..., d)
    against the field X (..., n, d) and its adjacency row Y_rows (..., n);
    the caller masks the node's own slot (reference
    static_network_fast.pyx:17-44)."""
    eta = intercept - distances_to_point(X, x_new)
    return Y_rows * eta - softplus(eta)


def directed_partial_loglik(Y_row, Y_col, X, x_new, radii, r_node,
                            intercept_in, intercept_out):
    """The directed terms (..., n) of node j at position x_new: its sent
    dyads (row Y[t, j, :]) and received ones (column Y[t, :, j]); radii
    (..., n), r_node (...,) j's radius; the caller masks slot j (reference
    directed_likelihoods_fast.pyx:46-80)."""
    dist = distances_to_point(X, x_new)
    r_node = r_node[..., None]
    eta_out = (intercept_in * (1.0 - dist / radii)
               + intercept_out * (1.0 - dist / r_node))
    eta_in = (intercept_in * (1.0 - dist / r_node)
              + intercept_out * (1.0 - dist / radii))
    ll = Y_row * eta_out - softplus(eta_out)
    return ll + (Y_col * eta_in - softplus(eta_in))


def directed_intercept_grad(Y, dist, radii, intercept_in, intercept_out):
    """Gradient (2,) of the directed log-likelihood in (b_in, b_out) at Y,
    dist (T, n, n) and radii (n,), summed in float64 (reference
    directed_likelihoods_fast.pyx:20-43)."""
    n = Y.shape[-1]
    d_in = 1.0 - dist / radii[None, None, :]
    d_out = 1.0 - dist / radii[None, :, None]
    eta = intercept_in * d_in + intercept_out * d_out
    step = ((Y.to(dist.dtype) - torch.sigmoid(eta))
            * _offdiag_mask(n, dist.dtype, dist.device))
    f64 = torch.float64
    return torch.stack([torch.sum(d_in * step, dtype=f64),
                        torch.sum(d_out * step, dtype=f64)]).to(dist.dtype)


def dynamic_network_loglikelihood_undirected(Y, X, intercept, squared=False,
                                             dist=None):
    """:func:`undirected_loglik_full` at ``dist``, or at the distances of
    X (reference network_likelihoods.py:26-33)."""
    if dist is None:
        dist = pairwise_distances(X, squared=squared)
    return undirected_loglik_full(Y, dist, intercept)


def dynamic_network_loglikelihood_directed(Y, X, intercept_in, intercept_out,
                                           radii, squared=False, dist=None):
    """:func:`directed_loglik_full` at ``dist``, or at the distances of X."""
    if dist is None:
        dist = pairwise_distances(X, squared=squared)
    return directed_loglik_full(Y, dist, radii, intercept_in, intercept_out)


def dynamic_network_loglikelihood(Y, X, intercept, radii=None, squared=False,
                                  dist=None):
    """The directed log-likelihood when ``radii`` is given (``intercept``
    then (..., 2) = (b_in, b_out)), else the undirected one (reference
    network_likelihoods.py:16-23)."""
    if radii is not None:
        intercept = torch.atleast_1d(torch.as_tensor(intercept))
        return dynamic_network_loglikelihood_directed(
            Y, X, intercept[..., 0], intercept[..., 1], radii,
            squared=squared, dist=dist)
    return dynamic_network_loglikelihood_undirected(
        Y, X, intercept, squared=squared, dist=dist)


def dense_network_loglik(Y, X, intercept, radii=None):
    """The dense network log-likelihood (C,) of every chain at positions X
    (C, T, n, d): :func:`undirected_loglik_full` (intercept (C, 1)) or,
    with radii (C, n), :func:`directed_loglik_full` (intercept (C, 2)),
    from distances computed here.  Y (T, n, n) or (C, T, n, n), 0/1 of any
    dtype.  Runs over blocks of chains and times of at most
    ``_BLOCK_ELEMS`` dyads, adding the blocks' sums in float64, so no
    (C, T, n, n) tensor is made (2.7 GB a chain at T = 10, n = 8,192); one
    block, the one call, where C T n^2 fits."""
    C, T, n, _ = X.shape
    per_chain = Y.dim() == 4
    tb = min(T, max(1, _BLOCK_ELEMS // (n * n)))
    cb = max(1, _BLOCK_ELEMS // (tb * n * n)) if tb == T else 1
    total = torch.zeros(C, dtype=torch.float64, device=X.device)
    for c0 in range(0, C, cb):
        c = slice(c0, c0 + cb)
        for t0 in range(0, T, tb):
            t = slice(t0, t0 + tb)
            Yb = Y[c, t] if per_chain else Y[t]
            dist = pairwise_distances(X[c, t])
            b = intercept[c]
            if radii is None:
                ll = undirected_loglik_full(Yb, dist, b[..., 0])
            else:
                ll = directed_loglik_full(Yb, dist, radii[c], b[..., 0],
                                          b[..., 1])
            total[c] += ll
    return total.to(X.dtype)
