"""The site kernel of the 'parallel' latent update
(``dynetlsm_tpu_torch/ops/site_loglik.py``, ``csrc/site_loglik.cu``)
against its plain version, which the JAX-parity tests of
``tests/test_torch_latent_schemes.py`` and ``tests/test_torch_spatial.py``
hold to the JAX package.

On the CPU: the plain version within rtol 1e-5 of the terms' magnitude of
a float64 evaluation; the launch rule's choices; and the kernel's own
source run on the host (``tests/torch_site_loglik_host.cpp``, one
module-scoped g++ build) against the float64 evaluation and the plain
version at rtol 1e-5 of the magnitude of the terms (each site's sum of
|l(x_prop)| + |l(x)|, at least 1: float32 rounds each term by ~6e-8 of it,
and the plain version loses its delta to the cancellation of two such
sums), at shapes that end mid-word and mid-tile, row ranges at offsets
that are no multiple of 4 or of the tile, staged chunks, and lane groups
of 1 to 32.

On the card (``cuda``-marked; ``python3 -m pytest --noconftest -m cuda
tests/test_torch_site_loglik.py``): the kernel against the plain version
at the same tolerance, bit-equal on rerun and in a CUDA graph's replay;
``_parallel_site_update`` on injected noise makes the plain path's accept
decisions but at near ties; and a 'parallel' sweep counts one launch.
"""
import ctypes

import numpy as np
import pytest
import torch

from dynetlsm_tpu_torch.mcmc import latent
from dynetlsm_tpu_torch.ops import site_loglik as sl
from dynetlsm_tpu_torch.ops.node_scan import pack_directed, pad_partners

from .torch_host_build import build

RTOL = 1e-5


def _inputs(seed, C, T, n, d=2, directed=False, per_chain=False):
    """(Y 0/1 (C, T, n, n) or (T, n, n) uint8, packed when directed; X;
    X_prop; intercept (C, 1) or (C, 2); radii (C, n) or None).  The radii
    sum to n / 3 a chain, as in the JAX-parity tests, so that distances
    over radii stay of order 1 with X ~ N(0, 1), as in a fitted state."""
    rng = np.random.RandomState(seed)
    shape = ((C,) if per_chain else ()) + (T, n, n)
    Y = rng.binomial(1, 0.3, shape).astype(np.uint8)
    if directed:
        Y[..., np.arange(n), np.arange(n)] = 0
        Y = pack_directed(torch.as_tensor(Y))
    else:
        Y = np.triu(Y, 1)
        Y = torch.as_tensor(Y + np.swapaxes(Y, -1, -2))
    X = rng.randn(C, T, n, d).astype(np.float32)
    X_prop = X + 0.3 * rng.randn(C, T, n, d).astype(np.float32)
    b = (0.5 * rng.randn(C, 2 if directed else 1) + 0.3).astype(np.float32)
    radii = ((rng.dirichlet(np.ones(n), C) * n / 3).astype(np.float32)
             if directed else None)
    f32 = [torch.as_tensor(a) if a is not None else None
           for a in (X, X_prop, b, radii)]
    return (Y,) + tuple(f32)


def _terms64(Y, X, Xq, intercept, radii, is_directed, row0=0):
    """(delta, magnitude) of the sites of Y's rows in float64: the sum of
    each partner's difference, and of the two terms' absolute values."""
    n = X.shape[2]
    rows = Y.shape[-2]
    sites = torch.arange(row0, row0 + rows)
    Yd = Y[..., :n].to(torch.float64)
    if Y.dim() == 3:
        Yd = Yd.expand(X.shape[0], -1, -1, -1)
    off = sites[:, None] != torch.arange(n)
    x = X.double()
    b = intercept.double()
    ll = []
    for cand in (Xq.double(), x):
        diff = cand[:, :, sites, None, :] - x[:, :, None, :, :]
        dist = torch.sqrt(torch.sum(diff * diff, -1))
        if is_directed:
            r = radii.double()
            ri, rj = r[:, None, sites, None], r[:, None, None, :]
            b0, b1 = b[:, 0, None, None, None], b[:, 1, None, None, None]
            eo = b0 * (1 - dist / rj) + b1 * (1 - dist / ri)
            ei = b0 * (1 - dist / ri) + b1 * (1 - dist / rj)
            y, yt = torch.remainder(Yd, 2), torch.floor(Yd / 2)
            terms = (y * eo - torch.logaddexp(eo, torch.zeros(()))
                     + yt * ei - torch.logaddexp(ei, torch.zeros(())))
        else:
            eta = b[:, 0, None, None, None] - dist
            terms = Yd * eta - torch.logaddexp(eta, torch.zeros(()))
        ll.append(terms.masked_fill(~off, 0.0))
    return ((ll[0] - ll[1]).sum(-1),
            (ll[0].abs() + ll[1].abs()).sum(-1))


def _assert_near(got, want, mag, what):
    """|got - want| within RTOL of each site's magnitude, at least a nat
    (as the benchmark's mh_gap scales a ratio: a site whose terms all
    vanish rounds them to 0)."""
    err = float(((got.double() - want.double()).abs()
                 / torch.clamp_min(mag, 1.0)).max())
    assert err <= RTOL, '%s: %g of the terms\' magnitude' % (what, err)


def test_plain_is_near_float64():
    """The plain version within rtol 1e-5 of the terms' magnitude of a
    float64 evaluation (the yardstick the kernel is held to)."""
    for directed in (False, True):
        Y, X, Xp, b, radii = _inputs(5, 2, 2, 40, 2, directed)
        want, mag = _terms64(Y, X, Xp, b, radii, directed)
        _assert_near(sl.site_loglik_plain(Y, X, Xp, b, radii, directed),
                     want, mag, 'plain')


def test_launch_layout():
    """Lanes a site from n (a word a lane, up to a warp); the whole row
    staged where it fits STAGE_BYTES, equal word-aligned chunks past it;
    the sites a lane group takes grow while the grid keeps WAVES times
    what the card holds, up to MAX_PER_GROUP."""
    assert [sl.lanes_per_site(n) for n in (1, 4, 5, 18, 64, 65, 500)] == [
        1, 1, 2, 8, 16, 32, 32]
    assert sl.stage_chunk(8192, 2, False) == 8192
    assert sl.stage_chunk(18, 2, True) == 20
    L = sl.stage_chunk(8192, 2, True)
    assert L % sl.WORD == 0 and 3 * 4 * L <= sl.STAGE_BYTES
    assert -(-8192 // L) == 2

    def resident(per_group, chunk):
        return 132 * 3
    # n = 8,192, 16 chains: the most sites a group; Sampson: one
    assert sl.launch_layout(16, 10, 8192, 8192, 2, False, resident) == (
        32, sl.MAX_PER_GROUP, 8192)
    assert sl.launch_layout(512, 3, 18, 18, 2, False, resident) == (
        8, 1, 20)
    lanes, k, _ = sl.launch_layout(32, 10, 500, 500, 2, False,
                                   lambda *a: 132 * 8)
    blocks = 32 * 10 * -(-500 // (sl.THREADS // lanes * k))
    assert blocks >= sl.WAVES * 132 * 8 and k > 1


# ---------------------------------------------------------------------------
# the kernel's source on the host
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def host_lib(tmp_path_factory):
    lib = build(tmp_path_factory, 'torch_site_loglik_host.cpp',
                ['site_loglik.cu', 'loglik_common.cuh'])
    p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.site_loglik_host.argtypes = [p] * 6 + [i] * 10 + [q] * 3 + [i]
    return lib


def _host(lib, Y, X, Xp, b, radii, directed, row0=0, lanes=None,
          per_group=1, chunk=None, reverse=False):
    """The kernel on the host, the launch rule's lanes and chunk unless
    given; the output starts as NaN."""
    C, T, n, d = X.shape
    rows, S = Y.shape[-2:]
    lanes = lanes or sl.lanes_per_site(n)
    chunk = (sl.stage_chunk(n, d, directed) if chunk is None
             else -(-chunk // sl.WORD) * sl.WORD)
    out = torch.full((C, T, rows), float('nan'))
    assert lib.site_loglik_host(
        X.data_ptr(), Xp.data_ptr(), Y.data_ptr(), b.data_ptr(),
        radii.data_ptr() if directed else None, out.data_ptr(), C, T, n,
        row0, rows, d, int(directed), lanes, per_group, chunk,
        T * rows * S if Y.dim() == 4 else 0, rows * S, S, int(reverse)) == 0
    return out


# (C, T, n, d, directed, per_chain, padded, lanes, per_group, chunk, rows):
# the launch rule's lanes at n = 18 and 37 (rows of bytes), a warp at
# n = 70 (words, padded), one lane a site, staged chunks (one not a
# multiple of the lanes' stride), three dimensions, several sites a group,
# row ranges at offsets 0, 5 and 13
HOST_CASES = [(2, 2, 18, 2, False, False, False, None, 1, None, None),
              (2, 1, 37, 2, True, True, False, None, 2, None, None),
              (1, 2, 70, 2, False, False, True, None, 1, None, None),
              (2, 1, 9, 2, True, False, False, 1, 1, None, None),
              (1, 1, 70, 2, True, False, True, 8, 3, 12, None),
              (2, 1, 45, 3, False, True, False, 4, 1, 20, None),
              (1, 2, 37, 2, False, False, True, None, 1, 16, (5, 29)),
              (2, 1, 30, 2, True, True, False, 4, 2, None, (13, 30))]


@pytest.mark.parametrize('case', HOST_CASES)
def test_host_kernel_matches_plain(host_lib, case):
    """The kernel's source on the host: within rtol 1e-5 of the terms'
    magnitude of the float64 evaluation and of the plain version, every
    site written, and bit-equal with the blocks in the opposite order."""
    (C, T, n, d, directed, per_chain, padded, lanes, per_group, chunk,
     rows) = case
    Y, X, Xp, b, radii = _inputs(3 + n + 7 * directed, C, T, n, d, directed,
                                 per_chain)
    if padded:
        Y = pad_partners(Y)
    row0 = 0
    if rows is not None:
        row0, end = rows
        Y = Y[..., row0:end, :].contiguous()
    want, mag = _terms64(Y, X, Xp, b, radii, directed, row0)
    plain = sl.site_loglik_plain(Y, X, Xp, b, radii, directed, row0)
    got = _host(host_lib, Y, X, Xp, b, radii, directed, row0, lanes,
                per_group, chunk)
    assert not torch.isnan(got).any()
    _assert_near(got, want, mag, 'kernel vs float64')
    _assert_near(got, plain, mag, 'kernel vs plain')
    again = _host(host_lib, Y, X, Xp, b, radii, directed, row0, lanes,
                  per_group, chunk, reverse=True)
    assert torch.equal(got, again)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the site kernel has no CPU mode')
    return torch.device('cuda')


def _on(dev, args):
    return [None if a is None else a.to(dev) for a in args]


# (C, T, n, directed, per_chain, padded, row ranges): mid-word rows of
# bytes, a tile and a half, Sampson, padded north-star rows, per-chain
# networks, row ranges at offsets no multiple of 4 nor of a block's sites
CARD_CASES = [(3, 2, 45, False, False, False, None),
              (2, 3, 133, True, False, True, None),
              (8, 3, 18, False, False, True, None),
              (2, 2, 500, False, False, True, None),
              (3, 2, 76, True, True, True, None),
              (2, 2, 301, False, True, False, [(0, 7), (7, 150), (150, 301)]),
              (2, 1, 133, True, False, False, [(0, 61), (61, 133)])]


@pytest.mark.cuda
@pytest.mark.parametrize('case', CARD_CASES)
def test_kernel_matches_plain_on_card(case):
    """The kernel (whole network or row ranges; the launch rule's chunk
    and a forced small one) within rtol 1e-5 of the terms' magnitude of
    the plain version and of a float64 evaluation, bit-equal on rerun."""
    dev = _card()
    C, T, n, directed, per_chain, padded, ranges = case
    Y, X, Xp, b, radii = _inputs(17 + n, C, T, n, 2, directed, per_chain)
    if padded:
        Y = pad_partners(Y)
    for row0, end in ranges or [(0, n)]:
        Yr = Y[..., row0:end, :].contiguous()
        want, mag = _terms64(Yr, X, Xp, b, radii, directed, row0)
        plain = sl.site_loglik_plain(*_on(dev, (Yr, X, Xp, b, radii)),
                                     directed, row0)
        name = 'site_loglik' if ranges is None else 'site_loglik_rows'
        for chunk in (None, 24):
            args = _on(dev, (Yr, X, Xp, b, radii))
            got = sl._launch(name, *args, directed, row0, chunk)
            again = sl._launch(name, *args, directed, row0, chunk)
            torch.cuda.synchronize()
            assert torch.equal(got, again)
            _assert_near(got.cpu(), want, mag, 'kernel vs float64')
            _assert_near(got.cpu(), plain.cpu(), mag, 'kernel vs plain')


@pytest.mark.cuda
def test_kernel_replays_in_a_cuda_graph():
    """A launch captured in a CUDA graph (after one eager call) replays to
    the eager call's bits: it neither synchronises nor allocates beyond
    its output."""
    dev = _card()
    args = _on(dev, _inputs(41, 4, 3, 130, 2, True))
    Y = pad_partners(args[0])
    eager = sl.site_loglik_cuda(Y, *args[1:], True)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = sl.site_loglik_cuda(Y, *args[1:], True)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, eager)


@pytest.mark.cuda
@pytest.mark.parametrize('directed', [False, True])
def test_parallel_update_accepts_match_plain_on_card(directed):
    """``_parallel_site_update`` with injected eps and log_u: the kernel's
    accept decisions are the plain path's but where the two ratios lie
    within 1e-5 of the terms' magnitude of log u (near ties), and the
    accepted positions are the same proposals."""
    dev = _card()
    C, T, n, K = 4, 3, 200, 5
    Y, X, _, b, radii = _inputs(29, C, T, n, 2, directed)
    rng = np.random.RandomState(4)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))  # noqa: E731
    step = f32(np.full((C, T, n), 0.3))
    eps = f32(rng.randn(C, T, n, 2))
    log_u = f32(np.log(rng.uniform(size=(C, T, n))))
    mu = f32(rng.randn(C, K, 2))
    sigma = f32(rng.uniform(0.5, 1.5, (C, K)))
    lmbda = f32(rng.uniform(0.2, 0.8, C))
    z = torch.as_tensor(rng.randint(0, K, (C, T, n)))
    kw = dict(radii=radii, mu=mu, sigma=sigma, lmbda=lmbda, z=z,
              is_directed=directed, eps=eps, log_u=log_u)
    Yp = pad_partners(Y)
    X_cpu, acc_cpu = latent._parallel_site_update(None, Yp, X, b, step,
                                                  **kw)
    on = {k: v.to(dev) if torch.is_tensor(v) else v for k, v in kw.items()}
    X_gpu, acc_gpu = latent._parallel_site_update(
        None, Yp.to(dev), X.to(dev), b.to(dev), step.to(dev), **on)
    flips = acc_gpu.cpu() != acc_cpu
    Xp = X + step[..., None] * eps
    delta, mag = _terms64(Y, X, Xp, b, radii, directed)
    ratio = delta + (_prior(Xp, X, mu, sigma, lmbda, z)
                     - _prior(X, X, mu, sigma, lmbda, z))
    near = (ratio - log_u.double()).abs() <= RTOL * mag
    assert not (flips & ~near).any()
    keep = ~flips[..., None].expand_as(X)
    assert torch.equal(X_gpu.cpu()[keep], X_cpu[keep])


def _prior(Xq, X, mu, sigma, lmbda, z):
    """The mixture prior of each site at Xq, stale temporal neighbours X,
    in float64 (the plain path's formula)."""
    c = torch.arange(X.shape[0])[:, None, None]
    mu_z, sig_z = mu.double()[c, z], sigma.double()[c, z]
    lam = lmbda.double()[:, None, None, None]
    Xq, X = Xq.double(), X.double()
    prev = torch.cat([torch.zeros_like(X[:, :1]), X[:, :-1]], 1)
    nxt = torch.cat([X[:, 1:], torch.zeros_like(X[:, :1])], 1)
    mu_n = torch.cat([mu_z[:, 1:], torch.zeros_like(mu_z[:, :1])], 1)
    sig_n = torch.cat([sig_z[:, 1:], torch.ones_like(sig_z[:, :1])], 1)
    back = Xq - (1 - lam) * prev - lam * mu_z
    back[:, 0] = Xq[:, 0] - mu_z[:, 0]
    fwd = -0.5 * ((nxt - (1 - lam) * Xq - lam * mu_n) ** 2).sum(-1) / sig_n
    fwd[:, -1] = 0.0
    return -0.5 * (back ** 2).sum(-1) / sig_z + fwd


@pytest.mark.cuda
def test_parallel_sweep_launches_the_kernel_once():
    """A 'parallel' HDP-LPCM sweep on the card launches the site kernel
    once and no node scan; two runs from one seed are bit-identical."""
    dev = _card()
    from dynetlsm_tpu_torch.entry import build_state_and_sweep
    from dynetlsm_tpu_torch.ops.node_scan import node_scan_cuda
    Y = _inputs(3, 1, 4, 60)[0].numpy()
    runs = []
    for _ in range(2):
        state, sweep, gen = build_state_and_sweep(
            Y, 4, K=5, device=dev, latent_update='parallel', seed=9)
        before = (sl.site_loglik_cuda.launches, node_scan_cuda.launches)
        for _ in range(3):
            state = sweep(state, gen)
        torch.cuda.synchronize()
        assert sl.site_loglik_cuda.launches - before[0] == 3
        assert node_scan_cuda.launches == before[1]
        runs.append(state)
    assert torch.equal(runs[0].X, runs[1].X)
    assert torch.equal(runs[0].logp, runs[1].logp)
