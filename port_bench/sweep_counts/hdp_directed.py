"""The directed HDP-LPCM sweep with social radii on the dense likelihood:
the exact scan against every partner in both directions, the intercept
steps and the radii step (``dir_loglik``, four candidate evaluations a
sweep: b_in's current and proposed, b_out's proposed, the radii's
proposed), and the mixture blocks.

The directed likelihood writes each direction's eta in the hoisted form
the program and the JAX package use, eta = B - d s with B = b_in + b_out
and s = b_in / r_recv + b_out / r_send (PERF.md, "Counting operations",
d = 2):

* a direction's term: eta (the scale's sum, the product, the subtraction:
  3), softplus (5), y * eta and the subtraction (2): ``DIR_TERM_FLOPS``
  10;
* a partner of a site's update: per candidate the distance (6), both
  directions' terms and their sum (21), 27; both candidates, their
  difference and the accumulation: 2 * 27 + 2 = 56; per node and chain
  the scan forms the two directions' scales over its partners once for
  every time (2 (n - 1)), and per chain the reciprocal rows (2 n);
* ``dir_loglik``: per launch each unordered dyad's distance once (6), then
  per candidate and dyad both directions' terms, their sum and the
  accumulation (22); per candidate and chain the reciprocals b_in / r and
  b_out / r of every node (2 n).  Bytes: the packed network (T n^2, one
  byte a dyad) and the positions (C T n d floats) once a launch; per
  candidate and chain the radii (n), the two intercepts and the result.

The radii's Dirichlet draw and Hastings term (O(C n) a sweep) are left
out, as are the per-chain draws of the mixture blocks.
"""
from port_bench import counts

DIR_TERM_FLOPS = 10
DIR_PARTNER_FLOPS = 2 * (counts.DYAD_DISTANCE_FLOPS + 2 * DIR_TERM_FLOPS
                         + 1) + 2
DIR_DYAD_FLOPS = 2 * DIR_TERM_FLOPS + 2
# dir_loglik's evaluations a sweep: the candidates (b_in's two, b_out's
# one, the radii's one) and the launches
SWEEP_CANDIDATES = 4
SWEEP_LAUNCHES = 3


def node_scan_flops(C, T, n):
    """One directed exact scan: every site against its n - 1 partners at
    two candidates, the site's own work, and the scales of each node."""
    return C * (T * n * ((n - 1) * DIR_PARTNER_FLOPS + counts.SITE_FLOPS)
                + 2 * n * (n - 1) + 2 * n)


def node_scan_bytes(C, T, n, d):
    """The undirected scan's inputs and outputs (``counts.node_scan_bytes``:
    the packed network is one byte a dyad too), with a second intercept and
    the radii (n) per chain."""
    return counts.node_scan_bytes(C, T, n, d) + 4 * C * (1 + n)


def dir_loglik_constants(C, T, n, d):
    """What ``metrics/dir_loglik_roofline.py`` needs to count the launches
    of a window from the program's counters: the unordered dyads of one
    candidate of one chain (``cand_dyads``), the operations and bytes of a
    launch whatever its candidates (``launch_flops``, ``launch_bytes``),
    of each candidate-dyad (``dyad_flops``) and of each candidate of a
    chain (``cand_flops``, ``cand_bytes``)."""
    pairs = T * n * (n - 1) // 2
    return {'cand_dyads': pairs,
            'launch_flops': C * pairs * counts.DYAD_DISTANCE_FLOPS,
            'launch_bytes': T * n * n + 4 * C * T * n * d,
            'dyad_flops': DIR_DYAD_FLOPS,
            'cand_flops': 2 * n,
            'cand_bytes': 4 * (n + 2 + 1)}


def dir_loglik_work(k, launches, dyads):
    """(operations, bytes) of ``launches`` whole-network launches that
    scored ``dyads`` candidate-dyads, ``k`` the
    :func:`dir_loglik_constants`."""
    cands = dyads / k['cand_dyads']
    return (launches * k['launch_flops'] + dyads * k['dyad_flops']
            + cands * k['cand_flops'],
            launches * k['launch_bytes'] + cands * k['cand_bytes'])


def count(spec, net):
    config, C = spec['config'], spec['traffic']['chains']
    T, n, d, K = config['T'], config['n'], config['d'], config['K']
    k = dir_loglik_constants(C, T, n, d)
    coef, _ = dir_loglik_work(k, SWEEP_LAUNCHES,
                              SWEEP_CANDIDATES * C * k['cand_dyads'])
    latent = node_scan_flops(C, T, n)
    return {'sweep_flops': latent + coef + counts.mixture_flops(C, T, n, K),
            'node_scan_flops': latent,
            'node_scan_bytes': node_scan_bytes(C, T, n, d),
            'dir_loglik': k}
