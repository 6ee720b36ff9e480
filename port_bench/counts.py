"""Operations and bytes of one sweep, from shapes alone: the primitives
that ``sweep_counts/<name>.py`` sum for a cell (the cell's
``workloads/<cell>.json`` names its module under ``"counts"``).

The counts are what the algorithm needs, the same whatever implements it
(PERF.md, "Counting operations", derives each constant at d = 2):

* a dense partner term, one candidate position x of a site against one
  partner x_i: the difference (d), its squares (d), their sum (d - 1),
  the square root, eta = b - dist, softplus(eta) = max(eta, 0) +
  log1p(exp(-|eta|)) (5: max, abs, exp of the negation, log1p, add),
  y * eta and the subtraction: 14;
* a site's update scores both candidates (the proposal and the current
  position) against each partner, takes the two terms' difference and
  adds it to the site's sum: 2 * 14 + 2 = 30 a partner;
* a site's own work, 50: the proposal x + s eps (2 d); the backward
  pull's mean (1 - lambda) x_{t-1} + lambda mu_z (3 d), then for each
  candidate its difference, squares, sum and scale (3 d each); the
  forward pull's x_{t+1} - lambda mu_z' (2 d), then for each candidate
  (1 - lambda) x, the difference, squares, sum and scale (4 d each);
  each candidate's two prior terms summed (2), their difference, its
  sum with the partner sum, the comparison with log u, and the select
  of the position and the flag (4 + d);
* the dense intercept step evaluates each unordered dyad at two
  intercepts: the distance once (3 d: difference, squares, sum, square
  root), then eta, softplus (5), y * eta, the subtraction and the
  accumulation at each intercept (9): 24 a dyad;
* a case-control term, an edge or a control of the site's row: the
  distance (3 d), eta, softplus (5), and the edge's eta - softplus or
  the control's s * softplus: 13; a partner of a site's update 2 * 13 +
  2 = 28; the intercept step a distinct edge or a control once at two
  intercepts: the distance (3 d), then eta, softplus (5), the term and
  the accumulation at each (8): 22;
* the mixture blocks per site, 2 K^2 + 21 K + 14: the emission
  terms (the site's x - (1 - lambda) x_{t-1}, 2 d; per component its
  difference, squares, sum, scale, log-normaliser, the max's subtraction
  and exp, 3 d + 3 = 9; the max over the components, K), the backward
  message (the partial marginal, K; the transition matrix-vector
  product, 2 K^2; the normalisation, 2 K), the forward draw (the Gumbel
  noise -log(-log u), 4 K; the product, log, sum and argmax, 4 K) and
  the sufficient statistics (the label's two counts, the means' sums d,
  the variances' residual, squares, sum and accumulation 3 d).  The per
  chain draws (Dirichlet rows, tables, concentrations: O(T K^2) a chain)
  are under 2% of the per-site count and are left out.

A transcendental (sqrt, exp, log, log1p) counts as one operation.  Bytes
count each input read once and each output written once: the network as
one byte a dyad, float32 fields as four bytes an element.
"""

# NVIDIA H100 SXM data sheet, dense, at the 700 W power limit: float32
# outside the tensor cores, and HBM3 bandwidth
PEAK_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

TERM_FLOPS = 14
PARTNER_FLOPS = 2 * TERM_FLOPS + 2
SITE_FLOPS = 50
DYAD_DISTANCE_FLOPS = 6
DYAD_INTERCEPT_FLOPS = 9
CC_TERM_FLOPS = 13
CC_PARTNER_FLOPS = 2 * CC_TERM_FLOPS + 2
CC_INTERCEPT_FLOPS = 6 + 2 * 8


def mixture_site_flops(K):
    return 2 * K * K + 21 * K + 14


def mixture_flops(C, T, n, K):
    """The mixture blocks of one sweep: every site's labels, messages and
    statistics."""
    return C * T * n * mixture_site_flops(K)


def latent_flops(C, T, n):
    """One dense latent update ('exact' or 'parallel'): every site against
    its n - 1 partners at two candidates."""
    return C * T * n * ((n - 1) * PARTNER_FLOPS + SITE_FLOPS)


def node_scan_bytes(C, T, n, d):
    """The node scan's inputs read once and outputs written once: the
    network (T n^2 bytes, shared by the chains); per site the position
    (d), step size, two phases of proposal noise (2 d) and log-uniforms
    (2), the cluster mean (d) and variance; per chain the intercept and
    lambda; out the new positions (d) and the accept flags."""
    per_site_in = d + 1 + 2 * d + 2 + d + 1
    per_site_out = d + 1
    return T * n * n + 4 * (C * T * n * (per_site_in + per_site_out)
                            + 2 * C)


def intercept_flops(C, T, n):
    """The dense undirected intercept step: every unordered dyad at two
    intercepts."""
    return C * T * (n * (n - 1) // 2) * (DYAD_DISTANCE_FLOPS
                                         + 2 * DYAD_INTERCEPT_FLOPS)


def cc_latent_flops(C, T, n, edges, m):
    """One case-control latent update: each site against the edges of its
    row and its m controls, at two candidates; ``edges`` the network's
    edge entries over all rows and times (each undirected edge in two
    rows)."""
    return C * ((edges + T * n * m) * CC_PARTNER_FLOPS + T * n * SITE_FLOPS)


def cc_intercept_flops(C, T, n, edges, m):
    """The case-control intercept step: each distinct edge once and each
    row's m controls, at two intercepts."""
    return C * (edges // 2 + T * n * m) * CC_INTERCEPT_FLOPS


def least_seconds(flops, nbytes):
    """The least time the card could take: the larger of the operations
    over the peak rate and the bytes over the peak bandwidth."""
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES_PER_S)
