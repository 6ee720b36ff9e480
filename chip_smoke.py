"""Drive the PyTorch port (dynetlsm_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each of which fails the run (exit code 1) when it fails:

1. the card (``nvidia-smi`` name and power limit) and the torch / CUDA
   versions;
2. the build of the CUDA kernels from ``dynetlsm_tpu_torch/csrc`` (nvcc,
   first use), with its time and ptxas report;
3. the node-scan kernel against its plain PyTorch version on the card, on
   one numpy-seeded proposal stream, at the north-star shape (T=10, n=500,
   d=2, 32 chains, K=25) and the Sampson shape (T=3, n=18, 512 chains,
   K=10), at every cluster size (blocks per chain) that the launch rule
   or a forced ``cluster=`` reaches there (1, 2 and 4 at the north star,
   1 at Sampson): identical accept indicators and positions (max |dX| =
   0);
4. the pair log-likelihood kernel against its plain version at the north
   star and Sampson shapes, with two intercepts and with one (the replica
   swap's mode), and at a few awkward shapes (n not a multiple of the
   tile, n = 2, T = 1, one chain) and at the nested LSM's (one chain at
   T=10, n=500: the most partials a chain's final reduce adds): rtol 1e-5
   per candidate, bit-identical
   on rerun, and the error of each column and of the columns' difference
   (what the MH step consumes) against a float64 dense evaluation;
5. the directed mode of the node-scan kernel against its plain version,
   as in 3, on packed ``Y + 2 Y^T`` adjacencies with social radii, at the
   directed north star (T=10, n=500, 32 chains, K=25) and directed Sampson
   (T=3, n=18, 512 chains, K=10);
6. the directed log-likelihood kernel against its plain version at the
   north star and Sampson shapes and the awkward and nested shapes of 4,
   with 1, 2
   and 3 candidates, negative intercepts included: rtol 1e-5 per
   candidate, bit-identical on rerun, and the float64 errors as in 4;
7. the random-walk-prior (LSM) mode of the node-scan kernel against its
   plain version, as in 3 and 5, undirected and directed, at the north
   star and Sampson shapes and the nested LSM's one chain (tau_sq 2.0,
   sigma_sq 0.1);
7b. the tempered lane of the node-scan kernel (per-chain inverse
   temperatures ``geomspace(1, 0.2, 4)`` tiled over the chains) against
   its plain version, as in 3, 5 and 7, in all four modes (undirected and
   directed, mixture and random-walk prior) at both shapes;
8. the slices, each built by ``entry.build_state_and_sweep`` and run for
   2 warm-up and 20 timed sweeps through the port's runner, with every
   launch counter set to 0 just before and read just after: the sticky
   HDP-LPCM at the north star (synthetic network, K=25, 32 chains) and on
   Sampson's monastery (K=10, 512 chains), the LSM at both, and the LPCM
   at the north star (K=8, the generator's communities) and on Sampson
   (K=4), each undirected and directed.  Every logp finite, ``it`` = 22,
   the node scan launched once per sweep and the pair kernel once per
   undirected sweep or the directed kernel three times per directed sweep
   (and the other not at all), and the final logp equal to the log joint
   recomputed densely from the final state (rtol 1e-5 plus atol 1e-3:
   one float32 ulp of the log joint's largest terms);
8b. the tempered slices, built by ``build_state_and_sweep(...,
   n_temps=4)`` (ladders of 4 rungs from 1 to 0.2, bench.py's
   ``tempered`` row) and run as in 8 through the parallel-tempering step:
   the HDP-LPCM at the north star (8 ladders), undirected and directed,
   and on directed Sampson (128 ladders), the LPCM on Sampson, and the LSM
   at both shapes, undirected and directed.  Per step the node scan once
   and the pair kernel twice (undirected: the intercept step and the
   swap's log-likelihood) or the directed kernel four times; every slot's
   logp equal to its dense untempered log joint (as in 8), the ladder
   unchanged bit for bit (no adaptation) and each pair's accepted swaps
   between 0 and its 11 attempts; each rung pair's swap acceptance and the
   cold slots' logp mean are printed;
8c. the tempered against the untempered HDP-LPCM north-star slice, ms per
   sweep, ten alternating rounds of 20 sweeps each in this process, and
   the median of the rounds' paired ratios (the host's speed drifts within
   a run by more than the swap costs);
10. one network a chain (missing-dyad resampling keeps one per chain, read
   through the kernels' chain stride): the node scan in all eight modes at
   the north star, Sampson and an awkward shape (T=3, n=45, 8 chains) as
   in 3, 5, 7 and 7b and in both random-walk modes at the nested shape,
   and the pair kernel (1 and 2 intercepts) and the directed kernel (1 to
   3 candidates) at the north star, Sampson and the awkward and nested
   shapes of 4 (n = 45: the byte-wise load) as in 4 and 6; each
   against its plain version on the same per-chain networks, and a
   per-chain network whose chains all equal one shared network gives the
   shared launch's bits;
11. the missing-dyad slices: ``build_state_and_sweep`` on the north-star
   network with 10% of its dyads coded -1 (seeded, both entries of a pair
   when undirected): the HDP-LPCM undirected and directed, the LSM and the
   tempered HDP-LPCM (8 ladders x 4 rungs), 2 + 20 steps as in 8.  The
   observed dyads unchanged bit for bit in every chain, Y 0/1 with a zero
   diagonal (symmetric when undirected), ``missing_sum`` zero off the
   mask, every logp equal to the dense log joint of the state on its own
   Y, and per step the node scan once and the pair kernel twice
   undirected (the intercept step and the log joint on the new network;
   three tempered, with the swap's) or the directed kernel four times;
12. the Geweke joint-distribution checks of ``dynetlsm_tpu_torch/geweke.py``
   through the kernels: the LSM, the directed LSM, the LPCM and the
   HDP-LPCM at T=3, n=8, 1,024 chains of 600 sweeps from exact prior
   draws with every dyad missing (every |z| < 5), the case-control LSM at
   its full-control limit (torch code, no kernel), the LSM with the joint
   MALA latent update (torch code, no node scan), the LSM's power check
   (|z| of the smoothness moment against a perturbed prior > 8) and the
   equal-temperature replica swap of the directed LSM (256 ladders of 4
   rungs, block |z| < 4.5); the z-scores and the seconds are printed;
13. the public estimators' ``fit`` on the card, through the kernels: the
   sticky HDP-LPCM at bench.py's north-star row (``northstar_network()``,
   T=10, n=500, K=25, 32 chains, 100 + 50 + 50 samples after its nested
   LSM's fixed 500 + 250 + 250) with the wall time of each stage,
   sweeps/s x chains of sampling, ESS(logp) over sampling's seconds, the
   logp R-hat, the mode of ``counts_`` and ``auc_`` (every logp finite,
   ``auc_`` within 0.02 of the AUC of the probabilities the network was
   drawn from, 0.736, the final state's logp at its dense log joint as in
   8); the JAX suite's four fast posterior-equivalence tests (Sampson LSM,
   HDP-LPCM and directed LSM at 4 chains, the LPCM on the simulated
   community network) against its reference numbers
   (``dynetlsm_tpu_torch/equivalence.py``, with their source lines); and a tempered (4 rungs) and a missing-dyad (10%)
   HDP-LPCM fit at Sampson size with ``thin=2``: cold slots only,
   ``(n_total - 1) // 2 + 1`` samples a chain, observed dyads unchanged and
   ``missings_`` in [0, 1]; and a case-control fit (directed Sampson,
   ``n_control=10``, its nested LSM case-control too), whose seconds are
   printed.  Each fit runs with the launch counters set to
   0 just before and read just after, and every count must equal its
   sweeps' (none under case-control; the kernels line's ``fit_launches``
   sums them);
14. the case-control slices, bench.py's ``cc_*`` rows through
   ``build_state_and_sweep(..., n_control=m)`` (the HDP-LPCM at K=25 from
   a random start, 2 + 20 sweeps as in 8): directed and undirected at the
   north star (n=500, m=145, 64 chains), directed at n=2048 (m=145, 128
   chains; past the dense node scan's limit) and directed at n=20,000
   (m=64, 8 chains) from ``datasets.northstar_edge_lists`` with no dense
   network anywhere (the generator's and the colouring's seconds are
   printed).  Every logp finite and equal to its state's case-control log
   joint recomputed from scratch (rtol 1e-5 plus atol 1e-3), no launch of
   the node-scan, pair or directed kernel, and the n = 20,000 slice's own
   peak device memory below 2 GB; each prints its ms/sweep, sweeps/s x
   chains, the chromatic scan's ms (``sample_latent_positions`` timed with
   a synchronisation around it), kernel launches per sweep and the device's
   busy share (``torch.profiler``) and its peak memory.  At both n = 500
   shapes the chromatic scan on the card, on 4 chains with seeded noise
   and the slice's controls, class by class from the card's positions,
   against the same torch code on the CPU: identical accepts except where
   the CPU's |log_u - ratio| is below 1e-4 (counted and printed), and the
   positions of every other site within 1e-5; the case-control Geweke
   check runs in 12;
15. past the resident node scan's shared memory, and the other latent
   updates: the split-field mode forced at clusters of 2, 4 and 8 against
   the resident launch in all eight instantiations at the north star
   (identical accepts, max |dX| = 0); the split-field mode (the launch
   rule's, and forced at 2, 4, 8) against the plain version at T=10,
   n=2,560 (P = 4,096), 2 chains, undirected and directed, mixture and
   random-walk prior, shared and per-chain network, as in 3; the slices
   past n = 2048 (HDP-LPCM K=25 at n = 8,192, 16 chains, undirected and
   directed; the LSM at n = 4,096, 32 chains, and n = 16,384, 4 chains;
   bench.py's north-star model at constant expected degree) as in 8, the
   split-field scan launched once a sweep, each with its scan's device
   time from one profiled sweep, the time per phase step, the cluster
   size, the bound, the device's busy share and peak memory; the scan
   launch of that profiled sweep, captured, timed at clusters of 2, 4 and
   8 and, at n = 8,192 undirected and directed and n = 16,384, rerun on
   two of its chains at the rule's cluster and at 2, 4, 8 against the
   plain version (identical accepts, max |dX| = 0, the rule's launch
   equal to the sweep's own on those chains); a DynamicNetworkLSM fit at
   T=10, n=2,100 (20 sweeps), which the estimators refused before, with
   its stage seconds; and the 'parallel'
   and 'mala' latent updates through ``build_state_and_sweep(...,
   latent_update=)`` at the north star (HDP-LPCM with each, the LSM with
   'mala', the directed HDP-LPCM with 'parallel', a tempered HDP-LPCM with
   'mala': no node scan launched, the logp at its dense log joint), the
   directed case-control row with 'parallel' (as in 14), and a Sampson
   HDP-LPCM fit with 'mala' (JAX tests/test_mala.py:43); the MALA LSM's
   Geweke check runs in 12;
9. each kernel's time beside its plain version's at the slices' shapes
   (CUDA events, median of repeats; the node scan's plain version, seconds
   a call, is timed once, in its check), the node scan's at each cluster size
   it reaches with the time per phase step (ms / 2n), and its bound: the
   larger of its
   operations over the card's float32 rate (67 TFLOP/s, each sqrt, exp
   and log1p counted as one operation) and its bytes (each input read
   once, each output written once) over 3.35 TB/s.  The log-likelihood
   kernels' rows also carry ``issue_bound_ms``: the instructions of the
   compiled inner loop per dyad (``LOGLIK_SASS``, counted from ``cuobjdump
   -sass`` by ``scripts/loglik_sass.py``) times the dyads, over 132 SMs x
   128 lanes x the SM clock ``nvidia-smi`` reports under load, or, if
   larger, its MUFU instructions at a quarter of that rate; and
   ``graph_ms``, the time per call of 20 calls captured in one CUDA graph
   and replayed (the device's time without the host's gaps, and the proof
   that a call can be captured: the replay's result equals the eager
   call's bit for bit).  No single PyTorch call computes any of these
   functions, so ``library_ms`` is null.  The rows of 10's per-chain mode
   (``mode`` ending in "per-chain Y") count the per-chain networks' bytes
   in their bound and the missing-dyad slices' launches.  The split-field
   rows (``node_scan_split``, the wrapper's ``split_launches``) time the
   kernel and its plain version at 15's comparison shape (n = 2,560) and
   carry the slice's scan time, time per phase step, cluster size, bound,
   its launch's time at each cluster size and its plain version's time
   on two chains (``slice_*``).

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or outside a
checkout, the script exits 1 and prints no result.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
NS = dict(T=10, n=500, K=25, C=32)
SAMPSON = dict(T=3, n=18, K=10, C=512)
WARM, TIMED = 2, 20
# parallel tempering: rungs per ladder and the hottest inverse temperature
# (bench.py's tempered row)
N_TEMPS, BETA_MIN = 4, 0.2
# the LSM's random-walk prior variances (models/lsm.py defaults)
TAU_SQ, SIGMA_SQ = 2.0, 0.1
# the card's published peaks (NVIDIA H100 SXM data sheet, 700 W)
PEAK_F32_OPS, PEAK_BYTES = 67e12, 3.35e12
SMS, LANES = 132, 128
# small shapes that end mid-tile or have a single dyad, time or chain
AWKWARD = [dict(T=2, n=45, C=3), dict(T=3, n=2, C=4), dict(T=1, n=76, C=5),
           dict(T=2, n=130, C=1)]
# the node scan's awkward shape with one network a chain: rows of n % 4 != 0
AWKWARD_SCAN = dict(T=3, n=45, C=8, K=3)
# the nested LSM that initialises a mixture fit at the north star: one
# chain (models/mixture_base.py::init_from_lsm), so the log-likelihood
# kernels' final reduce adds the most partials a chain (ops/loglik_tiles.py)
NESTED = dict(T=10, n=500, C=1, K=1)
# the share of dyads the missing-dyad slices code -1
MISSING = 0.1
# phase 15: the split-field node scan against its plain version (P =
# 4,096), the slices past the resident mode's n = 2048 (name, model,
# directed, n, chains, whether the slice's own launch is held against the
# plain version; bench.py's north-star model at constant expected degree,
# ``datasets.northstar_edge_lists``), the chains of that launch the plain
# version reruns and the cluster sizes it is timed (and checked) at, the
# refused-before fit, and the slices of the other latent updates at the
# north star (model, directed, latent_update, n_temps) and the
# case-control row they run
SPLIT_PLAIN = dict(T=10, n=2560, C=2, K=5)
LARGE_SLICES = [('hdp n8192', 'hdp', False, 8192, 16, True),
                ('hdp n8192 directed', 'hdp', True, 8192, 16, True),
                ('lsm n4096', 'lsm', False, 4096, 32, False),
                ('lsm n16384', 'lsm', False, 16384, 4, True)]
SPLIT_CHAINS = (0, -1)
SPLIT_CLUSTERS_TIMED = (2, 4, 8)
# the refused-before fit: T = 10 waves of n = 2,100 nodes, past the
# resident mode's n = 2048 (the estimators refused it before the
# split-field mode); its GMDS runs on the host, SMACOF's O(n^2) steps and
# an eigendecomposition a wave, which grow by 2-3x at n = 3,000
LARGE_FIT = dict(T=10, n=2100, n_chains=2, n_iter=10, tune=5, burn=5)
SCHEME_SLICES = [('hdp', False, 'parallel', None),
                 ('hdp', False, 'mala', None), ('lsm', False, 'mala', None),
                 ('hdp', True, 'parallel', None),
                 ('hdp', False, 'mala', N_TEMPS)]
SCHEME_CC = ('cc_directed_northstar', True, 500, 145, 64)
MALA_FIT = dict(n_iter=150, tune=150, burn=150, n_components=6,
                random_state=3, latent_update='mala')
# phase 14: bench.py's case-control rows (name, directed, n, controls a
# node, chains), their K, the n = 20,000 slice's peak memory limit, and the
# chains, accept margin and position tolerance of the CPU comparison
CC_SLICES = [('cc_directed_northstar', True, 500, 145, 64),
             ('cc_undirected_northstar', False, 500, 145, 64),
             ('cc_directed_n2048', True, 2048, 145, 128),
             ('cc_directed_n20000', True, 20000, 64, 8)]
CC_K = 25
CC_PEAK_GB = 2.0
CC_SCAN_CHAINS, CC_MARGIN, CC_DX = 4, 1e-4, 1e-5
# the case-control fit of phase 13: directed Sampson, controls a node
CC_FIT_CONTROLS = 10
# the Geweke phase: chains, sweeps; the swap's ladders
GEWEKE_CHAINS, GEWEKE_SWEEPS, GEWEKE_LADDERS = 1024, 600, 256
PER_CHAIN = 'per-chain Y'
# (instructions, MUFU instructions among them) per dyad of each kernel's
# inner loop as compiled for d = 2 (CUDA 12.8, sm_90a, -fmad=false), by
# kernel and candidate count (scripts/loglik_sass.py prints them from
# cuobjdump -sass; a pass of the loop scores 4 dyads)
LOGLIK_SASS = {
    ('pair_loglik', 1): (82.25, 2), ('pair_loglik', 2): (133.25, 3),
    ('dir_loglik', 1): (145.0, 3), ('dir_loglik', 2): (238.5, 5),
    ('dir_loglik', 3): (336.25, 7)}


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(*args):
    print(*args, flush=True)


def card_line():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, 'nvidia-smi failed: %s' % out.stderr.strip())
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, repeats, warmup=1):
    """Median milliseconds of fn() on the card, CUDA events around each
    call."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def graph_ms(fn, repeats, calls=20):
    """(milliseconds per call of ``calls`` calls of fn captured in one CUDA
    graph and replayed, the last call's result): the device's time without
    the host's gaps between launches."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            out = fn()
    ms = cuda_ms(graph.replay, repeats) / calls
    torch.cuda.synchronize()
    return ms, out


# ---------------------------------------------------------------------------
# phases 3, 5 and 7: node scan, undirected and directed, both priors
# ---------------------------------------------------------------------------

def scan_inputs(C, T, n, K, dev, seed, d=2, directed=False, mixture=True,
                tempered=False, per_chain=False):
    """Numpy-seeded inputs of one scan.  Directed: a zero-diagonal directed
    Y packed as Y + 2 Y^T, intercepts (C, 2) with a negative b_in in every
    fourth chain, and radii of order 1 (so eta is of order 1 and the
    likelihood, not the prior, decides most sites).  ``mixture`` selects
    the prior the scan runs with (``t['mixture']``); ``tempered`` adds the
    per-chain inverse temperatures ``t['temper']``, 4-rung ladders from 1
    to 0.2 (the other inputs are those of the untempered seed);
    ``per_chain`` draws one network a chain (C, T, n, n), of a density
    from 0.02 to 0.1 by chain."""
    import torch
    from dynetlsm_tpu_torch.ops.node_scan import (
        pack_directed, pad_partners, site_cluster_params)
    rng = np.random.RandomState(seed)
    if per_chain:
        Y = rng.binomial(1, rng.uniform(0.02, 0.1, (C, 1, 1, 1)),
                         (C, T, n, n)).astype(np.uint8)
    else:
        Y = rng.binomial(1, 0.05, (T, n, n)).astype(np.uint8)
    if directed:
        Y[..., np.arange(n), np.arange(n)] = 0
    else:
        Y = np.triu(Y, 1)
        Y = Y + np.swapaxes(Y, -1, -2)
    arrs = dict(
        X=rng.randn(C, T, n, d), step=np.full((C, T, n), 0.1),
        eps=rng.randn(C, 2, n, T, d), log_u=np.log(rng.rand(C, 2, n, T)),
        b=1.0 + 0.1 * rng.randn(C), mu=rng.randn(C, K, d),
        sig=rng.rand(C, K) + 0.3, lmbda=np.full(C, 0.9))
    if directed:
        b = 1.0 + 0.1 * rng.randn(C, 2)
        b[::4, 0] = -0.5
        arrs.update(b=b, radii=0.5 + rng.rand(C, n))
    t = {k: torch.as_tensor(v, dtype=torch.float32, device=dev)
         for k, v in arrs.items()}
    t['Y'] = torch.as_tensor(Y.astype(np.uint8), device=dev)
    if directed:
        t['Y'] = pack_directed(t['Y'])
    # the kernel's adjacency, rows padded once, as the sweeps store it
    t['Y_pad'] = pad_partners(t['Y'])
    z = torch.as_tensor(rng.randint(0, K, (C, T, n)), device=dev)
    t['mu_z'], t['sig_z'] = site_cluster_params(t['mu'], t['sig'], z)
    t['mixture'] = mixture
    if tempered:
        t['temper'] = torch.as_tensor(
            np.tile(np.geomspace(1.0, 0.2, N_TEMPS), C // N_TEMPS),
            dtype=torch.float32, device=dev)
    return t


def scan_args(t):
    return (t['Y'], t['X'], t['b'], t['step'], t['eps'], t['log_u'])


def run_scan(t, kernel, cluster=None, mode=None):
    """The kernel (on the padded adjacency, ``cluster`` blocks per chain
    in ``mode`` ('resident' or 'split'), None: the launch rule's) or its
    plain version on the inputs ``t``, with the prior ``t['mixture']``
    selects."""
    from dynetlsm_tpu_torch.ops.node_scan import (
        node_scan_cuda, node_scan_plain)
    radii = t.get('radii')
    if t['mixture']:
        prior = dict(mu_z=t['mu_z'], sig_z=t['sig_z'], lmbda=t['lmbda'])
    else:
        prior = dict(mixture=False, tau_sq=TAU_SQ, sigma_sq=SIGMA_SQ)
    if kernel:
        return node_scan_cuda(t['Y_pad'], *scan_args(t)[1:], radii=radii,
                              temper=t.get('temper'), cluster=cluster,
                              mode=mode, **prior)
    return node_scan_plain(*scan_args(t), radii=radii,
                           temper=t.get('temper'), **prior)


def scan_clusters(t):
    """(the launch rule's (cluster size, mode), every (size, mode) a forced
    ``cluster=`` reaches) at the shape and mode of ``t``: the resident
    clusters of 1, 2, 4 whose block fits and, where the rule takes the
    split-field mode, its clusters of 2, 4, 8."""
    from dynetlsm_tpu_torch.ops.node_scan import (
        SPLIT_CLUSTERS, _MAX_SMEM_BYTES, cuda_layout, smem_bytes)
    C, T, n, d = t['X'].shape
    mode = (t['X'].device.index, 'radii' in t, t['mixture'], 'temper' in t)
    reach = []
    for b in (1, 2, 4):
        try:
            W, B, _ = cuda_layout(C, T, n, d, *mode, cluster=b)
        except ValueError:
            continue
        if smem_bytes(T, n, d, 'radii' in t, W, B) <= _MAX_SMEM_BYTES:
            reach.append((b, 'resident'))
    _, rule, split = cuda_layout(C, T, n, d, *mode)
    if split:
        reach += [(b, 'split') for b in SPLIT_CLUSTERS]
    return (rule, 'split' if split else 'resident'), reach


def first_mismatch(t, acc_k, acc_p, X_k):
    """The first differing site in scan order and its margin
    |log_u - ratio|, recomputed with the plain formulas from the field at
    that moment (identical in both runs up to that site)."""
    import torch
    from dynetlsm_tpu_torch.ops.node_scan import (
        _directed_partial_loglik_terms, _mixture_prior_per_t,
        _partial_loglik_terms, _rw_prior_per_t, _tree_sum, partner_pad)
    diff = (acc_k != acc_p).nonzero().tolist()          # (c, t, j)
    c, t_, j = min(diff, key=lambda s: (s[0], s[2], s[1] % 2, s[1]))
    phase = t_ % 2
    X = t['X'][c:c + 1].clone()
    X[:, :, :j] = X_k[c:c + 1, :, :j]
    if phase == 1:
        X[:, 0::2, j] = X_k[c:c + 1, 0::2, j]
    x_cur = X[:, :, j]
    x_prop = x_cur + t['step'][c:c + 1, :, j, None] * t['eps'][c:c + 1,
                                                              phase, j]
    mask = (torch.arange(X.shape[2], device=X.device) != j).float()
    b = t['b'][c:c + 1]
    Y_row = t['Y'][c, :, j] if t['Y'].dim() == 4 else t['Y'][:, j]
    if 'radii' in t:
        r = t['radii'][c:c + 1]
        b_in, b_out = b[:, 0], b[:, 1]
        p_out = b_in[:, None] / r + b_out[:, None] / r[:, j, None]
        p_in = b_out[:, None] / r + b_in[:, None] / r[:, j, None]

        def terms(x):
            return _directed_partial_loglik_terms(Y_row, X, x, b_in + b_out,
                                                  p_out, p_in)
    else:
        Yf = Y_row.to(torch.float32)

        def terms(x):
            return _partial_loglik_terms(Yf, X, x, b)
    delta = _tree_sum((terms(x_prop) - terms(x_cur)) * mask,
                      partner_pad(X.shape[2]))
    if 'temper' in t:
        delta = t['temper'][c:c + 1, None] * delta
    if t['mixture']:
        mz, sz = t['mu_z'][c:c + 1, :, j], t['sig_z'][c:c + 1, :, j]
        lam = t['lmbda'][c:c + 1]

        def prior(x):
            return _mixture_prior_per_t(x, x_cur, mz, sz, lam)
    else:
        tau, sig = (torch.tensor(v, device=X.device)
                    for v in (TAU_SQ, SIGMA_SQ))

        def prior(x):
            return _rw_prior_per_t(x, x_cur, tau, sig)
    ratio = (delta + prior(x_prop) - prior(x_cur))[0, t_]
    margin = abs(float(t['log_u'][c, phase, j, t_]) - float(ratio))
    return dict(chain=c, node=j, phase=phase, t=t_, margin=margin)


def scan_mode(directed, mixture, tempered=False, per_chain=False):
    return '%s, %s prior%s%s' % ('directed' if directed else 'undirected',
                                 'mixture' if mixture else 'random-walk',
                                 ', tempered' if tempered else '',
                                 ', ' + PER_CHAIN if per_chain else '')


def check_shared_bits(name, got, want):
    """``got``, a launch on a per-chain network whose chains all equal one
    shared network, against ``want``, the shared launch: the same bits."""
    import torch
    torch.cuda.synchronize()
    check(all(torch.equal(g, w) for g, w in zip(got, want)),
          '%s: chains that all read the shared network differ from the '
          'shared launch' % name)


def check_node_scan(shape, dev, seed, directed=False, mixture=True,
                    tempered=False, per_chain=False):
    import torch
    t = scan_inputs(shape['C'], shape['T'], shape['n'], shape['K'], dev,
                    seed, directed=directed, mixture=mixture,
                    tempered=tempered, per_chain=per_chain)
    # the plain version's one run, timed for phase 9's rows
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    X_p, acc_p = run_scan(t, kernel=False)
    end.record()
    end.synchronize()
    t['plain_ms'] = start.elapsed_time(end)
    rule, reach = scan_clusters(t)
    for cluster, mode in reach:
        X_k, acc_k = run_scan(t, kernel=True, cluster=cluster, mode=mode)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(X_k).all()), 'node_scan: non-finite X')
        if not torch.equal(acc_k, acc_p):
            raise SmokeFailure(
                'node_scan accept mismatch (%s cluster %d) at %s (%d sites)'
                % (mode, cluster, first_mismatch(t, acc_k, acc_p, X_k),
                   int((acc_k != acc_p).sum())))
        err = float((X_k - X_p).abs().max())
        check(err == 0.0, 'node_scan (%s cluster %d): max |dX| = %g'
              % (mode, cluster, err))
    X_k, acc_k = run_scan(t, kernel=True)
    check(torch.equal(acc_k, acc_p) and torch.equal(X_k, X_p),
          'node_scan: the launch rule (%s cluster %d) differs' % rule[::-1])
    rate = float(acc_k.mean())
    check(0.0 < rate < 1.0, 'node_scan: acceptance rate %g' % rate)
    if tempered:
        # the cold chains (beta = 1) are the untempered scan's; the hot
        # ones are not
        _, acc_u = run_scan(dict(t, temper=None), kernel=True)
        check(torch.equal(acc_u[::N_TEMPS], acc_k[::N_TEMPS]),
              'node_scan: cold chains differ from the untempered scan')
        check(not torch.equal(acc_u, acc_k),
              'node_scan: the temperatures changed no accept decision')
    if per_chain:
        from dynetlsm_tpu_torch.ops.node_scan import pad_partners
        Y = t['Y'][:1].expand(t['Y'].shape).contiguous()
        check_shared_bits(
            'node_scan', run_scan(dict(t, Y=Y, Y_pad=pad_partners(Y)), True),
            run_scan(dict(t, Y=t['Y'][0], Y_pad=t['Y_pad'][0]), True))
    log('node_scan (%s) %s: accepts identical (rate %.4f), max |dX| %g, '
        'at clusters %s (rule %s)' % (scan_mode(directed, mixture, tempered,
                                                per_chain),
                                      shape, rate, err, reach, rule))
    return t, err


# ---------------------------------------------------------------------------
# phase 4: pair log-likelihood
# ---------------------------------------------------------------------------

def chain_networks(rng, C, T, n, directed):
    """One 0/1 network a chain (C, T, n, n) uint8, of a density from 0.02
    to 0.1 by chain; zero-diagonal, symmetric when undirected."""
    Y = rng.binomial(1, rng.uniform(0.02, 0.1, (C, 1, 1, 1)), (C, T, n, n))
    Y[..., np.arange(n), np.arange(n)] = 0
    if not directed:
        Y = np.triu(Y, 1)
        Y = Y + np.swapaxes(Y, -1, -2)
    return Y.astype(np.uint8)


def pair_inputs(C, T, n, dev, seed, per_chain=False):
    import torch
    rng = np.random.RandomState(seed)
    Y = rng.binomial(1, 0.05, (T, n, n))
    Y = np.triu(Y, 1)
    Y = (Y + Y.transpose(0, 2, 1)).astype(np.uint8)
    if per_chain:
        Y = chain_networks(rng, C, T, n, False)
    b = 1.0 + 0.1 * rng.randn(C)
    f = dict(dtype=torch.float32, device=dev)
    return (torch.as_tensor(Y, device=dev),
            torch.as_tensor(rng.randn(C, T, n, 2), **f),
            torch.as_tensor(b, **f), torch.as_tensor(b + 0.05, **f))


def float64_errors(got, plain, args):
    """(max |error| of any column, max |error| of column 1 minus column 0
    or None with one column) of ``got`` against the plain version on the
    same inputs in float64."""
    exact = plain(*(a.double() if a is not None and a.is_floating_point()
                    else a for a in args))
    col = float((got.double() - exact).abs().max())
    if got.shape[1] < 2:
        return col, None
    diff = float(((got[:, 1] - got[:, 0]).double()
                  - (exact[:, 1] - exact[:, 0])).abs().max())
    return col, diff


def check_loglik(name, kernel, plain, args, shape, mode):
    """One log-likelihood kernel on ``args`` against its plain version:
    finite, bit-identical on rerun, rtol 1e-5 per candidate.  Returns
    {'err', 'err64', 'diff_err64'}."""
    import torch
    got = kernel(*args)
    again = kernel(*args)
    want = plain(*args)
    torch.cuda.synchronize()
    label = '%s %s %s' % (name, mode, shape)
    check(got.shape == want.shape, '%s: shape %s' % (label, got.shape))
    check(bool(torch.isfinite(got).all()), '%s: non-finite' % label)
    check(torch.equal(got, again), '%s: rerun not bit-identical' % label)
    rel = float(((got - want).abs() / want.abs()).max())
    check(rel <= 1e-5, '%s: max rel err %g > 1e-5' % (label, rel))
    err = float((got - want).abs().max())
    col, diff = float64_errors(got, plain, args)
    log('%s: max rel err %g (abs %g), rerun bit-identical; against float64 '
        'max abs err %g, of column 1 - column 0 %s'
        % (label, rel, err, col, 'n/a' if diff is None else '%g' % diff))
    return {'err': err, 'err64': col, 'diff_err64': diff}


def per_chain_shared_bits(name, kernel, args):
    """The shared-launch check of a log-likelihood kernel on per-chain
    ``args``: chain 0's network repeated per chain, and shared."""
    Y, rest = args[0], tuple(args[1:])
    check_shared_bits(name, (kernel(Y[:1].expand(Y.shape).contiguous(),
                                    *rest),), (kernel(Y[0], *rest),))


def check_pair(shape, dev, seed, n_cand=2, per_chain=False):
    from dynetlsm_tpu_torch.ops.pair_loglik import (
        pair_loglik_cuda, pair_loglik_plain)
    args = pair_inputs(shape['C'], shape['T'], shape['n'], dev, seed,
                       per_chain)
    args = args[:2 + n_cand]
    errs = check_loglik('pair_loglik', pair_loglik_cuda, pair_loglik_plain,
                        args, shape, 'n_cand=%d%s' % (
                            n_cand, ', ' + PER_CHAIN if per_chain else ''))
    if per_chain:
        per_chain_shared_bits('pair_loglik', pair_loglik_cuda, args)
    return args, errs


# ---------------------------------------------------------------------------
# phase 6: directed log-likelihood
# ---------------------------------------------------------------------------

def dir_inputs(C, T, n, n_cand, dev, seed, per_chain=False):
    """Packed directed Y (one network a chain with ``per_chain``), radii of
    order 1 and intercepts with a negative b_in in every chain's first
    candidate."""
    import torch
    from dynetlsm_tpu_torch.ops.node_scan import pack_directed
    rng = np.random.RandomState(seed)
    Y = rng.binomial(1, 0.05, (T, n, n))
    Y[:, np.arange(n), np.arange(n)] = 0
    if per_chain:
        Y = chain_networks(rng, C, T, n, True)
    b = 0.3 + 0.5 * rng.randn(C, n_cand, 2)
    b[:, 0, 0] = -np.abs(b[:, 0, 0]) - 0.1
    f = dict(dtype=torch.float32, device=dev)
    return (pack_directed(torch.as_tensor(Y.astype(np.uint8), device=dev)),
            torch.as_tensor(rng.randn(C, T, n, 2), **f),
            torch.as_tensor(0.5 + rng.rand(C, n_cand, n), **f),
            torch.as_tensor(b, **f))


def check_dir(shape, n_cand, dev, seed, per_chain=False):
    from dynetlsm_tpu_torch.ops.dir_loglik import (
        dir_loglik_cuda, dir_loglik_plain)
    args = dir_inputs(shape['C'], shape['T'], shape['n'], n_cand, dev, seed,
                      per_chain)
    errs = check_loglik('dir_loglik', dir_loglik_cuda, dir_loglik_plain,
                        args, shape, 'n_cand=%d%s' % (
                            n_cand, ', ' + PER_CHAIN if per_chain else ''))
    if per_chain:
        per_chain_shared_bits('dir_loglik', dir_loglik_cuda, args)
    return args, errs


# ---------------------------------------------------------------------------
# phase 8: the slices
# ---------------------------------------------------------------------------

def check_scan_layouts(lib, dev):
    """The wrapper's shared-memory formula (ops/node_scan.py, which the
    CPU tests check) against the kernel library's own count, which the
    launch uses, at both shapes and every cluster size they reach; and the
    rule's choice with the card's count of clusters it runs at once."""
    from dynetlsm_tpu_torch.ops.node_scan import (
        _sm_count, cuda_layout, partner_pad, smem_bytes)
    sms = _sm_count(dev.index)
    for shape in (NS, SAMPSON):
        C, T, n = shape['C'], shape['T'], shape['n']
        for directed in (False, True):
            for cluster, mode in ((None, None), (1, None), (2, None),
                                  (4, None), (2, 'split'), (4, 'split'),
                                  (8, 'split')):
                try:
                    W, B, split = cuda_layout(C, T, n, 2, dev.index,
                                              directed, True, False, cluster,
                                              mode)
                except ValueError:
                    continue
                want = smem_bytes(T, n, 2, directed, W, B, split)
                got = lib.node_scan_smem_bytes(T, n, 2, partner_pad(n),
                                               32 * W * B, int(directed), B,
                                               int(split))
                check(got == want, 'node_scan layout: the library gives %d '
                      'bytes of shared memory, the wrapper %d' % (got, want))
        W, B, _ = cuda_layout(C, T, n, 2, dev.index, True, True, False)
        fits = {b: lib.node_scan_max_clusters(T, n, 2, partner_pad(n), W, b,
                                              1, 1, 0, 0)
                for b in (2, 4) if 32 * W * b <= partner_pad(n)}
        log('node_scan launch at T=%d, n=%d, %d chains on %d SMs: %d warps '
            'a time, clusters of %d, %d threads, %d bytes of shared memory '
            '(directed, mixture prior); the card runs %s clusters of %s '
            'blocks at once' % (T, n, C, sms, W, B,
                                lib.node_scan_threads(T, W),
                                lib.node_scan_smem_bytes(
                                    T, n, 2, partner_pad(n), 32 * W * B, 1,
                                    B, 0),
                                list(fits.values()), list(fits)))


class SplitCounter:
    """The node-scan wrapper's count of split-field launches
    (``node_scan_cuda.split_launches``) as a ``launches`` attribute."""

    @property
    def launches(self):
        from dynetlsm_tpu_torch.ops.node_scan import node_scan_cuda
        return node_scan_cuda.split_launches

    @launches.setter
    def launches(self, value):
        from dynetlsm_tpu_torch.ops.node_scan import node_scan_cuda
        node_scan_cuda.split_launches = value


def launch_counters():
    """Each kernel's launch counter: the node scan's resident and
    split-field modes apart."""
    from dynetlsm_tpu_torch.ops.dir_loglik import dir_loglik_cuda
    from dynetlsm_tpu_torch.ops.node_scan import node_scan_cuda
    from dynetlsm_tpu_torch.ops.pair_loglik import pair_loglik_cuda
    return {'node_scan': node_scan_cuda, 'node_scan_split': SplitCounter(),
            'pair_loglik': pair_loglik_cuda, 'dir_loglik': dir_loglik_cuda}


def run_slice(name, Y, shape, dev, directed=False, model='hdp',
              n_temps=None, latent_update='exact', report=None):
    """Build ``model`` ('hdp', 'lpcm' or 'lsm') on Y with
    ``entry.build_state_and_sweep`` (with ``n_temps``, its parallel-
    tempering step; ``latent_update`` its scheme), run WARM + TIMED sweeps
    through the runner with the launch counters set to 0 just before and
    read just after, and check them.  Dyads of Y coded -1 are missing: the
    state carries each chain's network and the checks of phase 11 apply.
    The exact scheme launches the node scan once a sweep, in the mode its
    launch rule takes; 'parallel' and 'mala' launch none.  ``report``, a
    dict, receives the final state, sweep and generator.  Returns
    (launches, ms per timed sweep)."""
    import torch
    from dynetlsm_tpu_torch.entry import build_state_and_sweep
    from dynetlsm_tpu_torch.mcmc.driver import make_scan_runner
    from dynetlsm_tpu_torch.mcmc.sweeps import (
        _lsm_logp, hdp_logp_at_state, lpcm_logp_at_state)
    C = shape['C']
    t_build = time.perf_counter()
    state, sweep, gen = build_state_and_sweep(Y, C, K=shape['K'],
                                              device=dev,
                                              is_directed=directed,
                                              model=model, n_temps=n_temps,
                                              beta_min=BETA_MIN,
                                              latent_update=latent_update)
    build_s = time.perf_counter() - t_build
    ladder = None if n_temps is None else state.temper.clone()
    missing = state.Y is not None
    check(missing == bool((Y == -1).any()), '%s: state.Y' % name)
    runner = make_scan_runner(sweep, lambda s: {'logp': s.logp},
                              chunk=TIMED)
    sweeps = WARM + TIMED
    # a tempered step adds the swap's log-likelihood, the missing dyads
    # the log joint's on the new network: one more pair or directed launch
    # each
    extra = (n_temps is not None) + missing
    expected = ({'pair_loglik': 0, 'dir_loglik': (3 + extra) * sweeps}
                if directed else
                {'pair_loglik': (1 + extra) * sweeps, 'dir_loglik': 0})
    split = False
    if latent_update == 'exact':
        from dynetlsm_tpu_torch.ops.node_scan import cuda_layout
        split = cuda_layout(C, shape['T'], shape['n'], 2, dev.index,
                            directed, model != 'lsm', n_temps is not None)[2]
    expected['node_scan'] = (sweeps if latent_update == 'exact'
                             and not split else 0)
    expected['node_scan_split'] = sweeps if split else 0
    counters = launch_counters()
    torch.cuda.reset_peak_memory_stats(dev)
    for fn in counters.values():
        fn.launches = 0
    state, warm = runner(state, gen, WARM)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, traced = runner(state, gen, TIMED)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    logps = torch.cat([warm['logp'][:WARM], traced['logp'][:TIMED]])
    check(bool(torch.isfinite(logps).all()), '%s: non-finite logp' % name)
    check(bool((state.it == sweeps).all()), '%s: it != %d'
          % (name, sweeps))
    for k, v in launches.items():
        check(v == expected[k], '%s: %s launched %d times in %d sweeps, '
              'expected %d' % (name, k, v, sweeps, expected[k]))
    T, n = Y.shape[:2]
    check(tuple(state.X.shape) == (C, T, n, 2), '%s: X shape' % name)
    acc_rate = float(state.acc_X.mean()) / sweeps
    # MALA accepts a chain's whole field, at first at every step
    check(0.0 < acc_rate < 1.0 or (latent_update == 'mala'
                                   and acc_rate == 1.0),
          '%s: X acceptance %g' % (name, acc_rate))
    s = state
    t_check = time.perf_counter()
    Yd = torch.as_tensor(Y, device=dev)
    if missing:
        Yd = s.Y
        check_missing_state(name, Y, s, directed, sweeps)
    prior = np.zeros(2 if directed else 1, np.float32)
    if model == 'lsm':
        dense = _lsm_logp(sweep.cfg, Yd, s.X, s.intercept, s.radii, None,
                          torch.as_tensor(prior, device=dev))
    elif model == 'lpcm':
        dense = lpcm_logp_at_state(
            sweep.cfg, Yd, prior, s.X, s.intercept, s.z, s.mu, s.sigma,
            s.lmbda, s.init_weights, s.trans_weights, s.mean_var, s.b_scale,
            radii=s.radii)
    else:
        dense = hdp_logp_at_state(
            sweep.cfg, Yd, prior, s.X, s.intercept, s.z, s.mu, s.sigma,
            s.lmbda, s.weights, s.beta, s.gamma, s.alpha_init, s.alpha,
            s.kappa, s.mean_var, s.b_scale, radii=s.radii)
    gap = (dense - s.logp).abs()
    rel = float((gap / s.logp.abs()).max())
    check(bool((gap <= 1e-5 * s.logp.abs() + 1e-3).all()),
          '%s: sweep logp vs dense log joint rel err %g' % (name, rel))
    ms = 1e3 * elapsed / TIMED
    extra = ''
    if T * n * n > 1 << 26:
        extra += ', build %.1f s, log-joint check %.1f s' % (
            build_s, time.perf_counter() - t_check)
    if n_temps is not None:
        check(torch.equal(s.temper, ladder), '%s: the ladder moved' % name)
        # each pair (i, i + 1) is attempted every other sweep
        attempts = sweeps // 2
        check(bool(((s.acc_swap >= 0) & (s.acc_swap <= attempts)).all()),
              '%s: acc_swap outside [0, %d]' % (name, attempts))
        rates = (s.acc_swap.reshape(-1, n_temps)[:, :n_temps - 1].mean(0)
                 / attempts)
        extra += (', swap acceptance by rung pair %s, cold-slot logp mean '
                  '%.2f' % ([round(float(r), 4) for r in rates],
                            float(s.logp[::n_temps].mean())))
    if model == 'lsm':
        # the MAP stays with the slot and a swap can bring it a better
        # configuration after the sweep tracked it, so only untempered
        check(n_temps is not None or bool((s.logp_map >= s.logp).all()),
              '%s: MAP logp below the current logp' % name)
        extra += ', MAP logp mean %.2f' % float(s.logp_map.mean())
    if directed:
        extra += (', radii acceptance %.3f, intercepts mean %s'
                  % (float(s.acc_radii.mean()) / sweeps,
                     [round(float(v), 4) for v in s.intercept.mean(0)]))
    log('slice %s (T=%d, n=%d%s, %d chains): %.3f ms/sweep, %.1f '
        'sweeps/s x chains, X acceptance %.3f, logp mean %.2f, '
        'dense-logp rel err %g (abs %g), launches %s, peak device memory '
        '%.3f GB%s'
        % (name, T, n, '' if model == 'lsm' else ', K=%d' % shape['K'], C,
           ms, C / (ms / 1e3), acc_rate, float(s.logp.mean()), rel,
           float(gap.max()), launches, peak_gb, extra))
    if report is not None:
        report.update(state=s, sweep=sweep, gen=gen, peak_gb=peak_gb)
    return launches, ms


def check_missing_state(name, Y, s, directed, sweeps):
    """The missing-dyad slice's final state against its coded network Y:
    observed dyads unchanged in every chain, Y 0/1 with a zero diagonal
    (symmetric when undirected), ``missing_sum`` zero off the mask and at
    most the sweeps on it (``n_burn`` is 0: every sweep counts)."""
    import torch
    dev = s.Y.device
    n = Y.shape[1]
    coded = torch.as_tensor(Y, device=dev)
    miss = coded == -1
    miss[:, torch.arange(n), torch.arange(n)] = False
    obs = ~miss
    obs[:, torch.arange(n), torch.arange(n)] = False
    check(torch.equal(s.Y[:, obs], coded[obs].to(torch.uint8).expand(
        s.Y.shape[0], -1)), '%s: an observed dyad changed' % name)
    check(bool((s.Y <= 1).all()), '%s: Y is not 0/1' % name)
    check(not bool(s.Y[..., torch.arange(n), torch.arange(n)].any()),
          '%s: a diagonal dyad is set' % name)
    if not directed:
        check(torch.equal(s.Y, s.Y.transpose(-1, -2)),
              '%s: the undirected Y is not symmetric' % name)
    check(not bool(s.missing_sum[:, ~miss].any()),
          '%s: missing_sum off the mask' % name)
    check(bool((s.missing_sum[:, miss] <= sweeps).all()),
          '%s: missing_sum above the sweeps' % name)
    drawn = s.Y[:, miss].float().mean()
    check(0.0 < float(drawn) < 1.0, '%s: missing density %g'
          % (name, float(drawn)))
    log('slice %s: %d missing dyads a chain, observed dyads unchanged, '
        'missing density %.4f (observed %.4f), mean missing_sum %.3f'
        % (name, int(miss.sum()), float(drawn),
           float(coded[obs].float().mean()),
           float(s.missing_sum[:, miss].mean())))


def slice_name(model, shape, directed, n_temps, missing=False):
    return '%s %s%s%s%s' % (
        model, 'northstar' if shape['n'] == NS['n'] else 'sampson',
        ' directed' if directed else '',
        '' if n_temps is None else ' tempered', ' missing' if missing else '')


def alternate_tempered(Y, shape, dev, rounds=10):
    """ms per sweep of the untempered HDP-LPCM slice and of its
    parallel-tempering step (``n_temps`` = N_TEMPS) on Y, in ``rounds``
    alternating rounds of TIMED sweeps after WARM sweeps each.  Returns
    {'untempered': [...], 'tempered': [...]}."""
    import torch
    from dynetlsm_tpu_torch.entry import build_state_and_sweep
    runs = {}
    for label, n_temps in (('untempered', None), ('tempered', N_TEMPS)):
        state, step, gen = build_state_and_sweep(
            Y, shape['C'], K=shape['K'], device=dev, n_temps=n_temps,
            beta_min=BETA_MIN)
        for _ in range(WARM):
            state = step(state, gen)
        runs[label] = [step, state, gen]
    times = {label: [] for label in runs}
    for _ in range(rounds):
        for label, run in runs.items():
            step, state, gen = run
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(TIMED):
                state = step(state, gen)
            torch.cuda.synchronize()
            times[label].append(1e3 * (time.perf_counter() - t0) / TIMED)
            run[1] = state
    for run in runs.values():
        check(bool(torch.isfinite(run[1].logp).all()),
              'alternating rounds: non-finite logp')
    return times


# ---------------------------------------------------------------------------
# phase 12: Geweke joint-distribution checks
# ---------------------------------------------------------------------------

def geweke_phase(dev):
    """Every model's Geweke check (``dynetlsm_tpu_torch/geweke.py``) at
    GEWEKE_CHAINS chains of GEWEKE_SWEEPS sweeps, the LSM's power check and
    the equal-temperature swap, through the kernels, from the JAX tests'
    seeds.  Returns {check: (max |z|, seconds)}."""
    import torch
    from dynetlsm_tpu_torch import geweke
    out = {}
    for model in geweke.MODELS:
        t0 = time.perf_counter()
        mc, sc = geweke.geweke_samples(model, GEWEKE_CHAINS, GEWEKE_SWEEPS,
                                       geweke.SEEDS[model], dev)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        z = geweke.compare(mc, sc)
        log('geweke %s: %d chains x %d sweeps in %.1f s, z %s'
            % (model, GEWEKE_CHAINS, GEWEKE_SWEEPS, seconds,
               np.round(z, 3).tolist()))
        check(bool(np.all(np.abs(z) < geweke.LIMIT)),
              'geweke %s: |z| >= %g: %s' % (model, geweke.LIMIT, z))
        out[model] = (float(np.abs(z).max()), seconds)
        if model == 'lsm':
            power = geweke.lsm_power_z(sc)
            log('geweke lsm power: z against the perturbed prior %s'
                % np.round(power, 3).tolist())
            check(abs(power[4]) > geweke.POWER_LIMIT,
                  'geweke lsm: the perturbed prior was not detected (z %g)'
                  % power[4])
            out['lsm power'] = (float(abs(power[4])), 0.0)
    t0 = time.perf_counter()
    mc, sc = geweke.pt_swap_samples(GEWEKE_LADDERS, GEWEKE_SWEEPS,
                                    geweke.SEEDS['swap'], dev)
    seconds = time.perf_counter() - t0
    z = geweke.pt_block_z(mc, sc)
    log('geweke swap at equal temperatures: %d ladders x %d rungs x %d '
        'steps in %.1f s, block z %s' % (GEWEKE_LADDERS, N_TEMPS,
                                         GEWEKE_SWEEPS, seconds,
                                         np.round(z, 3).tolist()))
    check(bool(np.all(np.abs(z) < geweke.PT_LIMIT)),
          'geweke swap: |z| >= %g: %s' % (geweke.PT_LIMIT, z))
    out['swap'] = (float(np.abs(z).max()), seconds)
    return out


# ---------------------------------------------------------------------------
# phase 13: the estimators
# ---------------------------------------------------------------------------

# the north-star fit: bench.py's north-star row through the public API
NS_FIT = dict(n_components=25, n_chains=32, n_iter=100, tune=50, burn=50,
              random_state=0)
# how far the north-star fit's auc_ may fall below the AUC of the edge
# probabilities the network was drawn from (0.7363): the limit, 0.716,
# sits between the sound fit's 0.7465 and the 0.497-0.499 of scrambled
# positions or node order (scripts/fit_checks.py on an H100 at 700 W).  A
# sampler that never moved (0.759), a start without the nested LSM's
# sweeps (0.738) and an intercept held at 0 (0.767) read as high as a
# sound fit: auc_ cannot see them, the equivalence and Geweke checks do
NS_AUC_SLACK = 0.02
# the nested LSM of a mixture fit: 500 + 250 + 250 samples, one sweep each
# after the initial one (models/mixture_base.py::init_from_lsm)
NESTED_SWEEPS = 999
# the tempered, missing-dyad and thinned fits at Sampson size
SMALL_FIT = dict(n_components=10, n_chains=4, n_iter=100, tune=50, burn=50,
                 thin=2, random_state=3)


def counted_fit(name, est, Y, dev, nested=True, missing=False,
                tempered=False, cc=False, split=False):
    """Fit ``est`` on Y with every launch counter set to 0 just before and
    read just after, and check the counts: per sweep the node scan once
    (in its split-field mode with ``split``; the fit's own sweeps none
    under ``latent_update`` 'parallel' or 'mala', the nested LSM's
    exact ones still) and the pair kernel once (three directed-kernel
    launches when directed), one more with missing dyads and one more a
    tempered step (the swap), over the nested LSM's sweeps (untempered)
    and the fit's; none at all under case-control (``cc``).  Returns
    (launches, wall seconds, peak device memory GB)."""
    import torch
    counters = launch_counters()
    torch.cuda.reset_peak_memory_stats(dev)
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    est.fit(Y)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    thin = getattr(est, 'thin', None) or 1
    n_total = est.n_iter + est.tune + est.burn
    main = (n_total - 1) // thin * thin
    nested = NESTED_SWEEPS if nested else 0
    per = 3 if est.is_directed else 1
    loglik = 'dir_loglik' if est.is_directed else 'pair_loglik'
    scans = nested + (main if est.latent_update == 'exact' else 0)
    expected = {'node_scan': 0 if split else scans,
                'node_scan_split': scans if split else 0, 'pair_loglik': 0,
                'dir_loglik': 0}
    expected[loglik] = ((per + missing) * nested
                        + (per + missing + tempered) * main)
    if cc:
        expected = dict.fromkeys(expected, 0)
    check(launches == expected, '%s fit: launches %s, expected %s'
          % (name, launches, expected))
    return launches, seconds, torch.cuda.max_memory_allocated(dev) / 1e9


def check_logp_gap(name, gap, rel, within):
    check(within, '%s: final logp vs dense log joint: max gap %g (relative '
          '%g)' % (name, gap, rel))


def final_logp_gap(m, dev):
    """(max |logp - dense log joint|, max relative, whether every chain
    is within rtol 1e-5 plus atol 1e-3 as the slices check it) over the
    chains of a mixture fit's final state, the log joint recomputed densely
    on the card from that state."""
    import torch
    from dynetlsm_tpu_torch.mcmc.sweeps import hdp_logp_at_state
    fs = m._final_state

    def t(name):
        v = torch.as_tensor(getattr(fs, name), device=dev)
        return v.long() if name == 'z' else v.float()
    Y = fs.Y if getattr(fs, 'Y', None) is not None else m.Y_fit_
    dense = hdp_logp_at_state(
        m._cfg, torch.as_tensor(np.asarray(Y, np.float32), device=dev),
        m.intercept_prior_.astype(np.float32),
        *(t(f) for f in ('X', 'intercept', 'z', 'mu', 'sigma', 'lmbda',
                         'weights', 'beta', 'gamma', 'alpha_init', 'alpha',
                         'kappa', 'mean_var', 'b_scale')),
        radii=t('radii') if m.is_directed else None)
    logp = t('logp')
    gap = (dense - logp).abs()
    return (float(gap.max()), float((gap / logp.abs()).max()),
            bool((gap <= 1e-5 * logp.abs() + 1e-3).all()))


def estimator_phase(dev):
    """Phase 13: the public estimators' ``fit`` on the card.  Returns the
    kernels' launches summed over the phase's fits."""
    import torch
    from dynetlsm_tpu_torch import DynamicNetworkHDPLPCM, equivalence
    from dynetlsm_tpu_torch.datasets import (
        load_dynamic_monks, northstar_network, northstar_probas,
        with_missing_dyads)
    from dynetlsm_tpu_torch.metrics import network_auc
    total = {}

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    # the north-star fit, bench.py's north-star row through the public API
    m = DynamicNetworkHDPLPCM(device=dev, **NS_FIT)
    launches, seconds, peak = counted_fit('hdp northstar', m,
                                          northstar_network(), dev)
    add(launches)
    oracle = network_auc(m.Y_fit_, np.broadcast_to(
        northstar_probas(n=m.Y_fit_.shape[1]), m.Y_fit_.shape))
    gap, rel, within = final_logp_gap(m, dev)
    sampling = m.stage_seconds_['sampling']
    sweeps = m.logps_.shape[1] - 1
    vals, freqs = np.unique(m.counts_, return_counts=True)
    T, n = m.Y_fit_.shape[:2]
    C = m.n_chains
    log('estimator hdp northstar (T=%d, n=%d, K=%d, %d chains, %d + %d '
        'sweeps): %.1f s, stages %s'
        % (T, n, m.n_components, C, NESTED_SWEEPS, sweeps, seconds,
           ', '.join('%s %.3f s' % kv for kv in m.stage_seconds_.items())))
    log('estimator hdp northstar: sampling %.1f sweeps/s x chains, '
        'ESS(logp) %.1f over %d post-burn samples x %d chains, %.2f '
        'ESS(logp)/s of sampling, logp R-hat %.4f, counts_ mode %d %s, '
        'auc_ %.4f (the generating probabilities\' %.4f), final logp vs '
        'dense rel err %g (abs %g), launches %s, peak device memory %.3f GB'
        % (sweeps * C / sampling, m.logp_effective_n_,
           sweeps + 1 - m.n_burn_, C, m.logp_effective_n_ / sampling,
           m.logp_rhat_, vals[np.argmax(freqs)], dict(zip(
               vals.tolist(), freqs.tolist())), m.auc_, oracle, rel, gap,
           launches, peak))
    check(bool(np.isfinite(m.logps_).all()), 'northstar fit: non-finite '
          'logps_')
    # the fit must rank the dyads about as well as the probabilities the
    # network was drawn from (0.1 within a community, 0.01 across): their
    # own AUC on this draw is only 0.736, so a fixed 0.75 would be a coin
    # flip for a correct fit
    check(m.auc_ > oracle - NS_AUC_SLACK, 'northstar fit: auc %g, the '
          'generating probabilities\' %g' % (m.auc_, oracle))
    check_logp_gap('northstar fit', gap, rel, within)

    # posterior equivalence with the JAX suite's reference numbers
    for name in ('lsm', 'hdp', 'lsm directed', 'lpcm'):
        est, Y, z_true = equivalence.make_fit(name, dev, fast=True)
        launches, seconds, _ = counted_fit(
            'equivalence ' + name, est, Y, dev,
            nested=name in ('hdp', 'lpcm'))
        add(launches)
        ok, stats, ref = equivalence.posterior_stats(name, est, True,
                                                     z_true)
        check(ok, 'equivalence %s (fast budget): %s against the reference '
              '%s' % (name, stats, ref))
        log('estimator equivalence %s: %.1f s, %s, launches %s'
            % (name, seconds, ', '.join('%s %.4f' % kv
                                        for kv in stats.items()), launches))

    # tempered, missing-dyad and thinned fits at Sampson size
    Y = load_dynamic_monks()
    coded = with_missing_dyads(Y, MISSING, seed=6)
    for name, net, extra in (('tempered', Y, dict(n_temps=N_TEMPS,
                                                  beta_min=BETA_MIN)),
                             ('missing', coded, {})):
        m = DynamicNetworkHDPLPCM(device=dev, **SMALL_FIT, **extra)
        launches, seconds, _ = counted_fit(
            'sampson ' + name, m, net, dev, missing=name == 'missing',
            tempered=name == 'tempered')
        add(launches)
        C, thin = SMALL_FIT['n_chains'], SMALL_FIT['thin']
        n_total = SMALL_FIT['n_iter'] + SMALL_FIT['tune'] + SMALL_FIT['burn']
        samples = (n_total - 1) // thin + 1
        check(m.Xs_.shape == (C, samples, 3, 18, 2)
              and m.logps_.shape == (C, samples),
              'sampson %s fit: trace shapes %s %s' % (
                  name, m.Xs_.shape, m.logps_.shape))
        check(bool(np.isfinite(m.logps_).all()), 'sampson %s fit: '
              'non-finite logps_' % name)
        check(m._final_state.X.shape[0] == C, 'sampson %s fit: final state '
              'of %d slots' % (name, m._final_state.X.shape[0]))
        extra_log = ''
        if name == 'tempered':
            check(m.temper_ladder_.shape == (C * N_TEMPS,),
                  'tempered fit: ladder shape %s' % (m.temper_ladder_.shape,))
            extra_log = ', ladder %s' % np.round(
                m.temper_ladder_[:N_TEMPS], 4).tolist()
        else:
            observed = coded != -1
            check(bool(np.array_equal(m.Y_fit_[observed], Y[observed])),
                  'missing fit: an observed dyad changed')
            miss = m.missings_[~observed & ~np.eye(18, dtype=bool)[None]]
            check(bool(np.isfinite(m.missings_).all()
                       and (m.missings_ >= 0).all()
                       and (m.missings_ <= 1).all()
                       and not m.missings_[observed].any()),
                  'missing fit: missings_ outside [0, 1] or set off the '
                  'mask')
            extra_log = ', mean missings_ %.4f' % float(miss.mean())
        check_logp_gap('sampson %s fit' % name, *final_logp_gap(m, dev))
        log('estimator sampson %s (thin %d, %d chains): %.1f s, logp mean '
            '%.2f, auc_ %.4f, launches %s%s'
            % (name, thin, C, seconds, float(m.logps_[:, -1].mean()),
               m.auc_, launches, extra_log))
    # a case-control fit: directed Sampson, its nested LSM case-control too
    m = DynamicNetworkHDPLPCM(device=dev, is_directed=True,
                              n_control=CC_FIT_CONTROLS, **SMALL_FIT)
    launches, seconds, _ = counted_fit(
        'sampson cc', m, load_dynamic_monks(is_directed=True), dev, cc=True)
    add(launches)
    check(bool(np.isfinite(m.logps_).all()), 'sampson cc fit: non-finite '
          'logps_')
    log('estimator sampson directed case-control (n_control=%d, %d chains, '
        '%d + %d sweeps): %.1f s, stages %s, logp mean %.2f, auc_ %.4f, '
        'launches %s'
        % (CC_FIT_CONTROLS, m.n_chains, NESTED_SWEEPS, m.logps_.shape[1] - 1,
           seconds, ', '.join('%s %.3f s' % kv
                              for kv in m.stage_seconds_.items()),
           float(m.logps_[:, -1].mean()), m.auc_, launches))
    for k, v in total.items():
        # the split-field scan's fit (LARGE_FIT) is phase 15's
        check(v > 0 or k == 'node_scan_split',
              'estimators: %s was never launched' % k)
    return total


# ---------------------------------------------------------------------------
# phase 14: the case-control slices
# ---------------------------------------------------------------------------

def cc_log_joint(sweep, s):
    """The HDP-LPCM log joint of the chain-batched state ``s`` under the
    case-control estimator, recomputed from scratch: the structures from
    the sweep's fixed edge lists and the state's controls, masks
    included."""
    from dynetlsm_tpu_torch.mcmc.sweeps import build_cc_dict, hdp_logp_at_state
    cfg = sweep.cfg
    cc = build_cc_dict(cfg, None, sweep.cc_static, s.ctrl_in, s.ctrl_out)
    prior = np.zeros(s.intercept.shape[1], np.float32)
    return hdp_logp_at_state(
        cfg, None, prior, s.X, s.intercept, s.z, s.mu, s.sigma, s.lmbda,
        s.weights, s.beta, s.gamma, s.alpha_init, s.alpha, s.kappa,
        s.mean_var, s.b_scale, radii=s.radii, cc=cc)


def check_colored_scan(name, s, sweep, dev, seed):
    """The chromatic scan on the card against the same code on the CPU, on
    CC_SCAN_CHAINS chains of the state ``s`` with the slice's controls and
    seeded noise, one colour class at a time from the card's positions, so
    that every class starts from one state on both devices.  Returns (the
    accepts that differ, the largest CPU margin among them, max |dX| over
    the sites whose accepts agree, accept rate)."""
    import torch
    from dynetlsm_tpu_torch.mcmc.latent import cc_colored_scan
    from dynetlsm_tpu_torch.mcmc.sweeps import build_cc_dict
    cfg = sweep.cfg
    cc = build_cc_dict(cfg, None, sweep.cc_static, s.ctrl_in, s.ctrl_out)
    cpu = torch.device('cpu')
    C = CC_SCAN_CHAINS
    _, T, n, d = s.X.shape
    rng = np.random.RandomState(seed)
    eps = torch.as_tensor(rng.randn(C, 2, n, T, d), dtype=torch.float32)
    log_u = torch.as_tensor(np.log(rng.uniform(size=(C, 2, n, T))),
                            dtype=torch.float32)
    fixed = dict(intercept=s.intercept[:C], step_size=s.step_X[:C],
                 eps=eps, log_u=log_u, mu=s.mu[:C], sigma=s.sigma[:C],
                 lmbda=s.lmbda[:C], z=s.z[:C],
                 radii=s.radii[:C] if cfg.is_directed else None)

    def on(device):
        def move(v):
            return v.to(device) if torch.is_tensor(v) else v
        return ({k: move(v) for k, v in cc.items()},
                {k: move(v) for k, v in fixed.items()})

    sides = [(dev, on(dev)), (cpu, on(cpu))]
    groups = cc['color_groups'].cpu()
    X = s.X[:C].clone()
    flips, worst_margin, max_dx, accepted = 0, 0.0, 0.0, 0.0
    for c in range(groups.shape[0]):
        k = cc['group_sizes'][c]
        out = []
        for device, (cc_d, kw) in sides:
            one = dict(cc_d, color_groups=cc_d['color_groups'][c:c + 1],
                       group_sizes=(k,))
            margins = torch.zeros((C, T, n), device=device)
            X_new, acc = cc_colored_scan(
                X.to(device), kw['intercept'], kw['step_size'], kw['eps'],
                kw['log_u'], radii=kw['radii'], mu=kw['mu'],
                sigma=kw['sigma'], lmbda=kw['lmbda'], z=kw['z'], cc=one,
                is_directed=cfg.is_directed, mixture=True, margins=margins)
            out.append((X_new.cpu(), acc.cpu(), margins.cpu()))
        nodes = groups[c, :k]
        (Xg, ag, _), (Xc, ac, mc) = out
        ag, ac, mc = ag[..., nodes], ac[..., nodes], mc[..., nodes]
        differ = ag != ac
        if bool(differ.any()):
            flips += int(differ.sum())
            worst_margin = max(worst_margin, float(mc[differ].max()))
        same = ~differ
        dx = (Xg[:, :, nodes] - Xc[:, :, nodes]).abs().amax(-1)
        max_dx = max(max_dx, float(dx[same].max()) if bool(same.any())
                     else 0.0)
        accepted += float(ag.sum())
        X = Xg.to(dev)
    check(worst_margin < CC_MARGIN, '%s: the chromatic scan on the card '
          'and on the CPU accept differently at a margin of %g'
          % (name, worst_margin))
    check(max_dx <= CC_DX, '%s: the chromatic scan on the card and on the '
          'CPU give positions %g apart' % (name, max_dx))
    return flips, worst_margin, max_dx, accepted / (C * T * n)


def run_cc_slice(name, directed, n, m, C, dev, latent_update='exact'):
    """One case-control slice (see phase 14; with ``latent_update``, that
    scheme, phase 15).  Returns its numbers."""
    import torch
    from dynetlsm_tpu_torch import profile_blocks
    from dynetlsm_tpu_torch.datasets import (
        northstar_edge_lists, northstar_network)
    from dynetlsm_tpu_torch.entry import build_state_and_sweep
    from dynetlsm_tpu_torch.mcmc.driver import make_scan_runner
    t0 = time.perf_counter()
    if n > 2048:
        lists, shape = northstar_edge_lists(n=n, directed=directed)
        Y, kw = None, dict(edge_lists=lists, shape=shape)
    else:
        Y = northstar_network(n=n, directed=directed)
        kw, shape = {}, Y.shape[:2]
    T, n_net = shape
    net_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    state, sweep, gen = build_state_and_sweep(
        Y, C, K=CC_K, device=dev, is_directed=directed, n_control=m,
        latent_update=latent_update, **kw)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    groups = sweep.cc_static['color_groups']
    runner = make_scan_runner(sweep, lambda s: {'logp': s.logp},
                              chunk=TIMED)
    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    state, warm = runner(state, gen, WARM)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, traced = runner(state, gen, TIMED)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / TIMED
    launches = {k: fn.launches for k, fn in counters.items()}
    peak_gb = (torch.cuda.max_memory_allocated(dev) - base) / 1e9
    sweeps = WARM + TIMED
    check(all(v == 0 for v in launches.values()),
          '%s: dense kernels launched %s' % (name, launches))
    logps = torch.cat([warm['logp'][:WARM], traced['logp'][:TIMED]])
    check(bool(torch.isfinite(logps).all()), '%s: non-finite logp' % name)
    check(bool((state.it == sweeps).all()), '%s: it != %d' % (name, sweeps))
    check(tuple(state.X.shape) == (C, T, n_net, 2), '%s: X shape' % name)
    want = cc_log_joint(sweep, state)
    gap = (want - state.logp).abs()
    rel = float((gap / state.logp.abs()).max())
    check(bool((gap <= 1e-5 * state.logp.abs() + 1e-3).all()),
          '%s: sweep logp vs the case-control log joint rel err %g'
          % (name, rel))
    acc_rate = float(state.acc_X.mean()) / sweeps
    check(0.0 < acc_rate < 1.0, '%s: X acceptance %g' % (name, acc_rate))
    if n > 2048:
        check(peak_gb < CC_PEAK_GB, '%s: peak device memory %.3f GB'
              % (name, peak_gb))
    t0 = time.perf_counter()
    blocks, state = profile_blocks.profile_slice(sweep, state, gen,
                                                 sweeps=2, warm=0)
    t1 = time.perf_counter()
    device = profile_blocks.device_times(sweep, state, gen, 1)
    profile_s = (t1 - t0, time.perf_counter() - t1)
    scan_ms = blocks['blocks_ms']['sample_latent_positions']
    out = dict(name=name, n=n_net, m=m, chains=C, ms=ms,
               sweeps_per_s_x_chains=C / (ms / 1e3), scan_ms=scan_ms,
               cc_structures_ms=blocks['blocks_ms']['_cc_structures'],
               launches_per_sweep=device['launches_per_sweep'],
               device_busy=device['device_busy'], peak_gb=peak_gb,
               colors=int(groups.shape[0]), class_size=int(groups.shape[1]),
               build_s=build_s, network_s=net_s)
    t0 = time.perf_counter()
    log('slice %s (T=%d, n=%d, m=%d, K=%d, %d chains; %d colour classes of '
        'up to %d nodes): network %.1f s, build (lists, colouring, state) '
        '%.1f s; %.3f ms/sweep, %.1f sweeps/s x chains, chromatic scan '
        '%.3f ms/sweep, control refresh and masks %.3f ms/sweep, %.0f '
        'kernel launches/sweep, device busy %.3f, X acceptance %.3f, logp '
        'mean %.2f, case-control log joint rel err %g (abs %g), dense '
        'launches %s, peak device memory %.3f GB; blocks ms %s'
        % (name, T, n_net, m, CC_K, C, out['colors'], out['class_size'],
           net_s,
           build_s, ms, out['sweeps_per_s_x_chains'], scan_ms,
           out['cc_structures_ms'], out['launches_per_sweep'],
           device['device_busy'], acc_rate, float(state.logp.mean()), rel,
           float(gap.max()), launches, peak_gb,
           {k: round(v, 3) for k, v in blocks['blocks_ms'].items()}))
    if n == NS['n'] and latent_update == 'exact':
        flips, margin, dx, rate = check_colored_scan(name, state, sweep, dev,
                                                     seed=n + directed)
        out.update(cpu_flips=flips, cpu_dx=dx)
        log('slice %s: chromatic scan on the card against the CPU, %d '
            'chains, class by class: %d accepts differ (largest CPU margin '
            '%g), max |dX| %g at the others, accept rate %.3f'
            % (name, CC_SCAN_CHAINS, flips, margin, dx, rate))
    log('slice %s: seconds spent on the block timing %.1f, the profiler '
        'trace %.1f, the CPU comparison %.1f'
        % ((name,) + profile_s + (time.perf_counter() - t0,)))
    return out


def cc_phase(dev):
    """Phase 14: every case-control slice.  Returns their numbers."""
    return [run_cc_slice(*row, dev=dev) for row in CC_SLICES]


# ---------------------------------------------------------------------------
# phase 15: the node scan past shared memory, and the other latent updates
# ---------------------------------------------------------------------------

def check_split_vs_resident(scans):
    """The split-field mode forced at clusters of 2, 4 and 8 against the
    resident mode's launch on the same inputs, in all eight instantiations
    at the north star: identical accepts, max |dX| = 0."""
    import torch
    for (key, n), (t, _) in scans.items():
        if n != NS['n'] or PER_CHAIN in key:
            continue
        X_r, acc_r = run_scan(t, kernel=True)
        for b in (2, 4, 8):
            X_s, acc_s = run_scan(t, kernel=True, cluster=b, mode='split')
            torch.cuda.synchronize()
            check(torch.equal(acc_s, acc_r),
                  'node_scan split (%s, cluster %d): %d accepts differ from '
                  'the resident mode' % (key, b, int((acc_s != acc_r).sum())))
            err = float((X_s - X_r).abs().max())
            check(err == 0.0, 'node_scan split (%s, cluster %d): max |dX| '
                  '%g against the resident mode' % (key, b, err))
        log('node_scan split-field (%s) at the north star, clusters of 2, '
            '4, 8: accepts identical to the resident mode, max |dX| 0'
            % key)


def large_network(n, directed, T=10):
    """bench.py's north-star community model at n nodes and constant
    expected degree, dense uint8 (T, n, n) (``datasets.
    northstar_edge_lists``, ``network_of_edge_lists``)."""
    from dynetlsm_tpu_torch.datasets import (
        network_of_edge_lists, northstar_edge_lists)
    return network_of_edge_lists(*northstar_edge_lists(T=T, n=n,
                                                       directed=directed))


def capture_scan(fn):
    """(fn(), the node-scan calls the sweeps made in it: a list of (args,
    keywords, (X_out, accepted)), copies of all but the network)."""
    import torch
    from dynetlsm_tpu_torch.mcmc import latent
    scan, calls = latent.node_scan, []

    def copy(v):
        return v.clone() if torch.is_tensor(v) else v

    def recorded(Y, *args, **kw):
        out = scan(Y, *args, **kw)
        calls.append(((Y,) + tuple(copy(v) for v in args),
                      {k: copy(v) for k, v in kw.items()},
                      tuple(copy(v) for v in out)))
        return out
    latent.node_scan = recorded
    try:
        return fn(), calls
    finally:
        latent.node_scan = scan


def check_split_at_slice(name, call, plain):
    """The slice's own split-field launch (``call``, captured from its
    sweep) at the launch rule's cluster and at forced clusters of 2, 4
    and 8, each timed on all the slice's chains (CUDA events).  With
    ``plain``, on SPLIT_CHAINS of its chains (chains are independent)
    against the plain version, timed once: identical accepts, max |dX| 0
    at every cluster size, and the rule's launch on those chains equal,
    bit for bit, to their rows of the sweep's launch.  Returns (the
    plain version's ms or None, {cluster: ms})."""
    import torch
    from dynetlsm_tpu_torch.ops.node_scan import (
        node_scan_cuda, node_scan_plain)
    (Y, X, b, step, eps, log_u), kw, (X_main, acc_main) = call
    C, T, n, d = X.shape
    kw = {k: v for k, v in kw.items() if v is not None}
    by = {B: cuda_ms(lambda: node_scan_cuda(Y, X, b, step, eps, log_u,
                                            cluster=B, mode='split', **kw),
                     2) for B in SPLIT_CLUSTERS_TIMED}
    if not plain:
        return None, by
    idx = torch.tensor(sorted({c % C for c in SPLIT_CHAINS}),
                       device=X.device)

    def cut(v):
        return (v[idx].contiguous() if torch.is_tensor(v) and v.dim()
                and v.shape[0] == C else v)
    sub = [cut(v) for v in (X, b, step, eps, log_u)]
    sub_kw = {k: cut(v) for k, v in kw.items()}
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    X_p, acc_p = node_scan_plain(Y[..., :n], *sub, **sub_kw)
    end.record()
    end.synchronize()
    plain_ms = start.elapsed_time(end)
    for B, mode in ((None, None),) + tuple(
            (B, 'split') for B in SPLIT_CLUSTERS_TIMED):
        X_k, acc_k = node_scan_cuda(Y, *sub, cluster=B, mode=mode,
                                    **sub_kw)
        torch.cuda.synchronize()
        what = '%s: split-field scan (cluster %s) on chains %s' % (
            name, 'of the rule' if B is None else B, idx.tolist())
        check(torch.equal(acc_k, acc_p), '%s: %d accepts differ from the '
              'plain version' % (what, int((acc_k != acc_p).sum())))
        err = float((X_k - X_p).abs().max())
        check(err == 0.0, '%s: max |dX| %g against the plain version'
              % (what, err))
        if B is None:
            check(torch.equal(X_k, X_main[idx])
                  and torch.equal(acc_k, acc_main[idx]),
                  '%s: differs from those chains of the sweep\'s launch'
                  % what)
    log('%s: the sweep\'s split-field launch on chains %s (T=%d, n=%d, '
        'P=%d): accepts identical to the plain version and max |dX| 0 at '
        'the rule\'s cluster and at clusters of %s, equal to the sweep\'s '
        'own launch; plain %.1f ms' % (name, idx.tolist(), T, n,
                                       Y.shape[-1], list(by), plain_ms))
    return plain_ms, by


def run_large_slice(name, model, directed, n, C, plain, dev):
    """One slice past the resident mode (2 + 20 sweeps, the checks of
    phase 8: the split-field scan launched once a sweep), then one
    profiled sweep, whose last scan's inputs :func:`check_split_at_slice`
    reruns (against the plain version where ``plain``): the scan's time,
    its time per phase step, its cluster size and bound, the device's busy
    share.  Returns (launches, ms/sweep, its numbers)."""
    from dynetlsm_tpu_torch import profile_blocks
    from dynetlsm_tpu_torch.ops.node_scan import cuda_layout
    t0 = time.perf_counter()
    Y = large_network(n, directed)
    net_s = time.perf_counter() - t0
    shape = dict(T=Y.shape[0], n=n, K=25, C=C)
    report = {}
    launches, ms = run_slice(name, Y, shape, dev, directed=directed,
                             model=model, report=report)
    del Y
    # the scan's time: the latent block of one sweep with a
    # synchronisation around it (the device runs it alone, back to back)
    (blocks, state), calls = capture_scan(
        lambda: profile_blocks.profile_slice(
            report['sweep'], report['state'], report['gen'], sweeps=1,
            warm=0))
    check(len(calls) > 0, '%s: no node-scan call in the profiled sweeps'
          % name)
    scan_ms = blocks['blocks_ms']['sample_latent_positions']
    device = profile_blocks.device_times(report['sweep'], state,
                                         report['gen'], 1)
    W, B, split = cuda_layout(C, shape['T'], n, 2, dev.index, directed,
                              model != 'lsm', False)
    check(split, '%s: the launch rule took the resident mode' % name)
    plain_ms, by = check_split_at_slice(name, calls[-1], plain)
    bound_ms, bound_by = scan_bound_of(C, shape['T'], n, 2, directed,
                                       model != 'lsm', False, False)
    out = dict(name=name, n=n, chains=C, ms=ms, scan_ms=scan_ms,
               us_per_step=1e3 * scan_ms / (2 * n), warps=W, cluster=B,
               ms_by_cluster=by, plain_ms=plain_ms,
               bound_ms=bound_ms, bound_by=bound_by,
               device_busy=device['device_busy'],
               peak_gb=report['peak_gb'], network_s=net_s)
    log('slice %s: split-field scan %.3f ms (one sweep, synchronised), '
        '%.3f us a phase step, %d warps a time, clusters of %d, the launch '
        'at clusters of %s: %s ms (CUDA events), bound %.4f ms (%s), %.3f '
        'ms/sweep, device busy %s, peak device memory %.3f GB, network '
        '%.1f s; largest kernels (ms/sweep, profiled) %s'
        % (name, scan_ms, out['us_per_step'], W, B, list(by),
           [round(v, 3) for v in by.values()], bound_ms, bound_by, ms,
           device['device_busy'], report['peak_gb'], net_s,
           [(k[:60], round(v, 3)) for k, v in device['kernels_ms'][:3]]))
    return launches, ms, out


def large_fit(dev):
    """A DynamicNetworkLSM fit past the resident node scan's shared memory
    (LARGE_FIT, which the estimators refused before the split-field mode),
    on the card with a short budget: launches counted (the split-field
    scan once a sweep), finite logps, the stage seconds printed.  Returns
    its launches."""
    from dynetlsm_tpu_torch import DynamicNetworkLSM
    from dynetlsm_tpu_torch.datasets import northstar_network
    kw = dict(LARGE_FIT)
    Y = northstar_network(T=kw.pop('T'), n=kw.pop('n'))
    m = DynamicNetworkLSM(device=dev, random_state=4, **kw)
    name = 'lsm T%d n%d' % Y.shape[:2]
    launches, seconds, peak = counted_fit(name, m, Y, dev, nested=False,
                                          split=True)
    check(bool(np.isfinite(m.logps_).all()), '%s fit: non-finite logp'
          % name)
    check(m.X_.shape == (Y.shape[0], Y.shape[1], 2), '%s fit: X_' % name)
    log('fit %s (%d chains, %d sweeps): %.1f s, launches %s, '
        'peak device memory %.3f GB, logp %.2f, stage seconds %s'
        % (name, m.n_chains, m.n_iter + m.tune + m.burn, seconds,
           launches, peak, m.logp_,
           {k: round(v, 2) for k, v in m.stage_seconds_.items()}))
    return launches


def scheme_phase(dev, networks, slices):
    """The 'parallel' and 'mala' latent updates at the north star through
    ``build_state_and_sweep(..., latent_update=)`` (phase 8's checks: no
    node scan launched, the coefficient kernels as before, the logp at the
    dense log joint), the case-control row with 'parallel', and a Sampson
    HDP-LPCM fit with 'mala' (JAX tests/test_mala.py:43; its nested LSM's
    exact scans counted).  Returns the fit's launches."""
    from dynetlsm_tpu_torch import DynamicNetworkHDPLPCM
    from dynetlsm_tpu_torch.datasets import load_dynamic_monks
    for model, directed, scheme, n_temps in SCHEME_SLICES:
        name = '%s %s' % (slice_name(model, NS, directed, n_temps), scheme)
        slices[name] = run_slice(name, networks[NS['n'], directed], NS, dev,
                                 directed=directed, model=model,
                                 n_temps=n_temps, latent_update=scheme)
    out = run_cc_slice(SCHEME_CC[0] + ' parallel', *SCHEME_CC[1:], dev=dev,
                       latent_update='parallel')
    m = DynamicNetworkHDPLPCM(device=dev, **MALA_FIT)
    Y = load_dynamic_monks()
    launches, seconds, _ = counted_fit('hdp sampson mala', m, Y, dev)
    check(bool(np.isfinite(m.logps_).all()), 'mala fit: non-finite logp')
    check(m.auc_ > 0.6, 'mala fit: auc_ %.4f' % m.auc_)
    log('fit hdp sampson mala: %.1f s, auc_ %.4f, launches %s'
        % (seconds, m.auc_, launches))
    return launches, out


# ---------------------------------------------------------------------------
# phase 9: bounds
# ---------------------------------------------------------------------------

def _bytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def bound(ops, nbytes):
    """(bound_ms, bound_by): the larger of the operations over the card's
    float32 rate and the bytes over its memory rate."""
    t_ops, t_bytes = ops / PEAK_F32_OPS, nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            'operations' if t_ops >= t_bytes else 'bytes')


def scan_bound(t):
    """:func:`scan_bound_of` the inputs ``t``."""
    C, T, n, d = t['X'].shape
    return scan_bound_of(C, T, n, d, 'radii' in t, t['mixture'],
                         'temper' in t, t['Y'].dim() == 4)


def scan_bound_of(C, T, n, d, directed, mixture, tempered, per_chain):
    """Per site and partner: two squared distances (10), two sqrt, two
    etas and two softplus (6 each: max, abs, negate, exp, log1p, add),
    two y * eta - softplus, their difference and the sum: 32; directed,
    four etas and four softplus: 58.  Per site, the prior and the accept:
    61 (mixture) or 37 (random walk), and one more when tempered (the
    temperature times the delta).  Bytes: every input once (X, the (T, n,
    n) uint8 network, or C of them, step, eps, log_u, the intercepts, the
    radii, the tempered lane's temperatures, the mixture's per-site means,
    variances and lambda), X and the accept indicators written once."""
    per_pair = 58 if directed else 32
    per_site = 61 if mixture else 37
    sites = C * T * n
    ops = sites * ((n - 1) * per_pair + per_site) + (sites if tempered
                                                     else 0)
    floats = (sites * d + sites + 2 * sites * d + 2 * sites
              + C * (2 if directed else 1) + (C * n if directed else 0)
              + (C if tempered else 0)
              + (sites * d + sites + C if mixture else 0))
    nbytes = (4 * floats + T * n * n * (C if per_chain else 1)
              + 4 * sites * (d + 1))
    return bound(ops, nbytes)


def pair_bound(args):
    """Per unordered dyad: a distance (7 with the clamp and sqrt), then per
    intercept eta, y * eta, softplus (6), their difference and the sum
    (10)."""
    Y, X = args[:2]
    C, T, n, _ = X.shape
    n_cand = len(args) - 2
    dyads = C * T * n * (n - 1) // 2
    return bound(dyads * (7 + n_cand * 10), _bytes(*args) + 4 * C * n_cand)


def dir_bound(args):
    """Per unordered dyad: a distance (7), then per candidate both
    directions' scale, eta, softplus and y * eta - softplus (24); per
    candidate and node, two reciprocals."""
    Yp, X, radii, b = args
    C, T, n, _ = X.shape
    n_cand = radii.shape[1]
    ops = (C * T * n * (n - 1) // 2 * (7 + 24 * n_cand)
           + 2 * C * n_cand * n)
    return bound(ops, _bytes(Yp, X, radii, b) + 4 * C * n_cand)


def busy_sm_clock_hz(fn, launches=2000):
    """The SM clock ``nvidia-smi`` reports while ``launches`` calls of fn
    are in flight on the card, in Hz."""
    import torch
    for _ in range(launches):
        fn()
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=clocks.sm',
         '--format=csv,noheader,nounits'],
        capture_output=True, text=True, timeout=60)
    torch.cuda.synchronize()
    check(out.returncode == 0, 'nvidia-smi failed: %s' % out.stderr.strip())
    return 1e6 * float(out.stdout.strip().splitlines()[0])


def issue_bound_ms(name, args, n_cand, clock_hz):
    """The least time the card needs to issue the compiled inner loop for
    every dyad: ``LOGLIK_SASS`` instructions per dyad over SMS x LANES
    lanes a clock, or, if larger, its MUFU instructions over a quarter of
    the lanes."""
    C, T, n, _ = args[1].shape
    dyads = C * T * n * (n - 1) // 2
    instr, mufu = LOGLIK_SASS[name, n_cand]
    slots = max(instr / LANES, mufu / (LANES / 4))
    return 1e3 * dyads * slots / (SMS * clock_hz)


def main():
    if not os.path.isdir(os.path.join(ROOT, 'dynetlsm_tpu_torch')):
        log('chip_smoke: no dynetlsm_tpu_torch package beside this script; '
            'run it from the root of a checkout')
        return 1
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        log('chip_smoke: torch.cuda.is_available() is False; this script '
            'measures the port on an NVIDIA GPU only')
        return 1
    dev = torch.device('cuda', 0)
    start = time.perf_counter()

    def phase_done(what):
        log('%s done at %.1f s' % (what, time.perf_counter() - start))
    try:
        log(card_line())
        log('torch %s, CUDA %s, python %s' % (
            torch.__version__, torch.version.cuda, sys.version.split()[0]))

        from dynetlsm_tpu_torch.ops import cuda_lib
        t0 = time.perf_counter()
        lib = cuda_lib.library()
        log('kernel build: %.1f s (nvcc %.1f s) -> %s'
            % (time.perf_counter() - t0, lib.build_seconds, lib.path))
        for line in lib.build_log.splitlines():
            if 'registers' in line or 'smem' in line or 'Compiling' in line:
                log('  ptxas: ' + line.strip())
        check_scan_layouts(lib, dev)

        # (name, shape, directed, mixture, seed) of each node-scan check,
        # untempered and then tempered
        untempered_cases = [
            ('mix', NS, False, True, 1), ('mix', SAMPSON, False, True, 2),
            ('mix dir', NS, True, True, 5),
            ('mix dir', SAMPSON, True, True, 6),
            ('rw', NS, False, False, 11), ('rw', SAMPSON, False, False, 12),
            ('rw dir', NS, True, False, 13),
            ('rw dir', SAMPSON, True, False, 14)]
        scan_cases = ([c + (False,) for c in untempered_cases]
                      + [(key + ' tempered', shape, directed, mixture,
                          seed + 20, True)
                         for key, shape, directed, mixture, seed
                         in untempered_cases])
        scans = {}
        for key, shape, directed, mixture, seed, tempered in scan_cases:
            scans[key, shape['n']] = check_node_scan(
                shape, dev, seed=seed, directed=directed, mixture=mixture,
                tempered=tempered)
        # the nested LSM's scan: one chain, random-walk prior
        for directed in (False, True):
            check_node_scan(NESTED, dev, seed=30 + directed,
                            directed=directed, mixture=False)
        # (kernel, candidates, n) -> (inputs, errors)
        logliks = {}
        for n_cand in (2, 1):
            logliks['pair_loglik', n_cand, NS['n']] = check_pair(
                NS, dev, seed=3, n_cand=n_cand)
            logliks['pair_loglik', n_cand, SAMPSON['n']] = check_pair(
                SAMPSON, dev, seed=4, n_cand=n_cand)
        for n_cand in (1, 2, 3):
            logliks['dir_loglik', n_cand, NS['n']] = check_dir(
                NS, n_cand, dev, seed=6 + n_cand)
            logliks['dir_loglik', n_cand, SAMPSON['n']] = check_dir(
                SAMPSON, n_cand, dev, seed=9 + n_cand)
        for k, shape in enumerate(AWKWARD + [NESTED]):
            for n_cand in (1, 2):
                check_pair(shape, dev, seed=40 + k, n_cand=n_cand)
            for n_cand in (1, 2, 3):
                check_dir(shape, n_cand, dev, seed=50 + k)

        phase_done('phases 1-7b')

        # phase 10: one network a chain, every kernel and mode
        for key, shape, directed, mixture, seed, tempered in scan_cases:
            scans[key + ' ' + PER_CHAIN, shape['n']] = check_node_scan(
                shape, dev, seed=seed + 60, directed=directed,
                mixture=mixture, tempered=tempered, per_chain=True)
            if shape is SAMPSON:
                check_node_scan(dict(AWKWARD_SCAN), dev, seed=seed + 80,
                                directed=directed, mixture=mixture,
                                tempered=tempered, per_chain=True)
        for directed in (False, True):
            check_node_scan(NESTED, dev, seed=32 + directed,
                            directed=directed, mixture=False, per_chain=True)
        for shape, seed in ((NS, 3), (SAMPSON, 4)):
            for n_cand in (1, 2):
                logliks['pair_loglik', n_cand, shape['n'], PER_CHAIN] = (
                    check_pair(shape, dev, seed=seed + 70, n_cand=n_cand,
                               per_chain=True))
            for n_cand in (1, 2, 3):
                logliks['dir_loglik', n_cand, shape['n'], PER_CHAIN] = (
                    check_dir(shape, n_cand, dev, seed=seed + 73 + n_cand,
                              per_chain=True))
        for k, shape in enumerate(AWKWARD + [NESTED]):
            for n_cand in (1, 2):
                check_pair(shape, dev, seed=90 + k, n_cand=n_cand,
                           per_chain=True)
            for n_cand in (1, 2, 3):
                check_dir(shape, n_cand, dev, seed=95 + k, per_chain=True)

        from dynetlsm_tpu_torch.datasets import (
            load_dynamic_monks, northstar_network)
        networks = {
            (NS['n'], False): northstar_network(),
            (NS['n'], True): northstar_network(directed=True),
            (SAMPSON['n'], False): load_dynamic_monks(),
            (SAMPSON['n'], True): load_dynamic_monks(is_directed=True)}
        # (model, shape): the HDP-LPCM at bench.py's K, the LSM, and the
        # LPCM at the north-star generator's 8 communities and at K=4 on
        # Sampson (models/lpcm.py:42)
        slice_cases = [('hdp', NS), ('hdp', SAMPSON), ('lsm', NS),
                       ('lsm', SAMPSON), ('lpcm', dict(NS, K=8)),
                       ('lpcm', dict(SAMPSON, K=4))]
        # (model, shape, directed) of the tempered slices: every mode of
        # the tempered node scan at both shapes
        tempered_cases = [
            ('hdp', NS, False), ('hdp', NS, True), ('lsm', NS, False),
            ('lsm', NS, True), ('lpcm', dict(SAMPSON, K=4), False),
            ('hdp', SAMPSON, True), ('lsm', SAMPSON, False),
            ('lsm', SAMPSON, True)]
        runs = ([(model, shape, directed, None) for model, shape in slice_cases
                 for directed in (False, True)]
                + [c + (N_TEMPS,) for c in tempered_cases])
        slices = {}
        for model, shape, directed, n_temps in runs:
            name = slice_name(model, shape, directed, n_temps)
            slices[name] = run_slice(
                name, networks[shape['n'], directed], shape, dev,
                directed=directed, model=model, n_temps=n_temps)
        pt_ms = alternate_tempered(networks[NS['n'], False], NS, dev)

        phase_done('phases 8-10')

        # phase 11: the missing-dyad slices
        from dynetlsm_tpu_torch.datasets import with_missing_dyads
        for model, directed, n_temps in (('hdp', False, None),
                                         ('hdp', True, None),
                                         ('lsm', False, None),
                                         ('hdp', False, N_TEMPS)):
            name = slice_name(model, NS, directed, n_temps, missing=True)
            coded = with_missing_dyads(networks[NS['n'], directed], MISSING,
                                       seed=5, directed=directed)
            slices[name] = run_slice(name, coded, NS, dev, directed=directed,
                                     model=model, n_temps=n_temps)

        phase_done('phase 11')

        # phase 12: Geweke
        geweke_out = geweke_phase(dev)
        phase_done('phase 12')

        # phase 13: the estimators
        fit_launches = estimator_phase(dev)
        phase_done('phase 13')

        # phase 14: the case-control slices
        cc_out = cc_phase(dev)
        phase_done('phase 14')

        # phase 15: the split-field node scan and the other latent updates
        check_split_vs_resident(scans)
        split_checks = {}
        for k, (directed, mixture, per_chain) in enumerate(
                (d, m, p) for d in (False, True) for m in (True, False)
                for p in (False, True)):
            split_checks[directed, mixture, per_chain] = check_node_scan(
                SPLIT_PLAIN, dev, seed=200 + k, directed=directed,
                mixture=mixture, per_chain=per_chain)
        large = {}
        for row in LARGE_SLICES:
            launches, ms, large[row[0]] = run_large_slice(*row, dev=dev)
            slices[row[0]] = (launches, ms)
        more_fits = [large_fit(dev)]
        launches, cc_parallel = scheme_phase(dev, networks, slices)
        more_fits.append(launches)
        for launches in more_fits:
            for k, v in launches.items():
                fit_launches[k] = fit_launches.get(k, 0) + v
        check(fit_launches['node_scan_split'] > 0,
              'estimators: node_scan_split was never launched')
        phase_done('phase 15')

        from dynetlsm_tpu_torch.ops.dir_loglik import (
            dir_loglik_cuda, dir_loglik_plain)
        from dynetlsm_tpu_torch.ops.pair_loglik import (
            pair_loglik_cuda, pair_loglik_plain)

        def scan_times(t):
            """(ms at the launch rule's cluster size, plain ms, the row's
            cluster fields): the kernel at every cluster size it reaches,
            and the time per phase step (ms / 2n) in microseconds."""
            (rule, _), reach = scan_clusters(t)
            by = {b: cuda_ms(lambda: run_scan(t, kernel=True, cluster=b,
                                              mode=m), 10)
                  for b, m in reach}
            steps = 2 * t['X'].shape[2]
            # the plain version's run of the check: a yardstick, seconds
            # a call
            return (by[rule], t['plain_ms'],
                    {'cluster': rule,
                     'ms_by_cluster': {str(b): v for b, v in by.items()},
                     'us_per_step': {str(b): 1e3 * v / steps
                                     for b, v in by.items()}})

        def loglik_times(key):
            """(ms, plain ms, the row's extra fields) of one log-likelihood
            kernel at the checked inputs of ``logliks[key]``, key (name,
            n_cand, n[, PER_CHAIN])."""
            name, n_cand, n = key[:3]
            kernel, plain = {
                'pair_loglik': (pair_loglik_cuda, pair_loglik_plain),
                'dir_loglik': (dir_loglik_cuda, dir_loglik_plain)}[name]
            args, errs = logliks[key]
            clock = busy_sm_clock_hz(lambda: kernel(*args))
            in_graph, replayed = graph_ms(lambda: kernel(*args), 20)
            check(torch.equal(replayed, kernel(*args)),
                  '%s n_cand=%d n=%d: the CUDA graph replay differs from '
                  'the eager call' % (name, n_cand, n))
            return (cuda_ms(lambda: kernel(*args), 20),
                    cuda_ms(lambda: plain(*args), 5),
                    {'cluster': None, 'graph_ms': in_graph,
                     'issue_bound_ms': issue_bound_ms(name, args, n_cand,
                                                      clock),
                     'sm_clock_mhz': clock / 1e6,
                     'err_vs_float64': errs['err64'],
                     'diff_err_vs_float64': errs['diff_err64']})

        kernels = []
        scan_cu = 'dynetlsm_tpu_torch/csrc/node_scan.cu'
        pair_cu = 'dynetlsm_tpu_torch/csrc/pair_loglik.cu'
        dir_cu = 'dynetlsm_tpu_torch/csrc/dir_loglik.cu'
        scan_py = 'dynetlsm_tpu/ops/pallas_scan.py'
        loglik_py = 'dynetlsm_tpu/ops/pallas_loglik.py'
        # the Pallas kernel of each shape: T > 8 or T <= 8
        scan_at = {NS['n']: scan_py + ':157', SAMPSON['n']: scan_py + ':637'}
        rows = []
        for key, shape, directed, mixture, _, tempered in scan_cases:
            t, err = scans[key, shape['n']]
            # the slice that runs this mode at this shape
            model = 'hdp' if mixture else 'lsm'
            if tempered and mixture and not directed and shape is SAMPSON:
                model = 'lpcm'
            rows.append(('node_scan', scan_mode(directed, mixture, tempered),
                         scan_cu, scan_at[shape['n']], shape,
                         slice_name(model, shape, directed,
                                    N_TEMPS if tempered else None),
                         err, scan_times(t), scan_bound(t)))
        # (kernel, candidates, shape, a slice that launches it so)
        loglik_rows = [
            ('pair_loglik', 2, NS, 'hdp northstar'),
            ('pair_loglik', 1, NS, 'hdp northstar tempered'),
            ('pair_loglik', 2, SAMPSON, 'hdp sampson'),
            ('pair_loglik', 1, SAMPSON, 'lpcm sampson tempered'),
            ('dir_loglik', 1, NS, 'hdp northstar directed'),
            ('dir_loglik', 2, NS, 'hdp northstar directed'),
            ('dir_loglik', 3, NS, 'hdp northstar directed'),
            ('dir_loglik', 1, SAMPSON, 'hdp sampson directed'),
            ('dir_loglik', 2, SAMPSON, 'hdp sampson directed'),
            ('dir_loglik', 3, SAMPSON, 'hdp sampson directed')]
        # the per-chain mode of each kernel that a missing-dyad slice runs
        for directed, mixture, tempered, model in (
                (False, True, False, 'hdp'), (True, True, False, 'hdp'),
                (False, False, False, 'lsm'), (False, True, True, 'hdp')):
            key = '%s%s%s' % ('mix' if mixture else 'rw',
                              ' dir' if directed else '',
                              ' tempered' if tempered else '')
            t, err = scans[key + ' ' + PER_CHAIN, NS['n']]
            rows.append(('node_scan',
                         scan_mode(directed, mixture, tempered, True),
                         scan_cu, scan_at[NS['n']], NS,
                         slice_name(model, NS, directed,
                                    N_TEMPS if tempered else None, True),
                         err, scan_times(t), scan_bound(t)))
        loglik_rows += [
            ('pair_loglik', 2, NS, 'hdp northstar missing', PER_CHAIN),
            ('pair_loglik', 1, NS, 'hdp northstar missing', PER_CHAIN),
            ('dir_loglik', 1, NS, 'hdp northstar directed missing',
             PER_CHAIN),
            ('dir_loglik', 2, NS, 'hdp northstar directed missing',
             PER_CHAIN)]
        # the split-field mode at the plain comparison's shape, in each
        # mode a slice past n = 2048 runs, with that slice's scan: its
        # launch's time at each cluster size and, where the slice held it
        # against the plain version, the plain version's on two chains
        for directed, mixture, slice_at in ((False, True, 'hdp n8192'),
                                            (True, True,
                                             'hdp n8192 directed'),
                                            (False, False, 'lsm n4096'),
                                            (False, False, 'lsm n16384')):
            t, err = split_checks[directed, mixture, False]
            big = large[slice_at]
            split_ms = cuda_ms(lambda: run_scan(t, kernel=True), 5)
            rows.append((
                'node_scan_split', 'split-field, ' + scan_mode(
                    directed, mixture), scan_cu, scan_py + ':157',
                SPLIT_PLAIN, slice_at, err,
                (split_ms, t['plain_ms'],
                 {'cluster': scan_clusters(t)[0][0],
                  'us_per_step': 1e3 * split_ms / (2 * SPLIT_PLAIN['n']),
                  'slice_shape': 'T=10 n=%d chains=%d' % (big['n'],
                                                          big['chains']),
                  'slice_scan_ms': big['scan_ms'],
                  'slice_us_per_step': big['us_per_step'],
                  'slice_cluster': big['cluster'],
                  'slice_ms_by_cluster': {str(b): v for b, v in
                                          big['ms_by_cluster'].items()},
                  'slice_plain_ms_2_chains': big['plain_ms'],
                  'slice_bound_ms': big['bound_ms'],
                  'slice_bound_by': big['bound_by']}),
                scan_bound(t)))
        for name, n_cand, shape, slice_at, *per_chain in loglik_rows:
            key = (name, n_cand, shape['n']) + tuple(per_chain)
            args, errs = logliks[key]
            rows.append((
                name, '%s, n_cand=%d%s' % (
                    'undirected' if name == 'pair_loglik' else 'directed',
                    n_cand, ''.join(', ' + m for m in per_chain)),
                pair_cu if name == 'pair_loglik' else dir_cu,
                loglik_py + (':25' if name == 'pair_loglik' else ':219'),
                shape, slice_at, errs['err'], loglik_times(key),
                (pair_bound if name == 'pair_loglik' else dir_bound)(args)))
        for (name, mode, source, replaces, shape, slice_at, err,
             (ms, pms, extra), (bound_ms, bound_by)) in rows:
            log('%s (%s) %s: kernel %.4f ms, plain %.4f ms, bound %.6f ms '
                '(%s)' % (name, mode, shape, ms, pms, bound_ms, bound_by))
            if 'issue_bound_ms' in extra:
                log('  %.4f ms a call in a CUDA graph of 20; issue bound '
                    '%.6f ms at an SM clock of %.0f MHz'
                    % (extra['graph_ms'], extra['issue_bound_ms'],
                       extra['sm_clock_mhz']))
            if 'ms_by_cluster' in extra:
                log('  by cluster size: %s (rule %d)' % (', '.join(
                    '%s: %.4f ms, %.3f us/step' % (b, v,
                                                   extra['us_per_step'][b])
                    for b, v in extra['ms_by_cluster'].items()),
                    extra['cluster']))
            kernels.append(dict({
                'name': name, 'route': 'cuda', 'source': source,
                'replaces': replaces,
                'launches': slices[slice_at][0][name],
                'max_abs_err': err, 'ms': ms, 'plain_ms': pms,
                'bound_ms': bound_ms, 'bound_by': bound_by,
                'library_ms': None, 'fit_launches': fit_launches[name],
                'mode': mode, 'slice': slice_at,
                'shape': 'T=%(T)d n=%(n)d chains=%(C)d' % shape}, **extra))
        log('slice ms/sweep: ' + ', '.join(
            '%s %.3f' % (k, v[1]) for k, v in slices.items()))
        log('slices past n = 2048: ' + ', '.join(
            '%s %.3f ms/sweep (split-field scan %.3f ms, %.3f us/step, '
            'clusters of %d, the launch at clusters of 2 / 4 / 8: %s ms, '
            'bound %.4f ms, busy %s, %.3f GB)'
            % (o['name'], o['ms'], o['scan_ms'], o['us_per_step'],
               o['cluster'], ' / '.join('%.3f' % v for v in
                                        o['ms_by_cluster'].values()),
               o['bound_ms'], o['device_busy'], o['peak_gb'])
            for o in large.values()))
        log('case-control parallel: %.3f ms/sweep (scan %.3f ms)'
            % (cc_parallel['ms'], cc_parallel['scan_ms']))
        log('case-control slices: ' + ', '.join(
            '%s %.3f ms/sweep (scan %.3f ms, %.0f launches, %.3f GB)'
            % (o['name'], o['ms'], o['scan_ms'], o['launches_per_sweep'],
               o['peak_gb']) for o in cc_out))
        log('geweke max |z| and seconds: ' + ', '.join(
            '%s %.3f (%.1f s)' % (k, z, sec)
            for k, (z, sec) in geweke_out.items()))
        ratios = np.divide(pt_ms['tempered'], pt_ms['untempered'])
        log('hdp northstar ms/sweep in alternating rounds: untempered %s, '
            'tempered %s; medians %.3f and %.3f; tempered / untempered '
            'per round %s, median %.4f'
            % (pt_ms['untempered'], pt_ms['tempered'],
               np.median(pt_ms['untempered']), np.median(pt_ms['tempered']),
               [round(float(r), 4) for r in ratios], np.median(ratios)))
        phase_done('phase 9')
    except SmokeFailure as e:
        log('chip_smoke FAILED: %s' % e)
        return 1

    print(json.dumps({'kernels': kernels}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
