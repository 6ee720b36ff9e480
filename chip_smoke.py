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
   MALA latent update (torch code, no node scan), the directed
   case-control LSM at its full-control limit (every other node an in-
   and an out-control; JAX test_geweke_joint.py:404-437 runs 8 chains x
   3,000 sweeps), the LSM's power check
   (|z| of the smoothness moment against a perturbed prior > 8) and the
   equal-temperature replica swap of the directed LSM (256 ladders of 4
   rungs, block |z| < 4.5); then the JAX package's three checks of the
   tempered and MALA samplers: the tempered HDP-LPCM's cold slots (32
   ladders of 4 rungs to beta 0.25 x 2,500 steps; JAX
   test_tempering.py:161-205 runs 10 ladders; block |z| < 4.5), the
   metastable target (the directed LSM's hard regime, 16 ladders of 10
   rungs to beta 0.02 x 4,000 steps and 16 untempered chains; JAX
   test_tempering.py:208-258 runs 8 of each: cold-slot block |z| < 4.5,
   and the edge density's spread over chains at least 1.5x smaller than
   the untempered chains'), whose steps are the JAX tests' own because
   the hot slots start from the untempered joint, not their targets (more
   ladders with fewer steps test less), and MALA against the exact scan
   on Sampson (two LSM fits of 4 chains x 1,200 + 400 + 400 samples, JAX
   test_mala.py:21-39: intercept means within 3 sds, logp means within 3
   sds, the distances' correlation > 0.7, MALA's auc_ > 0.8); the
   z-scores, the statistics and the seconds are printed;
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
   ``n_control=10``, its nested LSM case-control too, cut to 50 + 25 +
   25 samples since phase 18 came), whose seconds are printed.  Each fit runs with the launch counters set to
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
   updates: the split-field mode forced at clusters of 1, 2, 4, 8 and 16
   against the resident launch in all eight instantiations at the north
   star (identical accepts, max |dX| = 0); the split-field mode (the
   launch rule's, and forced at every cluster it takes) against the
   plain version at T=10,
   n=2,560 (P = 4,096), 2 chains, undirected and directed, mixture and
   random-walk prior, shared and per-chain network, as in 3; the slices
   past n = 2048 (HDP-LPCM K=25 at n = 8,192, 16 chains, undirected and
   directed; the LSM at n = 4,096, 32 chains, and n = 16,384, 4 chains;
   bench.py's north-star model at constant expected degree) as in 8 (1 +
   2 sweeps since phase 18 came; 2 + 3 before, 2 + 5 before phase 17),
   the split-field scan launched once a sweep, each with its
   scan's device
   time from one profiled sweep, the time per phase step, the cluster
   size, the bound, the device's busy share and peak memory; the scan
   launch of that profiled sweep, captured, timed at every cluster of 1,
   2, 4, 8 and 16 that its shape takes and, at n = 8,192 undirected and
   directed and n = 16,384, rerun on two of its chains at the rule's
   cluster and at those against the plain version (identical accepts,
   max |dX| = 0, the rule's launch
   equal to the sweep's own on those chains); a DynamicNetworkLSM fit at
   T=10, n=2,100 (20 sweeps), which the estimators refused before, with
   its stage seconds (in a child process started with the phase and
   waited for at its end: its GMDS is ~80 s of host work); and the
   'parallel'
   and 'mala' latent updates through ``build_state_and_sweep(...,
   latent_update=)`` at the north star (HDP-LPCM with each, the LSM with
   'mala', the directed HDP-LPCM with 'parallel', a tempered HDP-LPCM with
   'mala': no node scan launched, the site kernel once a 'parallel' sweep,
   the logp at its dense log joint), the
   directed case-control row with 'parallel' (as in 14, no kernel), a Sampson
   HDP-LPCM fit with 'mala' (JAX tests/test_mala.py:43), and the HDP-LPCM
   with 'parallel' and with 'mala' (from a step of 0.02) at n = 8,192, 16
   chains, 1 + 2 sweeps as in 8, each with its ms/sweep, X acceptance,
   busy share and peak memory, which must stay within 3 GB of the exact
   scan's slice at that shape; at the 'parallel' one, and at the north
   star's two 'parallel' slices, the site kernel on all of the slice's
   chains, from its final state and a seeded proposal, against its plain
   version and a float64 evaluation (within 1e-5 of the terms' magnitude,
   bit-equal on rerun), its row-range mode's two shares bit-equal to the
   whole launch, each timed beside the plain version; the MALA LSM's
   Geweke check runs in 12;
16. forecasts and the HDP-LPCM's headline scenario: the north-star fit's
   ``forecast_probas_marginalized_`` and ``forecast_probas_pp_`` on the
   card, timed with their peak memory, and the forecast functions on the
   card and on the CPU on the same traces (the posterior-predictive one
   on uniforms and normals drawn on the card), equal within rtol 1e-4,
   atol 1e-6; then the community split of
   tests/test_splitting_recovery.py:18-28 through the port
   (``simple_splitting_dynamic_network(n_nodes=50, n_time_steps=4,
   random_state=42)``, DynamicNetworkHDPLPCM at 1,500 + 750 + 750
   sweeps, half the test's budget, launches counted as in 13): mean ARI
   above 0.8 and fewer
   groups at t = 0 than at t = T - 1, with the ARIs, the groups and the
   stage seconds printed;
17. checkpoints: five fits (CKPT_FITS: the LSM at the north star, T=10,
   n=500, 4 chains; at Sampson size the HDP-LPCM, a directed tempered LSM
   (4 rungs, stopped mid-tune), a missing-dyad HDP-LPCM (10%) and a directed
   case-control LSM whose controls are redrawn across the stop; 199
   samples in chunks of 40) each run uninterrupted here, with launches
   counted as in 13, and with ``checkpoint_dir`` in a child process
   (``--checkpoint-child crash``, all five at once) that ends itself with
   ``os._exit`` after its second chunk, then resumed in one fresh child
   process (``--checkpoint-child resume``): ``Xs_``, ``intercepts_``,
   ``logps_`` and, where present, ``zs_``, ``temper_ladder_``,
   ``missings_`` and ``radiis_`` must equal the uninterrupted fit's bit
   for bit; then the missing-dyad north-star HDP-LPCM fit (32 chains,
   chunks of 50) with a checkpoint.  The checkpoint's bytes (state and
   chunk), its write seconds per chunk and their share of the sampling
   stage's seconds are printed for the north-star LSM state (from the
   resume) and the missing-dyad north-star HDP state;
18. multi-device fits, on min(cards, 4) distinct cards, or on a one-card
   machine ``cuda:0`` twice (printed first; a repeated card checks the
   sharded path with its kernels at shard shapes, not peer copies): the
   row-range modes of the two log-likelihood kernels (``*_rows_launch``,
   rows [a, b) held, every dyad i in them with j > i) against their plain
   versions, the north star split 2 and 4 ways (pair 1-2 intercepts,
   directed 1-3 candidates, shard s on card s mod k; each float64 share
   rtol 1e-9, bit-identical on rerun; the shares' float64 sum rounded
   once against the whole-network launch, rtol 1e-6) and n = 8,192 with
   16 chains in halves, checked alike (the first half timed: CUDA events,
   a CUDA graph of 5 calls, the plain share, the bound); the ``chains``
   axis: a Sampson
   HDP-LPCM fit and a tempered LSM fit with ``devices`` of two shards,
   each shard's traces equal to the unsharded runner's on its chains with
   its generator, bit for bit; the ``nodes`` axis at full width: the
   HDP-LPCM 'parallel' and 'mala' slices at n = 8,192, 16 chains (15's),
   node_devices = 2, one sweep against the unsharded sweep from the same
   state and generator (X rtol 1e-5 where the accepts agree, at most 4
   accepts flipped at near ties, printed; the log joint of each chain
   whose accepts agree rtol 1e-6), then 1 timed sweep with each card's
   peak memory; node-sharded fits at the north star
   (``node_devices=2``, 'parallel', 4 chains, 79 sweeps, a mixture's
   nested LSM cut to 99): LSM, HDP-LPCM, directed LSM, missing-dyad LSM
   and case-control LSM, each with finite log joints, no whole-network
   kernel launched, the row-range modes launched (the site kernel's once
   a shard and 'parallel' sweep; none under case-control) and ``auc_``
   within 0.05 of its unsharded twin's (whose sweeps launch the site
   kernel, the estimators' check of it; none under case-control); the
   missing-dyad one killed after its second chunk in a child process
   (17's machinery) and resumed in another, equal to its uninterrupted
   twin bit for bit; then ``entry.dryrun_multichip``.  The row-range
   counters are set to 0 before the node-sharded sweeps and fits and
   read after: each must be above 0;
19. the JAX package's examples that need numpy and the package alone,
   run against the port from their unedited sources
   (``scripts/run_example.py``: a copy with ``dynetlsm_tpu`` swapped for
   ``dynetlsm_tpu_torch``), each with the launch counters set to 0 just
   before and read just after: ``examples/parallel_tempering.py::run`` at
   ``tests/test_examples_smoke.py``'s budget (400 + 150 + 150), whose
   claim ``b_pt.std() < b_plain.std()`` must hold, launching the node scan
   (its tempered lane) and ``dir_loglik``; ``examples/got.py`` at its full
   width (T = 4, n = 313, 25 components) with its budget constants cut to
   ``GOT_BUDGET``, its report printed, launching the node scan and
   ``pair_loglik``; the
   case-control sweep without colour classes (the sequential scan, one
   control draw a chain) on the directed north-star network (T = 10,
   n = 500, 64 controls, ``UNCOLORED_CC``): its scan on the card against
   the same code on the CPU for 2 chains on seeded noise, node by node
   from the card's positions (accepts equal but at near ties), its logp
   at the case-control log joint, ms/sweep, launches a sweep and the
   device's busy share (``torch.profiler``); these three in a child
   process started with phase 17, beside 17 and 18; and the public
   functions the port gained for the JAX package's exports on CUDA
   tensors against the same call on the CPU (rtol 1e-5).
   ``example_launches`` in the kernels line counts each kernel's launches
   in the two examples;
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
   call's bit for bit).  The node scan's rows carry ``issue_bound_ms``
   too: ``NODE_SCAN_SASS`` instructions per partner term of its compiled
   partner-term loop (``scripts/node_scan_sass.py``) times the C T n
   (n - 1) partner terms, at the log-likelihood rows' median SM clock
   (the split-field rows also their slice's, ``slice_issue_bound_ms``).
   No single PyTorch call computes any of these
   functions, so ``library_ms`` is null.  The rows of 10's per-chain mode
   (``mode`` ending in "per-chain Y") count the per-chain networks' bytes
   in their bound and the missing-dyad slices' launches.  The split-field
   rows (``node_scan_split``, the wrapper's ``split_launches``) time the
   kernel and its plain version at 15's comparison shape (n = 2,560) and
   carry the slice's scan time, time per phase step, cluster size, bound,
   its launch's time at each cluster size and its plain version's time
   on two chains (``slice_*``).  ``checkpoint_launches`` counts each
kernel's launches in phase 17's uninterrupted fits.  The row-range rows
(``pair_loglik_rows``, ``dir_loglik_rows``) are 18's timed shares, their
``launches`` the node-sharded sweeps' and fits' of 18, their
``issue_bound_ms`` at the whole modes' median SM clock.  The site
kernel's rows (``site_loglik`` at 15's three 'parallel' slices,
``launches`` the slice's; ``site_loglik_rows``, the first share at
n = 8,192, ``launches`` 18's node-sharded sweeps' and fits') carry 15's
check: ms, plain ms, the bound (30 operations a partner term undirected,
72 directed), ``issue_bound_ms`` (``SITE_SASS`` instructions per partner
term at the SM clock read while the kernel runs) and the errors over the
terms' magnitude.

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
# (the last field: hold the slice's own launch against the plain version)
LARGE_SLICES = [('hdp n8192', 'hdp', False, 8192, 16, True),
                ('hdp n8192 directed', 'hdp', True, 8192, 16, True),
                ('lsm n4096', 'lsm', False, 4096, 32, False),
                ('lsm n16384', 'lsm', False, 16384, 4, True)]
SPLIT_CHAINS = (0, -1)
SPLIT_CLUSTERS_TIMED = (1, 2, 4, 8, 16)
# warm and timed sweeps of each slice past n = 2048 (0.35-1.9 s a sweep;
# fewer than the other slices' to keep the script inside its time)
LARGE_SLICE_SWEEPS = (1, 2)
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
# 'parallel' and 'mala' at the first large slice's shape (the HDP-LPCM at
# T = 10, n = 8,192, 16 chains, undirected), warm and timed sweeps each,
# and how far their peak device memory may exceed that exact-scan slice's
# in the same run (their dense passes go a block of dyads at a time)
LARGE_SCHEMES = ('parallel', 'mala')
LARGE_SCHEME_SWEEPS = (1, 2)
LARGE_SCHEME_PEAK_SLACK_GB = 3.0
# the MALA slice's starting step there: at the sweeps' default 0.1 the
# drift sums 8,192 partners a site and every joint proposal of a random
# start is rejected until the tuner's first window closes; 0.02 is on the
# tuned side (scripts/latent_scheme_memory.py --step prints the
# acceptance at a given step)
LARGE_MALA_STEP = 0.02
# the site kernel against its plain version and float64 at the 'parallel'
# slice there: the largest gap a site may have, over its terms' magnitude
# (float32 rounds each term by ~6e-8 of it; the plain version's two row
# sums cancel)
SITE_RTOL = 1e-5
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
# the tempered checks' (ladders, steps): the JAX tests' steps (the hot
# slots start off their targets, so the steps cannot be traded for
# ladders), more ladders (JAX: 10 and 8)
PT_HDP_RUN = (32, 2500)
METASTABLE_RUN = (16, 4000)
PER_CHAIN = 'per-chain Y'
# (instructions, MUFU instructions among them) per dyad of each kernel's
# inner loop as compiled for d = 2 (CUDA 12.8, sm_90a, -fmad=false), by
# kernel and candidate count (scripts/loglik_sass.py prints them from
# cuobjdump -sass; a pass of the loop scores 4 dyads); the whole-network
# instantiations, recounted when the row-range mode came
LOGLIK_SASS = {
    ('pair_loglik', 1): (82.75, 2), ('pair_loglik', 2): (134.0, 3),
    ('dir_loglik', 1): (144.25, 3), ('dir_loglik', 2): (238.5, 5),
    ('dir_loglik', 3): (337.5, 7),
    # the row-range instantiations phase 18 times (their MUFU counts the
    # whole mode's: the row offset adds integer instructions only)
    ('pair_loglik_rows', 2): (139.75, 3), ('dir_loglik_rows', 3): (338.0, 7)}
# (instructions, MUFU instructions among them) per partner term of the
# node scan's partner-term loop (its chunk of four terms, compiled for
# d = 2; CUDA 12.8, sm_90a, -fmad=false), by directed and split-field
# mode, the mixture prior's untempered instantiations (the other six of a
# mode are within 1.5 instructions: the prior and the temperature do not
# enter the loop): printed by scripts/node_scan_sass.py from cuobjdump
# -sass
NODE_SCAN_SASS = {
    (False, False): (165.25, 4), (False, True): (162.25, 4),
    (True, False): (264.0, 6), (True, True): (264.25, 6)}
# (instructions, MUFU instructions among them) per partner term of the
# site kernel's partner loop (a lane's word of four partners, both
# candidates; compiled for d = 2; CUDA 12.8, sm_90a, -fmad=false), by
# directed: the shortest path through the loop body, printed by
# scripts/site_loglik_sass.py from cuobjdump -sass
SITE_SASS = {False: (126.75, 4), True: (264.25, 10)}


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
    split-field mode, its clusters of 1, 2, 4, 8, 16 that fit."""
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
        for b in SPLIT_CLUSTERS:
            try:
                cuda_layout(C, T, n, d, *mode, cluster=b, mode='split')
            except ValueError:
                continue
            reach.append((b, 'split'))
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
                                  (4, None), (1, 'split'), (2, 'split'),
                                  (4, 'split'), (8, 'split'),
                                  (16, 'split')):
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
                                lib.node_scan_threads(T, W, 0),
                                lib.node_scan_smem_bytes(
                                    T, n, 2, partner_pad(n), 32 * W * B, 1,
                                    B, 0),
                                list(fits.values()), list(fits)))
    # the split-field rule at each slice past n = 2048: the library's
    # shared memory against the wrapper's at every cluster it takes, and
    # the card's count of clusters it runs at once
    for name, model, directed, n, C, _ in LARGE_SLICES:
        mixture = model != 'lsm'
        P = partner_pad(n)
        counts = {}
        for b in SPLIT_CLUSTERS_TIMED:
            try:
                W, B, _ = cuda_layout(C, 10, n, 2, dev.index, directed,
                                      mixture, False, b, 'split')
            except ValueError:
                continue
            want = smem_bytes(10, n, 2, directed, W, B, True)
            got = lib.node_scan_smem_bytes(10, n, 2, P, 32 * W * B,
                                           int(directed), B, 1)
            check(got == want, 'node_scan split layout (%s, cluster %d): the '
                  'library gives %d bytes of shared memory, the wrapper %d'
                  % (name, B, got, want))
            counts['%d (%d warps)' % (B, W)] = lib.node_scan_max_clusters(
                10, n, 2, P, W, B, int(directed), int(mixture), 0, 1)
        W, B, split = cuda_layout(C, 10, n, 2, dev.index, directed, mixture,
                                  False)
        check(split, '%s: the launch rule took the resident mode' % name)
        at_once = counts['%d (%d warps)' % (B, W)]
        check(at_once >= 1, '%s: the card runs no cluster of the rule\'s %d '
              'blocks' % (name, B))
        log('node_scan split-field rule at %s (T=10, n=%d, %d chains): %d '
            'warps a time, clusters of %d, %d wave(s); the card runs %s '
            'clusters at once' % (name, n, C, W, B, -(-C // at_once),
                                  counts))


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
    from dynetlsm_tpu_torch.ops.site_loglik import site_loglik_cuda
    return {'node_scan': node_scan_cuda, 'node_scan_split': SplitCounter(),
            'pair_loglik': pair_loglik_cuda, 'dir_loglik': dir_loglik_cuda,
            'site_loglik': site_loglik_cuda}


def run_slice(name, Y, shape, dev, directed=False, model='hdp',
              n_temps=None, latent_update='exact', report=None, warm=WARM,
              timed=TIMED, step=None):
    """Build ``model`` ('hdp', 'lpcm' or 'lsm') on Y with
    ``entry.build_state_and_sweep`` (with ``n_temps``, its parallel-
    tempering step; ``latent_update`` its scheme), run ``warm`` +
    ``timed`` sweeps (WARM + TIMED unless given) through the runner with
    the launch counters set to 0 just before and read just after, and
    check them.  ``step``, when given, is every site's starting step
    size of the latent update.  Dyads of Y coded -1 are missing: the
    state carries each chain's network and the checks of phase 11 apply.
    The exact scheme launches the node scan once a sweep, in the mode its
    launch rule takes; 'parallel' the site kernel once a sweep instead;
    'mala' neither.  ``report``, a
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
    if step is not None:
        state = state.replace(step_X=torch.full_like(state.step_X, step))
    ladder = None if n_temps is None else state.temper.clone()
    missing = state.Y is not None
    check(missing == bool((Y == -1).any()), '%s: state.Y' % name)
    runner = make_scan_runner(sweep, lambda s: {'logp': s.logp},
                              chunk=timed)
    sweeps = warm + timed
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
    expected['site_loglik'] = sweeps if latent_update == 'parallel' else 0
    counters = launch_counters()
    torch.cuda.reset_peak_memory_stats(dev)
    for fn in counters.values():
        fn.launches = 0
    state, warm_trace = runner(state, gen, warm)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, traced = runner(state, gen, timed)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    logps = torch.cat([warm_trace['logp'][:warm], traced['logp'][:timed]])
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
    ms = 1e3 * elapsed / timed
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
        report.update(state=s, sweep=sweep, gen=gen, peak_gb=peak_gb,
                      acc_rate=acc_rate)
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
    GEWEKE_CHAINS chains of GEWEKE_SWEEPS sweeps, the LSM's power check,
    the equal-temperature swap, the tempered HDP-LPCM's cold slots and the
    metastable target (PT_HDP_RUN, METASTABLE_RUN) and MALA against the
    exact scan on Sampson, through the kernels, from the JAX tests' seeds.
    Returns {check: (max |z| or the bar's statistic, seconds)}."""
    import torch
    from dynetlsm_tpu_torch import geweke
    from dynetlsm_tpu_torch.mcmc.tempering import temper_ladder
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

    # the tempered HDP-LPCM (JAX test_pt_hdp_joint_distribution)
    n_ladders, steps = PT_HDP_RUN
    t0 = time.perf_counter()
    mc, sc, ladder = geweke.pt_hdp_samples(n_ladders, steps,
                                           geweke.SEEDS['pt hdp'], dev)
    seconds = time.perf_counter() - t0
    z = geweke.block_z(mc, sc.mean(1))
    log('geweke tempered hdp: %d ladders x %d rungs (beta_min %g) x %d '
        'steps in %.1f s, cold-slot block z %s'
        % (n_ladders, geweke.PT_HDP[0], geweke.PT_HDP[1], steps, seconds,
           np.round(z, 3).tolist()))
    check(bool(np.all(np.abs(z) < geweke.PT_LIMIT)),
          'geweke tempered hdp: |z| >= %g: %s' % (geweke.PT_LIMIT, z))
    check(np.array_equal(ladder, temper_ladder(
        *geweke.PT_HDP, n_ladders=n_ladders).numpy()),
        'geweke tempered hdp: the ladder moved')
    out['tempered hdp'] = (float(np.abs(z).max()), seconds)

    # the metastable target (JAX test_pt_samples_metastable_joint)
    n_ladders, steps = METASTABLE_RUN
    t0 = time.perf_counter()
    mc, cold, plain, ladder = geweke.metastable_samples(
        n_ladders, steps, geweke.SEEDS[geweke.METASTABLE], dev)
    seconds = time.perf_counter() - t0
    z = geweke.block_z(mc, cold.mean(1))
    spread_pt = geweke.density_spread(cold)
    spread_plain = geweke.density_spread(plain)
    log('geweke metastable: %d ladders x %d rungs (beta_min %g) x %d steps '
        'and %d untempered chains in %.1f s, cold-slot block z %s, edge '
        'density spread over chains %.5f tempered, %.5f untempered (%.2fx)'
        % (n_ladders, geweke.PT_METASTABLE[0], geweke.PT_METASTABLE[1],
           steps, n_ladders, seconds, np.round(z, 3).tolist(), spread_pt,
           spread_plain, spread_plain / max(spread_pt, 1e-300)))
    check(bool(np.all(np.abs(z) < geweke.PT_LIMIT)),
          'geweke metastable: |z| >= %g: %s' % (geweke.PT_LIMIT, z))
    check(np.array_equal(ladder, temper_ladder(
        *geweke.PT_METASTABLE, n_ladders=n_ladders).numpy()),
        'geweke metastable: the ladder moved')
    check(spread_pt * geweke.SPREAD_GAIN < spread_plain,
          'geweke metastable: the tempered density spread %g is not %gx '
          'below the untempered %g' % (spread_pt, geweke.SPREAD_GAIN,
                                        spread_plain))
    out['metastable'] = (float(np.abs(z).max()), seconds)
    out['metastable spread gain'] = (spread_plain / spread_pt, 0.0)

    # MALA against the exact scan (JAX test_mala_lsm_matches_exact_posterior)
    t0 = time.perf_counter()
    rows = geweke.mala_posterior_check(dev)
    seconds = time.perf_counter() - t0
    log('mala vs exact on sampson (%s, twice): %.1f s, %s'
        % (geweke.MALA_EXACT_FIT, seconds, ', '.join(
            '%s %.4f (bar %.4f)' % (k, v, bar) for k, v, bar, _ in rows)))
    check(all(ok for *_, ok in rows), 'mala vs exact: %s' % rows)
    out['mala vs exact distance r'] = (float(rows[2][1]), seconds)
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
    exact ones still), the site kernel once a 'parallel' sweep of the
    fit's, and the pair kernel once (three directed-kernel
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
                'dir_loglik': 0,
                'site_loglik': (main if est.latent_update == 'parallel'
                                else 0)}
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
    kernels' launches summed over the phase's fits, and the north-star
    fit (phase 16 forecasts from it)."""
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
    m = ns_fit = DynamicNetworkHDPLPCM(device=dev, **NS_FIT)
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
    # (its nested LSM cut to SHORT_NESTED, to keep the script inside its
    # time)
    m = DynamicNetworkHDPLPCM(device=dev, is_directed=True,
                              n_control=CC_FIT_CONTROLS, **SMALL_FIT)
    launches, seconds, _ = short_nested(lambda: counted_fit(
        'sampson cc', m, load_dynamic_monks(is_directed=True), dev, cc=True))
    add(launches)
    check(bool(np.isfinite(m.logps_).all()), 'sampson cc fit: non-finite '
          'logps_')
    log('estimator sampson directed case-control (n_control=%d, %d chains, '
        '%d + %d sweeps): %.1f s, stages %s, logp mean %.2f, auc_ %.4f, '
        'launches %s'
        % (CC_FIT_CONTROLS, m.n_chains, sum(SHORT_NESTED.values()) - 1,
           m.logps_.shape[1] - 1,
           seconds, ', '.join('%s %.3f s' % kv
                              for kv in m.stage_seconds_.items()),
           float(m.logps_[:, -1].mean()), m.auc_, launches))
    for k, v in total.items():
        # the split-field scan's fit (LARGE_FIT) is phase 15's; the site
        # kernel's estimator fits ('parallel') are phase 18's unsharded
        # twins, checked there
        check(v > 0 or k in ('node_scan_split', 'site_loglik'),
              'estimators: %s was never launched' % k)
    return total, ns_fit


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


def check_colored_scan(name, s, sweep, dev, seed, chains=CC_SCAN_CHAINS):
    """The chromatic scan on the card against the same code on the CPU, on
    ``chains`` chains of the state ``s`` with the slice's controls and
    seeded noise, one colour class at a time from the card's positions, so
    that every class starts from one state on both devices.  Without
    colour classes (the sequential scan) each node is a class, in index
    order, and each chain has its own controls.  Returns (the accepts that
    differ, the largest CPU margin among them, max |dX| over the sites
    whose accepts agree, accept rate)."""
    import torch
    from dynetlsm_tpu_torch.mcmc.latent import cc_colored_scan
    from dynetlsm_tpu_torch.mcmc.sweeps import build_cc_dict
    cfg = sweep.cfg
    cc = build_cc_dict(cfg, None, sweep.cc_static, s.ctrl_in, s.ctrl_out)
    cpu = torch.device('cpu')
    C = chains
    _, T, n, d = s.X.shape
    if 'color_groups' not in cc:
        cc.update(color_groups=torch.arange(n, device=dev)[:, None],
                  group_sizes=(1,) * n)
        for k in ('ctrl_in', 'ctrl_out', 'ctrl_in_valid', 'ctrl_out_valid'):
            if cc[k] is not None:
                cc[k] = cc[k][:C]
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
    """The split-field mode forced at every cluster size it takes (1, 2,
    4, 8 and 16) against the resident mode's launch on the same inputs, in
    all eight instantiations at the north star: identical accepts, max
    |dX| = 0."""
    import torch
    for (key, n), (t, _) in scans.items():
        if n != NS['n'] or PER_CHAIN in key:
            continue
        X_r, acc_r = run_scan(t, kernel=True)
        for b in SPLIT_CLUSTERS_TIMED:
            X_s, acc_s = run_scan(t, kernel=True, cluster=b, mode='split')
            torch.cuda.synchronize()
            check(torch.equal(acc_s, acc_r),
                  'node_scan split (%s, cluster %d): %d accepts differ from '
                  'the resident mode' % (key, b, int((acc_s != acc_r).sum())))
            err = float((X_s - X_r).abs().max())
            check(err == 0.0, 'node_scan split (%s, cluster %d): max |dX| '
                  '%g against the resident mode' % (key, b, err))
        log('node_scan split-field (%s) at the north star, clusters of %s: '
            'accepts identical to the resident mode, max |dX| 0'
            % (key, list(SPLIT_CLUSTERS_TIMED)))


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
    sweep) at the launch rule's cluster and at every forced cluster of
    SPLIT_CLUSTERS_TIMED that the shape takes, each timed on all the
    slice's chains (CUDA events).  With
    ``plain``, on SPLIT_CHAINS of its chains (chains are independent)
    against the plain version, timed once: identical accepts, max |dX| 0
    at every cluster size, and the rule's launch on those chains equal,
    bit for bit, to their rows of the sweep's launch.  Returns (the
    plain version's ms or None, {cluster: ms})."""
    import torch
    from dynetlsm_tpu_torch.ops.node_scan import (
        cuda_layout, node_scan_cuda, node_scan_plain)
    (Y, X, b, step, eps, log_u), kw, (X_main, acc_main) = call
    C, T, n, d = X.shape
    kw = {k: v for k, v in kw.items() if v is not None}
    taken = []
    for B in SPLIT_CLUSTERS_TIMED:
        try:
            cuda_layout(C, T, n, d, X.device.index, 'radii' in kw,
                        kw.get('mixture', True), 'temper' in kw, B, 'split')
        except ValueError:
            continue
        taken.append(B)
    by = {B: cuda_ms(lambda: node_scan_cuda(Y, X, b, step, eps, log_u,
                                            cluster=B, mode='split', **kw),
                     2) for B in taken}
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
    for B, mode in ((None, None),) + tuple((B, 'split') for B in taken):
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
    """One slice past the resident mode (LARGE_SLICE_SWEEPS, the checks
    of phase 8: the split-field scan launched once a sweep), then one
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
    warm, timed = LARGE_SLICE_SWEEPS
    launches, ms = run_slice(name, Y, shape, dev, directed=directed,
                             model=model, report=report, warm=warm,
                             timed=timed)
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
    # the rule's launch against the fastest cluster timed
    fastest = min(by, key=by.get)
    out = dict(name=name, n=n, chains=C, ms=ms, scan_ms=scan_ms,
               us_per_step=1e3 * scan_ms / (2 * n), warps=W, cluster=B,
               ms_by_cluster=by, fastest_cluster=fastest,
               rule_over_fastest=by[B] / by[fastest], plain_ms=plain_ms,
               bound_ms=bound_ms, bound_by=bound_by,
               device_busy=device['device_busy'],
               peak_gb=report['peak_gb'], network_s=net_s)
    log('slice %s: split-field scan %.3f ms (one sweep, synchronised), '
        '%.3f us a phase step, %d warps a time, clusters of %d (%.4f x the '
        'fastest, clusters of %d), the launch '
        'at clusters of %s: %s ms (CUDA events), bound %.4f ms (%s), %.3f '
        'ms/sweep, device busy %s, peak device memory %.3f GB, network '
        '%.1f s; largest kernels (ms/sweep, profiled) %s'
        % (name, scan_ms, out['us_per_step'], W, B,
           out['rule_over_fastest'], fastest, list(by),
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


def start_large_fit(dev):
    """Start :func:`large_fit` in a child process (``--checkpoint-child
    large-fit``), beside the rest of phase 15: its GMDS is ~80 s of host
    work that the card does not wait for.  Returns the child for
    :func:`large_fit_launches`."""
    import shutil
    root = os.path.join(ROOT, 'build', 'large_fit')
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    # half the host's cores for its GMDS, the rest for this process
    threads = str(max(1, (os.cpu_count() or 2) // 2))
    env = dict(os.environ, OMP_NUM_THREADS=threads,
               OPENBLAS_NUM_THREADS=threads, MKL_NUM_THREADS=threads)
    return run_child(['large-fit', '-', root, str(dev)],
                     os.path.join(root, 'child.log'), 900, env=env), root


def large_fit_launches(started):
    """Wait for the :func:`start_large_fit` child, show its report and
    return the fit's launches (its checks fail the child, and so the
    phase)."""
    import shutil
    child, root = started
    code, out = wait_child(child)
    check(code == 0, 'large fit child exited %s: %s' % (code, out))
    with open(os.path.join(root, 'launches.json')) as f:
        launches = json.load(f)
    for line in out.splitlines():
        if line.startswith('fit lsm T'):
            log(line + ' (in a child process, beside phase 15)')
    shutil.rmtree(root, ignore_errors=True)
    return launches


def scheme_phase(dev, networks, slices, site):
    """The 'parallel' and 'mala' latent updates at the north star through
    ``build_state_and_sweep(..., latent_update=)`` (phase 8's checks: no
    node scan launched, the coefficient kernels as before, the site kernel
    once a 'parallel' sweep, the logp at the dense log joint;
    :func:`check_site_kernel` on each 'parallel' slice's final state, its
    numbers into ``site``), the case-control row with 'parallel', and a
    Sampson HDP-LPCM fit with 'mala' (JAX tests/test_mala.py:43; its
    nested LSM's exact scans counted).  Returns the fit's launches."""
    from dynetlsm_tpu_torch import DynamicNetworkHDPLPCM
    from dynetlsm_tpu_torch.datasets import load_dynamic_monks
    for model, directed, scheme, n_temps in SCHEME_SLICES:
        name = '%s %s' % (slice_name(model, NS, directed, n_temps), scheme)
        report = {} if scheme == 'parallel' else None
        slices[name] = run_slice(name, networks[NS['n'], directed], NS, dev,
                                 directed=directed, model=model,
                                 n_temps=n_temps, latent_update=scheme,
                                 report=report)
        if report is not None:
            site[name] = check_site_kernel(
                name, networks[NS['n'], directed], report['state'],
                directed)
        del report
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


def run_large_schemes(dev, exact):
    """The 'parallel' and 'mala' HDP-LPCM slices at the shape of the
    first large slice (LARGE_SLICES[0]), as in 8 (no node scan launched,
    the site kernel once a 'parallel' sweep, the logp at the dense log
    joint), LARGE_SCHEME_SWEEPS each ('mala' from LARGE_MALA_STEP), then
    one profiled sweep: ms/sweep, X acceptance, peak device memory (within
    LARGE_SCHEME_PEAK_SLACK_GB of the exact-scan slice's, ``exact``, from
    this run) and the device's busy share; at the 'parallel' slice
    :func:`check_site_kernel` on its final state.  Returns {name:
    numbers}."""
    from dynetlsm_tpu_torch import profile_blocks
    base, model, directed, n, C, _ = LARGE_SLICES[0]
    Y = large_network(n, directed)
    shape = dict(T=Y.shape[0], n=n, K=25, C=C)
    warm, timed = LARGE_SCHEME_SWEEPS
    out = {}
    for scheme in LARGE_SCHEMES:
        name = '%s %s' % (base, scheme)
        report = {}
        launches, ms = run_slice(
            name, Y, shape, dev, directed=directed, model=model,
            latent_update=scheme, report=report, warm=warm, timed=timed,
            step=LARGE_MALA_STEP if scheme == 'mala' else None)
        device = profile_blocks.device_times(report['sweep'], report['state'],
                                             report['gen'], 1)
        over = report['peak_gb'] - exact['peak_gb']
        check(over <= LARGE_SCHEME_PEAK_SLACK_GB,
              '%s: peak device memory %.3f GB, %.3f GB above the exact '
              'scan\'s slice (%.3f GB)' % (name, report['peak_gb'], over,
                                           exact['peak_gb']))
        out[name] = dict(name=name, launches=launches, ms=ms,
                         acc_rate=report['acc_rate'],
                         peak_gb=report['peak_gb'],
                         exact_peak_gb=exact['peak_gb'],
                         device_busy=device['device_busy'])
        if scheme == 'parallel':
            out[name]['site_kernel'] = check_site_kernel(
                name, Y, report['state'], directed)
        log('slice %s: %.3f ms/sweep, X acceptance %.4f, peak device memory '
            '%.3f GB (the exact scan\'s slice %.3f GB), device busy %s; '
            'largest kernels (ms/sweep, profiled) %s'
            % (name, ms, report['acc_rate'], report['peak_gb'],
               exact['peak_gb'], device['device_busy'],
               [(k[:60], round(v, 3)) for k, v in device['kernels_ms'][:3]]))
        del report
    return out


def site_terms64(Y, X, X_prop, b, radii, directed):
    """(delta, magnitude), (C, T, n) float64: each site's sum over its
    partners of l(x_prop) - l(x) and of |l(x_prop)| + |l(x)| (the scale
    of its delta's rounding), the plain arithmetic in float64 on Y (T, n,
    S) uint8 (packed when directed), a chain and time at a time."""
    import torch
    C, T, n, _ = X.shape
    delta = torch.empty((C, T, n), dtype=torch.float64, device=X.device)
    mag = torch.empty_like(delta)
    off = ~torch.eye(n, dtype=torch.bool, device=X.device)
    zero = torch.zeros((), dtype=torch.float64, device=X.device)
    b = b.double()
    for c in range(C):
        r = radii[c].double() if directed else None
        for t in range(T):
            x = X[c, t].double()
            y = Y[t, :, :n].double()
            ll = []
            for cand in (X_prop[c, t].double(), x):
                dist = torch.sqrt(torch.sum(
                    (cand[:, None, :] - x[None, :, :]) ** 2, -1))
                if directed:
                    q_j, q_i = dist / r[None, :], dist / r[:, None]
                    eo = b[c, 0] * (1 - q_j) + b[c, 1] * (1 - q_i)
                    ei = b[c, 0] * (1 - q_i) + b[c, 1] * (1 - q_j)
                    terms = (torch.remainder(y, 2) * eo
                             - torch.logaddexp(eo, zero)
                             + torch.floor(y / 2) * ei
                             - torch.logaddexp(ei, zero))
                else:
                    eta = b[c, 0] - dist
                    terms = y * eta - torch.logaddexp(eta, zero)
                ll.append(torch.where(off, terms, zero))
            delta[c, t] = (ll[0] - ll[1]).sum(-1)
            mag[c, t] = (ll[0].abs() + ll[1].abs()).sum(-1)
    return delta, mag


def site_bound(args, rows):
    """(bound_ms, bound_by) of the site kernel over the sites ``rows`` of
    the inputs ``args`` (Y holding those rows): per site and partner 30
    operations undirected, as ``port_bench``'s counts take a partner of a
    site's update, 72 directed (each candidate's distance 6, two etas 14,
    two softplus 10, two y eta 2, two subtractions and their sum 3; the
    difference and the accumulation 2); the bytes of every input once and
    of the output."""
    Y, X = args[:2]
    C, T, n, _ = X.shape
    ops = (72 if args[-1] else 30) * C * T * rows * (n - 1)
    return bound(ops, _bytes(*args[:-1]) + 4 * C * T * rows)


def site_issue_bound_ms(C, T, n, rows, directed, clock_hz):
    """The least time the card needs to issue the site kernel's compiled
    partner loop for ``rows`` sites of n - 1 partners each, C chains and
    T times: ``SITE_SASS`` instructions per partner term over SMS x LANES
    lanes a clock, or, if larger, its MUFU instructions over a quarter of
    the lanes."""
    instr, mufu = SITE_SASS[bool(directed)]
    slots = max(instr / LANES, mufu / (LANES / 4))
    return 1e3 * C * T * rows * (n - 1) * slots / (SMS * clock_hz)


def check_site_kernel(name, Y, state, directed):
    """The site kernel on every chain of a 'parallel' slice (its final
    state, a seeded proposal at each site's step, the network's rows
    padded as the sweeps store them): within SITE_RTOL of the terms'
    magnitude (at least 1) of its plain version and of the plain
    arithmetic in float64, bit-equal on rerun; its row-range mode's two
    shares, cut at a row no multiple of 4, bit-equal to the whole launch's
    sites.  Timed beside the plain version (the whole network and the
    first share), with the bounds and the issue bounds at the SM clock
    ``nvidia-smi`` reports while it runs.  Returns its numbers."""
    import torch
    from dynetlsm_tpu_torch.ops.node_scan import pack_directed, pad_partners
    from dynetlsm_tpu_torch.ops.site_loglik import (
        site_loglik_cuda, site_loglik_plain, site_loglik_rows_cuda)
    t0 = time.perf_counter()
    Y = torch.as_tensor(Y).to(device=state.X.device, dtype=torch.uint8)
    Yk = pad_partners(pack_directed(Y) if directed else Y)
    X = state.X.contiguous()
    C, T, n, _ = X.shape
    gen = torch.Generator(device=X.device).manual_seed(19)
    eps = torch.randn(X.shape, generator=gen, device=X.device)
    X_prop = (X + state.step_X[..., None] * eps).contiguous()
    b = state.intercept.contiguous()
    radii = state.radii.contiguous() if directed else None
    args = (Yk, X, X_prop, b, radii, directed)
    big = n > 2048
    got = site_loglik_cuda(*args)
    again = site_loglik_cuda(*args)
    # past n = 2,048 the plain version (a second a call at n = 8,192) is
    # timed on its one call
    plain = []
    plain_ms = cuda_ms(lambda: plain.append(site_loglik_plain(*args)),
                       1 if big else 5, warmup=0 if big else 1)
    plain = plain[0]
    want, mag = site_terms64(Yk, X, X_prop, b, radii, directed)
    # at least a nat, as the benchmark's mh_gap scales a ratio: a site
    # whose terms all vanish (y = 0, eta far below 0) rounds them to 0
    mag = torch.clamp_min(mag, 1.0)
    err_plain = float(((got.double() - plain.double()).abs() / mag).max())
    err64 = float(((got.double() - want).abs() / mag).max())
    plain_err64 = float(((plain.double() - want).abs() / mag).max())
    cut = n // 3 + 1
    share = (Yk[..., :cut, :].contiguous(), X, X_prop, b, radii, directed)
    shares = [site_loglik_rows_cuda(*share, row0=0),
              site_loglik_rows_cuda(Yk[..., cut:, :].contiguous(),
                                    *share[1:], row0=cut)]
    rows_equal = torch.equal(torch.cat(shares, dim=2), got)
    ms = cuda_ms(lambda: site_loglik_cuda(*args), 5 if big else 20)
    rows_ms = cuda_ms(lambda: site_loglik_rows_cuda(*share, row0=0),
                      5 if big else 20)
    rows_plain_ms = cuda_ms(lambda: site_loglik_plain(*share),
                            1 if big else 5, warmup=0 if big else 1)
    clock = busy_sm_clock_hz(lambda: site_loglik_cuda(*args),
                             max(20, int(1e3 / ms)))
    out = dict(
        chains=C, err_plain=err_plain, err64=err64, plain_err64=plain_err64,
        max_abs_err=float((got.double() - want).abs().max()), ms=ms,
        plain_ms=plain_ms, bound=site_bound(args, n),
        issue_bound_ms=site_issue_bound_ms(C, T, n, n, directed, clock),
        rows=(0, cut), rows_ms=rows_ms, rows_plain_ms=rows_plain_ms,
        rows_bound=site_bound(share, cut),
        rows_issue_bound_ms=site_issue_bound_ms(C, T, n, cut, directed,
                                                clock),
        rows_max_abs_err=float((shares[0].double()
                                - want[..., :cut]).abs().max()),
        sm_clock_mhz=clock / 1e6, directed=directed,
        shape='T=%d n=%d chains=%d' % (T, n, C))
    log('site kernel at %s, %d chains: against the plain version %g and '
        'float64 %g of the terms\' magnitude (the plain version against '
        'float64 %g), rerun %s, row shares [0, %d) and [%d, %d) %s; kernel '
        '%.3f ms, plain %.3f ms, bound %.4f ms (%s), issue bound %.3f ms at '
        '%.0f MHz; share [0, %d): kernel %.3f ms, plain %.3f ms; %.1f s'
        % (name, C, err_plain, err64, plain_err64,
           'bit-equal' if torch.equal(got, again) else 'DIFFERENT', cut, cut,
           n, 'bit-equal to the whole launch' if rows_equal else 'DIFFERENT',
           ms, plain_ms, out['bound'][0], out['bound'][1],
           out['issue_bound_ms'], clock / 1e6, cut, rows_ms, rows_plain_ms,
           time.perf_counter() - t0))
    check(torch.equal(got, again), '%s: site kernel rerun differs' % name)
    check(rows_equal, '%s: the site kernel\'s row shares differ from the '
          'whole launch' % name)
    check(max(err_plain, err64) <= SITE_RTOL, '%s: site kernel off its plain '
          'version by %g and float64 by %g of the terms\' magnitude'
          % (name, err_plain, err64))
    return out


# ---------------------------------------------------------------------------
# phase 16: forecasts and the headline scenario
# ---------------------------------------------------------------------------

# the forecasts of phase 13's north-star fit on the card against the same
# functions on the CPU, on the same traces (the posterior-predictive one
# on the same uniforms and normals)
FORECAST_RTOL, FORECAST_ATOL = 1e-4, 1e-6
# the community split (tests/test_splitting_recovery.py:18-28): the
# network, the fit at half its full budget (to keep the script inside its
# time: the full one gave ARI 1.0 in every run), and its bar
SPLIT_NET = dict(n_nodes=50, n_time_steps=4, random_state=42)
SPLIT_FIT = dict(n_iter=1500, tune=750, burn=750, n_components=10,
                 random_state=123)
SPLIT_MIN_ARI = 0.8


def forecast_phase(dev, m):
    """Phase 16(a): ``forecast_probas_marginalized_`` and
    ``forecast_probas_pp_`` of the fit ``m`` on the card, timed with their
    peak device memory, and the forecast functions on the card and on the
    CPU on the same traces (the posterior-predictive one on uniforms and
    normals drawn on the card): equal within FORECAST_RTOL /
    FORECAST_ATOL; (n, n), finite, in [0, 1], the marginal forecast's
    diagonal 0.  Returns its numbers."""
    import torch
    from dynetlsm_tpu_torch.ops.forecast import (
        marginal_forecast, posterior_predictive_forecast)

    def timed(fn, card=True):
        if card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        value = fn()
        if card:
            torch.cuda.synchronize()
        return (value, time.perf_counter() - t0,
                torch.cuda.max_memory_allocated(dev) / 1e9 if card else None)

    out = {}
    *args, renormalize = m._marginal_forecast_inputs()
    pp_args = m._pp_forecast_inputs()
    S, n, d = pp_args[0].shape
    gen = torch.Generator(device=dev).manual_seed(7)
    u = torch.rand((S, n), generator=gen, device=dev)
    eps = torch.randn((S, n, d), generator=gen, device=dev)
    runs = {
        'marginalized': (lambda: m.forecast_probas_marginalized_,
                         lambda device: marginal_forecast(
                             *args, renormalize=renormalize, device=device)),
        'pp': (lambda: m.forecast_probas_pp_,
               lambda device: posterior_predictive_forecast(
                   None, *pp_args, u=u.to(device), eps=eps.to(device),
                   device=device))}
    for name, (attribute, function) in runs.items():
        probas, seconds, peak = timed(attribute)
        card, card_s, card_peak = timed(lambda: function(dev).cpu())
        cpu, cpu_s, _ = timed(lambda: function('cpu'), card=False)
        for what, p in (('forecast_probas_%s_' % name, probas),
                        ('%s on the card\'s draws' % name, card.numpy())):
            check(p.shape == (n, n) and bool(np.isfinite(p).all())
                  and bool(((p >= 0) & (p <= 1)).all()),
                  'forecast %s: shape %s or values outside [0, 1]'
                  % (what, p.shape))
        if name == 'marginalized':
            check(not np.diag(probas).any(), 'forecast_probas_marginalized_'
                  ': non-zero diagonal')
            check(np.allclose(probas, card.numpy(), rtol=1e-6, atol=0.0),
                  'forecast_probas_marginalized_ differs from the function '
                  'on its inputs')
        err = float((card - cpu).abs().max())
        check(torch.allclose(card, cpu, rtol=FORECAST_RTOL,
                             atol=FORECAST_ATOL),
              'forecast %s: the card and the CPU differ by %g' % (name, err))
        out[name] = dict(attribute_s=seconds, attribute_peak_gb=peak,
                         card_s=card_s, card_peak_gb=card_peak, cpu_s=cpu_s,
                         max_abs_err=err)
        log('forecast %s of the north-star fit (S=%d samples, n=%d): the '
            'attribute %.3f s (peak device memory %.3f GB); the function '
            'on the card %.3f s (%.3f GB), on the CPU %.3f s; max |card - '
            'CPU| %g (rtol %g, atol %g)'
            % (name, S, n, seconds, peak, card_s, card_peak, cpu_s, err,
               FORECAST_RTOL, FORECAST_ATOL))
    return out


def split_recovery(dev):
    """Phase 16(b): the HDP-LPCM's headline scenario at its full budget
    through the port on the card (tests/test_splitting_recovery.py:18-28),
    launches counted as in 13: mean ARI over the times above
    SPLIT_MIN_ARI and fewer groups at t = 0 than at t = T - 1.  Returns
    (launches, its numbers)."""
    from dynetlsm_tpu_torch import DynamicNetworkHDPLPCM
    from dynetlsm_tpu_torch.datasets import simple_splitting_dynamic_network
    from dynetlsm_tpu_torch.metrics import adjusted_rand_score
    Y, z_true = simple_splitting_dynamic_network(**SPLIT_NET)
    m = DynamicNetworkHDPLPCM(device=dev, **SPLIT_FIT)
    launches, seconds, peak = counted_fit('hdp split', m, Y, dev)
    T = Y.shape[0]
    aris = [adjusted_rand_score(z_true[t], m.z_[t]) for t in range(T)]
    groups = [len(set(m.z_[t].tolist())) for t in range(T)]
    log('fit hdp split (T=%d, n=%d, %d + %d sweeps): %.1f s, ARI by time '
        '%s (mean %.4f), groups by time %s (true %s), stage seconds %s, '
        'launches %s, peak device memory %.3f GB'
        % (T, Y.shape[1], NESTED_SWEEPS, m.logps_.shape[-1] - 1, seconds,
           [round(a, 4) for a in aris], np.mean(aris), groups,
           [len(set(z_true[t].tolist())) for t in range(T)],
           {k: round(v, 2) for k, v in m.stage_seconds_.items()},
           launches, peak))
    check(bool(np.isfinite(m.logps_).all()), 'split fit: non-finite logp')
    check(np.mean(aris) > SPLIT_MIN_ARI, 'split fit: ARI %s, mean %.4f '
          '<= %g' % (aris, np.mean(aris), SPLIT_MIN_ARI))
    check(groups[0] < groups[-1], 'split fit: %d groups at t = 0, %d at t '
          '= T - 1' % (groups[0], groups[-1]))
    return launches, dict(seconds=seconds, aris=aris, groups=groups,
                          stage_seconds=dict(m.stage_seconds_))


# ---------------------------------------------------------------------------
# phase 17: checkpoints
# ---------------------------------------------------------------------------

# the checkpointed fits: name -> (estimator, keywords, network, counted_fit
# flags, traces compared); each stops after CKPT_CRASH_AFTER of its chunks
# of CKPT_CHUNK samples in its own process and resumes in another
CKPT_CHUNK = 40
CKPT_CRASH_AFTER = 2
CKPT_CRASH_CODE = 86
CKPT_BUDGET = dict(n_chains=4, n_iter=100, tune=50, burn=50,
                   trace_chunk=CKPT_CHUNK)
CKPT_TRACES = ('Xs_', 'intercepts_', 'logps_')
CKPT_FITS = {
    'lsm northstar': ('lsm', dict(random_state=0), 'northstar',
                      dict(nested=False), CKPT_TRACES),
    'hdp sampson': ('hdp', dict(n_components=10, random_state=3), 'sampson',
                    dict(nested=True), CKPT_TRACES + ('zs_',)),
    # directed (the dir_loglik kernel), stopped at sample 80 of a tuning
    # stage of 100 whose ladder adapts every 20 sweeps: the resume adapts
    # it once more
    'lsm sampson directed tempered': ('lsm', dict(
        random_state=3, is_directed=True, n_temps=N_TEMPS,
        beta_min=BETA_MIN, n_iter=50, tune=100, tune_interval=20),
        'sampson directed', dict(nested=False, tempered=True),
        CKPT_TRACES + ('radiis_', 'temper_ladder_')),
    'hdp sampson missing': ('hdp', dict(n_components=10, random_state=3),
                            'sampson missing',
                            dict(nested=True, missing=True),
                            CKPT_TRACES + ('zs_', 'missings_')),
    # the controls redrawn every 30 sweeps, across the interruption
    'lsm sampson cc': ('lsm', dict(random_state=3, is_directed=True,
                                   n_control=CC_FIT_CONTROLS,
                                   n_resample_control=30),
                       'sampson directed', dict(nested=False, cc=True),
                       CKPT_TRACES + ('radiis_',)),
}
# the missing-dyad north-star HDP-LPCM fit whose checkpoint writes are
# timed (its state carries each chain's Y and missing_sum)
CKPT_NS_MISSING = dict(NS_FIT, trace_chunk=50)


def checkpoint_network(key):
    from dynetlsm_tpu_torch.datasets import (
        load_dynamic_monks, northstar_network, with_missing_dyads)
    if key == 'northstar':
        return northstar_network()
    if key == 'sampson directed':
        return load_dynamic_monks(is_directed=True)
    Y = load_dynamic_monks()
    return with_missing_dyads(Y, MISSING, seed=6) if 'missing' in key else Y


def checkpoint_estimator(name, dev, checkpoint_dir=None):
    """(the estimator of CKPT_FITS[name] on ``dev``, or of phase 18's
    NODE_FITS[name], its network)."""
    from dynetlsm_tpu_torch import DynamicNetworkHDPLPCM, DynamicNetworkLSM
    if name in NODE_FITS:
        return node_estimator(name, dev, checkpoint_dir)
    model, kw, net, _, _ = CKPT_FITS[name]
    cls = DynamicNetworkLSM if model == 'lsm' else DynamicNetworkHDPLPCM
    kw = dict(CKPT_BUDGET, **kw)
    return (cls(device=dev, checkpoint_dir=checkpoint_dir, **kw),
            checkpoint_network(net))


class CheckpointWrites:
    """Times the checkpoint's writes (the trace chunk, the state with the
    generator's state, the meta) per chunk, and their bytes, by wrapping
    ``dynetlsm_tpu_torch.checkpoint``'s writers (``collect_traces`` imports
    them when it is called)."""

    def __init__(self):
        self.seconds = []       # per chunk: the three writes
        self.state_bytes = []
        self.chunk_bytes = []

    def __enter__(self):
        from dynetlsm_tpu_torch import checkpoint
        self.saved = {k: getattr(checkpoint, k) for k in
                      ('save_traces_chunk', 'save_state', 'write_meta')}

        def timed(key):
            fn = self.saved[key]

            def wrapper(*args):
                t0 = time.perf_counter()
                fn(*args)
                dt = time.perf_counter() - t0
                if key == 'save_traces_chunk':
                    self.seconds.append(dt)
                    self.chunk_bytes.append(os.path.getsize(os.path.join(
                        args[0], 'chunk_%05d.npz' % args[1])))
                else:
                    self.seconds[-1] += dt
                if key == 'save_state':
                    self.state_bytes.append(os.path.getsize(args[0]))
            return wrapper
        for k in self.saved:
            setattr(checkpoint, k, timed(k))
        return self

    def __exit__(self, *exc):
        from dynetlsm_tpu_torch import checkpoint
        for k, fn in self.saved.items():
            setattr(checkpoint, k, fn)

    def numbers(self, sampling_seconds):
        return dict(chunks=len(self.seconds),
                    write_s=[round(s, 4) for s in self.seconds],
                    state_bytes=max(self.state_bytes),
                    chunk_bytes=max(self.chunk_bytes),
                    sampling_s=sampling_seconds,
                    share=sum(self.seconds) / sampling_seconds)


def checkpoint_child(mode, names, root, device):
    """The child processes of phase 17 (``chip_smoke.py
    --checkpoint-child MODE NAMES ROOT DEVICE``; DEVICE 'cuda:0' as the
    phase runs them, or 'cpu' to rehearse the Sampson fits on the host).
    'crash': fit CKPT_FITS[NAMES]
    with ``checkpoint_dir`` ROOT/NAME and end the process with
    ``os._exit(CKPT_CRASH_CODE)`` from the progress report after
    CKPT_CRASH_AFTER chunks (no exception, no clean-up: a crash).  'resume':
    fit each of the comma-separated NAMES over its checkpoint, timing the
    writes, and save the compared traces, the write numbers and the
    launches to ROOT/NAME/result.npz.  'large-fit' (phase 15, NAMES '-'):
    :func:`large_fit`, its launches to ROOT/launches.json.  'examples'
    (phase 19, NAMES '-'): :func:`examples_child`, its numbers to
    ROOT/result.json."""
    import torch
    from dynetlsm_tpu_torch.mcmc import driver
    dev = torch.device(device)
    if mode == 'large-fit':
        # a CUDA context before counted_fit reads the memory statistics
        torch.zeros(1, device=dev)
        with open(os.path.join(root, 'launches.json'), 'w') as f:
            json.dump(large_fit(dev), f)
        return 0
    if mode == 'examples':
        with open(os.path.join(root, 'result.json'), 'w') as f:
            json.dump(examples_child(dev), f)
        return 0
    if mode == 'crash':
        orig = driver.collect_traces

        def crashing(*args, checkpoint_dir=None, progress=None, **kw):
            if checkpoint_dir is None:      # a mixture fit's nested LSM
                return orig(*args, progress=progress, **kw)
            done = []

            def report(k, total):
                done.append(k)
                if len(done) == CKPT_CRASH_AFTER:
                    os._exit(CKPT_CRASH_CODE)
            return orig(*args, checkpoint_dir=checkpoint_dir,
                        progress=report, **kw)
        driver.collect_traces = crashing
        est, Y = checkpoint_estimator(names, dev, os.path.join(root, names))
        est.fit(Y)
        log('checkpoint child: %s ran to its end' % names)
        return 1
    counters = launch_counters()
    for name in names.split(','):
        path = os.path.join(root, name)
        est, Y = checkpoint_estimator(name, dev, path)
        for fn in counters.values():
            fn.launches = 0
        with CheckpointWrites() as writes:
            est.fit(Y)
        out = {k: getattr(est, k) for k in (
            CKPT_FITS[name][4] if name in CKPT_FITS else NODE_CKPT_TRACES)}
        out['writes'] = np.array(json.dumps(writes.numbers(
            est.stage_seconds_['sampling'])))
        out['launches'] = np.array(json.dumps(
            {k: fn.launches for k, fn in counters.items()}))
        np.savez(os.path.join(path, 'result.npz'), **out)
    return 0


def run_child(args, log_path, timeout, env=None):
    """Start ``chip_smoke.py --checkpoint-child ARGS`` (in ``env``, this
    process's by default) with its output in ``log_path``; (process, log
    path, timeout) for :func:`wait_child`."""
    with open(log_path, 'w') as out:
        proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), '--checkpoint-child']
            + args, cwd=ROOT, stdout=out, stderr=subprocess.STDOUT, env=env)
    CHILDREN.append(proc)
    return proc, log_path, timeout


# every child started, killed at exit if still running (a phase that
# failed before waiting for its children)
CHILDREN = []


def stop_children():
    for proc in CHILDREN:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def wait_child(child):
    """(exit code, the end of its output); a child past its time limit is
    killed and fails the phase."""
    proc, log_path, timeout = child
    try:
        proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise SmokeFailure('child %s timed out' % log_path)
    with open(log_path) as f:
        return proc.returncode, f.read()[-3000:]


def checkpoint_phase(dev):
    """Phase 17: each CKPT_FITS fit runs uninterrupted here (launches
    counted as in 13), is killed in a child process after
    CKPT_CRASH_AFTER chunks (the five children at once) and resumed in a
    fresh process; the resumed traces must equal the uninterrupted ones
    bit for bit.  Then the missing-dyad north-star HDP-LPCM fit with a
    checkpoint, its writes timed.  Returns (launches, the write numbers
    by state)."""
    import shutil
    import torch
    from dynetlsm_tpu_torch import DynamicNetworkHDPLPCM
    root = os.path.join(ROOT, 'build', 'checkpoints')
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    crashes = {name: run_child(['crash', name, root, str(dev)],
                               os.path.join(root, name + '.crash.log'), 600)
               for name in CKPT_FITS}
    total = {}
    twins = {}
    for name, (_, _, _, flags, traces) in CKPT_FITS.items():
        est, Y = checkpoint_estimator(name, dev)
        launches, seconds, _ = counted_fit('checkpoint twin ' + name, est,
                                           Y, dev, **flags)
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        twins[name] = {k: getattr(est, k) for k in traces}
        log('checkpoint twin %s: %.1f s uninterrupted, %d samples a chain '
            'in chunks of %d, launches %s'
            % (name, seconds, est.logps_.shape[-1] - 1, CKPT_CHUNK,
               launches))
    for name, proc in crashes.items():
        code, out = wait_child(proc)
        from dynetlsm_tpu_torch.checkpoint import read_meta
        meta = read_meta(os.path.join(root, name))
        check(code == CKPT_CRASH_CODE and meta is not None
              and meta['n_done'] == CKPT_CRASH_AFTER * CKPT_CHUNK,
              'checkpoint %s: the crash child exited %s with meta %s: %s'
              % (name, code, meta, out))
    t0 = time.perf_counter()
    code, out = wait_child(run_child(['resume', ','.join(CKPT_FITS), root,
                                      str(dev)],
                                     os.path.join(root, 'resume.log'), 900))
    check(code == 0, 'checkpoint resume child exited %s: %s'
          % (code, out))
    log('checkpoint resume child: the %d fits in %.1f s'
        % (len(CKPT_FITS), time.perf_counter() - t0))
    writes = {}
    for name, twin in twins.items():
        with np.load(os.path.join(root, name, 'result.npz')) as r:
            got = {k: r[k] for k in r.files}
        diffs = {k: float(np.max(np.abs(got[k].astype(np.float64)
                                        - v.astype(np.float64))))
                 for k, v in twin.items() if got[k].shape == v.shape}
        equal = all(got[k].dtype == v.dtype and np.array_equal(got[k], v)
                    for k, v in twin.items())
        log('checkpoint %s: killed after %d of its chunks, resumed in a '
            'fresh process: %s; max |resumed - uninterrupted| %s, resumed '
            'launches %s' % (name, CKPT_CRASH_AFTER,
                             'equal bit for bit' if equal else 'DIFFERENT',
                             diffs, json.loads(str(got['launches']))))
        check(equal, 'checkpoint %s: the resumed traces differ from the '
              'uninterrupted fit\'s: %s' % (name, diffs))
        if name == 'lsm northstar':
            writes['lsm northstar'] = json.loads(str(got['writes']))
    # the missing-dyad north-star state: 32 chains' Y and missing_sum
    from dynetlsm_tpu_torch.datasets import (
        northstar_network, with_missing_dyads)
    path = os.path.join(root, 'hdp northstar missing')
    m = DynamicNetworkHDPLPCM(device=dev, checkpoint_dir=path,
                              **CKPT_NS_MISSING)
    with CheckpointWrites() as w:
        launches, seconds, peak = counted_fit(
            'checkpointed hdp northstar missing', m,
            with_missing_dyads(northstar_network(), MISSING, seed=5), dev,
            missing=True)
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v
    writes['hdp northstar missing'] = w.numbers(m.stage_seconds_['sampling'])
    check(bool(np.isfinite(m.logps_).all()), 'checkpointed north-star '
          'missing fit: non-finite logps_')
    for name, o in writes.items():
        log('checkpoint writes %s: state.npz %d bytes, chunk %d bytes, '
            'write seconds per chunk %s (mean %.4f), %.1f%% of the sampling '
            "stage's %.3f s"
            % (name, o['state_bytes'], o['chunk_bytes'], o['write_s'],
               np.mean(o['write_s']), 100 * o['share'], o['sampling_s']))
    shutil.rmtree(root, ignore_errors=True)
    return total, writes


# ---------------------------------------------------------------------------
# phase 18: multi-device fits (devices=, node_devices=)
# ---------------------------------------------------------------------------

# the cards the phase lays its meshes on: min(cards, MESH_CARDS) distinct
# ones, or cuda:0 twice on a one-card machine
MESH_CARDS = 4
# the row-range kernels: the north star split 2 and 4 ways, and n = 8,192
# with 16 chains split in halves (the node-sharded slices' network; the
# first half, 3/4 of the dyads, timed)
ROW_SPLITS = (2, 4)
ROW_BLOCK = dict(T=10, n=8192, C=16, K=25)
# a float64 share against the plain float64 share: the sound kernels read
# up to 8.3e-12 (directed, n = 8,192), 3.0e-10 (directed, north star) and
# 4.2e-16 (pair) relative (H100 80GB HBM3, 700 W; seeded inputs, so the
# readings repeat); a 32 x 32 tile skipped in one chain of n = 8,192
# moves a share by ~4e-6
ROW_SHARE_RTOL = 1e-9
ROW_SUM_RTOL = 1e-6         # the shares' sum against the whole launch
# one node-sharded sweep against the unsharded one: X within this rtol
# (atol 1e-6) where the accepts agree; an accept may flip only at a near
# tie of the float64 sums' order, at most this many a sweep (printed); the
# float32 log joint of a chain whose accepts all agree within
# NODE_LOGP_RTOL (16 ulps; both sum float64 shares and round once)
NODE_SWEEP_RTOL = 1e-5
NEAR_TIES = 4
NODE_LOGP_RTOL = 1e-6
NODE_SWEEPS = (1, 1)        # compared, then timed
# the node-sharded fits at the north star (node_devices=2), each against
# its unsharded twin at the same budget: auc_ within NODE_AUC_GAP
NODE_BUDGET = dict(n_chains=4, n_iter=40, tune=20, burn=20, trace_chunk=30,
                   latent_update='parallel')
SHORT_NESTED = dict(n_iter=50, tune=25, burn=25)
NODE_AUC_GAP = 0.05
NODE_FITS = {
    'nodes lsm': ('lsm', dict(random_state=0), 'northstar'),
    'nodes hdp': ('hdp', dict(n_components=8, random_state=1), 'northstar'),
    'nodes lsm directed': ('lsm', dict(random_state=2, is_directed=True),
                           'northstar directed'),
    'nodes lsm missing': ('lsm', dict(random_state=3), 'northstar missing'),
    'nodes lsm cc': ('lsm', dict(random_state=4, n_control=64),
                     'northstar'),
}
# killed after CKPT_CRASH_AFTER chunks in a child and resumed in another
NODE_CKPT = 'nodes lsm missing'
NODE_CKPT_TRACES = CKPT_TRACES + ('missings_',)
# the chains mesh: Sampson-size fits on two shards, each shard's traces
# against the unsharded runner with the shard's generator
MESH_FITS = {
    'hdp sampson': ('hdp', dict(n_components=10, n_chains=8, n_iter=40,
                                tune=20, burn=20, random_state=3)),
    'lsm sampson tempered': ('lsm', dict(n_chains=4, n_temps=N_TEMPS,
                                         beta_min=BETA_MIN, n_iter=40,
                                         tune=20, burn=20, random_state=3)),
}


def phase18_devices(dev):
    """(the devices of phase 18's meshes, 'distinct' or 'repeated'):
    min(cards, MESH_CARDS) cards, or on one card cuda:0 twice (``dev`` the
    CPU: the CPU twice, to rehearse the phase)."""
    import torch
    if torch.device(dev).type == 'cpu':
        return [torch.device('cpu')] * 2, 'repeated'
    count = torch.cuda.device_count()
    if count >= 2:
        return ([torch.device('cuda', i)
                 for i in range(min(count, MESH_CARDS))], 'distinct')
    return [torch.device('cuda', 0)] * 2, 'repeated'


def row_counters():
    """The row-range modes' launch counters."""
    from dynetlsm_tpu_torch.ops.dir_loglik import dir_loglik_rows_cuda
    from dynetlsm_tpu_torch.ops.pair_loglik import pair_loglik_rows_cuda
    from dynetlsm_tpu_torch.ops.site_loglik import site_loglik_rows_cuda
    return {'pair_loglik_rows': pair_loglik_rows_cuda,
            'dir_loglik_rows': dir_loglik_rows_cuda,
            'site_loglik_rows': site_loglik_rows_cuda}


def share_dyads(C, T, n, a, b):
    """The dyads i in [a, b), j > i of C chains and T times."""
    return C * T * sum(n - 1 - i for i in range(a, b))


def check_row_range(name, args, cuts, devices, label, timed=False):
    """The row-range mode of one kernel (``name`` 'pair' or 'dir') on the
    whole-network inputs ``args``, its rows cut at ``cuts`` and shard s on
    ``devices[s % k]``: each share against the plain share (rtol
    ROW_SHARE_RTOL), bit-identical on rerun; the shares' float64 sum,
    rounded once, against the whole launch (rtol ROW_SUM_RTOL; the count
    of bit-equal values printed).  With ``timed``, the first share's
    CUDA-event and graph ms, the plain share's ms and the share's bound.
    Returns (max abs error of a share, timing numbers or None)."""
    import torch
    from dynetlsm_tpu_torch.ops import dir_loglik as dl, pair_loglik as pl
    kernel, plain, whole = {
        'pair': (pl.pair_loglik_rows_cuda, pl.pair_loglik_rows_plain,
                 pl.pair_loglik_cuda),
        'dir': (dl.dir_loglik_rows_cuda, dl.dir_loglik_rows_plain,
                dl.dir_loglik_cuda)}[name]
    Y, X, rest = args[0], args[1], tuple(args[2:])
    full = whole(*args) if cuts[0] == 0 and cuts[-1] == X.shape[2] else None
    total, err, worst, numbers = None, 0.0, 0.0, None
    for s, (a, b) in enumerate(zip(cuts[:-1], cuts[1:])):
        dev = devices[s % len(devices)]
        part = (Y[..., a:b, :].contiguous().to(dev), X.to(dev)) + tuple(
            v.to(dev) for v in rest)
        got = kernel(*part, row0=a)
        again = kernel(*part, row0=a)
        plain_ms = []
        want = cuda_ms(lambda: plain_ms.append(plain(*part, row0=a)), 1,
                       warmup=0)
        want, plain_ms = plain_ms[0], want
        torch.cuda.synchronize(dev)
        check(bool(torch.isfinite(got).all()) and torch.equal(got, again),
              '%s_loglik_rows %s rows [%d, %d): non-finite or not '
              'bit-identical on rerun' % (name, label, a, b))
        rel = float(((got - want).abs() / want.abs()).max())
        check(rel <= ROW_SHARE_RTOL, '%s_loglik_rows %s rows [%d, %d): max '
              'rel err %g against the plain share' % (name, label, a, b, rel))
        worst = max(worst, rel)
        err = max(err, float((got - want).abs().max()))
        total = got.to(X.device) if total is None else total + got.to(
            X.device)
        if timed and s == 0:
            C, T, n, _ = X.shape
            in_graph, replayed = graph_ms(lambda: kernel(*part, row0=a), 3,
                                          calls=5)
            check(torch.equal(replayed, got), '%s_loglik_rows %s: the CUDA '
                  'graph replay differs from the eager call' % (name, label))
            dyads = share_dyads(C, T, n, a, b)
            numbers = dict(
                ms=cuda_ms(lambda: kernel(*part, row0=a), 5),
                graph_ms=in_graph, plain_ms=plain_ms,
                bound=(pair_bound(part, dyads) if name == 'pair'
                       else dir_bound(part, dyads)),
                rows=(a, b), dyads=dyads)
    same = ''
    if full is not None:
        rounded = total.to(torch.float32)
        rel = float(((rounded - full).abs() / full.abs()).max())
        check(rel <= ROW_SUM_RTOL, '%s_loglik_rows %s split %s: the shares\' '
              'sum against the whole launch, max rel err %g'
              % (name, label, cuts, rel))
        same = ', the shares\' sum against the whole launch max rel err %g ' \
            '(%d of %d values bit-equal)' % (
                rel, int((rounded == full).sum()), full.numel())
    log('%s_loglik_rows %s, rows cut at %s: shares against the plain '
        'shares max abs err %g (rel %g), bit-identical on rerun%s'
        % (name, label, cuts, err, worst, same))
    return err, numbers


def row_range_phase(devices, Y8192):
    """The row-range modes against their plain versions (see 18).
    Returns {kernel name: (max abs err, timing numbers, mode, shape)}."""
    import torch
    from dynetlsm_tpu_torch.ops.node_scan import pack_directed
    dev = devices[0]
    out = {}
    n = NS['n']
    for k in ROW_SPLITS:
        cuts = [s * n // k for s in range(k + 1)]
        for n_cand in (1, 2):
            args = pair_inputs(NS['C'], NS['T'], n, dev, 300 + n_cand)
            check_row_range('pair', args[:2 + n_cand], cuts, devices,
                            'north star n_cand=%d' % n_cand)
        for n_cand in (1, 2, 3):
            check_row_range('dir', dir_inputs(NS['C'], NS['T'], n, n_cand,
                                              dev, 310 + n_cand),
                            cuts, devices, 'north star n_cand=%d' % n_cand)
    # n = 8,192's rows in halves, 16 chains, the slices' network; the
    # first half timed
    T, n, C = Y8192.shape[0], Y8192.shape[1], ROW_BLOCK['C']
    rng = np.random.RandomState(320)
    f = dict(dtype=torch.float32, device=dev)
    X = torch.as_tensor(rng.randn(C, T, n, 2), **f)
    Y = torch.as_tensor(Y8192, device=dev)
    b = torch.as_tensor(1.0 + 0.1 * rng.randn(C), **f)
    label = 'T=%d n=%d chains=%d' % (T, n, C)
    shape = '%s, rows [0, %d)' % (label, n // 2)
    err, numbers = check_row_range('pair', (Y, X, b, b + 0.05),
                                   [0, n // 2, n], devices, label,
                                   timed=True)
    out['pair_loglik_rows'] = (err, numbers, 'row range, 2 intercepts',
                               shape)
    bd = 0.3 + 0.5 * rng.randn(C, 3, 2)
    bd[:, 0, 0] = -np.abs(bd[:, 0, 0]) - 0.1
    args = (pack_directed(Y), X, torch.as_tensor(0.5 + rng.rand(C, 3, n),
                                                 **f),
            torch.as_tensor(bd, **f))
    del Y
    err, numbers = check_row_range('dir', args, [0, n // 2, n], devices,
                                   label, timed=True)
    out['dir_loglik_rows'] = (err, numbers, 'row range, 3 candidates',
                              shape)
    return out


def mesh_fit(name, dev, devices):
    """(the estimator of MESH_FITS[name] on ``devices`` (a chains mesh),
    its network)."""
    from dynetlsm_tpu_torch import DynamicNetworkHDPLPCM, DynamicNetworkLSM
    from dynetlsm_tpu_torch.datasets import load_dynamic_monks
    model, kw = MESH_FITS[name]
    cls = DynamicNetworkLSM if model == 'lsm' else DynamicNetworkHDPLPCM
    return cls(device=dev, devices=devices, **kw), load_dynamic_monks()


def chain_mesh_phase(dev, devices):
    """The chains axis: each MESH_FITS fit on two shards (the first two
    of ``devices``); every shard's traces, replayed alone by the
    unsharded runner over its chains with its sweep and a generator in
    its generator's first state, equal the mesh's bit for bit."""
    import torch
    from dynetlsm_tpu_torch.mcmc import driver
    make, collect = driver.make_scan_runner, driver.collect_traces
    for name in MESH_FITS:
        seen = {}

        def make_spy(sweep_fn, trace_fn, **kw):
            if isinstance(sweep_fn, list):
                seen.update(sweeps=sweep_fn, trace=trace_fn, kw=kw)
            return make(sweep_fn, trace_fn, **kw)

        def collect_spy(runner, state, gen, n, **kw):
            if not isinstance(state, list):     # a nested LSM
                return collect(runner, state, gen, n, **kw)
            seen.update(states=[s.replace() for s in state], n=n,
                        gens=[g.get_state() for g in gen])
            out = collect(runner, state, gen, n, **kw)
            seen['traces'] = out[1]
            return out
        driver.make_scan_runner, driver.collect_traces = make_spy, collect_spy
        try:
            t0 = time.perf_counter()
            est, Y = mesh_fit(name, dev, devices[:2])
            short_nested(lambda: est.fit(Y))
            seconds = time.perf_counter() - t0
        finally:
            driver.make_scan_runner, driver.collect_traces = make, collect
        check(dict(est.mesh_.shape) == {'chains': 2}, 'chains mesh %s: mesh '
              '%s' % (name, est.mesh_))
        check(bool(np.isfinite(est.logps_).all()), 'chains mesh %s: '
              'non-finite logps_' % name)
        c0 = 0
        for r, (sweep, state, g_state) in enumerate(zip(
                seen['sweeps'], seen['states'], seen['gens'])):
            gen = torch.Generator(device=state.X.device)
            gen.set_state(g_state)
            runner = make(sweep, seen['trace'], **seen['kw'])
            _, alone = collect(runner, state, gen, seen['n'],
                               chunk=seen['kw']['chunk'])
            C = next(iter(alone.values())).shape[1]
            for k, v in alone.items():
                check(np.array_equal(seen['traces'][k][:, c0:c0 + C], v),
                      'chains mesh %s: shard %d trace %s differs from the '
                      'unsharded runner\'s' % (name, r, k))
            c0 += C
        log('chains mesh %s on %s: %.1f s, %d shards, each shard\'s traces '
            '(%s) equal to the unsharded runner\'s with its generator bit '
            'for bit' % (name, [str(d) for d in devices[:2]], seconds,
                         len(seen['sweeps']), ', '.join(seen['traces'])))


def node_sweep_phase(devices, Y8192):
    """The nodes axis at full width: the HDP-LPCM 'parallel' and 'mala'
    slices at n = 8,192, 16 chains (phase 15's), node_devices = 2: one
    sweep against the unsharded sweep from the same state and generator
    state, then NODE_SWEEPS[1] timed sweeps; ms/sweep and each card's
    peak memory.  Returns {name: numbers}."""
    import torch
    from dynetlsm_tpu_torch.entry import build_state_and_sweep
    dev = devices[0]
    nodes = devices[:2]
    out = {}
    for scheme in LARGE_SCHEMES:
        name = 'hdp n%d %s nodes=2' % (Y8192.shape[1], scheme)

        def build(**kw):
            """(state, sweep, gen), the state and generator the same in
            every build (the entry's seed)."""
            state, sweep, gen = build_state_and_sweep(
                Y8192, ROW_BLOCK['C'], K=ROW_BLOCK['K'], device=dev,
                latent_update=scheme, **kw)
            if scheme == 'mala':
                state = state.replace(step_X=torch.full_like(
                    state.step_X, LARGE_MALA_STEP))
            return state, sweep, gen
        state, sweep, gen = build()
        ref = sweep(state, gen)
        torch.cuda.synchronize()
        del sweep, state
        state, sharded, gen = build(node_devices=nodes)
        for d in set(nodes):
            torch.cuda.reset_peak_memory_stats(d)
        got = sharded(state, gen)
        torch.cuda.synchronize()
        flips = (got.acc_X != ref.acc_X)
        n_flips = int(flips.sum())
        check(n_flips <= NEAR_TIES, '%s: %d accepts differ from the '
              'unsharded sweep\'s' % (name, n_flips))
        agree = ~flips[..., None].expand_as(ref.X)
        gap = float(((got.X - ref.X).abs() - NODE_SWEEP_RTOL
                     * ref.X.abs()).masked_fill(~agree, -1).max())
        check(gap <= 1e-6, '%s: positions off the unsharded sweep\'s by '
              '%g beyond rtol %g' % (name, gap, NODE_SWEEP_RTOL))
        check(n_flips > 0 or (torch.equal(got.acc_int, ref.acc_int)
                              and torch.equal(got.z, ref.z)),
              '%s: intercept accepts or labels differ' % name)
        rel_by_chain = (got.logp - ref.logp).abs() / ref.logp.abs()
        rel = float(rel_by_chain.max())
        clean = ~flips.reshape(flips.shape[0], -1).any(1)
        if bool(clean.any()):
            gap = float(rel_by_chain[clean].max())
            check(gap <= NODE_LOGP_RTOL, '%s: log joint off the unsharded '
                  'sweep\'s by rel %g on a chain whose accepts agree'
                  % (name, gap))
        t0 = time.perf_counter()
        s = got
        for _ in range(NODE_SWEEPS[1]):
            s = sharded(s, gen)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / NODE_SWEEPS[1]
        check(bool(torch.isfinite(s.logp).all()), '%s: non-finite logp'
              % name)
        peaks = {str(d): torch.cuda.max_memory_allocated(d) / 1e9
                 for d in set(nodes)}
        out[name] = dict(ms=ms, flips=n_flips, logp_rel=rel, peak_gb=peaks)
        log('node-sharded %s on %s: one sweep against the unsharded sweep '
            'from the same state and generator: %d accepts differ, X within '
            'rtol %g elsewhere, logp rel err %g; %.3f ms/sweep over %d '
            'sweeps, peak memory by card %s GB (both shards on one card '
            'when repeated)'
            % (name, [str(d) for d in nodes], n_flips, NODE_SWEEP_RTOL, rel,
               ms, NODE_SWEEPS[1], {k: round(v, 3) for k, v in
                                    peaks.items()}))
        del ref, got, s, sharded, state
        torch.cuda.empty_cache()
    return out


def node_network(key):
    from dynetlsm_tpu_torch.datasets import (
        northstar_network, with_missing_dyads)
    Y = northstar_network(directed='directed' in key)
    return with_missing_dyads(Y, MISSING, seed=5) if 'missing' in key else Y


def node_estimator(name, dev, checkpoint_dir=None, nodes=True):
    """(the estimator of NODE_FITS[name], node_devices=2 on phase 18's
    devices, or with ``nodes`` False its unsharded twin; its network)."""
    from dynetlsm_tpu_torch import DynamicNetworkHDPLPCM, DynamicNetworkLSM
    model, kw, net = NODE_FITS[name]
    cls = DynamicNetworkLSM if model == 'lsm' else DynamicNetworkHDPLPCM
    kw = dict(NODE_BUDGET, **kw)
    if nodes:
        kw.update(node_devices=2, devices=phase18_devices(dev)[0])
    return (cls(device=dev, checkpoint_dir=checkpoint_dir, **kw),
            node_network(net))


def short_nested(fn):
    """Run ``fn()`` with the mixture fits' nested LSM cut to
    SHORT_NESTED."""
    from dynetlsm_tpu_torch.models import mixture_base
    init = mixture_base.init_from_lsm

    def short(*args, **kw):
        kw['lsm_kwargs'] = dict(SHORT_NESTED)
        return init(*args, **kw)
    mixture_base.init_from_lsm = short
    try:
        return fn()
    finally:
        mixture_base.init_from_lsm = init


def node_fit_phase(dev):
    """The node-sharded fits (NODE_FITS) and their unsharded twins; the
    NODE_CKPT fit killed in a child after CKPT_CRASH_AFTER chunks and
    resumed in another, against its twin bit for bit.  Returns the
    launches of the node-sharded fits."""
    import shutil
    root = os.path.join(ROOT, 'build', 'checkpoints18')
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    crash = run_child(['crash', NODE_CKPT, root, str(dev)],
                      os.path.join(root, 'crash.log'), 600)
    counters = dict(launch_counters(), **row_counters())
    total = {}
    twins = {}
    for name in NODE_FITS:
        runs = {}
        for nodes in (True, False):
            est, Y = node_estimator(name, dev, nodes=nodes)
            for fn in counters.values():
                fn.launches = 0
            t0 = time.perf_counter()
            short_nested(lambda: est.fit(Y))
            runs[nodes] = (est, time.perf_counter() - t0,
                           {k: fn.launches for k, fn in counters.items()})
            check(bool(np.isfinite(est.logps_[..., 1:]).all()),
                  '%s%s: non-finite logps_' % (name, '' if nodes
                                               else ' twin'))
        (m, seconds, launches), (twin, twin_s, twin_launches) = (
            runs[True], runs[False])
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        # the unsharded 'parallel' twin: the site kernel once a sweep of
        # its own (none under case-control)
        check(('cc' in name) != (twin_launches['site_loglik'] > 0),
              '%s twin: launches %s' % (name, twin_launches))
        # no whole-network kernel under node sharding; the row-range modes
        # unless case-control (its own estimator, no kernel)
        check(not any(v for k, v in launches.items()
                      if not k.endswith('_rows'))
              and ('cc' in name) != any(launches[k] for k in row_counters()),
              '%s: launches %s' % (name, launches))
        gap = abs(m.auc_ - twin.auc_)
        log('node-sharded fit %s (mesh %s, T=10, n=500, %d chains, %d '
            'sweeps): %.1f s, auc_ %.4f against the unsharded twin\'s %.4f '
            '(%.1f s), launches %s'
            % (name, dict(m.mesh_.shape), m.n_chains,
               m.logps_.shape[-1] - 1, seconds, m.auc_, twin.auc_, twin_s,
               launches))
        check(gap <= NODE_AUC_GAP, '%s: auc_ %.4f against its unsharded '
              'twin\'s %.4f' % (name, m.auc_, twin.auc_))
        if name == NODE_CKPT:
            twins[name] = {k: getattr(m, k) for k in NODE_CKPT_TRACES}
    code, out = wait_child(crash)
    check(code == CKPT_CRASH_CODE, 'node checkpoint crash child exited %s: '
          '%s' % (code, out))
    code, out = wait_child(run_child(['resume', NODE_CKPT, root, str(dev)],
                                     os.path.join(root, 'resume.log'), 600))
    check(code == 0, 'node checkpoint resume child exited %s: %s'
          % (code, out))
    with np.load(os.path.join(root, NODE_CKPT, 'result.npz')) as r:
        got = {k: r[k] for k in r.files}
    equal = all(got[k].dtype == v.dtype and np.array_equal(got[k], v)
                for k, v in twins[NODE_CKPT].items())
    log('node checkpoint %s: killed after %d of its chunks, resumed in a '
        'fresh process: %s' % (NODE_CKPT, CKPT_CRASH_AFTER,
                               'equal bit for bit' if equal
                               else 'DIFFERENT'))
    check(equal, 'node checkpoint %s: the resumed traces differ from the '
          'uninterrupted fit\'s' % NODE_CKPT)
    shutil.rmtree(root, ignore_errors=True)
    return total


def multi_device_phase(dev):
    """Phase 18 (see the module's text).  Returns (the row-range rows'
    numbers, the launches of the node-sharded path, the node-sharded
    sweeps' numbers)."""
    import torch
    from dynetlsm_tpu_torch.entry import dryrun_multichip
    devices, kind = phase18_devices(dev)
    log('phase 18 meshes on %s: %s' % (
        kind + (' cards' if kind == 'distinct'
                else ' (one card, cuda:0 repeated)'),
        [str(d) for d in devices]))
    Y8192 = large_network(ROW_BLOCK['n'], False, ROW_BLOCK['T'])
    rows = row_range_phase(devices, Y8192)
    chain_mesh_phase(dev, devices)
    # the main path of the row-range modes: the node-sharded sweeps and
    # fits, every count set to 0 just before and read just after
    counters = row_counters()
    for fn in counters.values():
        fn.launches = 0
    sweeps = node_sweep_phase(devices, Y8192)
    sweep_launches = {k: fn.launches for k, fn in counters.items()}
    del Y8192
    fit_launches = node_fit_phase(dev)
    launches = {k: sweep_launches[k] + fit_launches[k] for k in counters}
    for k, v in launches.items():
        check(v > 0, 'phase 18: %s was never launched on the node-sharded '
              'path' % k)
    t0 = time.perf_counter()
    dryrun_multichip(len(devices), device=dev.type)
    log('dryrun_multichip(%d): passed in %.1f s'
        % (len(devices), time.perf_counter() - t0))
    torch.cuda.synchronize()
    log('phase 18 launches of the row-range modes: %s' % launches)
    return rows, launches, sweeps


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


def pair_bound(args, dyads=None):
    """Per unordered dyad: a distance (7 with the clamp and sqrt), then per
    intercept eta, y * eta, softplus (6), their difference and the sum
    (10).  ``dyads``: the dyads scored (a row range's), all by default."""
    Y, X = args[:2]
    C, T, n, _ = X.shape
    n_cand = len(args) - 2
    if dyads is None:
        dyads = C * T * n * (n - 1) // 2
    return bound(dyads * (7 + n_cand * 10), _bytes(*args) + 4 * C * n_cand)


def dir_bound(args, dyads=None):
    """Per unordered dyad: a distance (7), then per candidate both
    directions' scale, eta, softplus and y * eta - softplus (24); per
    candidate and node, two reciprocals.  ``dyads``: the dyads scored (a
    row range's), all by default."""
    Yp, X, radii, b = args
    C, T, n, _ = X.shape
    n_cand = radii.shape[1]
    if dyads is None:
        dyads = C * T * n * (n - 1) // 2
    ops = dyads * (7 + 24 * n_cand) + 2 * C * n_cand * n
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


def scan_issue_bound_ms(C, T, n, directed, split, clock_hz):
    """The least time the card needs to issue the node scan's compiled
    partner-term loop for every site's n - 1 partners: ``NODE_SCAN_SASS``
    instructions per term over SMS x LANES lanes a clock, or, if larger,
    its MUFU instructions over a quarter of the lanes."""
    instr, mufu = NODE_SCAN_SASS[bool(directed), bool(split)]
    slots = max(instr / LANES, mufu / (LANES / 4))
    return 1e3 * C * T * n * (n - 1) * slots / (SMS * clock_hz)


def issue_bound_ms(name, args, n_cand, clock_hz, dyads=None):
    """The least time the card needs to issue the compiled inner loop for
    every dyad (``dyads``, or all of the inputs ``args``):
    ``LOGLIK_SASS`` instructions per dyad over SMS x LANES lanes a clock,
    or, if larger, its MUFU instructions over a quarter of the lanes."""
    if dyads is None:
        C, T, n, _ = args[1].shape
        dyads = C * T * n * (n - 1) // 2
    instr, mufu = LOGLIK_SASS[name, n_cand]
    slots = max(instr / LANES, mufu / (LANES / 4))
    return 1e3 * dyads * slots / (SMS * clock_hz)


# ---------------------------------------------------------------------------
# phase 19: the examples, the uncoloured case-control scan, the exports
# ---------------------------------------------------------------------------

# got.py's budget constants on the card (its own: 20,000 + 5,000 + 5,000)
GOT_BUDGET = dict(N_ITER=300, N_TUNE=100, N_BURN=100)
# the tempering demo at tests/test_examples_smoke.py's budget
PT_DEMO = dict(n_iter=400, tune=150, burn=150)
# the uncoloured case-control slice: directed north star, controls a node,
# chains, (warm, timed) sweeps
UNCOLORED_CC = dict(n=500, m=64, C=8, sweeps=(1, 2))
UNCOLORED_SCAN_CHAINS = 2


def example_module(name, constants=None):
    """``examples/NAME.py`` against the port (``scripts/run_example.py``),
    its copy under build/examples."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        'run_example', os.path.join(ROOT, 'scripts', 'run_example.py'))
    run_example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run_example)
    return run_example.load_port_example(name, constants)


def got_example(dev):
    """``examples/got.py`` at ``GOT_BUDGET`` on the card (its estimator's
    default device), launches counted; its checks must hold.  Returns its
    numbers."""
    import contextlib
    import io
    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        m = example_module('got', GOT_BUDGET).model
    seconds = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    check(m.Y_fit_.shape == (4, 313, 313), 'got.py: network %s'
          % (m.Y_fit_.shape,))
    check(bool(np.isfinite(m.logps_).all()), 'got.py: non-finite logp')
    check(0.5 < m.auc_ <= 1.0, 'got.py: auc_ %g' % m.auc_)
    check(m.forecast_probas_marginalized_.shape == (313, 313),
          'got.py: forecast shape')
    check(launches['node_scan'] > 0 and launches['pair_loglik'] > 0,
          'got.py: launches %s' % launches)
    return dict(seconds=seconds, launches=launches, auc=float(m.auc_),
                report=out.getvalue().strip().splitlines(),
                stage_seconds={k: round(v, 3)
                               for k, v in m.stage_seconds_.items()},
                sweeps=m.n_iter + m.tune + m.burn, chains=m.n_chains,
                device=str(m.device_))


def examples_child(dev):
    """Phase 19's work that runs in a child process beside phases 17 and
    18: the tempering demo, the uncoloured case-control slice and
    ``got.py``, each with the launch counters set to 0 just before it and
    read just after.  Returns their numbers."""
    return dict(pt=pt_demo(), cc=uncolored_cc(dev), got=got_example(dev))


def start_examples(dev):
    """Start :func:`examples_child` in a child process (``--checkpoint-child
    examples``).  Returns the child for :func:`examples_result`."""
    import shutil
    root = os.path.join(ROOT, 'build', 'examples_child')
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    threads = str(max(1, (os.cpu_count() or 2) // 2))
    env = dict(os.environ, OMP_NUM_THREADS=threads,
               OPENBLAS_NUM_THREADS=threads, MKL_NUM_THREADS=threads)
    return run_child(['examples', '-', root, str(dev)],
                     os.path.join(root, 'child.log'), 900, env=env), root


def examples_result(started):
    """Wait for the :func:`start_examples` child and return its numbers
    (its checks fail the child, and so the phase)."""
    import shutil
    child, root = started
    code, out = wait_child(child)
    check(code == 0, 'examples child exited %s: %s' % (code, out))
    with open(os.path.join(root, 'result.json')) as f:
        result = json.load(f)
    shutil.rmtree(root, ignore_errors=True)
    return result


def pt_demo():
    """``examples/parallel_tempering.py::run`` at ``PT_DEMO`` on the card,
    launches counted; its claim must hold.  Returns its numbers."""
    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    b_plain, b_pt, ladder = example_module('parallel_tempering').run(
        **PT_DEMO)
    seconds = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    check(b_plain.shape == (8,) and b_pt.shape == (2,),
          'tempering demo: shapes %s %s' % (b_plain.shape, b_pt.shape))
    check(bool(np.isfinite(b_plain).all() and np.isfinite(b_pt).all()),
          'tempering demo: non-finite means')
    check(b_pt.std() < b_plain.std(), 'tempering demo: tempered spread %g '
          'not below the untempered %g' % (b_pt.std(), b_plain.std()))
    check(ladder.shape == (8,) and bool(np.allclose(ladder[::4], 1.0)),
          'tempering demo: ladder %s' % ladder)
    check(launches['node_scan'] > 0 and launches['dir_loglik'] > 0,
          'tempering demo: launches %s' % launches)
    return dict(seconds=seconds, launches=launches,
                spread_plain=float(b_plain.std()),
                spread_pt=float(b_pt.std()), b_plain=b_plain.tolist(),
                b_pt=b_pt.tolist(), ladder=ladder.tolist())


def uncolored_cc(dev):
    """The case-control sweep without colour classes on the directed
    north-star network (``UNCOLORED_CC``): the HDP-LPCM state of
    ``build_state_and_sweep`` with one control draw a chain and the sweep
    of its edge lists alone; its scan on the card against the CPU, its
    logp against the case-control log joint, its times.  Returns its
    numbers."""
    import torch
    from dynetlsm_tpu_torch import profile_blocks
    from dynetlsm_tpu_torch.datasets import northstar_network
    from dynetlsm_tpu_torch.entry import build_state_and_sweep
    from dynetlsm_tpu_torch.mcmc.driver import make_scan_runner
    from dynetlsm_tpu_torch.mcmc.sweeps import make_hdp_sweep
    from dynetlsm_tpu_torch.ops.case_control import sample_control_nodes
    n, m, C = UNCOLORED_CC['n'], UNCOLORED_CC['m'], UNCOLORED_CC['C']
    warm, timed = UNCOLORED_CC['sweeps']
    name = 'cc uncoloured directed northstar'
    Y = northstar_network(n=n, directed=True)
    state, sweep, gen = build_state_and_sweep(
        Y, C, K=CC_K, device=dev, is_directed=True, n_control=m)
    static = {k: sweep.cc_static[k]
              for k in ('in_edges', 'out_edges', 'degrees')}
    sweep = make_hdp_sweep(None, np.zeros(2, np.float32), sweep.cfg,
                           device=dev, cc_static=static)
    ci, co = sample_control_nodes(gen, state.X[..., 0], m, directed=True,
                                  n_chains=C)
    state = state.replace(ctrl_in=ci, ctrl_out=co)
    runner = make_scan_runner(sweep, lambda s: {'logp': s.logp},
                              chunk=timed)
    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    state, _ = runner(state, gen, warm)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, traced = runner(state, gen, timed)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / timed
    launches = {k: fn.launches for k, fn in counters.items()}
    check(all(v == 0 for v in launches.values()),
          '%s: dense kernels launched %s' % (name, launches))
    check(tuple(state.ctrl_out.shape) == (C, n, m),
          '%s: controls %s' % (name, tuple(state.ctrl_out.shape)))
    check(bool(torch.isfinite(traced['logp']).all()),
          '%s: non-finite logp' % name)
    want = cc_log_joint(sweep, state)
    gap = (want - state.logp).abs()
    rel = float((gap / state.logp.abs()).max())
    check(bool((gap <= 1e-5 * state.logp.abs() + 1e-3).all()),
          '%s: sweep logp vs the case-control log joint rel err %g'
          % (name, rel))
    acc_rate = float(state.acc_X.mean()) / (warm + timed)
    check(0.0 < acc_rate < 1.0, '%s: X acceptance %g' % (name, acc_rate))
    device = profile_blocks.device_times(sweep, state, gen, 1)
    flips, margin, dx, rate = check_colored_scan(
        name, state, sweep, dev, seed=n + 2, chains=UNCOLORED_SCAN_CHAINS)
    return dict(name=name, n=n, m=m, chains=C, ms=ms, acc_rate=acc_rate,
                logp_rel_err=rel,
                launches_per_sweep=device['launches_per_sweep'],
                device_busy=device['device_busy'], cpu_flips=flips,
                cpu_margin=margin, cpu_dx=dx)


def exports_on_card(dev):
    """The functions the port gained for the JAX package's exports on CUDA
    tensors against the same call on the CPU (rtol 1e-5).  Returns the
    largest relative difference."""
    import torch
    from dynetlsm_tpu_torch import math as pmath, ops as pops
    from dynetlsm_tpu_torch.math import distributions as pdist
    from dynetlsm_tpu_torch.math import procrustes as pproc
    from dynetlsm_tpu_torch.mcmc import labels as plabels
    from dynetlsm_tpu_torch.ops import likelihoods as plik
    rng = np.random.RandomState(19)
    T, n, K = 3, 40, 4
    Y = (rng.uniform(size=(T, n, n)) < 0.3).astype(np.float32)
    X = rng.randn(T, n, 2).astype(np.float32)
    radii = rng.uniform(0.5, 1.0, n).astype(np.float32)
    mu = rng.randn(K, 2).astype(np.float32)
    sig = rng.uniform(0.5, 2.0, K).astype(np.float32)
    Xs = rng.randn(5, T, n, 2).astype(np.float32)
    g = rng.gumbel(size=(1, T, n, K)).astype(np.float32)
    w0 = rng.dirichlet(np.ones(K)).astype(np.float32)
    w = rng.dirichlet(np.ones(K), size=K).astype(np.float32)

    def calls(d):
        def t(a):
            return torch.as_tensor(a, device=d)
        tY, tX, tr = t(Y), t(X), t(radii)
        dist = pops.pairwise_distances(tX)
        return {
            'distances_to_point': pops.distances_to_point(tX, tX[:, 3]),
            'undirected_partial_loglik': pops.undirected_partial_loglik(
                tY[:, 3], tX, tX[:, 3] + 0.1, 0.4),
            'directed_partial_loglik': pops.directed_partial_loglik(
                tY[:, 3], tY[:, :, 3], tX, tX[:, 3] + 0.1, tr,
                tr[3].expand(T), 0.3, -0.2),
            'directed_intercept_grad': pops.directed_intercept_grad(
                tY, dist, tr, 0.3, -0.2),
            'dynamic_network_loglikelihood': torch.stack([
                plik.dynamic_network_loglikelihood(tY, tX, 0.4),
                plik.dynamic_network_loglikelihood(
                    tY, tX, t(np.float32([0.3, -0.2])), radii=tr)]),
            'loglik_pair': torch.stack(plik.undirected_loglik_pair(
                tY, dist, 0.4, 0.5) + plik.directed_loglik_pair(
                tY, dist, tr, (0.3, -0.2), (0.4, -0.1))),
            'emission_logliks': pops.emission_logliks(tX, t(mu), t(sig),
                                                      0.8),
            'emission_likelihoods': pops.emission_likelihoods(
                tX, t(mu), t(sig), 0.8),
            'spherical_normal_logpdf': pops.spherical_normal_logpdf(
                tX, t(mu[0]), 0.7),
            'multivariate_t_logpdf': torch.stack([
                pmath.multivariate_t_logpdf(tX[0, 0], 4.0, t(mu[0]), t(
                    np.float32([[2.0, 0.3], [0.3, 1.0]]))),
                pmath.multivariate_t_logpdf(tX[0, 0], 4.0, t(mu[0]), 1.7)]),
            'spherical_normal_log_pdf': pdist.spherical_normal_log_pdf(
                tX, t(mu[0]), 0.7),
            'longitudinal_procrustes_transform':
                pmath.longitudinal_procrustes_transform(t(Xs))[0],
            'static_procrustes_rotation': pproc.static_procrustes_rotation(
                tX[0], tX[1])[0],
            'labels_gibbs_from_gumbel': plabels.labels_gibbs_from_gumbel(
                tX[None], t(mu)[None], t(sig)[None],
                t(np.float32([0.8])), t(w0)[None], t(w)[None], t(g)),
            'log_normalize': plabels.log_normalize(t(X[0])),
        }
    card = calls(dev)
    cpu = calls(torch.device('cpu'))
    worst = 0.0
    for k, v in card.items():
        check(v.device.type == 'cuda', '%s: result on %s' % (k, v.device))
        v, c = v.cpu(), cpu[k]
        if not v.is_floating_point():
            check(torch.equal(v, c), '%s: card and CPU differ' % k)
            continue
        err = float(((v - c).abs() / (c.abs() + 1e-6)).max())
        worst = max(worst, err)
        check(bool(torch.allclose(v, c, rtol=1e-5, atol=1e-5)),
              '%s: card and CPU differ by %g (relative)' % (k, err))
    gen = torch.Generator(device=dev).manual_seed(19)
    draws = [pdist.truncated_normal(gen, torch.full((4096,), 0.99999,
                                                    device=dev),
                                    torch.full((4096,), 1e-8, device=dev)),
             pdist.sample_inv_gamma(gen, 3.0, 2.0),
             pdist.sample_categorical(gen, torch.full((64, 3), 1 / 3,
                                                      device=dev))]
    check(all(d.device == dev for d in draws), 'samplers: a draw off the '
          'card')
    check(bool(((draws[0] > 0) & (draws[0] < 1)).all()),
          'truncated_normal: a draw on or past a bound')
    log('exports on the card against the CPU: %d functions, largest '
        'relative difference %g; samplers draw on the generator\'s device'
        % (len(card), worst))
    return worst


def examples_phase(dev, child):
    """Phase 19: the exports on the card, then the numbers of the
    :func:`start_examples` child.  Returns (its numbers, each kernel's
    launches in the two examples)."""
    worst = exports_on_card(dev)
    out = examples_result(child)
    pt, cc, got = out['pt'], out['cc'], out['got']
    log('tempering demo (%s): %.1f s, per-chain mean b_in untempered %s '
        '(spread %.4f), tempered %s (spread %.4f), ladder %s, launches %s'
        % (', '.join('%s=%d' % kv for kv in PT_DEMO.items()), pt['seconds'],
           np.round(pt['b_plain'], 4).tolist(), pt['spread_plain'],
           np.round(pt['b_pt'], 4).tolist(), pt['spread_pt'],
           np.round(pt['ladder'], 4).tolist(), pt['launches']))
    log('slice %s (T=10, n=%d, m=%d, %d chains, one control draw a chain): '
        '%.3f ms/sweep, %.0f kernel launches/sweep, device busy %.3f, X '
        'acceptance %.3f, case-control log joint rel err %g; the scan on '
        'the card against the CPU, %d chains node by node: %d accepts '
        'differ (largest CPU margin %g), max |dX| %g at the others'
        % (cc['name'], cc['n'], cc['m'], cc['chains'], cc['ms'],
           cc['launches_per_sweep'], cc['device_busy'], cc['acc_rate'],
           cc['logp_rel_err'], UNCOLORED_SCAN_CHAINS, cc['cpu_flips'],
           cc['cpu_margin'], cc['cpu_dx']))
    log('got.py (%s, %d sweeps, %d chain(s), on %s): %.1f s, auc_ %.4f, '
        'launches %s, stage seconds %s; its report: %s'
        % (', '.join('%s=%d' % kv for kv in GOT_BUDGET.items()),
           got['sweeps'], got['chains'], got['device'], got['seconds'],
           got['auc'], got['launches'], got['stage_seconds'],
           ' | '.join(got['report'])))
    log('(the demo, the slice and got.py in a child process beside phases '
        '17 and 18)')
    launches = {k: pt['launches'][k] + got['launches'][k]
                for k in pt['launches']}
    return dict(out, exports_worst=worst), launches


def main():
    if not os.path.isdir(os.path.join(ROOT, 'dynetlsm_tpu_torch')):
        log('chip_smoke: no dynetlsm_tpu_torch package beside this script; '
            'run it from the root of a checkout')
        return 1
    sys.path.insert(0, ROOT)
    if sys.argv[1:2] == ['--checkpoint-child']:
        return checkpoint_child(*sys.argv[2:6])
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
        fit_launches, ns_fit = estimator_phase(dev)
        phase_done('phase 13')

        # phase 14: the case-control slices
        cc_out = cc_phase(dev)
        phase_done('phase 14')

        # phase 15: the split-field node scan and the other latent updates
        large_fit_child = start_large_fit(dev)
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
        large_schemes = run_large_schemes(dev, large[LARGE_SLICES[0][0]])
        site = {}
        for k, o in large_schemes.items():
            slices[k] = (o['launches'], o['ms'])
            if 'site_kernel' in o:
                site[k] = o['site_kernel']
        more_fits = [large_fit_launches(large_fit_child)]
        launches, cc_parallel = scheme_phase(dev, networks, slices, site)
        more_fits.append(launches)
        for launches in more_fits:
            for k, v in launches.items():
                fit_launches[k] = fit_launches.get(k, 0) + v
        check(fit_launches['node_scan_split'] > 0,
              'estimators: node_scan_split was never launched')
        phase_done('phase 15')

        # phase 16: forecasts and the headline scenario
        forecasts = forecast_phase(dev, ns_fit)
        del ns_fit
        launches, split_out = split_recovery(dev)
        for k, v in launches.items():
            fit_launches[k] = fit_launches.get(k, 0) + v
        phase_done('phase 16')

        # phase 17: checkpoints, with phase 19's examples beside it and 18
        examples_child = start_examples(dev)
        ckpt_launches, ckpt_writes = checkpoint_phase(dev)
        for k, v in ckpt_launches.items():
            fit_launches[k] = fit_launches.get(k, 0) + v
        phase_done('phase 17')

        # phase 18: multi-device fits
        row_rows, row_launches, node_sweeps = multi_device_phase(dev)
        phase_done('phase 18')

        # phase 19: the examples, the uncoloured case-control scan, the
        # exports
        examples_out, example_launches = examples_phase(dev, examples_child)
        phase_done('phase 19')

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
            C, T, n, _ = t['X'].shape
            # the plain version's run of the check: a yardstick, seconds
            # a call
            return (by[rule], t['plain_ms'],
                    {'cluster': rule,
                     'ms_by_cluster': {str(b): v for b, v in by.items()},
                     'us_per_step': {str(b): 1e3 * v / (2 * n)
                                     for b, v in by.items()},
                     'issue_of': (C, T, n, 'radii' in t, False)})

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
            clocks.append(clock)
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
        clocks = []
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
                  'slice_rule_over_fastest': big['rule_over_fastest'],
                  'slice_ms_by_cluster': {str(b): v for b, v in
                                          big['ms_by_cluster'].items()},
                  'slice_plain_ms_2_chains': big['plain_ms'],
                  'slice_bound_ms': big['bound_ms'],
                  'slice_bound_by': big['bound_by'],
                  'issue_of': tuple(t['X'].shape[:3]) + (directed, True),
                  'slice_issue_of': (big['chains'], 10, big['n'], directed,
                                     True)}),
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
            # the node scan's issue bound at the log-likelihood rows'
            # median SM clock
            for key in ('issue_of', 'slice_issue_of'):
                if key in extra:
                    clock = float(np.median(clocks))
                    extra[key[:-3] + '_bound_ms'] = scan_issue_bound_ms(
                        *extra.pop(key), clock)
                    extra['sm_clock_mhz'] = clock / 1e6
            if name.startswith('node_scan'):
                log('  issue bound %.6f ms%s at an SM clock of %.0f MHz'
                    % (extra['issue_bound_ms'],
                       ' (its slice: %.4f ms)' % extra['slice_issue_bound_ms']
                       if 'slice_issue_bound_ms' in extra else '',
                       extra['sm_clock_mhz']))
            if 'graph_ms' in extra:
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
                'checkpoint_launches': ckpt_launches[name],
                'example_launches': example_launches[name],
                'mode': mode, 'slice': slice_at,
                'shape': 'T=%(T)d n=%(n)d chains=%(C)d' % shape}, **extra))
        for name, (err, nums, mode, shape) in row_rows.items():
            bound_ms, bound_by = nums['bound']
            # at the median SM clock of the whole modes' rows
            clock = float(np.median(clocks))
            issue_ms = issue_bound_ms(
                name, None, 2 if name.startswith('pair') else 3, clock,
                dyads=nums['dyads'])
            log('%s (%s) %s: kernel %.4f ms, %.4f ms a call in a CUDA graph '
                'of 5, plain %.4f ms, bound %.6f ms (%s), issue bound %.6f '
                'ms at %.0f MHz, %d dyads'
                % (name, mode, shape, nums['ms'], nums['graph_ms'],
                   nums['plain_ms'], bound_ms, bound_by, issue_ms,
                   clock / 1e6, nums['dyads']))
            kernels.append({
                'name': name, 'route': 'cuda',
                'source': pair_cu if name.startswith('pair') else dir_cu,
                'replaces': loglik_py + (':25' if name.startswith('pair')
                                         else ':219'),
                'launches': row_launches[name], 'max_abs_err': err,
                'ms': nums['ms'], 'plain_ms': nums['plain_ms'],
                'bound_ms': bound_ms, 'bound_by': bound_by,
                'library_ms': None, 'graph_ms': nums['graph_ms'],
                'issue_bound_ms': issue_ms, 'sm_clock_mhz': clock / 1e6,
                'mode': mode, 'shape': shape,
                'slice': 'phase 18 node-sharded sweeps and fits'})
        site_cu = 'dynetlsm_tpu_torch/csrc/site_loglik.cu'
        # JAX's 'parallel' update, one fused XLA pass: no Pallas kernel
        site_replaces = 'dynetlsm_tpu/mcmc/latent.py:105'
        for slice_at, nums in site.items():
            site_rows = [(
                'site_loglik', 'whole network', nums['ms'], nums['plain_ms'],
                nums['bound'], nums['issue_bound_ms'], nums['max_abs_err'],
                slices[slice_at][0]['site_loglik'], slice_at)]
            if nums['shape'].startswith('T=10 n=8192'):
                site_rows.append((
                    'site_loglik_rows',
                    'rows [%d, %d)' % tuple(nums['rows']), nums['rows_ms'],
                    nums['rows_plain_ms'], nums['rows_bound'],
                    nums['rows_issue_bound_ms'], nums['rows_max_abs_err'],
                    row_launches['site_loglik_rows'],
                    'phase 18 node-sharded sweeps and fits'))
            for (name, mode, ms, pms, (bound_ms, bound_by), issue_ms, err,
                 launches, at) in site_rows:
                mode = '%s, %s' % ('directed' if nums['directed']
                                   else 'undirected', mode)
                log('%s (%s) %s: kernel %.4f ms, plain %.4f ms, bound %.6f '
                    'ms (%s), issue bound %.6f ms at %.0f MHz'
                    % (name, mode, nums['shape'], ms, pms, bound_ms,
                       bound_by, issue_ms, nums['sm_clock_mhz']))
                kernels.append({
                    'name': name, 'route': 'cuda', 'source': site_cu,
                    'replaces': site_replaces, 'launches': launches,
                    'max_abs_err': err, 'ms': ms, 'plain_ms': pms,
                    'bound_ms': bound_ms, 'bound_by': bound_by,
                    'library_ms': None, 'issue_bound_ms': issue_ms,
                    'sm_clock_mhz': nums['sm_clock_mhz'],
                    'err_vs_plain': nums['err_plain'],
                    'err_vs_float64': nums['err64'],
                    'plain_err_vs_float64': nums['plain_err64'],
                    'fit_launches': fit_launches.get(name),
                    'checkpoint_launches': ckpt_launches.get(name),
                    'example_launches': example_launches.get(name),
                    'mode': mode, 'slice': at, 'shape': nums['shape']})
        log('node-sharded sweeps at n = 8,192: ' + ', '.join(
            '%s %.3f ms/sweep (%d accepts off the unsharded sweep, peak GB '
            'by card %s)' % (k, o['ms'], o['flips'], o['peak_gb'])
            for k, o in node_sweeps.items()))
        log('slice ms/sweep: ' + ', '.join(
            '%s %.3f' % (k, v[1]) for k, v in slices.items()))
        log('slices past n = 2048: ' + ', '.join(
            '%s %.3f ms/sweep (split-field scan %.3f ms, %.3f us/step, '
            'clusters of %d, the launch at clusters of %s: %s ms, '
            'bound %.4f ms, busy %s, %.3f GB)'
            % (o['name'], o['ms'], o['scan_ms'], o['us_per_step'],
               o['cluster'], ' / '.join(map(str, o['ms_by_cluster'])),
               ' / '.join('%.3f' % v for v in o['ms_by_cluster'].values()),
               o['bound_ms'], o['device_busy'], o['peak_gb'])
            for o in large.values()))
        log('case-control parallel: %.3f ms/sweep (scan %.3f ms)'
            % (cc_parallel['ms'], cc_parallel['scan_ms']))
        log('past n = 4,096 with the other latent updates: ' + ', '.join(
            '%s %.3f ms/sweep (X acceptance %.4f, %.3f GB against %.3f, '
            'busy %s)' % (o['name'], o['ms'], o['acc_rate'], o['peak_gb'],
                          o['exact_peak_gb'], o['device_busy'])
            for o in large_schemes.values()))
        log('forecasts: ' + ', '.join(
            '%s %.3f s (card function %.3f s, CPU %.3f s, max err %g, peak '
            '%.3f GB)' % (k, o['attribute_s'], o['card_s'], o['cpu_s'],
                          o['max_abs_err'], o['attribute_peak_gb'])
            for k, o in forecasts.items()))
        log('split recovery: %.1f s, ARI %s, groups %s'
            % (split_out['seconds'],
               [round(a, 4) for a in split_out['aris']],
               split_out['groups']))
        log('case-control slices: ' + ', '.join(
            '%s %.3f ms/sweep (scan %.3f ms, %.0f launches, %.3f GB)'
            % (o['name'], o['ms'], o['scan_ms'], o['launches_per_sweep'],
               o['peak_gb']) for o in cc_out))
        log('checkpoint writes: ' + ', '.join(
            '%s state %d bytes, chunk %d bytes, %.4f s a chunk, %.1f%% of '
            'sampling' % (k, o['state_bytes'], o['chunk_bytes'],
                          np.mean(o['write_s']), 100 * o['share'])
            for k, o in ckpt_writes.items()))
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
    try:
        code = main()
    finally:
        stop_children()
    sys.exit(code)
