"""Node sharding of a chain row's sweep: the port's counterpart of the
``'nodes'`` axis of the JAX package's ``('chains', 'nodes')`` mesh
(``dynetlsm_tpu/mcmc/driver.py:55-135``, ``mcmc/sweeps.py``'s
``cfg.spatial``).

JAX row-shards every per-node field and lets GSPMD insert the gathers and
psums.  The port shards only what grows as n^2 (``ops.shards.RowShards``):
the network and its kernel form, the missing-dyad mask, each chain's
network ``state.Y`` and ``state.missing_sum``, and under case-control the
edge lists.  The n-sized state (positions, labels, steps, radii, the
mixture and HDP parameters) stays whole on the row's first device, so only
the blocks that read the network change:

* the intercept and radii steps and the log joint add the shards'
  row-range shares of the network log-likelihood (``ops/pair_loglik.py``,
  ``ops/dir_loglik.py``: the kernels' row-range mode on the card;
  ``ops/case_control.py::cc_loglik``);
* the ``'parallel'`` and ``'mala'`` latent updates score each shard's own
  sites against all partners from its rows (``mcmc/latent.py``);
* the missing-dyad resample (:func:`missing_dyad_step`): each shard draws
  the dyads of its rows from a generator of its own (``sweep.node_gens``);
  undirected, a dyad is drawn by the shard of its smaller index and its
  mirror is sent to the shard that owns the other row, by index lists
  made once (:func:`sharded_missing`);
* case-control (:func:`shard_cc_static`, :func:`build_cc_shards`): the
  edge lists are row-split, the controls (one draw for the chains) are
  drawn on the first device and each shard takes its rows.

Draws of X's size come from the row's generator as unsharded, so a
node-sharded sweep equals the unsharded one up to the order of the shard
sums; the missing-dyad draws, from the shards' generators, match it in
distribution only.  The sequential node scan ('exact') is not sharded.
"""
from typing import NamedTuple

import numpy as np
import torch

from ..config import DTYPE
from ..math.distributions import uniform
from ..ops.case_control import control_masks, edge_lists_device
from ..ops.distances import _sum_sq_last
from ..ops.shards import RowShards, node_bounds, pack_rows


def derive_seed(*ints):
    """A 64-bit seed from a tuple of non-negative integers (NumPy's
    ``SeedSequence``): the seeds of the shards' generators."""
    return int(np.random.SeedSequence([int(v) for v in ints])
               .generate_state(1, np.uint64)[0])


def node_generators(devices, seed):
    """One ``torch.Generator`` a node shard, on its device, shard s seeded
    by ``derive_seed(seed, s)``."""
    return [torch.Generator(device=dev).manual_seed(derive_seed(seed, s))
            for s, dev in enumerate(devices)]


def shard_network(cfg, Y, devices):
    """A fixed 0/1 network Y (T, n, n) split by rows over ``devices`` in
    the kernels' form: packed ``Y + 2 Y^T`` when directed, packed on the
    host before the split.  Returns RowShards of (T, rows, n) uint8."""
    Y = np.asarray(Y, np.uint8)
    if cfg.is_directed:
        Y = Y + 2 * np.swapaxes(Y, 1, 2)
    return RowShards.split(Y, devices, dtype=torch.uint8)


def kernel_rows(cfg, Y):
    """The kernels' form of a row-split 0/1 network: packed when directed
    (``ops.shards.pack_rows``: an exchange of column blocks), Y itself
    otherwise."""
    return pack_rows(Y) if cfg.is_directed else Y


class ShardedMissing(NamedTuple):
    """The missing dyads of a row-split network: ``mask`` (RowShards of
    (T, rows, n) bool); per shard the dyads it draws, ``draws[s]`` =
    (t, i, j) int64 on its device with i local to its rows (every masked
    dyad of its rows when directed, those with i < j when undirected);
    undirected, ``mirrors[s][s2]`` = (sel, t, j, i) the draws of shard s
    (``sel`` indexes them, on s's device) whose mirror (t, j, i) lies in
    shard s2's rows (j local to s2, i global, on s2's device)."""
    mask: RowShards
    draws: list
    mirrors: list


def sharded_missing(miss_mask, is_directed, devices):
    """:class:`ShardedMissing` of a (T, n, n) bool mask over ``devices``
    (its diagonal is never drawn), built on the host once."""
    mask = np.array(miss_mask, dtype=bool)
    n = mask.shape[-1]
    mask[:, np.arange(n), np.arange(n)] = False
    bounds = node_bounds(n, len(devices))
    drawn = mask if is_directed else np.triu(mask, 1)
    owner = np.searchsorted(np.asarray(bounds[1:]), np.arange(n),
                            side='right')
    draws, mirrors = [], []
    for s, dev in enumerate(devices):
        a, b = bounds[s], bounds[s + 1]
        t, i, j = np.nonzero(drawn[:, a:b])

        def put(v, d=dev):
            return torch.as_tensor(v, dtype=torch.int64, device=d)
        draws.append((put(t), put(i), put(j)))
        if is_directed:
            continue
        row = []
        for s2, dev2 in enumerate(devices):
            sel = np.nonzero(owner[j] == s2)[0]
            row.append((put(sel), put(t[sel], dev2),
                        put(j[sel] - bounds[s2], dev2), put(i[sel] + a, dev2)))
        mirrors.append(row)
    return ShardedMissing(RowShards.split(mask, devices), draws, mirrors)


def missing_draws(cfg, gen, X, intercept, radii, t, i, j, temper=None,
                  u=None):
    """New draws (C, M) of the dyads (t, i, j) (global node indices) from
    their Bernoulli conditionals, as ``sweeps.resample_missing`` draws
    them: ``u < expit(eta)``, eta undirected b - d_ij, directed b_in (1 -
    d_ij / r_j) + b_out (1 - d_ij / r_i), times ``temper`` (C,) when
    given; ``u`` (C, M) the uniforms, drawn from ``gen`` when None.
    Returns a bool tensor."""
    dist = torch.sqrt(torch.clamp_min(
        _sum_sq_last(X[:, t, i] - X[:, t, j]), 0.0))          # (C, M)
    if cfg.is_directed:
        b_in, b_out = intercept[:, 0, None], intercept[:, 1, None]
        eta = (b_in * (1.0 - dist / radii[:, j])
               + b_out * (1.0 - dist / radii[:, i]))
    else:
        eta = intercept[:, 0, None] - dist
    if temper is not None:
        eta = temper[:, None] * eta
    if u is None:
        u = uniform(gen, dist.shape, X.device)
    return u < torch.sigmoid(eta)


def missing_dyad_step(cfg, miss, gens, Y, missing_sum, X, intercept, radii,
                      it_next, temper=None):
    """Resample the missing dyads of a row-split network (step 7 of the
    JAX sweeps under node sharding): each shard draws its dyads
    (:func:`missing_draws`) from its generator ``gens[s]`` with its own
    copy of X, intercept and radii, and adds them to its rows of
    ``missing_sum`` once a chain's sweep count ``it_next`` passes
    ``cfg.n_burn``; undirected, each draw's mirror goes to the shard of
    its other row (only the missing entries move).  Y, missing_sum
    RowShards of (C, T, rows, n).  Returns the new (Y, missing_sum)."""
    Y_parts = [p.clone() for p in Y.parts]
    ms_parts = [p.clone() for p in missing_sum.parts]
    after_burn = (it_next > cfg.n_burn).to(DTYPE)
    for s, (t, i, j) in enumerate(miss.draws):
        dev = Y_parts[s].device
        Xs, bs, rs, ts, burn = [None if v is None else v.to(dev) for v in
                                (X, intercept, radii, temper, after_burn)]
        draw = missing_draws(cfg, gens[s], Xs, bs, rs, t, i + Y.bounds[s],
                             j, ts).to(torch.uint8)
        add = draw.to(DTYPE) * burn[:, None]
        Y_parts[s][:, t, i, j] = draw
        ms_parts[s][:, t, i, j] += add
        if cfg.is_directed:
            continue
        for s2, (sel, t2, j2, i2) in enumerate(miss.mirrors[s]):
            dev2 = Y_parts[s2].device
            Y_parts[s2][:, t2, j2, i2] = draw[:, sel].to(dev2)
            ms_parts[s2][:, t2, j2, i2] += add[:, sel].to(dev2)
    return RowShards(Y_parts, Y.bounds), RowShards(ms_parts, Y.bounds)


def shard_cc_static(cc_static, home, devices):
    """The case-control structures of a node-sharded sweep: the colour
    classes and the control seed on the row's first device ``home`` (the
    controls are drawn there, one draw for every shard), the fixed edge
    lists split by rows over ``devices`` (``'shards'``, each with its
    ``'row0'``; none with missing dyads, whose lists are rebuilt from each
    chain's rows), and the shards' ``'bounds'`` and ``'devices'``."""
    n = (cc_static['colors'] if 'colors' in cc_static
         else cc_static['out_edges'][0]).shape[0]
    bounds = node_bounds(n, len(devices))
    out = {k: (v.to(home) if torch.is_tensor(v) else v)
           for k, v in cc_static.items()
           if k not in ('in_edges', 'out_edges', 'degrees')}
    out.update(bounds=bounds, devices=list(devices))
    if 'out_edges' in cc_static:
        out['shards'] = [
            {k: cc_static[k][:, bounds[s]:bounds[s + 1]].to(dev)
             for k in ('in_edges', 'out_edges', 'degrees')}
            for s, dev in enumerate(devices)]
    return out


def build_cc_shards(cfg, Y, cc_static, ctrl_in, ctrl_out):
    """The node-sharded counterpart of ``sweeps.build_cc_dict``: per shard
    the lists of its rows (``cc_static``'s, or with ``cfg.sample_missing``
    rebuilt from the rows of each chain's network Y, RowShards: the
    in-edges from the packed rows' second bit when directed), its rows of
    the controls with their validity masks, and its ``'row0'``.  Returns
    ``{'shards': [...], 'ctrl_in', 'ctrl_out'}`` (the whole draw, for the
    state)."""
    bounds, devices = cc_static['bounds'], cc_static['devices']
    packed = (pack_rows(Y) if cfg.sample_missing and cfg.is_directed
              else None)
    shards = []
    for s, dev in enumerate(devices):
        a, b = bounds[s], bounds[s + 1]
        if cfg.sample_missing:
            rows = Y.parts[s]
            lists = edge_lists_device(
                rows, cc_static['max_deg'],
                Y_in=packed.parts[s] >> 1 if packed is not None else rows)
        else:
            lists = dict(cc_static['shards'][s])
        ci = None if ctrl_in is None else ctrl_in[..., a:b, :].to(dev)
        co = ctrl_out[..., a:b, :].to(dev)
        civ, cov = control_masks(ci, co, lists, cfg.is_directed)
        shards.append(dict(lists, ctrl_in=ci, ctrl_out=co, ctrl_in_valid=civ,
                           ctrl_out_valid=cov, row0=a))
    return {'shards': shards, 'ctrl_in': ctrl_in, 'ctrl_out': ctrl_out}
