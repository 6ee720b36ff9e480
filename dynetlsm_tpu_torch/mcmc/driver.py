"""Chain driver (counterpart of ``dynetlsm_tpu/mcmc/driver.py``): the
meshes, ``replicate_state``, ``make_scan_runner`` and ``collect_traces``.

Chains are the leading axis of every state tensor, so one sweep call
advances all of them.  The runner is a Python loop over sweeps that writes
the traced values into a buffer on the device, one row every ``thin``
sweeps, at most ``chunk`` rows a call; ``collect_traces`` copies each
chunk to the host, and with a ``checkpoint_dir`` persists it with the
state so that an interrupted run resumes.

Meshes (:class:`Mesh`; JAX's ``chain_mesh``, ``auto_mesh``,
``spatial_mesh``, ``spatial_auto_mesh`` under their names and rules) lay a
fit over devices.  A ``('chains',)`` mesh cuts the chains into one shard a
device: each shard is its own state (:func:`shard_state`), advanced by the
unchanged one-device sweep on its device, with its own copy of the network
and its own ``torch.Generator``; a ``('chains', 'nodes')`` mesh gives each
chain row a node-sharded sweep over its row of devices
(``mcmc/nodes.py``).  The runner of a list of sweeps (one a chain row)
issues every row's sweep before any wait and ``collect_traces`` joins the
rows' traces on the chain axis.  A device may repeat in a mesh (several
shards on one card, or the CPU): that checks the machinery and brings no
speed.
"""
import collections
import dataclasses
import os

import numpy as np
import torch

from .. import tracing
from ..ops.shards import RowShards, node_bounds
from .states import (
    NODE_FIELDS, SHARED_FIELDS, is_shared, place_like, state_from_numpy)


class Mesh:
    """Devices laid out on named axes (the counterpart of
    ``jax.sharding.Mesh``): ``devices`` a NumPy object array of
    ``torch.device``, one axis a name of ``axis_names``; ``shape`` maps
    each name to its size."""

    def __init__(self, devices, axis_names):
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self):
        return collections.OrderedDict(zip(self.axis_names,
                                           self.devices.shape))

    @property
    def rows(self):
        """The chain rows: each row's devices as a list (one device a row
        on a ``('chains',)`` mesh)."""
        return [list(r) for r in self.devices.reshape(
            self.devices.shape[0], -1)]

    def __repr__(self):
        return 'Mesh(%s, %s)' % (
            dict(self.shape), [str(d) for d in self.devices.flat])


def _device(d):
    """``torch.device`` of ``d``, a card named without its index taken as
    the current card."""
    d = torch.device(d)
    if d.type == 'cuda' and d.index is None and torch.cuda.is_available():
        d = torch.device('cuda', torch.cuda.current_device())
    return d


def all_devices(device_type='cuda'):
    """Every device of a type: each card for ``'cuda'``, the one CPU
    device for ``'cpu'`` (the counterpart of ``jax.devices()``)."""
    if device_type == 'cuda':
        if not torch.cuda.is_available():
            return []
        return [torch.device('cuda', i)
                for i in range(torch.cuda.device_count())]
    return [torch.device(device_type)]


def device_list(devices=None, device_type='cuda'):
    """The devices given (names or ``torch.device``s, repeats allowed), or
    by default :func:`all_devices` of ``device_type``."""
    if devices is None:
        return all_devices(device_type)
    return [_device(d) for d in devices]


def chain_mesh(devices=None, device_type='cuda'):
    """1-D mesh over all (or the given) devices with axis name
    ``chains``."""
    return Mesh(np.array(device_list(devices, device_type), dtype=object),
                ('chains',))


def auto_mesh(n_chains, devices=None, device_type='cuda'):
    """Pick a ``chains`` mesh for ``n_chains`` parallel chains: the
    largest device subset that evenly divides ``n_chains`` (4 chains on 8
    devices run on 4), or ``None`` when a single device (or a single
    chain) is the right answer."""
    devices = device_list(devices, device_type)
    use = min(n_chains, len(devices))
    while use > 1 and n_chains % use:
        use -= 1
    if use <= 1:
        return None
    return chain_mesh(devices[:use])


def spatial_mesh(n_chain_shards, n_node_shards, devices=None,
                 device_type='cuda'):
    """2-D ``('chains', 'nodes')`` mesh: data-parallel over chains and the
    network's rows split over ``nodes`` within each chain row, the devices
    taken in order, row by row."""
    devices = device_list(devices, device_type)
    use = n_chain_shards * n_node_shards
    if use > len(devices):
        raise ValueError('spatial mesh %dx%d needs %d devices, have %d'
                         % (n_chain_shards, n_node_shards, use,
                            len(devices)))
    return Mesh(np.array(devices[:use], dtype=object).reshape(
        n_chain_shards, n_node_shards), ('chains', 'nodes'))


def spatial_auto_mesh(n_chains, n_nodes, node_devices, devices=None,
                      device_type='cuda'):
    """Mesh for ``node_devices``-way node sharding: uses as many device
    rows as divide ``n_chains``.  Requires the node axis to split
    evenly."""
    node_bounds(n_nodes, node_devices)
    devices = device_list(devices, device_type)
    rows = max(1, len(devices) // node_devices)
    rows = min(rows, n_chains)
    while rows > 1 and n_chains % rows:
        rows -= 1
    return spatial_mesh(rows, node_devices, devices)


def shard_state(state, mesh):
    """Lay a chain-batched state (on any device) out on ``mesh``: one
    state a chain row, its chains (the rows' equal shares, in order) on
    the row's first device; on a ``('chains', 'nodes')`` mesh the row's
    ``NODE_FIELDS`` are split by rows over its devices.  The shared
    fields go whole to every row.  ``mesh`` None: ``state``."""
    if mesh is None:
        return state
    rows = mesh.rows
    C = state.X.shape[0]
    if C % len(rows):
        raise ValueError('%d chains do not split over %d chain shards'
                         % (C, len(rows)))
    per = C // len(rows)
    nodes = 'nodes' in mesh.axis_names
    out = []
    for r, devs in enumerate(rows):
        sl = slice(r * per, (r + 1) * per)
        fields = {}
        for f in dataclasses.fields(state):
            v = getattr(state, f.name)
            if v is None:
                continue
            if is_shared(f.name, v):
                fields[f.name] = v.to(devs[0])
            elif nodes and f.name in NODE_FIELDS:
                fields[f.name] = RowShards.split(v[sl], devs)
            else:
                fields[f.name] = v[sl].to(devs[0])
        out.append(type(state)(**fields))
    return out


class StateSharding:
    """The layout of a fit's state on its mesh (the counterpart of JAX's
    ``NamedSharding``): ``specs`` maps each state field, and the sweep's
    ``'network'`` (the stored network, or its missing-dyad mask) and
    ``'edge_lists'`` (case-control), to a tuple naming the mesh axis each
    of its dimensions is split on (None: whole).  ``spec`` is the
    positions' spec."""

    def __init__(self, mesh, specs):
        self.mesh = mesh
        self.specs = dict(specs)

    @property
    def spec(self):
        return self.specs['X']


def state_sharding(mesh, state):
    """:class:`StateSharding` of ``state`` (a mesh's list of row states)
    on ``mesh``: every chain-batched field split on ``chains``; under
    node sharding ``Y`` and ``missing_sum`` also on ``nodes`` (their rows,
    ``('chains', None, 'nodes', None)``), and the network and the edge
    lists by rows; the shared fields whole.  None without a mesh."""
    if mesh is None:
        return None
    nodes = 'nodes' in mesh.axis_names
    row = state[0] if isinstance(state, list) else state
    specs = {}
    for f in dataclasses.fields(row):
        v = getattr(row, f.name)
        if v is None:
            continue
        if is_shared(f.name, v):
            specs[f.name] = (None,) * len(v.shape)
            continue
        spec = ['chains'] + [None] * (len(v.shape) - 1)
        if nodes and f.name in NODE_FIELDS:
            spec[2] = 'nodes'
        specs[f.name] = tuple(spec)
    specs['network'] = (None, 'nodes' if nodes else None, None)
    specs['edge_lists'] = (None, 'nodes' if nodes else None, None)
    return StateSharding(mesh, specs)


def replicate_state(state0, n_chains, device, shared=SHARED_FIELDS):
    """Broadcast a single-chain state, given as a dict of arrays keyed by
    the field names of :class:`~.states.LSMState` or
    :class:`~.states.MixtureState` (no chain axis; the fields given pick
    the class, :func:`~.states.state_class`), across a new leading chain
    axis of length ``n_chains`` on ``device``; ``None`` fields stay
    ``None``.  Every chain gets its own copy of the network ``Y`` (missing
    dyads resampled), and a zero ``missing_sum`` unless one is given; the
    fields named in ``shared`` (the coloured case-control controls,
    ``states.SHARED_FIELDS``) stay one for all: pass ``shared=()`` to give
    every chain its copy of the controls of a sweep without colour
    classes, which redraws them per chain."""
    batched = {k: (np.asarray(v) if k in shared else
                   np.broadcast_to(np.asarray(v), (n_chains,)
                                   + np.shape(v)).copy())
               for k, v in state0.items() if v is not None}
    if 'Y' in batched and 'missing_sum' not in batched:
        batched['missing_sum'] = np.zeros(batched['Y'].shape, np.float32)
    return state_from_numpy(batched, device)


def _buffers(trace_fn, state, n_samples):
    return {k: torch.empty((n_samples,) + tuple(v.shape), dtype=v.dtype,
                           device=v.device)
            for k, v in trace_fn(state).items()}


def make_scan_runner(sweep_fn, trace_fn, chunk=512, thin=1):
    """A runner ``run(state, gen, n_samples) -> (state, buffers)`` that
    records ``n_samples`` <= ``chunk`` samples, each after ``thin`` more
    sweeps (thinning on the device: the sweeps between two samples are
    never recorded), writing ``trace_fn(state)`` (a dict of tensors) into
    buffers of ``n_samples`` rows on the device.  Nothing in it waits on
    the device.  Each call is a ``chunk`` span (``tracing``).

    ``sweep_fn`` may be a list of sweeps, one a chain row of a mesh: the
    runner then takes the rows' states and generators as lists and
    returns the rows' states and buffers as lists; each sample advances
    every row in turn, so every row's work is issued before any wait.
    ``run.extra_generators`` lists the node shards' generators of the
    sweeps (``sweep.node_gens``), which a checkpoint saves beside the
    rows' own; ``run.layout`` is (chain rows, node shards)."""
    single = not isinstance(sweep_fn, (list, tuple))
    rows = [sweep_fn] if single else list(sweep_fn)

    def runner(state, gen, n_samples):
        if n_samples > chunk:
            raise ValueError('n_samples=%d exceeds the runner chunk %d'
                             % (n_samples, chunk))
        states, gens = ([state], [gen]) if single else (list(state), gen)
        with tracing.span('chunk'):
            bufs = [_buffers(trace_fn, s, n_samples) for s in states]
            for i in range(n_samples):
                for r, sweep in enumerate(rows):
                    for _ in range(thin):
                        states[r] = sweep(states[r], gens[r])
                    for k, v in trace_fn(states[r]).items():
                        bufs[r][k][i].copy_(v)
        return (states[0], bufs[0]) if single else (states, bufs)

    runner.chunk = chunk
    runner.thin = thin
    runner.extra_generators = [g for s in rows
                               for g in (getattr(s, 'node_gens', None) or ())]
    runner.layout = (len(rows), getattr(rows[0], 'node_shards', 1))
    return runner


def _host_traces(ys):
    """A runner's buffers as NumPy arrays; a mesh's rows joined on the
    chain axis (axis 1, after the sample axis)."""
    if isinstance(ys, list):
        return {k: np.concatenate([b[k].cpu().numpy() for b in ys], axis=1)
                for k in ys[0]}
    return {k: v.cpu().numpy() for k, v in ys.items()}


def collect_traces(runner, state, gen, n_samples, chunk=512, progress=None,
                   checkpoint_dir=None):
    """Record ``n_samples`` samples in chunks, copying each chunk's traces
    to host memory (the copy is the only wait on the device, a
    ``tracing.host_sync``) and calling
    ``progress(done, n_samples)`` after each.  Returns (final_state,
    traces) with traces a dict of NumPy arrays, sample axis first.

    With ``checkpoint_dir`` (JAX ``collect_traces``'s policy) the chunk's
    traces, then the state with the generator's state, then the meta are
    written after each chunk (``dynetlsm_tpu_torch/checkpoint.py``), so a
    crash between two writes leaves the previous good meta; ``progress``
    runs after the meta.  A run resumes from the last completed chunk when
    the meta's ``n_samples`` and ``chunk`` and the fingerprint of the state
    and generator (``checkpoint.state_fingerprint``) match and ``n_done >
    0``: the state and the generator's state are restored (``gen``
    itself, so the caller's generator goes on from there) and the first
    ``ceil(n_done / chunk)`` chunks are read back.  Otherwise the directory
    is cleared and the run starts fresh.  The generator's state is taken
    after the chunk's sweeps are issued: a CUDA generator advances its
    offset when a kernel is launched, not when it finishes.

    On a mesh (a runner of a list of sweeps) ``state`` and ``gen`` are the
    chain rows' lists; the checkpoint holds the rows' states joined
    (``states.gather_state``) with every generator's state, the rows' and
    the node shards' (``runner.extra_generators``), and its fingerprint
    names the mesh's layout, so a resume on another mesh starts fresh; a
    resumed state is laid out as ``state`` was (``states.place_like``)."""
    from ..checkpoint import (
        clear_checkpoint, load_state_arrays, load_traces_chunks, read_meta,
        save_state, save_traces_chunk, state_fingerprint, write_meta)
    if getattr(runner, 'chunk', chunk) != chunk:
        raise ValueError('collect_traces chunk=%d does not match the '
                         "runner's trace buffer (%d)"
                         % (chunk, runner.chunk))
    chunks = []
    done = 0
    gens = ((list(gen) if isinstance(gen, list) else [gen])
            + list(getattr(runner, 'extra_generators', ())))
    layout = getattr(runner, 'layout', (1, 1))
    if checkpoint_dir is not None and n_samples > 0:
        os.makedirs(checkpoint_dir, exist_ok=True)
        state_path = os.path.join(checkpoint_dir, 'state.npz')
        meta = read_meta(checkpoint_dir)
        fingerprint = state_fingerprint(state, gens, layout)
        if meta is not None and meta.get('n_samples') == n_samples \
                and meta.get('chunk') == chunk and meta.get('n_done', 0) > 0 \
                and meta.get('fingerprint') == fingerprint:
            arrays, gen_states = load_state_arrays(state_path)
            state = place_like(state_from_numpy(arrays, 'cpu'), state)
            for g, g_state in zip(gens, gen_states):
                g.set_state(g_state)
            done = meta['n_done']
            chunks = load_traces_chunks(checkpoint_dir, -(-done // chunk))
        else:
            clear_checkpoint(checkpoint_dir)
    while done < n_samples:
        step_n = min(chunk, n_samples - done)
        state, ys = runner(state, gen, step_n)
        with tracing.host_sync():
            host_chunk = _host_traces(ys)
        if checkpoint_dir is not None:
            save_traces_chunk(checkpoint_dir, len(chunks), host_chunk)
            save_state(state_path, state, gens)
        chunks.append(host_chunk)
        done += step_n
        if checkpoint_dir is not None:
            write_meta(checkpoint_dir,
                       {'n_done': done, 'n_samples': n_samples,
                        'chunk': chunk, 'fingerprint': fingerprint})
        if progress is not None:
            progress(done, n_samples)
    if not chunks:
        _, ys = runner(state, gen, 0)
        return state, _host_traces(ys)
    return state, {k: np.concatenate([c[k] for c in chunks], axis=0)
                   for k in chunks[0]}
