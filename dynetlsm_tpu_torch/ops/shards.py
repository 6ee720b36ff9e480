"""Row-split dyad-sized tensors: the layout of node sharding (the port's
counterpart of the ``'nodes'`` axis of the JAX package's 2-D mesh,
``dynetlsm_tpu/mcmc/driver.py::spatial_mesh``).

A node-sharded chain row keeps what grows as n^2 split by rows over its
node devices: shard s holds the rows ``[bounds[s], bounds[s + 1])`` of a
(..., n, n) tensor as (..., rows, n) on ``devices[s]``.  What grows as n
(positions, labels, steps, radii) stays whole on the row's first device.
A device may appear more than once (several shards on one card, or on the
CPU): the split and the exchanges are the same, only no memory is saved.
"""
import numpy as np
import torch


def node_bounds(n, k):
    """Row bounds of ``k`` equal node shards of n nodes (k divides n)."""
    if k < 1 or n % k:
        raise ValueError('node_devices=%d must divide n_nodes=%d (pad the '
                         'network or choose a divisor)' % (k, n))
    return tuple(s * (n // k) for s in range(k + 1))


class RowShards:
    """A (..., n, n) tensor split by rows: ``parts[s]`` (..., rows_s, n)
    on its own device holds the rows ``[bounds[s], bounds[s + 1])``."""

    def __init__(self, parts, bounds):
        self.parts = list(parts)
        self.bounds = tuple(int(b) for b in bounds)
        if len(self.bounds) != len(self.parts) + 1:
            raise ValueError('RowShards: %d parts need %d bounds'
                             % (len(self.parts), len(self.parts) + 1))

    @classmethod
    def split(cls, a, devices, bounds=None, dtype=None):
        """Split a (..., n, n) NumPy array or tensor by rows over
        ``devices`` (equal shards unless ``bounds`` is given), each part
        copied to its device (as ``dtype`` when given)."""
        n = a.shape[-2]
        bounds = node_bounds(n, len(devices)) if bounds is None else bounds
        parts = []
        for s, dev in enumerate(devices):
            part = a[..., bounds[s]:bounds[s + 1], :]
            if isinstance(part, np.ndarray):
                part = torch.from_numpy(np.ascontiguousarray(part))
            parts.append(part.to(device=dev, dtype=dtype).contiguous())
        return cls(parts, bounds)

    @property
    def devices(self):
        return [p.device for p in self.parts]

    @property
    def shape(self):
        return tuple(self.parts[0].shape[:-2]) + (self.bounds[-1],
                                                  self.parts[0].shape[-1])

    def rows(self, s):
        """(first row, end row) of shard s."""
        return self.bounds[s], self.bounds[s + 1]

    def gather(self, device):
        """The whole (..., n, n) tensor on ``device``."""
        return torch.cat([p.to(device) for p in self.parts], dim=-2)


def pack_rows(Y):
    """The packed rows ``Y + 2 Y^T`` (the directed kernels' form) of a
    row-split 0/1 network Y (RowShards of (..., rows, n) uint8): shard s
    needs Y^T's rows, the columns [a_s, b_s) of every shard's rows, which
    each shard sends it transposed (the exchange grows as n^2 / k a
    shard).  Returns RowShards of (..., rows, n) uint8."""
    parts = []
    for s, part in enumerate(Y.parts):
        a, b = Y.rows(s)
        cols = [other[..., a:b].transpose(-1, -2).to(part.device)
                for other in Y.parts]
        parts.append(part + 2 * torch.cat(cols, dim=-1))
    return RowShards(parts, Y.bounds)
