"""The directed community network, drawn on the device from a seed.

``bench.py::northstar_network(directed=True)``: nodes fall into
``n_groups`` uniformly drawn communities, and each ordered dyad (i, j),
i != j, of each time is an edge i -> j with probability ``p_within``
inside a community and ``p_across`` between two, drawn independently of
(j, i), both scaled by ``degree_n / n`` past ``degree_n`` nodes (as
``community.py``).  Nothing is symmetrised and the diagonal is zero.  The
draws are PyTorch's on the device: the same seed gives the same network
on the same kind of card.
"""
import torch


def community_directed_network(T, n, seed, device, n_groups=8,
                               p_within=0.1, p_across=0.01, degree_n=500):
    """(T, n, n) uint8 0/1 network, Y[t, i, j] the edge i -> j, with a zero
    diagonal."""
    scale = min(1.0, degree_n / n)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    z = torch.randint(0, n_groups, (n,), generator=gen, device=device)
    p = torch.where(z[:, None] == z[None, :],
                    torch.tensor(p_within * scale, device=device),
                    torch.tensor(p_across * scale, device=device))
    p.fill_diagonal_(0.0)
    Y = torch.empty((T, n, n), dtype=torch.uint8, device=device)
    for t in range(T):
        Y[t] = torch.rand((n, n), generator=gen, device=device) < p
    return Y


draw = community_directed_network
