"""The benchmark's network, drawn on the device from a seed.

The community model of the repository's original benchmark
(``northstar_network``): nodes fall into ``n_groups`` uniformly drawn
communities, and each undirected dyad of each time is an edge with
probability ``p_within`` inside a community and ``p_across`` between two,
both scaled by ``degree_n / n`` past ``degree_n`` nodes so the expected
degree stays at the north star's (``datasets.northstar_edge_lists``).  The
draws are PyTorch's on the device, in a few large calls: the same seed
gives the same network on the same kind of card.
"""
import torch


def community_network(T, n, seed, device, n_groups=8, p_within=0.1,
                      p_across=0.01, degree_n=500):
    """(T, n, n) uint8 symmetric 0/1 network with a zero diagonal."""
    scale = min(1.0, degree_n / n)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    z = torch.randint(0, n_groups, (n,), generator=gen, device=device)
    p = torch.where(z[:, None] == z[None, :],
                    torch.tensor(p_within * scale, device=device),
                    torch.tensor(p_across * scale, device=device))
    Y = torch.empty((T, n, n), dtype=torch.uint8, device=device)
    for t in range(T):
        upper = torch.triu(torch.rand((n, n), generator=gen, device=device)
                           < p, diagonal=1)
        Y[t] = upper | upper.T
    return Y


draw = community_network
