"""The benchmark's network generator."""
import torch

from port_bench.networks.community import community_network


def test_same_seed_same_network():
    a = community_network(3, 120, 2 ** 33 + 5, 'cpu')
    b = community_network(3, 120, 2 ** 33 + 5, 'cpu')
    c = community_network(3, 120, 2 ** 33 + 6, 'cpu')
    assert torch.equal(a, b)
    assert not torch.equal(a, c)


def test_symmetric_binary_no_self_loops():
    Y = community_network(2, 200, 11, 'cpu')
    assert Y.dtype == torch.uint8 and Y.shape == (2, 200, 200)
    assert torch.equal(Y, Y.transpose(1, 2))
    assert int(Y.max()) <= 1
    assert int(torch.diagonal(Y, dim1=1, dim2=2).sum()) == 0


def test_density_of_the_community_model():
    # expected edge probability: 0.1 / 8 + 0.01 * 7 / 8 at n = 400
    Y = community_network(4, 400, 3, 'cpu').double()
    density = float(Y.sum()) / (4 * 400 * 399)
    assert abs(density - (0.1 / 8 + 0.01 * 7 / 8)) < 0.003
    # past degree_n the probabilities shrink by degree_n / n
    Y = community_network(1, 1000, 3, 'cpu').double()
    density = float(Y.sum()) / (1000 * 999)
    assert abs(density - 0.5 * (0.1 / 8 + 0.01 * 7 / 8)) < 0.002
