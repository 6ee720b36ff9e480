"""The node-scan kernel's source on the host against the plain version:
the split-field mode in all eight instantiations, and the resident
mode, undirected, with one network a chain.

The build and the checks are in ``tests/torch_node_scan_emulation.py``;
each ``test_torch_node_scan_emulated*.py`` file runs a share of the cases
with its own module-scoped build.
"""
import pytest

from .torch_node_scan_emulation import (  # noqa: F401  (host_lib: fixture)
    check_per_chain_network, check_split_field, host_lib)


@pytest.mark.parametrize('mixture', [False, True])
@pytest.mark.parametrize('directed', [False])
def test_host_kernel_per_chain_network(host_lib, directed, mixture):
    check_per_chain_network(host_lib, directed, mixture)


@pytest.mark.parametrize('tempered', [False, True])
@pytest.mark.parametrize('mixture', [False, True])
@pytest.mark.parametrize('directed', [False, True])
def test_host_kernel_split_field_matches_plain(host_lib, directed, mixture,
                                               tempered):
    check_split_field(host_lib, directed, mixture, tempered)
