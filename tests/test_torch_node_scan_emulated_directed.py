"""The node-scan kernel's source on the host against the plain version:
the resident mode, directed and untempered, with one network shared by
the chains and one network a chain.

The build and the checks are in ``tests/torch_node_scan_emulation.py``;
each ``test_torch_node_scan_emulated*.py`` file runs a share of the cases
with its own module-scoped build.
"""
import pytest

from .torch_node_scan_emulation import (  # noqa: F401  (host_lib: fixture)
    check_matches_plain, check_per_chain_network, host_lib)


@pytest.mark.parametrize('tempered', [False])
@pytest.mark.parametrize('mixture', [False, True])
@pytest.mark.parametrize('directed', [True])
def test_host_kernel_matches_plain(host_lib, directed, mixture, tempered):
    check_matches_plain(host_lib, directed, mixture, tempered)


@pytest.mark.parametrize('mixture', [False, True])
@pytest.mark.parametrize('directed', [True])
def test_host_kernel_per_chain_network(host_lib, directed, mixture):
    check_per_chain_network(host_lib, directed, mixture)
