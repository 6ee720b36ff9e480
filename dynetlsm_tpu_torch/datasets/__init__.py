"""Networks in NumPy alone (counterpart of ``dynetlsm_tpu/datasets``):

* ``loaders``: Sampson's monastery (:func:`load_dynamic_monks`,
  :func:`load_static_monks`, :func:`load_monks`), Game of Thrones
  (:func:`load_got`, :func:`load_got_edgelists`) and the Cold-War
  alliances (:func:`load_alliances`), read from the JAX package's raw
  files in place;
* ``samples_generator`` and ``detection_limit``: the JAX package's
  synthetic generators, with its draws from the same seed;
* ``northstar``: the synthetic community network of ``bench.py``'s
  headline shapes, dense or as edge lists, and missing-dyad coding.
"""
from .detection_limit import detection_limit_simulation, make_lookup_table
from .loaders import (
    RAW, core_number, load_alliances, load_dynamic_monks, load_got,
    load_got_edgelists, load_monks, load_static_monks, network_from_edgelist)
from .northstar import (
    network_of_edge_lists, northstar_edge_lists, northstar_network,
    northstar_probas, with_missing_dyads)
from .samples_generator import (
    forecast_probas, forecast_probas_map, homogeneous_simulation,
    inhomogeneous_simulation, merging_block_model, merging_dynamic_network,
    network_from_dynamic_latent_space, simple_splitting_dynamic_network,
    synthetic_dynamic_network, synthetic_static_community_dynamic_network)

__all__ = [
    'RAW', 'core_number', 'detection_limit_simulation', 'forecast_probas',
    'forecast_probas_map', 'homogeneous_simulation',
    'inhomogeneous_simulation', 'load_alliances', 'load_dynamic_monks',
    'load_got', 'load_got_edgelists', 'load_monks', 'load_static_monks', 'make_lookup_table', 'merging_block_model',
    'merging_dynamic_network', 'network_from_dynamic_latent_space',
    'network_from_edgelist', 'network_of_edge_lists', 'northstar_edge_lists',
    'northstar_network', 'northstar_probas',
    'simple_splitting_dynamic_network', 'synthetic_dynamic_network',
    'synthetic_static_community_dynamic_network', 'with_missing_dyads']
