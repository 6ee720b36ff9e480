"""Community-splitting recovery through the port on the CPU: the HDP-LPCM's
headline scenario (SURVEY.md §7.5 item 4), the reduced-budget variant of
``tests/test_splitting_recovery.py`` (the same network, budget and bar).
The full-budget variant runs on the card in ``chip_smoke.py`` phase 16.
"""
import numpy as np

from dynetlsm_tpu_torch import DynamicNetworkHDPLPCM
from dynetlsm_tpu_torch.datasets import simple_splitting_dynamic_network
from dynetlsm_tpu_torch.metrics import adjusted_rand_score


def test_hdp_recovers_community_split_fast():
    Y, z_true = simple_splitting_dynamic_network(n_nodes=50, n_time_steps=4,
                                                 random_state=42)
    m = DynamicNetworkHDPLPCM(n_iter=800, tune=400, burn=400,
                              n_components=10, random_state=123,
                              device='cpu').fit(Y)
    T = Y.shape[0]
    aris = [adjusted_rand_score(z_true[t], m.z_[t]) for t in range(T)]
    assert np.mean(aris) > 0.6, aris
    n_early = len(set(m.z_[0].tolist()))
    n_late = len(set(m.z_[-1].tolist()))
    assert n_early < n_late, (n_early, n_late)
