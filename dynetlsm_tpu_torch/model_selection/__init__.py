"""Model selection over posterior samples (counterpart of
``dynetlsm_tpu/model_selection``): approximate BIC, the posterior
expected variation of information, and the train/test split of dyads."""
from .approx_bic import DynamicNetworkMixtureModel, select_bic  # noqa: F401
from .posterior_vi import (  # noqa: F401
    batched_posterior_expected_vi, minimize_posterior_expected_vi,
    nonvectorized_posterior_expected_vi, posterior_expected_vi,
    time_averaged_posterior_expected_vi)
from .train_test_split import train_test_split  # noqa: F401
