"""Estimator-side helpers of the port (counterpart of
``dynetlsm_tpu/models``); so far the network validation alone."""
