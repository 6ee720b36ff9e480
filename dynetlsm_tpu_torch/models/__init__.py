"""The public estimators of the port (counterpart of
``dynetlsm_tpu/models``) and their shared machinery."""
