"""The benchmark of ``dynetlsm_tpu_torch`` on one NVIDIA GPU: configuration,
traffic and workload files, the run (``run.py``), the plain reference that
decides ``correct`` and the readers of the per-layer metrics."""
