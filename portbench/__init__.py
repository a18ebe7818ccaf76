"""The benchmark of ``fks_tpu_torch`` on an NVIDIA H100 (``run.py``)."""
