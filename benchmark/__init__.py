"""The benchmark of ``cnmf_e_tpu_torch`` (see README.md)."""
