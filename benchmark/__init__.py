"""The benchmark of cgs_vmc_tpu_torch (see README.md)."""
