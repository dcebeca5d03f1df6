"""Chain-sharded data parallelism over ``torch.distributed`` (port of
cgs_vmc_tpu/parallel/)."""
