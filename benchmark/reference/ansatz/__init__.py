"""One file an ansatz family, named as its wavefunction_type; each has
``build(cfg) -> log_psi(params, boards)``."""
