"""SMC annealed initialization."""
