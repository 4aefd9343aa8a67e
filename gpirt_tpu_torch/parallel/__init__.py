"""SMC annealed initialization, parallel tempering, and chains and items
over a torch.distributed DeviceMesh."""
