"""Hand-written CUDA kernels of the port: build, load, launch counts
(``orbit_tpu_torch.kernels.build``). Importing this package builds nothing."""
