"""Models of the port: ViT backbones, poolers, heads, precision policy,
JAX-parameter conversion and the single-step recogniser."""
