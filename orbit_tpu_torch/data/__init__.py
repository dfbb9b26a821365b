"""Host side of the port: copies of ``orbit_tpu/data`` (index, sampling,
JPEG loader, native decoder, queues, padded episodes)."""
