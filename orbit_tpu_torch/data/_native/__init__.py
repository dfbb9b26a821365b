"""Native (C++) frame-decode pipeline sources.

``orbit_decoder.cpp`` is a libjpeg-based decode->resize->normalize pipeline
(the TPU-native analog of the reference's torch DataLoader worker decode,
reference: data/datasets.py:422-431). It is compiled on first use by
``orbit_tpu_torch/data/loader.py`` (or explicitly via scripts/build_native.sh)
and loaded through ctypes; this package exists so the .cpp source ships
inside wheels/sdists.

Copy of ``orbit_tpu/data/_native/__init__.py`` for the PyTorch port, which imports
nothing of the JAX package; keep the two in step.
"""
