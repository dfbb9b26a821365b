"""The benchmark of the PyTorch and CUDA port ``orbit_tpu_torch`` on one
NVIDIA H100: ``python3 port_bench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` runs one cell of ``BENCHMARK.json`` once."""
