"""Utilities of the port: copies of ``orbit_tpu/utils/{args,logging,
eval_metrics}.py``, and the port's own optimiser and checkpoint code."""
