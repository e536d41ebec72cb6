"""The benchmark of jellyfish_tpu_torch: whole count jobs on one card
(run.py)."""
