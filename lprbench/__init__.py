"""The benchmark of lpr_tpu_torch: see run.py."""
