"""The benchmark of sparkdl_tpu_torch: run one cell with run.py."""
