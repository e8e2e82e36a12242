"""The benchmark of g1_locomotion_tpu_torch on one NVIDIA H100 (see run.py)."""
