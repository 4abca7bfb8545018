"""The benchmark of the PyTorch and CUDA port (``letf_tpu_torch``): a
data-driven harness, its plain reference and its tests. See README.md."""
