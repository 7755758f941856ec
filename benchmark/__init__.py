"""The benchmark of the PyTorch and CUDA port (genstark_tpu_torch): one
command runs one cell once (`python3 -m benchmark.run`, see run.py and
README.md)."""
