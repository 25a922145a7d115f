"""The benchmark of the PyTorch and CUDA port (``sparkucx_tpu_torch``) on
NVIDIA H100 cards. ``python3 benchmark/run.py --help`` runs one cell."""
