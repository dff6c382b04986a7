"""Benchmark of the PyTorch/CUDA port: repeated steady heat solves on the
card, driven by the data files beside this package (``run.py``)."""
