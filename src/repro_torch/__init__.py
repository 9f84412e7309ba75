"""PyTorch/CUDA port of the graph-accelerator memory-access simulator.

Mirrors the module layout of the JAX package ``repro`` (the reference): the
host-side numpy substrate is carried over, the graph problems' reference
solver runs on torch, and DRAM timing runs through a hand-written CUDA
kernel for Hopper (``csrc/dram_timing.cu``).  Entry points take
``device=None``, which means the CUDA card; see ``kernels/_platform.py``.
"""
