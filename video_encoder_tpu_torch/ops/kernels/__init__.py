"""Hand-written Hopper kernels (CUDA C++ under `csrc/`) and their wrappers.

Each wrapper takes its plain PyTorch version for a CPU tensor and launches
its kernel for a CUDA tensor; nothing falls back from the kernel. The
kernels are built at first launch (`build.py`), never at import.
"""
