"""CUDA kernels: build/load (build.py) and the wrappers with their plain twins."""
