"""CUDA kernels of the port: ``build`` compiles ``csrc/*.cu`` at first
use; ``flash_attention`` holds the wrappers and their plain versions."""
