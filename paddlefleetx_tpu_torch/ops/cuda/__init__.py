"""CUDA kernels of the port: ``build`` compiles ``csrc/*.cu`` at first
use; ``flash_attention`` holds the attention wrappers and their plain
versions, ``quantized_matmul`` the weight-only int8 matmul's,
``grouped_matmul`` the grouped GEMM's (the MoE expert FFN);
``launch_counts`` keeps every wrapper's launch counts."""
