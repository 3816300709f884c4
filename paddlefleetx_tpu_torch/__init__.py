"""PyTorch/CUDA port of PaddleFleetX-TPU for NVIDIA Hopper.

A second package beside ``paddlefleetx_tpu``: the same YAML configs,
the same GPT model and the same continuous-batching server, written
in PyTorch, with the attention kernels written by hand in CUDA C++
(``csrc/``). It imports nothing of JAX and nothing of
``paddlefleetx_tpu``; the JAX package is the reference the port's
tests hold it to.

Entry points run on ``cuda`` unless the caller passes
``device="cpu"`` (``utils/device.py``).
"""

__version__ = "0.1.0"
