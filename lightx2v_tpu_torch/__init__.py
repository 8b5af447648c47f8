"""PyTorch/CUDA port of lightx2v_tpu for NVIDIA Hopper (H100).

The JAX package ``lightx2v_tpu`` is the reference; this package mirrors its
layout (``ops/``, ``models/wan/``, ``schedulers/``, ``encoders/``, ``vae/``,
``runners/``, ``utils/``, ``infer.py``) and replaces every Pallas kernel on
its path with a hand-written CUDA kernel (``csrc/``, built on first use by
``ops/cuda/_build.py``). It imports nothing from ``lightx2v_tpu``.
"""
