"""TrackieLLM's PyTorch + CUDA port, for one NVIDIA H100.

The JAX package ``trackiellm_tpu`` is the reference; this package mirrors
its layout (``ops/quant.py``, ``ops/attention.py``, ``models/llm.py``,
``llm/runner.py``, ...) so each counterpart is found by path. Its kernels
are hand-written CUDA C++ for ``sm_90a`` under ``csrc/``, built with nvcc
at first use (``ops/_build.py``). It imports ``torch`` and never ``jax``.
"""

__version__ = "0.1.0"
