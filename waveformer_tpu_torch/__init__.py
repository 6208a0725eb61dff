"""PyTorch/CUDA port of waveformer_tpu for NVIDIA Hopper (sm_90a).

The package imports torch and never jax or waveformer_tpu: it keeps its
own copy of every host-side helper it needs. Where the JAX package wrote a
Pallas kernel for the TPU, this package has a CUDA kernel written by hand
(`csrc/`), built with nvcc at first use and bound with ctypes
(`ops/_build.py`). On CPU tensors each kernel wrapper runs its plain
PyTorch version, which is what the parity tests compare against JAX.

Entry points (`create_waveformer`, `Predictor`) run on the CUDA device
unless the caller passes ``device="cpu"``; without a CUDA device and
without that request they raise.
"""

from waveformer_tpu_torch.config import Config, NetworkConfig, TransformerConfig

__all__ = ["Config", "NetworkConfig", "TransformerConfig"]
