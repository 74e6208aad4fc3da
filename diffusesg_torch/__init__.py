"""diffusesg_torch: the PyTorch/CUDA port of diffusesg_tpu for NVIDIA Hopper.

Scene-graph EDM sampling and decode with the Swin U-Net denoiser.  The
Swin block, patch merge/breakup and readout heads run as hand-written CUDA
kernels (``csrc/``, built with nvcc for sm_90a at first use) on CUDA
tensors, and as their plain PyTorch versions on CPU tensors.  Entry points
(``models.build_model``, ``serving.generate``, ``serving.load_artifact``, the
CLIs under ``cli/``) run on ``cuda`` unless the caller passes
``device="cpu"`` (``--device cpu``).
"""
__version__ = "0.1.0"
