"""mpibwa_tpu_torch: the PyTorch and CUDA port of mpibwa_tpu.

It runs ``cli mem`` (SE and PE) with the device work as torch tensors on
one NVIDIA GPU. The three TPU kernels of mpibwa_tpu are hand-written CUDA
kernels here: the banded extension DP (csrc/extend.cu), the fused occ4 +
bwt_extend (csrc/occ4_extend.cu, MPIBWA_PALLAS=1) and the backward SMEM
pass, one launch a pass (csrc/bwd_pass.cu, the default backward engine on
a CUDA int32 index). The package stands on
its own: it imports torch, never jax and nothing of mpibwa_tpu. The host
modules (core/, index/, io/, native/, pipeline/native_final.py,
parallel/) are its own copies under the names of their mpibwa_tpu
counterparts, and the modules that touch the device keep those names too.
"""

__version__ = "0.1.0"
