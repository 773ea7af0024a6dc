"""Hand-written Hopper kernels and their plain PyTorch versions.

K1 ``rbf_block.kernel_block`` (``csrc/kernel_block.cu``), K2
``rls_scores.rls_scores_fused`` (``csrc/rls_scores.cu``), K3
``sparse_block.sparse_cross`` (``csrc/sparse_cross.cu``) and K4
``flash_attention.flash_attention`` (``csrc/flash_attention.cu``) are CUDA
C++ for ``sm_90a``, compiled by ``_build`` at first launch and called
through ctypes. ``ops`` dispatches: CPU tensors take the plain versions in
``ref``, CUDA tensors the kernels.
"""
