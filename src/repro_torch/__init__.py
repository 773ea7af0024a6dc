"""PyTorch/CUDA port of the paper pipeline (El Alaoui & Mahoney 2014).

A second package beside the JAX reference ``repro``: the same
``SketchedKRR(SketchConfig(kernel, p)).fit(X, y).predict(X_test)`` path,
running on an NVIDIA H100 through two hand-written CUDA kernels
(``repro_torch.kernels``: K1 ``kernel_block`` and K2 ``rls_scores``), or on
the CPU through their plain PyTorch versions when ``device="cpu"``. It
imports ``torch`` and numpy, never JAX or the reference package.
"""
