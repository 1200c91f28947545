"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version: ``bsp_spmv`` (dense-tile semiring SpMV) and ``segment_combine``
(windowed segment reduce). ``_build`` compiles ``repro_torch/csrc`` with
``nvcc`` on first use; ``ops`` holds the single-partition layouts."""
