"""Hand-written CUDA kernels of the port (sources in ``csrc/``).

    flash_attention   replaces repro/kernels/flash_attention (``_fa_kernel``)
    fused_serving     replaces repro/kernels/fused_serving (``_wa_kernel``)
    ssd               replaces repro/kernels/ssd (``_ssd_kernel``)
    embedding         the token gather's gradient on the card (no TPU
                      kernel: added for PyTorch's serial index backward)
    build             nvcc build at first use + ctypes loading, and the
                      wrappers' launch helpers
"""
