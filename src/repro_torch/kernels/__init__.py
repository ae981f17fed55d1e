"""Hand-written CUDA kernels of the port (sources in ``csrc/``).

    flash_attention   replaces repro/kernels/flash_attention (``_fa_kernel``)
    fused_serving     replaces repro/kernels/fused_serving (``_wa_kernel``)
    ssd               replaces repro/kernels/ssd (``_ssd_kernel``)
    build             nvcc build at first use + ctypes loading
"""
