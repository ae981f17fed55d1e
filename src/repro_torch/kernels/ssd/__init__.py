"""The Mamba2 SSD scan: CUDA kernel wrapper, plain version, oracle."""
