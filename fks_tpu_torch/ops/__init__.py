"""GPU sub-allocation and the CUDA kernel loader."""
