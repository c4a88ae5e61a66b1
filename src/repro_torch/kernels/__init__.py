"""Hand-written CUDA kernels of the port, with their plain PyTorch versions.

Each kernel module holds the plain version of its function beside the
wrapper that launches the CUDA kernel.  A wrapper runs the plain version
only for tensors that lie on the CPU; for a CUDA tensor it launches the
kernel (built from ``csrc/`` at first use) or raises.
"""
