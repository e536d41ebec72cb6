"""Hand-written CUDA kernels for Hopper (sm_90a), each beside its plain
PyTorch version. A wrapper given CPU tensors runs the plain version; given
CUDA tensors it launches the kernel or raises."""
