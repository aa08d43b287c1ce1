"""Device-side numeric ops: the log-mel frontend and the res8 stem, each as a
hand-written CUDA kernel with its plain PyTorch version beside it."""
