"""armada_tpu_torch: the scheduling round of armada-tpu in PyTorch, with its
device programs as CUDA kernels for Hopper (sm_90a), and the multi-pool
scheduling cycle around it (`scheduler`, over the job store in `jobdb`).

Entry points run on the card (device="cuda") unless the caller passes
device="cpu", which runs the plain PyTorch versions of the kernels.
"""
