"""The hand-written CUDA kernels of the port and their wrappers.

Each wrapper takes tensors on one device: on a CUDA device it launches its
kernel (built from ../csrc at first use, see build.py) or raises; on the CPU
it runs the kernel's plain PyTorch version.  There is no fallback from the
kernel to the plain version.

LAUNCHES counts kernel launches per kernel, incremented only where a wrapper
launches its kernel, so a run can show that its path went through them.
"""

LAUNCHES = {"fair_shares": 0, "round": 0, "compact": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
