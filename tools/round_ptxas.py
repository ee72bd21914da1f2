"""Print ptxas's registers, shared memory and spills for every
instantiation of the round's placement loop (armada_tpu_torch/csrc/round.cu)
at several block sizes of its multi-commit instantiation.

    python3 tools/round_ptxas.py [EXT_BLOCK ...]

Needs nvcc (a machine with the CUDA toolkit); compiles round.cu alone, with
the package's build flags plus -DEXT_BLOCK=<n>, into a temporary directory.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from armada_tpu_torch.kernels.build import FLAGS, SRC_DIR, _nvcc  # noqa: E402


def report(ext_block: int) -> list[str]:
    with tempfile.TemporaryDirectory() as tmp:
        out = subprocess.run(
            [_nvcc(), *FLAGS, f"-DEXT_BLOCK={ext_block}", "-c", str(SRC_DIR / "round.cu"),
             "-o", os.path.join(tmp, "round.o")],
            capture_output=True, text=True,
        )
    if out.returncode != 0:
        raise RuntimeError(out.stderr)
    lines = (out.stdout + out.stderr).splitlines()
    rows = set()
    for i, line in enumerate(lines):
        if "Function properties for" in line and "place_loop_kernel" in line:
            name = line.split("for ")[-1]
            rows.add(f"{name}: {lines[i + 1].strip()}; {lines[i + 2].split(':', 1)[-1].strip()}")
    return sorted(rows)


def main(argv: list[str]) -> int:
    for block in [int(a) for a in argv] or [768, 640]:
        print(f"EXT_BLOCK={block}")
        for row in report(block):
            print("  " + row)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
