"""Print ptxas's registers, shared memory and spills for every
instantiation of the round's placement loop: the narrow ones
(armada_tpu_torch/csrc/round.cu) and the cluster ones (round_cluster.cu),
at several block sizes of the multi-commit instantiation.

    python3 tools/round_ptxas.py [EXT_BLOCK ...]

Needs nvcc (a machine with the CUDA toolkit); compiles the two sources
side by side, with the package's build flags plus -DEXT_BLOCK=<n>, into a
temporary directory.
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

SOURCES = ("round.cu", "round_cluster.cu")


def report(ext_block: int) -> list[str]:
    with tempfile.TemporaryDirectory() as tmp:
        procs = [(src, subprocess.Popen(
            [_nvcc(), *FLAGS, f"-DEXT_BLOCK={ext_block}", "-c", str(SRC_DIR / src),
             "-o", os.path.join(tmp, src + ".o")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)) for src in SOURCES]
        rows = set()
        for src, proc in procs:
            out, err = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(err)
            lines = (out + err).splitlines()
            for i, line in enumerate(lines):
                if "Function properties for" in line and "place_loop_kernel" in line:
                    name = line.split("for ")[-1]
                    rows.add(f"{src} {name}: {lines[i + 1].strip()}; "
                             f"{lines[i + 2].split(':', 1)[-1].strip()}")
    return sorted(rows)


def main(argv: list[str]) -> int:
    for block in [int(a) for a in argv] or [640]:
        print(f"EXT_BLOCK={block}")
        for row in report(block):
            print("  " + row)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
