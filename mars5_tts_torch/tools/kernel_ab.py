"""Two checkouts' K6 / K5 and K2 kernel checks in turns (A, B, B, A) on one GPU.

    python3 mars5_tts_torch/tools/kernel_ab.py ROOT_A ROOT_B

Each turn is a process of its own that imports that checkout's
``chip_smoke.py`` and runs its ``check_heads_tail`` (K6 and K5 at the bench
shape, t = 0 and 100) and ``check_decode_layer`` (K2, W8 and W4 at the
released AR widths, one row at pos 600 and 1900, then four rows), which
build that checkout's kernels and print their times beside the twins'. Use
it to compare two versions of a kernel within one call, where the card and
its host are the same for both.
"""

from __future__ import annotations

import os
import subprocess
import sys

CHECKS = """
import os, sys
root = os.path.abspath(sys.argv[1])
os.chdir(root)
sys.path.insert(0, root)
import torch
import chip_smoke as S
from mars5_tts_torch.models.ar import CodecLM, CodecLMConfig
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda", 0)
gen = torch.Generator(device=dev).manual_seed(1)
S.check_heads_tail(gen, dev)
g = torch.Generator(device=dev).manual_seed(0)
with torch.device(dev):
    ar = CodecLM(CodecLMConfig.mars5(24_000)).init_(g).to(torch.bfloat16)
S.check_decode_layer(ar, gen, dev)
"""


def main() -> int:
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    roots = {"A": sys.argv[1], "B": sys.argv[2]}
    rc = 0
    for tag in "ABBA":
        print(f"=== {tag}: {os.path.abspath(roots[tag])}", flush=True)
        proc = subprocess.run([sys.executable, "-c", CHECKS, roots[tag]], capture_output=True,
                              text=True)
        for line in proc.stdout.splitlines():
            if line.startswith(("K2 W", "K5 ", "K6 ")):
                print(line, flush=True)
        if proc.returncode != 0:
            print(proc.stderr[-3000:], flush=True)
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
