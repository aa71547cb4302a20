"""Two checkouts' kernel checks in turns (A, B, B, A) on one GPU.

    python3 mars5_tts_torch/tools/kernel_ab.py ROOT_A ROOT_B [--checks k6,k2,k8,k9,k3,k3g,k1q]

Each turn is a process of its own that imports that checkout's
``chip_smoke.py`` and runs the checks named by ``--checks`` (default
``k6,k2``): ``k6`` its ``check_heads_tail`` (K6 and K5 at the bench shape,
t = 0 and 100), ``k2`` its ``check_decode_layer`` (K2, W8 and W4 at the
released AR widths, one row at pos 600 and 1900, then four rows), ``k8`` its
``check_head4`` (K8 on the released AR's head, one row and four), ``k9``
its ``check_mega`` (K9 on a released-width int8 NAR decoder), ``k3`` its
``check_nar_fused`` (K3 qkv, caq and residual, K4, one group) and ``k3g``
its ``check_nar_fused_grouped`` (the same at gsize 128, with the grouped
plan; then each launch's device time and the tile widths' A/B where the
checkout has ``w8a8_launch_split`` and ``grouped_tile_ab``) and ``k1q`` its
``check_k1_modes`` (K1's int8 mode at its four shapes and the bf16
cross-attention), then each int8 call's kernels by device time
(``launch_split`` over the kernels named ``mha_*``, on the calls that
check timed, so a checkout whose smoke keeps no per-launch split of K1 is
split the same way). The checks
build that checkout's kernels and print their times beside the twins'.
Use it to compare two versions of a kernel within one call, where the card
and its host are the same for both.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

CHECKS = """
import os, re, sys
root = os.path.abspath(sys.argv[1])
checks = sys.argv[2].split(",")
os.chdir(root)
sys.path.insert(0, root)
import torch
import chip_smoke as S
from mars5_tts_torch.models.ar import CodecLM, CodecLMConfig
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda", 0)
gen = torch.Generator(device=dev).manual_seed(1)
if "k6" in checks:
    S.check_heads_tail(gen, dev)
if "k2" in checks or "k8" in checks:
    g = torch.Generator(device=dev).manual_seed(0)
    with torch.device(dev):
        ar = CodecLM(CodecLMConfig.mars5(24_000)).init_(g).to(torch.bfloat16)
    if "k2" in checks:
        S.check_decode_layer(ar, gen, dev)
    if "k8" in checks:
        S.check_head4(ar, gen, dev)
if "k3" in checks or "k3g" in checks:
    one = S.check_nar_fused(gen, dev) if "k3" in checks else {}
    grouped = S.check_nar_fused_grouped(dev) if "k3g" in checks else {}
    if hasattr(S, "w8a8_launch_split"):
        S.w8a8_launch_split(one, grouped)
    if hasattr(S, "grouped_tile_ab") and grouped:
        S.grouped_tile_ab(grouped)
if "k1q" in checks:
    names = list(S.check_k1_modes(dev))
    # then each case's kernels by device time, in a second, silent pass
    # (the profiler slows a process's later launches): each call the check
    # times on the device is profiled there, while its inputs are that case's
    import contextlib, io
    splits, timed, w8a8 = [], S.device_ms, S.W8A8_KERNELS
    S.W8A8_KERNELS = ("mha_",)
    S.device_ms = lambda fn, *a, **kw: splits.append(S.launch_split(fn))
    with contextlib.redirect_stdout(io.StringIO()):
        S.check_k1_modes(dev)
    S.device_ms, S.W8A8_KERNELS = timed, w8a8
    for name, split in zip(names, splits):
        if name.startswith("int8"):
            print(f"K1 {name} per launch, device us: " + ("not measured" if split is None else
                  ", ".join(f"{re.search(r'mha_\\w+', k).group(0)} {us:.1f}" for k, us in split)
                  + f" (sum {sum(us for _, us in split):.1f})"), flush=True)
if "k9" in checks:
    from mars5_tts_torch.models.nar import ResidualTransformer, ResidualTransformerConfig
    from mars5_tts_torch.ops.quant import quantize_nar
    g = torch.Generator(device=dev).manual_seed(0)
    with torch.device(dev):
        nar = ResidualTransformer(ResidualTransformerConfig.mars5(4_096)).init_(g)
    S.check_mega(quantize_nar(nar.to(torch.bfloat16)).tfm.decoder, dev)
"""
PREFIXES = ("K1 ", "K2 W", "K3", "K4 ", "K5 ", "K6 ", "K8 ", "K9 ", "torch._int_mm")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("root_a")
    ap.add_argument("root_b")
    ap.add_argument("--checks", default="k6,k2")
    args = ap.parse_args()
    if not set(args.checks.split(",")) <= {"k6", "k2", "k8", "k9", "k3", "k3g", "k1q"}:
        ap.error(f"unknown checks {args.checks}")
    roots = {"A": args.root_a, "B": args.root_b}
    rc = 0
    for tag in "ABBA":
        print(f"=== {tag}: {os.path.abspath(roots[tag])}", flush=True)
        proc = subprocess.run([sys.executable, "-c", CHECKS, roots[tag], args.checks],
                              capture_output=True, text=True)
        for line in proc.stdout.splitlines():
            if line.startswith(PREFIXES):
                print(line, flush=True)
        if proc.returncode != 0:
            print(proc.stderr[-3000:], flush=True)
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
