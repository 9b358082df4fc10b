"""K6's inner loop in SASS, and the issue floors it implies, on one NVIDIA GPU.

Run from the root of a checkout, on a machine with one CUDA card and nvcc:

    python3 chip_k6.py [--parent-source PATH] [--out DIR]

Compiles ``moptimizer_0_tpu_torch/csrc/nn_expand.cu`` (and the file at
``--parent-source``, another tree's K6, when given) to a cubin for sm_90a,
disassembles it with ``cuobjdump -sass`` and finds the search kernel's hot
loop: the backward branch whose body holds the most pair minima (FMNMX) or,
in a kernel without them, pair compares (FSETP). Prints the loop's
instructions, its pairs and instructions a pair, and its opcodes, and the
issue floors at the fleet shape (64 × 29,310²) that follow: its pairs times
instructions a pair (or times the 7 float operations a pair that
bit-equality forces), one warp instruction for 32 pairs, at 4 issues a clock
on each of the card's SMs at the card's maximum SM clock. The full listings
go to DIR (default ``build/k6``).
"""

import argparse
import collections
import re
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke as cs
from moptimizer_0_tpu_torch.kernels import build

SOURCE = build.CSRC_DIR / "nn_expand.cu"


def _run(cmd):
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(map(str, cmd))} failed:\n{proc.stdout}{proc.stderr}")
    return proc.stdout


def _tool(name):
    return str(Path(build._nvcc()).with_name(name))


def sass_loop(source, out_dir, tag):
    """(instructions, pairs, opcode counts) of the search kernel's hot loop."""
    cubin = out_dir / f"{tag}.cubin"
    _run([build._nvcc(), "-cubin", "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
          "-std=c++17", "-o", str(cubin), str(source)])
    sass = _run([_tool("cuobjdump"), "-sass", str(cubin)])
    (out_dir / f"{tag}.sass").write_text(sass)
    # the search kernel's listing: from its Function header to the next one
    funcs = re.split(r"\n\s*Function : ", sass)
    body = next(f for f in funcs if "nn_expand_kernel" in f.splitlines()[0])
    labels, instrs, at = {}, [], {}
    for line in body.splitlines():
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if m:
            labels[m.group(1)] = len(instrs)
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if m:
            at[int(m.group(1), 16)] = len(instrs)
            instrs.append(m.group(2).strip())
    # the densest loop in pairs a instruction: the unrolled body of the
    # search, not the loops around it or its ragged remainder
    best = None
    for pos, ins in enumerate(instrs):
        m = re.search(r"\bBRA\b.*?(\.L_x_\d+|0x[0-9a-f]+)", ins)
        if not m:
            continue
        target = m.group(1)
        start = labels.get(target) if target.startswith(".L") else at.get(int(target, 16))
        if start is None or start > pos:
            continue  # not a backward branch
        loop = instrs[start : pos + 1]
        ops = collections.Counter(re.sub(r"^@!?U?P\w+\s+", "", i).split()[0].split(".")[0] for i in loop)
        pairs = ops["FMNMX"] or ops["FSETP"]
        if pairs and (best is None or (pairs / len(loop), pairs) > (best[1] / best[0], best[1])):
            best = (len(loop), pairs, ops)
    if best is None:
        raise RuntimeError(f"{tag}: no loop with pair minima or compares in the search kernel")
    return best


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent-source", help="another tree's csrc/nn_expand.cu, for its SASS")
    parser.add_argument("--out", default="build/k6", help="directory for the listings")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_k6: no CUDA device; this runs on a GPU only")
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0])
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, cuda {torch.version.cuda}")

    max_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    fleet_pairs = cs.FLEET_B * cs.load_txt_cloud(cs.FACHADA).shape[0] ** 2

    def floor_ms(per_pair):
        return fleet_pairs * per_pair / 32 / (sms * 4 * max_mhz * 1e6) * 1e3

    print(f"issue floor at the fleet shape ({fleet_pairs} pairs, {sms} SMs, {max_mhz:.0f} MHz): "
          f"7 float operations a pair {floor_ms(7):.3f} ms")
    sources = [("this tree", SOURCE)] + ([("parent", Path(args.parent_source))] if args.parent_source else [])
    for tag, src in sources:
        n, pairs, ops = sass_loop(src, out_dir, tag.replace(" ", "_"))
        print(f"K6 SASS, {tag} ({src}): hot loop {n} instructions, {pairs} pairs, "
              f"{n / pairs:.3f} instructions a pair, issue floor {floor_ms(n / pairs):.3f} ms; "
              f"opcodes {dict(ops.most_common())}")


if __name__ == "__main__":
    main()
