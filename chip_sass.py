"""The NN kernels' hot loops in SASS, and the issue floors they imply, on one NVIDIA GPU.

Run from the root of a checkout, on a machine with one CUDA card and nvcc:

    python3 chip_sass.py [--kernel k5|k6|both] [--parent-tree DIR] [--out DIR]

For each kernel asked for (both by default): K5, the search kernel of
``moptimizer_0_tpu_torch/csrc/nn_search.cu``, at one fachada scan
(29,310²); K6, that of ``csrc/nn_expand.cu``, at the fleet shape
(64 × 29,310²). Compiles the source of this tree (and of the checkout at
``--parent-tree``, when given) to a cubin for sm_90a, disassembles it with
``cuobjdump -sass`` and finds the search kernel's hot loop: the backward
branch whose body holds the most pair minima (FMNMX) or, in a kernel without
them, pair compares (FSETP). Prints the loop's instructions, its pairs and
instructions a pair, and its opcodes, and the issue floors that follow: the
pairs times the loop's instructions a pair (or times the float operations a
pair that bit-equality forces: 8 for K5, 7 for K6), one warp instruction for
32 pairs, at 4 issues a clock on each of the card's SMs at the card's
maximum SM clock. The full listings go to DIR (default ``build/sass``).
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

# name: (source under csrc/, search kernel, float operations a pair, lanes at its shape)
KERNELS = {
    "k5": ("nn_search.cu", "nn_bruteforce_kernel", 8, 1),
    "k6": ("nn_expand.cu", "nn_expand_kernel", 7, cs.FLEET_B),
}


def _run(cmd):
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(map(str, cmd))} failed:\n{proc.stdout}{proc.stderr}")
    return proc.stdout


def _tool(name):
    return str(Path(build._nvcc()).with_name(name))


def sass_loop(source, kernel, out_dir, tag):
    """(instructions, pairs, opcode counts) of the search kernel's hot loop."""
    cubin = out_dir / f"{tag}.cubin"
    _run([build._nvcc(), "-cubin", "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
          "-std=c++17", "-o", str(cubin), str(source)])
    sass = _run([_tool("cuobjdump"), "-sass", str(cubin)])
    (out_dir / f"{tag}.sass").write_text(sass)
    # the search kernel's listing: from its Function header to the next one
    funcs = re.split(r"\n\s*Function : ", sass)
    body = next(f for f in funcs if kernel in f.splitlines()[0])
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
        raise RuntimeError(f"{tag}: no loop with pair minima or compares in {kernel}")
    return best


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--kernel", choices=("k5", "k6", "both"), default="both")
    parser.add_argument("--parent-tree", help="another checkout's root, for its kernels' SASS")
    parser.add_argument("--out", default="build/sass", help="directory for the listings")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_sass: no CUDA device; this runs on a GPU only")
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
    n = cs.load_txt_cloud(cs.FACHADA).shape[0]
    trees = [("this tree", build.CSRC_DIR)]
    if args.parent_tree:
        trees.append(("parent", Path(args.parent_tree) / "moptimizer_0_tpu_torch" / "csrc"))

    for name in (("k5", "k6") if args.kernel == "both" else (args.kernel,)):
        source, kernel, flops, lanes = KERNELS[name]
        pairs = lanes * n * n

        def floor_ms(per_pair):
            return pairs * per_pair / 32 / (sms * 4 * max_mhz * 1e6) * 1e3

        print(f"{name.upper()} issue floor at {lanes} x {n}^2 ({pairs} pairs, {sms} SMs, {max_mhz:.0f} MHz): "
              f"{flops} float operations a pair {floor_ms(flops):.3f} ms")
        for tag, csrc in trees:
            src = csrc / source
            count, n_pairs, ops = sass_loop(src, kernel, out_dir, f"{name}_{tag.replace(' ', '_')}")
            print(f"{name.upper()} SASS, {tag} ({src}): hot loop {count} instructions, {n_pairs} pairs, "
                  f"{count / n_pairs:.3f} instructions a pair, issue floor {floor_ms(count / n_pairs):.3f} ms; "
                  f"opcodes {dict(ops.most_common())}")


if __name__ == "__main__":
    main()
