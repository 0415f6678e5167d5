#!/usr/bin/env python3
"""MUFU (special-function unit) instructions per value and round of each
variant of K6, the elementwise-rate probe, read from the SASS of its built
library (needs nvcc and cuobjdump, not a card).

    python scripts/vpu_probe_sass_torch.py [--dump PATH]

Builds ``trajsde_tpu_torch/csrc/vpu_probe.cu`` (``ops/build.py``), runs
``cuobjdump -sass`` on the library and, for each of its three kernels
(``chained_tanh_f32<false>``: tanhf; ``chained_tanh_f32<true>``:
tanh.approx.f32; ``chained_tanh_bf16``: tanh.approx.bf16x2), finds the
loop over the 64 rounds: the one backward branch, and the step of the
counter that its predicate compares (the rounds one pass of the loop
body takes).  The body's MUFU instructions over (rounds a pass x values
a thread holds: 4 f32 or 8 bf16) are the count per value and round; a
kernel without a loop takes all 64 rounds in line.  It prints each
kernel's loop, its MUFU opcodes and the count, and one JSON line
``{variant: count}``; ``--dump`` writes the whole SASS to PATH.  Exits
non-zero if a kernel's loop cannot be read, or if its MUFU instructions
lie on a branch inside the loop (then the count would depend on the
data).  ``chip_smoke.K6_MUFU`` holds these counts, and phase H checks
them with :func:`mufu_per_value`.
"""
from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from trajsde_tpu_torch.ops import build  # noqa: E402

ROUNDS = 64
# kernel (mangled name's fragment) -> (variant, values one thread holds)
KERNELS = {"chained_tanh_f32ILb0E": ("float32", 4),
           "chained_tanh_f32ILb1E": ("float32-approx", 4),
           "chained_tanh_bf16": ("bfloat16", 8)}
INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
LABEL = re.compile(r"^\s*(\.L_x_\d+):")


def _cuobjdump() -> str:
    path = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(path).exists():
        raise SystemExit("cuobjdump not found (looked on PATH and /usr/local/cuda/bin)")
    return path


def functions(sass: str) -> dict:
    """Mangled kernel name -> its lines of SASS."""
    out, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = []
        elif name is not None:
            out[name].append(line)
    return out


def parse(lines: list) -> tuple:
    """(instructions [(address, text)], labels {label: address})."""
    insns, labels, pending = [], {}, []
    for line in lines:
        m = LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = INSN.search(line)
        if m:
            addr = int(m.group(1), 16)
            for label in pending:
                labels[label] = addr
            pending = []
            insns.append((addr, m.group(2)))
    return insns, labels


def _target(text: str, labels: dict):
    m = re.search(r"`\((\.L_x_\d+)\)", text)
    if m:
        return labels[m.group(1)]
    m = re.search(r"BRA\s+(?:\S+\s+)?(0x[0-9a-f]+)", text)
    return int(m.group(1), 16) if m else None


def count(lines: list, values: int) -> dict:
    """The loop of one kernel and its MUFU instructions per value and round."""
    insns, labels = parse(lines)
    branches = [(a, t, _target(t, labels)) for a, t in insns if re.search(r"\bBRA\b", t)]
    # a branch to itself is the trap after EXIT, not a loop
    back = [(a, t, dst) for a, t, dst in branches if dst is not None and dst < a]
    mufu_all = [t for _, t in insns if "MUFU" in t]
    if not back:  # every round in line
        return dict(loop=None, rounds_a_pass=ROUNDS, mufu=mufu_all,
                    per_value=len(mufu_all) / (ROUNDS * values))
    if len(back) != 1:
        raise SystemExit(f"{len(back)} backward branches: the round loop is not one loop")
    end, text, start = back[0]
    body = [(a, t) for a, t in insns if start <= a <= end]
    inner = [t for a, t, _ in branches if start <= a < end]
    if inner:
        raise SystemExit(f"branches inside the loop ({inner}): the MUFU count depends on the data")
    pred = re.match(r"@(!?)(U?P\d)\s+BRA", text)
    if not pred:
        raise SystemExit(f"the loop's branch {text!r} has no predicate")
    preg = pred.group(2)
    setp = [t for _, t in body if re.search(rf"ISETP\S*\s+{preg},", t)]
    if len(setp) != 1:
        raise SystemExit(f"{len(setp)} ISETPs set {preg} in the loop")
    counter = re.search(rf"ISETP\S*\s+{preg},\s*\S+,\s*(R\d+),", setp[0]).group(1)
    steps = [t for _, t in body
             if re.match(rf"IADD3\s+{counter},\s*{counter},\s*(-?0x[0-9a-f]+)", t)]
    if len(steps) != 1:
        raise SystemExit(f"the loop counter {counter} is not stepped once by an immediate: "
                         f"{steps}")
    step = abs(int(re.match(rf"IADD3\s+{counter},\s*{counter},\s*(-?0x[0-9a-f]+)",
                            steps[0]).group(1), 16))
    mufu = [t for _, t in body if "MUFU" in t]
    if len(mufu) != len(mufu_all):
        raise SystemExit("MUFU instructions outside the round loop")
    return dict(loop=[hex(start), hex(end), setp[0], steps[0]], rounds_a_pass=step, mufu=mufu,
                per_value=len(mufu) / (step * values))


def mufu_per_value(dump: str | None = None) -> dict:
    """variant -> MUFU instructions per value and round in the built
    library, with the loop read from its SASS (see the module's docstring)."""
    lib = build.build_all(["vpu_probe"])["vpu_probe"]
    sass = subprocess.run([_cuobjdump(), "-sass", lib], capture_output=True, text=True,
                          check=True, timeout=120).stdout
    if dump:
        Path(dump).parent.mkdir(parents=True, exist_ok=True)
        Path(dump).write_text(sass)
    out = {}
    for name, lines in functions(sass).items():
        for key, (variant, values) in KERNELS.items():
            if key in name:
                c = count(lines, values)
                ops = sorted(set(re.search(r"(MUFU\.\S+)", t).group(1) for t in c["mufu"]))
                print(f"[sass] {variant} ({name}): loop {c['loop']}, {c['rounds_a_pass']} rounds a "
                      f"pass x {values} values, {len(c['mufu'])} MUFU ({', '.join(ops)}): "
                      f"{c['per_value']:g} per value and round", flush=True)
                out[variant] = c["per_value"]
    missing = {v for v, _ in KERNELS.values()} - set(out)
    if missing:
        raise SystemExit(f"no kernel of {sorted(missing)} in the SASS")
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dump", help="write the library's whole SASS here")
    args = ap.parse_args()
    print(json.dumps(mufu_per_value(args.dump)))


if __name__ == "__main__":
    main()
