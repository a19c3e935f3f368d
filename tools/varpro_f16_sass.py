"""Count the instructions of the float16 kernel_varpro instances in their SASS.

    python3 tools/varpro_f16_sass.py [--show NAME_FRAGMENT]

Builds the package's kernels (``_build.load()``, nvcc for sm_90a), runs
``cuobjdump -sass <library>`` on the shared library and, for every
float16 instance (``varpro_lm_p1_f16_kernel<G, S, Basis>``), prints its
instruction count and the count of each opcode of interest (HADD2, HMUL2,
HFMA2, FADD, FMUL, FFMA, MUFU, F2FP, ...).

ptxas issues many of the packed half adds and multiplies as HFMA2 (most
as ``HFMA2.MMA``): a sum as ``a * 1 + b`` (``Rd, Ra, 1, 1, Rb``), a
product as ``a * b + (-0)`` (``Rd, Ra, Rb, -RZ``), and a constant as
``0 * 0 + imm`` (``Rd, -RZ, RZ, imm``). Each of these rounds once and is
the add, multiply or move it stands for. An HFMA2 with a real addend and
a multiplier other than 1 would be a multiply and an add contracted into
one rounding: the script prints each such line and exits non-zero if
any float16 instance holds one. ``--show`` prints the whole SASS of the
instances whose name contains the fragment.
"""

import argparse
import collections
import os
import re
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from leastsquaresoptim_jl_torch import _build  # noqa: E402

OPCODES = ("HADD2", "HMUL2", "HFMA2", "HSETP2", "HSET2", "HMNMX2", "FADD", "FMUL", "FFMA",
           "MUFU", "F2FP", "HADD2.F32", "LOP3", "SHFL", "PRMT", "FSETP", "FCHK", "CALL",
           "BRA", "LDG", "STG")
ZERO = re.compile(r"^-?RZ(\.\w+)?$")
ONE = re.compile(r"^-?1$")


def hfma2_kind(ins):
    """'sum', 'product', 'move' or 'contracted' for one HFMA2 line."""
    ops = [o.strip() for o in ins.split(None, 1)[1].split(",")]
    src = ops[1:]
    if len(src) == 4:  # a, imm, imm, c: the multiplier is an immediate pair
        a, m, c = src[0], src[1:3], src[3]
    elif len(src) == 3:
        a, m, c = src[0], [src[1]], src[2]
    else:
        return "contracted"
    if ZERO.match(a):
        return "move"
    if ZERO.match(c):
        return "product"
    if all(ONE.match(v) for v in m):
        return "sum"
    return "contracted"


def functions(sass):
    """{function name: [instruction lines]} of a cuobjdump -sass listing."""
    out, name = {}, None
    for line in sass.splitlines():
        hit = re.search(r"Function : (\S+)", line)
        if hit:
            name = hit.group(1)
            out[name] = []
            continue
        hit = re.search(r"/\*[0-9a-f]{4,}\*/\s+(.*?);", line)
        if hit and name:
            out[name].append(hit.group(1).strip())
    return out


def opcode(ins):
    ins = re.sub(r"^@!?U?P\w+\s+", "", ins)  # predicate
    return ins.split()[0] if ins else ""


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--show", default=None)
    args = ap.parse_args()
    _build.load()
    lib = Path(_build._lib._name)
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    cmd = [str(cuobjdump), "-sass", str(lib)]
    print(" ".join(cmd))
    sass = subprocess.run(cmd, capture_output=True, text=True, check=True).stdout
    fns = {k: v for k, v in functions(sass).items() if "varpro_lm_p1_f16_kernel" in k}
    if not fns:
        raise SystemExit("no float16 kernel_varpro instance in the SASS")
    contracted = 0
    for name in sorted(fns):
        ins = fns[name]
        counts = collections.Counter()
        for i in ins:
            op = opcode(i)
            base = op.split(".")[0]
            counts[base] += 1
            if op.startswith("HADD2.F32"):
                counts["HADD2.F32"] += 1
        kinds = collections.Counter()
        data = []
        for i in ins:
            if opcode(i).startswith("HFMA2"):
                kind = hfma2_kind(re.sub(r"^@!?U?P\w+\s+", "", i))
                kinds[kind] += 1
                if kind == "contracted":
                    data.append(i)
        contracted += len(data)
        line = ", ".join(f"{k} {counts[k]}" for k in OPCODES if counts[k])
        print(f"{name}: {len(ins)} instructions; {line}; HFMA2 as sums {kinds['sum']}, "
              f"products {kinds['product']}, moves {kinds['move']}, contracted "
              f"{kinds['contracted']}")
        for i in data:
            print(f"    {i}")
        if args.show and args.show in name:
            print("\n".join(f"    {i}" for i in ins))
    print(f"{len(fns)} float16 instances; contracted HFMA2 in all: {contracted}")
    if contracted:
        raise SystemExit("a float16 instance contracts a multiply and an add (HFMA2)")


if __name__ == "__main__":
    main()
