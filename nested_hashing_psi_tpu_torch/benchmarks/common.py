"""What the three probes share: the SASS instruction counts of their
kernels (``cuobjdump -sass`` of the built kernel library)."""

from __future__ import annotations

import os
import re
import subprocess

from nested_hashing_psi_tpu_torch.ops import cuda_lib

# SASS opcodes (the part before the first dot) by the unit that runs them;
# the ALU pipe and the other arithmetic units take the rest. Hopper's VIADD
# issues on the FMA pipe: A1's where_ge (one VIADD and one ISETP per
# application) runs at 30.7 T instructions/s, two pipes' rate (H100 80GB
# HBM3, 700 W; bench_vpu_ops.py).
FMA_PIPE = ("IMAD", "IMUL", "VIADD", "FFMA", "FMUL", "FADD", "HFMA2")
MEMORY = ("LDG", "STG", "LDS", "STS", "LDC", "ULDC", "LD", "ST", "LDGSTS")
CONTROL = ("BRA", "EXIT", "NOP", "BAR", "BSSY", "BSYNC", "RET", "CALL")

_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")
_sass_cache: dict = {}


def sass_functions() -> dict[str, list[tuple[int, str, str]]]:
    """Kernel name -> [(address, opcode, operands)] of the built library,
    from ``cuobjdump -sass`` (cached per build)."""
    lib = cuda_lib.LIB_PATH
    key = (lib, os.path.getmtime(lib))
    if key not in _sass_cache:
        tool = os.path.join(os.path.dirname(cuda_lib.find_nvcc()), "cuobjdump")
        out = subprocess.run([tool, "-sass", lib], capture_output=True, text=True,
                             timeout=300, check=True).stdout
        funcs = {}
        for part in out.split("Function : ")[1:]:
            name, body = part.split("\n", 1)
            funcs[name.strip()] = [(int(a, 16), op, rest)
                                   for a, _, op, rest in _INSTR.findall(body)]
        _sass_cache.clear()
        _sass_cache[key] = funcs
    return _sass_cache[key]


def find_function(fragment: str) -> list[tuple[int, str, str]]:
    """The one kernel whose mangled name contains ``fragment``."""
    hits = [k for k in sass_functions() if fragment in k]
    if len(hits) != 1:
        raise RuntimeError(f"{len(hits)} kernels match {fragment!r} in the SASS")
    return sass_functions()[hits[0]]


def loop_body(instrs: list[tuple[int, str, str]]) -> list[tuple[int, str, str]]:
    """The instructions of the largest loop (a backward branch to an
    earlier address, the branch itself excluded)."""
    best = []
    for addr, op, rest in instrs:
        if op.split(".")[0] != "BRA":
            continue
        m = re.search(r"0x([0-9a-f]+)", rest)
        if not m or int(m.group(1), 16) >= addr:
            continue  # forward, or the self-loop after EXIT
        target = int(m.group(1), 16)
        body = [i for i in instrs if target <= i[0] < addr]
        if len(body) > len(best):
            best = body
    if not best:
        raise RuntimeError("no loop found in the kernel's SASS")
    return best


def fma_pipe_slots(op: str) -> float:
    """Issue slots of one FMA-pipe instruction on the 64-lane integer FMA
    pipe: a wide or high 32x32 product (IMAD.WIDE, IMAD.HI) takes two, an
    FP32 instruction half (the SM's 128 FP32 lanes per clock), the rest one."""
    base = op.split(".")[0]
    if base in ("IMAD", "IMUL") and (".WIDE" in op or ".HI" in op):
        return 2.0
    return 0.5 if base in ("FFMA", "FMUL", "FADD", "HFMA2") else 1.0


def by_pipe(instrs, units: float) -> dict[str, float]:
    """Instruction counts per unit of work (an application, a butterfly, an
    element): FMA pipe, ALU and other arithmetic, memory, control, and the
    arithmetic total (FMA + ALU), the FMA pipe's issue slots
    (``fma_pipe_slots``), plus the opcode histogram."""
    ops = [op.split(".")[0] for _, op, _ in instrs]
    fma = sum(o in FMA_PIPE for o in ops)
    slots = sum(fma_pipe_slots(op) for _, op, _ in instrs if op.split(".")[0] in FMA_PIPE)
    mem = sum(o in MEMORY for o in ops)
    ctl = sum(o in CONTROL for o in ops)
    alu = len(ops) - fma - mem - ctl
    hist: dict[str, int] = {}
    for o in ops:
        hist[o] = hist.get(o, 0) + 1
    return {"fma": fma / units, "alu": alu / units, "memory": mem / units,
            "control": ctl / units, "arith": (fma + alu) / units, "fma_slots": slots / units,
            "opcodes": {k: v / units for k, v in sorted(hist.items())}}


def ptxas_instances(report: str) -> dict[str, dict[str, int]]:
    """Kernel name -> {registers, spill_stores, spill_loads} (bytes) from
    the ``-Xptxas -v`` report of a build (``cuda_lib.build(verbose=True)``,
    ``cuda_lib.ptxas_report``)."""
    out, name = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            out[name] = {"registers": 0, "spill_stores": 0, "spill_loads": 0}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[name]["spill_stores"], out[name]["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
    return out


def instance(instances: dict[str, dict[str, int]], fragment: str) -> dict[str, int]:
    """The one entry of ``ptxas_instances`` whose name contains ``fragment``."""
    hits = [k for k in instances if fragment in k]
    if len(hits) != 1:
        raise RuntimeError(f"{len(hits)} kernels match {fragment!r} in the ptxas report")
    return instances[hits[0]]
