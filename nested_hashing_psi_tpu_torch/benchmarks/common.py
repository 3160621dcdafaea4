"""What the three probes share: the device choice, timing, and the SASS
instruction counts of their kernels (``cuobjdump -sass`` of the built
kernel library)."""

from __future__ import annotations

import os
import re
import subprocess
import time

import torch

from nested_hashing_psi_tpu_torch.ops import cuda_lib

# SASS opcodes (the part before the first dot) by the unit that runs them;
# the ALU pipe and the other arithmetic units take the rest
FMA_PIPE = ("IMAD", "IMUL", "FFMA", "FMUL", "FADD", "HFMA2")
MEMORY = ("LDG", "STG", "LDS", "STS", "LDC", "ULDC", "LD", "ST", "LDGSTS")
CONTROL = ("BRA", "EXIT", "NOP", "BAR", "BSSY", "BSYNC", "RET", "CALL")

_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")
_sass_cache: dict = {}


def resolve_device(name: str) -> torch.device:
    """torch.device(name); ``cuda`` without a GPU raises (no fallback)."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs a GPU (torch.cuda.is_available() is false); "
                           "pass --device cpu for the plain version")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"no probe for device {dev}")
    return dev


def time_ms(fn, device: torch.device, iters: int) -> float:
    """Mean ms of fn(): CUDA events over iters launches after two warm-ups
    on a GPU, the host clock on the CPU."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


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


def by_pipe(instrs, units: float) -> dict[str, float]:
    """Instruction counts per unit of work (an application, a butterfly, an
    element): FMA pipe, ALU and other arithmetic, memory, control, and the
    arithmetic total (FMA + ALU), plus the opcode histogram."""
    ops = [op.split(".")[0] for _, op, _ in instrs]
    fma = sum(o in FMA_PIPE for o in ops)
    mem = sum(o in MEMORY for o in ops)
    ctl = sum(o in CONTROL for o in ops)
    alu = len(ops) - fma - mem - ctl
    hist: dict[str, int] = {}
    for o in ops:
        hist[o] = hist.get(o, 0) + 1
    return {"fma": fma / units, "alu": alu / units, "memory": mem / units,
            "control": ctl / units, "arith": (fma + alu) / units,
            "opcodes": {k: v / units for k, v in sorted(hist.items())}}


def card_line() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` of the first card, or a note."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    except OSError:
        out = []
    return out[0] if out else "nvidia-smi unavailable"
