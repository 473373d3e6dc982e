"""What the compiler made of the port's kernel libraries: each kernel's
registers, spills and stack (``nvcc -Xptxas -v``) and its count of chosen
SASS instructions (``cuobjdump -sass``): HGMMA (wgmma), UTMALDG (TMA
loads), SYNCS (mbarrier operations), HMMA (mma.sync), LDL/STL (local
memory, where spills go), LDGSTS (cp.async copies into shared memory),
and global loads split by width: LDG.128 (16 bytes a thread) against
LDG<128 (narrower).

    python3 -m parameter_server_tpu_torch.benchmarks.kernel_report [NAME ...] [--require-regs PART=N ...]
        [--require-wide PART ...] [--define MACRO ...]

Builds each named library (default: all) from ``kernels/csrc`` with the
port's own flags plus ``-Xptxas -v`` (and ``-DMACRO`` for each
``--define``: a variant build) into a temporary directory, prints
one line a kernel and writes ``chiprun_out/kernel_report.json``. Exits
non-zero if a build fails, or if a kernel whose name contains PART does
not use exactly N registers a thread (``--require-regs``: a kernel that
hands registers between warpgroups with setmaxnreg needs the whole
register file allotted to its block at launch), or if a kernel whose
name contains a ``--require-wide`` PART has no 16-byte global load or
spills (a streaming kernel whose vector loads did not compile). Needs the
CUDA toolkit, not a card.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

from .. import kernels

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
MNEMONICS = ("HGMMA", "UTMALDG", "SYNCS", "HMMA", "LDL", "STL", "LDGSTS", "LDG.128", "LDG<128")
_OPCODE = re.compile(r"/\*[0-9a-f]+\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_]*)((?:\.[A-Z0-9_]+)*)")


def mnemonic(base: str, modifiers: str) -> str:
    """The name counted for an opcode: global loads by width."""
    if base == "LDG":
        return base + (".128" if "128" in modifiers.split(".") else "<128")
    return base


def _tool(name: str) -> str:
    path = shutil.which(name) or os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", name)
    if not os.path.exists(path):
        raise RuntimeError(f"{name} not found: this report needs the CUDA toolkit")
    return path


def demangle(names):
    """C++ names of mangled symbols (as they are, without c++filt)."""
    if not names or shutil.which("c++filt") is None:
        return {n: n for n in names}
    out = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True, text=True,
                         check=True).stdout.splitlines()
    return dict(zip(names, out))


def parse_ptxas(text: str) -> dict:
    """Mangled kernel name -> registers, spill bytes, stack bytes, and the
    lines ptxas warned with, from ``-Xptxas -v`` output."""
    kernels_, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = kernels_.setdefault(m.group(1), {"warnings": []})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)), spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
        if "warning" in line.lower() or "performance" in line.lower():
            cur["warnings"].append(line.strip())
    return kernels_


def count_sass(text: str) -> dict:
    """Mangled function name -> count of each of MNEMONICS in its SASS."""
    counts, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = counts.setdefault(m.group(1), collections.Counter())
            continue
        m = _OPCODE.search(line)
        if cur is not None and m and mnemonic(m.group(1), m.group(2)) in MNEMONICS:
            cur[mnemonic(m.group(1), m.group(2))] += 1
    return {k: {n: v.get(n, 0) for n in MNEMONICS} for k, v in counts.items()}


def report(name: str, tmp: str, *defines: str) -> dict:
    lib = os.path.join(tmp, f"{name}.so")
    cmd = [kernels._nvcc(), *kernels._flags(name, defines), "-Xptxas", "-v", "-o", lib,
           str(kernels._CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{name}: nvcc exit {proc.returncode}\n{proc.stdout}{proc.stderr}")
    info = parse_ptxas(proc.stdout + proc.stderr)
    sass = count_sass(subprocess.run([_tool("cuobjdump"), "-sass", lib], capture_output=True,
                                     text=True, check=True).stdout)
    names = demangle(sorted(set(info) | set(sass)))
    return {names[k]: dict(info.get(k, {}), sass=sass.get(k, {})) for k in names}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("names", nargs="*", help="kernel libraries (default: all)")
    ap.add_argument("--require-regs", action="append", default=[], metavar="PART=N")
    ap.add_argument("--require-wide", action="append", default=[], metavar="PART")
    ap.add_argument("--define", action="append", default=[], metavar="MACRO")
    args = ap.parse_args(argv)
    names = args.names or sorted(kernels._SIGNATURES)
    out = {}
    with tempfile.TemporaryDirectory(prefix="kernel_report_") as tmp:
        for name in names:
            out[name] = report(name, tmp, *args.define)
    bad = []
    for lib, ks in out.items():
        for kname, r in ks.items():
            print(f"# {lib} {kname}: registers {r.get('registers')}, spill stores "
                  f"{r.get('spill_stores')} B, spill loads {r.get('spill_loads')} B, stack "
                  f"{r.get('stack')} B; SASS {r['sass']}" +
                  (f"; ptxas: {r['warnings']}" if r.get("warnings") else ""), flush=True)
            for req in args.require_regs:
                part, n = req.split("=")
                if part in kname and r.get("registers") != int(n):
                    bad.append(f"{kname}: {r.get('registers')} registers, want {n}")
            for part in args.require_wide:
                if part in kname and (r["sass"].get("LDG.128", 0) == 0 or r.get("spill_stores")
                                      or r.get("spill_loads")):
                    bad.append(f"{kname}: LDG.128 {r['sass'].get('LDG.128', 0)}, spills "
                               f"{r.get('spill_stores')}/{r.get('spill_loads')} B, want 16-byte "
                               "loads and no spills")
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "kernel_report.json"), "w") as f:
        json.dump(out, f, indent=1)
    for b in bad:
        print(f"kernel_report: {b}", file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
