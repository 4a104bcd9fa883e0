#!/usr/bin/env python3
"""Registers, spills, shared memory and tensor-core instructions of the
port's hand-written CUDA kernels, as the compiler built them.

    python3 scripts/kernel_resources.py [--only paged_attention.cu ...]

Compiles each source of ``paddle_tpu_torch/ops/cuda`` with the port's
flags plus ``-Xptxas -v`` (one ``nvcc`` per source, all started together)
into ``paddle_tpu_torch/ops/cuda/_build/resources/``, then counts, per
kernel, the instructions of its SASS (``cuobjdump -sass``) that matter for
the tensor-core design: ``HMMA`` (mma.sync on tensor cores), ``HGMMA``
(wgmma, the warpgroup products), ``LDGSTS``
(cp.async), ``FFMA`` (f32 FMA) and ``LDS`` (shared-memory loads). Prints
one JSON object per kernel (demangled name, registers, spill bytes, static
shared memory, stack, instruction counts), then a summary line. Needs the
CUDA toolkit (``nvcc``, ``cuobjdump``); it runs no kernel.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from paddle_tpu_torch.ops.cuda import build  # noqa: E402

OUT = build.BUILD_DIR / "resources"
COUNTED = ("HMMA", "HGMMA", "LDGSTS", "FFMA", "LDS")


def _tool(name):
    nvcc = build._nvcc()
    cand = os.path.join(os.path.dirname(nvcc), name)
    return cand if os.path.exists(cand) else shutil.which(name)


def demangle(names):
    tool = _tool("cu++filt") or shutil.which("c++filt")
    if tool is None or not names:
        return {n: n for n in names}
    out = subprocess.run([tool], input="\n".join(names), text=True,
                         capture_output=True, check=True).stdout
    return dict(zip(names, out.splitlines()))


def ptxas_info(text):
    """{mangled kernel: {registers, spill_stores, spill_loads, stack,
    smem}} from ``-Xptxas -v`` output."""
    info, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w$]+)'?", line)
        if m:
            cur = m.group(1)
            info.setdefault(cur, {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            info[cur].update(stack=int(m.group(1)),
                             spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            info[cur]["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            info[cur]["smem"] = int(s.group(1)) if s else 0
    return info


def sass_counts(obj):
    """{mangled kernel: {instruction: count}} from ``cuobjdump -sass``."""
    text = subprocess.run([_tool("cuobjdump"), "-sass", str(obj)],
                          capture_output=True, text=True, check=True).stdout
    counts, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = m.group(1)
            counts[cur] = dict.fromkeys(COUNTED, 0)
            continue
        if cur is None or not re.match(r"\s+/\*[0-9a-f]+\*/", line):
            continue
        op = re.search(r"\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)", line)
        if op and op.group(1) in COUNTED:
            counts[cur][op.group(1)] += 1
    return counts


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", nargs="*", default=None,
                    help="sources to compile (default: all)")
    args = ap.parse_args()
    sources = [s for s in build.SOURCES
               if args.only is None or s in args.only]
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc = build._nvcc()
    procs = []
    for src in sources:
        obj = OUT / (Path(src).stem + ".o")
        cmd = [nvcc, *build.NVCC_FLAGS, "-Xptxas", "-v", "-Xcompiler",
               "-fPIC", "-c", str(build._DIR / src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    rows = []
    for src, obj, proc in procs:
        text, _ = proc.communicate()
        if proc.returncode != 0:
            print(text, file=sys.stderr)
            raise SystemExit(f"nvcc failed on {src}")
        info, counts = ptxas_info(text), sass_counts(obj)
        names = demangle(sorted(set(info) | set(counts)))
        for mangled in sorted(set(info) | set(counts)):
            rows.append(dict(source=src, kernel=names[mangled],
                             **info.get(mangled, {}),
                             sass=counts.get(mangled, {})))
    for r in rows:
        print(json.dumps(r))
    print(json.dumps({"kernels": len(rows), **{
        f"with_{op.lower()}": sum(1 for r in rows if r["sass"].get(op, 0))
        for op in ("HMMA", "HGMMA")}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
