#!/usr/bin/env python3
"""Registers and spills of the kernels in this tree against another
checkout's, as ``nvcc -Xptxas -v`` reports them for sm_90a. Needs nvcc.

    python3 scripts/ptxas_vs_parent.py --other DIR [--log-dir DIR]
        [--sources tcn|dpt|all]

DIR holds another checkout's ``convtasnet_tpu_torch/`` (for example the
parent commit, unpacked with ``git archive HEAD convtasnet_tpu_torch``).
Each source of both trees (the TCN's ``tcn_block*.cu`` and the DPT's
``dpt_*.cu``, or one family with ``--sources``) compiles at once, with the
package's own nvcc flags, and every kernel both trees have is held by its
registers, stack frame and spill stores and loads: one line per kernel
whose numbers moved, one per kernel only one tree has, and a count of the
kernels the trees share with the same numbers. A kernel's name is taken
without both of its source's anonymous-namespace hashes (nvcc's second one
can change with the source, as when it gains an ``extern "C"`` entry), so
an edited source's kernels are held against the other tree's too. A kernel that gained a
defaulted template parameter keeps its old name for its default
instantiation (``e2_kernel`` and ``e2_wg_kernel``'s ``kTapChunks``,
``out_proj_wg_kernel``'s ``kHaloDev``, the f32 inter cores' ``kKeys`` of
32, the f32 backward stages' ``kCln``), so that a P <= 16 route, one up
to B = 512, or a gLN stage is held against itself. ``--log-dir`` keeps each report. Exits 1 if a shared kernel's
numbers moved.
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

FAMILIES = {
    "tcn": ("tcn_block", "tcn_block_bwd", "tcn_block_pair",
            "tcn_block_pair_bwd", "tcn_block_tp"),
    "dpt": ("dpt_attention", "dpt_attention_bwd", "dpt_intra",
            "dpt_intra_bwd", "dpt_ffn", "dpt_ffn_bwd"),
}
SOURCES = FAMILIES["tcn"] + FAMILIES["dpt"]
# default instantiations of kernels that gained a defaulted template
# parameter, mapped to the names they had without it
RENAMES = [(r"(e2_kernelI\w+?)ELb0EEEv", r"\1EEEv"),
           (r"(out_proj_wg_kernelILi\d+ELb[01])ELb0EEEv", r"\1EEEv"),
           (r"e2_wg_kernelILb0EEEvNS_9BwdParamsEi",
            "e2_wg_kernelENS_9BwdParamsEi"),
           (r"(inter(?:_bwd)?_core_kernelIfLi\d+ELb[01]E)Li32EEEv",
            r"\1EEv"),
           (r"((?:g1|g2b)_tf32_kernelILi\d+)ELb0EEEv", r"\1EEEv"),
           (r"(e2_tf32_kernelILi\d+ELb[01])ELb0EEEv", r"\1EEEv")]


def kernel_name(mangled: str) -> str:
    """A kernel's mangled name without its file's two anonymous-namespace
    hashes (an edited source may get another second one), default
    instantiations under their old names."""
    name = re.sub(r"_GLOBAL__N__[0-9a-f]+_", "_GLOBAL__N__", mangled)
    name = re.sub(r"(_cu)_[0-9a-f]{8}(?=\d)", r"\1", name)
    for old, new in RENAMES:
        name = re.sub(old, new, name)
    return name


def short(name: str) -> str:
    """The name past the namespace prefix, for printing."""
    return re.sub(r"^_ZN\d+_GLOBAL__N__\w+?_cu(?:_[0-9a-f]{8})?\d+", "", name)


def parse(report: str) -> dict:
    """{kernel: (registers, stack, spill stores, spill loads)} from one
    ``-Xptxas -v`` report."""
    out, fn, frame = {}, None, None
    for line in report.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([^' ]+)'?", line)
        if m:
            fn = kernel_name(m.group(1))
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            frame = tuple(int(v) for v in m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            out[fn] = (int(m.group(1)), *(frame or (0, 0, 0)))
            fn, frame = None, None
    return out


def compile_reports(root: str, tmp: str, tag: str,
                    sources=SOURCES) -> dict:
    """Each of ``sources`` of the tree at root compiled at once; {source:
    report}."""
    from convtasnet_tpu_torch.ops.cuda.build import NVCC_FLAGS, _nvcc

    nvcc, procs = _nvcc(), {}
    for src in sources:
        path = os.path.join(root, "convtasnet_tpu_torch", "csrc", f"{src}.cu")
        procs[src] = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
             os.path.join(tmp, f"{tag}_{src}.o"), path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    reports = {}
    for src, proc in procs.items():
        reports[src] = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {tag} {src}:\n"
                               f"{reports[src][-2000:]}")
    return reports


def compare(mine: dict, other: dict) -> tuple:
    """(lines, n_same, n_shared, n_moved) for two trees' reports (of the
    same sources)."""
    lines, same, shared, moved = [], 0, 0, 0
    fmt = "{} registers, {} bytes stack, {}/{} bytes spill stores/loads"
    for src in mine:
        a, b = parse(mine[src]), parse(other[src])
        for k in sorted(set(a) | set(b)):
            if k in a and k in b:
                shared += 1
                if a[k] == b[k]:
                    same += 1
                    continue
                moved += 1
                lines.append(f"{src}: MOVED {short(k)}: this "
                             f"{fmt.format(*a[k])}; other "
                             f"{fmt.format(*b[k])}")
            else:
                tree, v = ("this", a[k]) if k in a else ("other", b[k])
                lines.append(f"{src}: {tree} tree only {short(k)}: "
                             f"{fmt.format(*v)}")
    return lines, same, shared, moved


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True,
                    help="directory holding the other checkout's "
                         "convtasnet_tpu_torch/")
    ap.add_argument("--log-dir", help="keep each tree's reports here")
    ap.add_argument("--sources", choices=("tcn", "dpt", "all"),
                    default="all", help="which sources' kernels (default: "
                    "all)")
    a = ap.parse_args()
    sources = SOURCES if a.sources == "all" else FAMILIES[a.sources]
    with tempfile.TemporaryDirectory() as tmp:
        reports = {tag: compile_reports(root, tmp, tag, sources)
                   for tag, root in
                   (("this", REPO), ("other", os.path.abspath(a.other)))}
    if a.log_dir:
        os.makedirs(a.log_dir, exist_ok=True)
        for tag, per in reports.items():
            for src, text in per.items():
                with open(os.path.join(a.log_dir, f"ptxas_{tag}_{src}.txt"),
                          "w") as f:
                    f.write(text)
    lines, same, shared, moved = compare(reports["this"], reports["other"])
    for line in lines:
        print(f"ptxas {line}", flush=True)
    print(f"ptxas: {same} of {shared} kernels both trees compile with the "
          f"same registers, stack and spills ({moved} moved)", flush=True)
    return 1 if moved else 0


if __name__ == "__main__":
    sys.exit(main())
