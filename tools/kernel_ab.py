#!/usr/bin/env python3
"""Time the PyTorch port's stencil and tail kernels against an earlier
commit's on one CUDA card, and count the SASS of their CUDA kernels.

    git archive <commit> | tar -x -C build/parent
    python3 tools/kernel_ab.py build/parent [--kernels conv9,lp9_decimate] \
        [--sass stencils:stencil9_kernel]
    python3 tools/kernel_ab.py build/parent --sass "stencils:build_level_kernel|inject9_kernel" \
        --kernels riesz_build_level,riesz_build_level[bf16 out],lp9_inject,lp9_inject[bf16],conv9,band5,lp9_decimate
    python3 tools/kernel_ab.py build/parent --sass stencils:band5_kernel \
        --kernels band5,band5[bf16],conv9,conv9[bf16],lp9_decimate,riesz_build_level
    python3 tools/kernel_ab.py build/parent --sass tail:amplify13_kernel \
        --kernels riesz_amplify_mxu,riesz_amplify_fused[preweighted],riesz_amplify_mxu[fast],riesz_level_mxu

The port under PARENT and the port of this checkout each run in a process of
their own, in the order parent, change, change, parent. Each process times
every kernel named in --kernels (default: all of KERNELS) at every band level
of 2160x3840 levels=6 and at 1080x1920's level 4 (68x120), by CUDA events over back-to-back calls (``ms``, the
wrapper's host cost included, as chip_smoke.py's ``ms``) and by CUDA graph
replay (``graph_ms``, the kernel alone), with chip_smoke.py's timers of this
checkout; and it counts the SASS opcodes (``cuobjdump -sass``, static counts)
of every function of the built library whose name holds the text after the
colon in --sass (several joined by ``|``), with the seconds its build took. Each measurement is one JSON line tagged with its tree; the
lines after them give, for each kernel and level, both trees' mean times and
the ratio change / parent of the graph times.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smoke():
    """chip_smoke.py of this checkout (its timers), whichever tree is imported."""
    spec = importlib.util.spec_from_file_location("chip_smoke_timers",
                                                  os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cases(st, tl, x, small, tail_planes, h, w):
    """Each kernel's wrapper call on one level's planes; a new kernel is one
    more entry. The tail kernels run on standard-normal planes (the amplitude
    a magnitude): K6 with f32 planes, K7 preweighted (the phase_fused+pallas
    call), K6's fast arm (bf16 planes and operands) and K9, the whole level
    tail, as a control. band5 takes all eight instantiations: ``band5`` (f32
    in and out, the defaults and the sharded step), ``band5[bf16]`` (bf16
    in and out, bf16 operands: --fast) and ``band5[<in>><out>]`` with
    `` bf16 ops`` for the bf16 operand arm."""
    import torch
    from live_video_magnification_tpu_torch.ops.kernels import (
        LOWPASS_2X,
        RIESZ_BAND_KERNEL,
        RIESZ_HIGHPASS_9x9,
    )
    from live_video_magnification_tpu_torch.ops.temporal import butterworth_bandpass_coeffs

    hp9, lp2 = RIESZ_HIGHPASS_9x9, LOWPASS_2X
    six = tail_planes[:6]
    weighted = six[:1] + [c * six[0] for c in six[1:3]] + six[3:]
    fast = [p.to(torch.bfloat16) for p in six]
    coeffs = [c for band in (1.0, 5.0) for c in butterworth_bandpass_coeffs(band, 30.0)]
    q = tail_planes  # K9's 16 planes
    planes = {"f32": x, "bf16": x.to(torch.bfloat16)}
    band = {
        f"band5[{ti}>{to}{' bf16 ops' if ops else ''}]":
            (lambda hp=planes[ti], to=to, ops=ops:
             st.band5(hp, RIESZ_BAND_KERNEL, bf16=ops, out_dtype=to))
        for ti in ("f32", "bf16") for to in ("f32", "bf16") for ops in (False, True)
    }
    band["band5"] = band.pop("band5[f32>f32]")
    band["band5[bf16]"] = band.pop("band5[bf16>bf16 bf16 ops]")
    return {**band,
        "conv9": lambda: st.conv9(x, hp9),
        "conv9[bf16]": lambda: st.conv9(x, hp9, bf16=True, out_dtype="bf16"),
        "conv9[bf16 to f32]": lambda: st.conv9(x, hp9, bf16=True),
        "lp9_decimate": lambda: st.lp9_decimate(x, lp2),
        "lp9_decimate[bf16]": lambda: st.lp9_decimate(x, lp2, bf16=True),
        "lp9_inject": lambda: st.lp9_inject(small, lp2, (h, w)),
        "lp9_inject[bf16]": lambda: st.lp9_inject(small, lp2, (h, w), bf16=True),
        "riesz_build_level": lambda: st.riesz_build_level(x),
        "riesz_build_level[bf16 out]": lambda: st.riesz_build_level(x, out_dtype="bf16"),
        "riesz_amplify_mxu": lambda: tl.riesz_amplify_mxu(*six, 50.0, 1.2),
        "riesz_amplify_fused[preweighted]":
            lambda: tl.riesz_amplify_fused(*weighted, 50.0, 1.2, preweighted=True),
        "riesz_amplify_mxu[fast]": lambda: tl.riesz_amplify_mxu(*fast, 50.0, 1.2, bf16=True),
        "riesz_level_mxu": lambda: tl.riesz_level_mxu(*q[:6], tuple(q[6:8]), tuple(q[8:12]),
                                                      tuple(q[12:16]), *coeffs, False, 50.0,
                                                      1.2),
    }


BAND5 = ("band5", "band5[bf16]", "band5[f32>f32 bf16 ops]", "band5[f32>bf16]",
         "band5[f32>bf16 bf16 ops]", "band5[bf16>f32]", "band5[bf16>f32 bf16 ops]",
         "band5[bf16>bf16]")
KERNELS = ("conv9", "conv9[bf16]", "conv9[bf16 to f32]", *BAND5, "lp9_decimate",
           "lp9_decimate[bf16]", "lp9_inject", "lp9_inject[bf16]", "riesz_build_level",
           "riesz_build_level[bf16 out]", "riesz_amplify_mxu",
           "riesz_amplify_fused[preweighted]", "riesz_amplify_mxu[fast]", "riesz_level_mxu")


def sass_counts(lib, names: str) -> list:
    """Static SASS opcode counts of each function of a built library whose
    mangled name holds one of the ``|``-separated ``names``: every opcode, and the totals of the f32,
    special-function, predicate and memory classes a kernel's cost is made
    of."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    funcs, cur = {}, None
    for line in sass.splitlines():
        fn = re.match(r"\s*Function : (\S+)", line)
        if fn:
            cur = fn.group(1) if any(n in fn.group(1) for n in names.split("|")) else None
            if cur:
                funcs[cur] = {}
            continue
        op = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]\s+)?([A-Z][A-Z0-9_.]*)", line)
        if cur and op:
            funcs[cur][op.group(1)] = funcs[cur].get(op.group(1), 0) + 1
    if not funcs:
        raise AssertionError(f"no function named like {names} in {lib}")
    names = list(funcs)
    filt = shutil.which("cu++filt") or "/usr/local/cuda/bin/cu++filt"
    try:
        shown = subprocess.run([filt, *names], capture_output=True, text=True, check=True,
                               timeout=60).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        shown = names
    rows = []
    for mangled, demangled in zip(names, shown):
        ops = funcs[mangled]
        base = lambda p: sum(v for k, v in ops.items() if k.split(".")[0] == p)
        rows.append(dict(function=demangled, total=sum(ops.values()),
                         **{p: base(p) for p in ("FMUL", "FADD", "FFMA", "MUFU", "FSETP",
                                                 "FSEL", "LDS", "STS", "LDG", "STG", "BRA")},
                         LDS_128=ops.get("LDS.128", 0),
                         LDG_128=ops.get("LDG.E.128", 0) + ops.get("LDG.E.128.CONSTANT", 0),
                         opcodes=ops))
    return rows


def report(tree: str, kernels, sass: str) -> int:
    """The measurements of the port importable from the working directory."""
    sys.path.insert(0, os.getcwd())
    import torch
    from live_video_magnification_tpu_torch.ops.hopper import _build
    from live_video_magnification_tpu_torch.ops.hopper import stencils as st
    from live_video_magnification_tpu_torch.ops.hopper import tail as tl
    from live_video_magnification_tpu_torch.ops.riesz import riesz_level_sizes

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device; this script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    smoke = _smoke()
    dev = torch.device("cuda", 0)
    if sass:
        source, name = sass.split(":", 1)
        fresh = not _build.library_path(source).exists()
        t0 = time.perf_counter()
        lib = _build.build([source])[source]
        smoke.log(phase="build", tree=tree, source=source, compiled_now=fresh,
                  seconds=time.perf_counter() - t0)
        for row in sass_counts(lib, name):
            smoke.log(phase="sass", tree=tree, **row)
    rng = np.random.default_rng(smoke.SEED + 9)
    sizes = riesz_level_sizes(2160, 3840, 6)
    flagship = riesz_level_sizes(1080, 1920, 6)  # level 4 (68x120): K5 on the default path
    levels = [(lvl, hw, sizes[lvl + 1]) for lvl, hw in enumerate(sizes[:-1])]
    for lvl, (h, w), small_hw in levels + [("1080p:4", flagship[4], flagship[5])]:
        x = torch.from_numpy(rng.random((h, w), dtype=np.float32) * 100.0).to(dev)
        small = torch.from_numpy(rng.random(small_hw, dtype=np.float32) * 100.0).to(dev)
        tail_planes = [torch.from_numpy(rng.standard_normal((h, w), dtype=np.float32)).to(dev)
                       for _ in range(16)]
        tail_planes[0] = tail_planes[0].abs()
        cases = _cases(st, tl, x, small, tail_planes, h, w)
        iters = 50 if h * w > 4e6 else 200
        for k in kernels:
            smoke.log(phase="time", tree=tree, kernel=k, level=lvl, shape=[h, w],
                      ms=smoke.cuda_ms(cases[k], iters), graph_ms=smoke.graph_ms(cases[k], iters))
    return 0


def summary(lines) -> None:
    """Each kernel's and level's mean times by tree and the graph ratio."""
    runs = {}
    for r in lines:
        if r.get("phase") == "time":
            runs.setdefault((r["kernel"], r["level"]), {}).setdefault(r["tree"], []).append(r)
    for (k, lvl), by_tree in runs.items():
        mean = {t: {m: float(np.mean([r[m] for r in rs])) for m in ("ms", "graph_ms")}
                for t, rs in by_tree.items()}
        print(json.dumps(dict(phase="summary", kernel=k, level=lvl, **mean,
                              graph_ratio=mean["change"]["graph_ms"]
                              / mean["parent"]["graph_ms"])), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent", nargs="?", help="a copy of an earlier commit's tree")
    ap.add_argument("--kernels", default=",".join(KERNELS))
    ap.add_argument("--sass", default="stencils:stencil9_kernel",
                    help="source:function-name text (several joined by |); empty for none")
    ap.add_argument("--report", metavar="TREE", help=argparse.SUPPRESS)
    args = ap.parse_args()
    kernels = [k for k in args.kernels.split(",") if k]
    if args.report:
        return report(args.report, kernels, args.sass)
    if not args.parent:
        ap.error("give the parent tree")
    lines = []
    parent = os.path.abspath(args.parent)
    for tree, root in (("parent", parent), ("change", HERE), ("change", HERE),
                       ("parent", parent)):
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--report", tree,
                              "--kernels", args.kernels, "--sass", args.sass],
                             cwd=root, capture_output=True, text=True, timeout=900)
        sys.stderr.write(out.stderr)
        if out.returncode:
            print(out.stdout, end="")
            return out.returncode
        print(out.stdout, end="", flush=True)
        lines += [json.loads(ln) for ln in out.stdout.splitlines() if ln.startswith("{")]
    summary(lines)
    return 0


if __name__ == "__main__":
    sys.exit(main())
