"""Profile K2 and K3 (kernels/csrc/flash_attention.cu and
flash_attention_bwd.cu) on the card without a hardware profiler.

For one or more copies of the kernel sources (this tree's by default, and
for example an earlier tree's unpacked with `git archive <commit>
sais_tpu_torch/kernels/csrc | tar -x -C build/parent`) it

- builds both sources with `nvcc -Xptxas -v` (one process each, in
  parallel) and prints every instance's registers, spill bytes and
  static shared memory;
- reads each kernel's SASS (cuobjdump) and counts its instructions by
  class: tensor-core (HMMA), FFMA, other f32 arithmetic, shared-memory
  loads (LDS, LDSM) and stores, shuffles (SHFL), integer / logic and the
  rest, over the whole function and over its main loop (the widest
  backward branch);
- times K2 and K3 at the given shapes with CUDA events (the calls of all
  copies in turns; device time: calls queued behind a spin kernel),
  holds each copy's outputs against the plain PyTorch versions (1e-4 of
  the largest value, the chip_smoke.py limit) and prints whether two
  copies agree bit for bit;
- estimates the issue-slot use of each launch: the SASS of its main loop
  (inner loops expanded by their trip counts: k-steps for a loop that
  holds HMMA, copies a thread issues for one that holds LDGSTS) times the
  loop's trips and the warps that run it, plus the rest of the function
  once a warp, over 4 issue slots a cycle on each of the card's SMs at
  the SM clock nvidia-smi reads during the timing.  An estimate: branches
  not taken, predicated-off instructions and warps that leave early are
  counted as issued.

Theoretical occupancy (blocks an SM) comes from the instances' registers
and dynamic shared memory (`occupancy` of each design below); ncu, and so
achieved occupancy, is not available on the card's machine.

    python3 tools/flash_profile.py                      # this tree
    python3 tools/flash_profile.py --csrc 53ef9b8=build/parent/csrc \\
        --csrc this=sais_tpu_torch/kernels/csrc
    python3 tools/flash_profile.py --only k2 --shapes 132,4,301,96
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys
import tempfile
import threading
from collections import Counter

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SMS = 132
REGS_PER_SM = 65536
SMEM_PER_SM = 233472        # 228 KB, 1 KB of it reserved a block

# (B, H, L, Dh, masked): the profile shapes of K2 and K3
K2_SHAPES = ((132, 4, 301, 96, False), (32, 4, 129, 192, True),
             (8, 4, 2001, 96, True), (8, 4, 2001, 192, True))
K3_SHAPES = ((32, 4, 129, 192, True), (8, 4, 2001, 192, True),
             (132, 4, 301, 96, False))


def cdiv(a, b):
    return -(-a // b)


# What each tree launches: for K2 and K3 at (bh, lq, lk) on the instance
# `d` a list of (instance, blocks, warps a block, trips of the main loop,
# rows a streaming tile: copies a thread issues are rows * d / 4 /
# threads, dynamic shared memory of a block in bytes, HMMA a warp issues
# in one trip: 3 for each product of a k-step and an n-tile).
def launches_earlier(kernel, bh, lq, lk, d):
    ld, ks = d + 4, d // 8
    if kernel == "k2":
        return [(f"flash_fwd_kernel<{d}>", bh * cdiv(lq, 64), 4, cdiv(lk, 32),
                 32, (256 * ld + 64) * 4, 12 * ks)]
    planes, stages = d <= 96, 1 if d > 128 else 2
    tile = 64 * ld
    rows = 8 * tile if planes else 2 * tile + 2 * stages * tile
    smem = (rows + 2 * (2 if planes else stages) * 64 + 64) * 4
    parts = 2 if d > 128 else 1
    nb = bh * cdiv(lk, 64) * parts
    if d <= 96:
        dkv = [(f"flash_bwd_dkv_kernel<{d},3>", nb, 8, cdiv(lq, 64), 64, smem,
                48 * ks)]
    else:   # dv (p^T, p^T dO), then dk (p^T, dp^T, ds^T q')
        dkv = [(f"flash_bwd_dkv_kernel<{d},2>", nb, 8, cdiv(lq, 64), 64, smem,
                12 * ks + 12 * ks // parts),
               (f"flash_bwd_dkv_kernel<{d},1>", nb, 8, cdiv(lq, 64), 64, smem,
                24 * ks + 12 * ks // parts)]
    return [(f"flash_bwd_dq_kernel<{d}>", bh * cdiv(lq, 64) * parts, 8,
             cdiv(lk, 64), 64, smem, 24 * ks + 12 * ks // parts)] + dkv


def launches_this(kernel, bh, lq, lk, d):
    ld, ks = d + 4, d // 8
    if kernel == "k2":
        warps = 4 if d <= 96 else 8
        return [(f"flash_fwd_kernel<{d}>", bh * cdiv(lq, 64), warps,
                 cdiv(lk, 32), 32,
                 (256 * ld + 2560 * (warps // 4) + 64 + 64 * warps) * 4,
                 3 * ks * (16 // warps))]
    if d <= 96:
        return [(n.replace(",3>", ">"), *rest)
                for n, *rest in launches_earlier(kernel, bh, lq, lk, d)]
    return [(f"flash_bwd_dq_kernel<{d}>", bh * cdiv(lq, 64), 8, cdiv(lk, 32),
             32, (256 * ld + 2112) * 4, 18 * ks),
            (f"flash_bwd_dkv_kernel<{d}>", bh * cdiv(lk, 32), 8, cdiv(lq, 32),
             32, (256 * ld + 2464) * 4, 12 * ks)]


DESIGNS = {"53ef9b8": launches_earlier, "this": launches_this}


def blocks_an_sm(regs, warps, smem):
    """Theoretical resident blocks an SM: registers (allocated 256 a warp
    at a time), shared memory (1 KB reserved a block), 64 warps."""
    per_warp = cdiv(max(regs, 1) * 32, 256) * 256
    return min(REGS_PER_SM // (per_warp * warps),
               SMEM_PER_SM // (smem + 1024), 64 // warps)


def nvcc():
    from sais_tpu_torch.kernels import _build
    return _build.nvcc_path()


def build(label, csrc, out_dir):
    """Start nvcc for both flash sources of one copy; -> {name: (so, proc)}."""
    from sais_tpu_torch.kernels import _build
    jobs = {}
    for name in ("flash_attention", "flash_attention_bwd"):
        so = os.path.join(out_dir, f"{label}_{name}.so")
        jobs[name] = (so, subprocess.Popen(
            [nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
             "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", so,
             os.path.join(csrc, f"{name}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    return jobs


def instance(func):
    """'flash_fwd_kernel<96>' from a mangled name."""
    base = next((f for f in ("flash_fwd_kernel", "flash_bwd_dq_kernel",
                             "flash_bwd_dkv_kernel") if f in func), func)
    args = re.findall(r"ILi(\d+)E(?:Li(\d+)E)?", func)
    if not args:
        return base
    a = args[0]
    return base + "<" + ",".join(x for x in a if x) + ">"


def ptxas_report(log):
    """{instance: 'N registers, spills ...'} from nvcc -Xptxas -v."""
    out, current = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            current = instance(line.split("'")[1])
            out[current] = []
        elif current and ("registers" in line or "spill" in line
                          or "stack frame" in line):
            out[current].append(line.split("ptxas info    :")[-1].strip())
    return out


def registers(lines):
    for line in lines:
        m = re.search(r"Used (\d+) registers", line)
        if m:
            return int(m.group(1))
    return 0


def spills(lines):
    return sum(int(a) + int(b) for line in lines for a, b in re.findall(
        r"(\d+) bytes spill stores, (\d+) bytes spill loads", line))


CLASSES = (("HMMA", ("HMMA",)), ("FFMA", ("FFMA",)),
           ("f32 other", ("FADD", "FMUL", "FMNMX", "MUFU", "FSETP", "FSEL",
                          "FCHK")),
           ("LDS", ("LDS", "LDSM")), ("STS", ("STS",)),
           ("SHFL", ("SHFL",)), ("LDG/LDGSTS", ("LDG", "LDGSTS")),
           ("int/logic", ("IMAD", "IADD3", "LOP3", "SHF", "LEA", "ISETP",
                          "MOV", "SEL", "IMNMX", "PRMT", "S2R", "CS2R",
                          "ULDC", "UMOV", "ULEA", "UIADD3", "UIMAD")))


def opclass(op):
    base = op.split(".")[0]
    for name, ops in CLASSES:
        if base in ops:
            return name
    return "rest"


def sass(so):
    """{instance: [(address, opcode)]} of one library."""
    tool = os.path.join(os.path.dirname(nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", so], capture_output=True,
                          text=True, timeout=300).stdout
    funcs, current = {}, None
    pat = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)"
                     r"\s*([^;]*);")
    for line in text.splitlines():
        if "Function :" in line:
            current = instance(line.split("Function :")[1].strip())
            funcs[current] = []
        elif current:
            m = pat.search(line)
            if m:
                funcs[current].append((int(m.group(1), 16), m.group(3),
                                       m.group(4)))
    return funcs


def loops(code):
    """[(start, end)] of every backward branch, widest first."""
    out = []
    for addr, op, args in code:
        if op.startswith("BRA"):
            m = re.search(r"0x([0-9a-f]+)", args)
            if m and int(m.group(1), 16) < addr:
                out.append((int(m.group(1), 16), addr))
    return sorted(set(out), key=lambda x: x[0] - x[1])


def mix(code):
    c = Counter(opclass(op) for _, op, _ in code)
    return c, sum(c.values())


def per_warp(code, trips, hmma, copies):
    """Instructions one warp issues: the main loop `trips` times, the
    rest once.  Inner loops run their trip counts: one that holds LDGSTS
    `copies` times; those that hold HMMA as often as makes the loop's
    HMMA come to `hmma` a trip."""
    ls = loops(code)
    if not ls:
        return len(code), "no loop"
    main = ls[0]
    body = [x for x in code if main[0] <= x[0] <= main[1]]
    inner = []
    for lo, hi in ls[1:]:
        if main[0] <= lo and hi <= main[1] and not any(
                a <= lo and hi <= b for a, b in inner):
            inner.append((lo, hi))
    count = lambda xs: sum(op.startswith("HMMA") for _, op, _ in xs)  # noqa
    in_loops = [[x for x in body if lo <= x[0] <= hi] for lo, hi in inner]
    h_in = sum(count(x) for x in in_loops if count(x))
    h_out = count(body) - h_in
    extra, notes = 0, []
    for xs in in_loops:
        ops = {op.split(".")[0] for _, op, _ in xs}
        if "HMMA" in ops:
            n = max(1, round((hmma - h_out) / h_in))
        elif "LDGSTS" in ops:
            n = copies
        else:
            n = 1
        extra += (n - 1) * len(xs)
        notes.append(f"inner loop {len(xs)} x {n}")
    per_trip = len(body) + extra
    return (len(code) - len(body) + trips * per_trip,
            f"main loop {len(body)} instructions"
            + (f" ({'; '.join(notes)})" if notes else "")
            + f", {per_trip} a trip")


class SmClock:
    """Mean SM clock (MHz) nvidia-smi reads while the block runs."""

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,"
             "nounits", "-lms", "50"], stdout=subprocess.PIPE, text=True)
        self.lines = []
        self.thread = threading.Thread(target=self._read, daemon=True)
        self.thread.start()
        return self

    def _read(self):
        for line in self.proc.stdout:
            self.lines.append(line)

    def __exit__(self, *exc):
        self.proc.terminate()
        self.proc.wait()
        self.thread.join(timeout=5)
        vals = [float(x) for x in self.lines if x.strip().replace(".", "")
                .isdigit()]
        self.mhz = sum(vals) / len(vals) if vals else float("nan")


def inputs(b, h, l, dh, masked, seed):
    import torch
    g = torch.Generator().manual_seed(seed)
    q, k, v, do = (torch.randn((b, h, l, dh), generator=g).cuda()
                   for _ in range(4))
    valid = [l] * b
    if masked:
        valid = [l - (37 * i) % l for i in range(b - 1)] + [0]
    mask = torch.arange(l)[None, :] >= torch.tensor(valid)[:, None]
    bias = torch.where(mask, -1e30, 0.0).float().cuda() if masked else None
    return q, k, v, do, bias


class Copy:
    """One copy's K2 and K3 through its own libraries (this tree's C ABI)."""

    def __init__(self, label, libs):
        self.label = label
        ptr, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int,
                              ctypes.c_longlong, ctypes.c_float)
        self.fwd = ctypes.CDLL(libs["flash_attention"]).flash_attention_fwd
        self.fwd.argtypes = [ptr] * 6 + [i32] * 5 + [i64] * 12 + [f32, i32,
                                                                  ptr]
        self.bwd = ctypes.CDLL(libs["flash_attention_bwd"]).flash_attention_bwd
        self.bwd.argtypes = [ptr] * 10 + [i32] * 5 + [i64] * 21 + [f32, ptr]

    def k2(self, q, k, v, bias):
        import torch
        b, h, lq, dh = q.shape
        out = torch.empty((b, lq, h, dh), device=q.device).transpose(1, 2)
        lse = torch.empty((b, h, lq), device=q.device)
        rc = self.fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      None if bias is None else bias.data_ptr(),
                      out.data_ptr(), lse.data_ptr(), b, h, lq, k.shape[2],
                      dh, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                      *out.stride()[:3], dh ** -0.5, 0,
                      torch.cuda.current_stream().cuda_stream)
        assert rc == 0, f"{self.label} K2 launch failed ({rc})"
        return out, lse

    def k3(self, q, k, v, bias, do, lse, delta):
        import torch
        b, h, lq, dh = q.shape
        grads = [torch.empty((b, t.shape[2], h, dh), device=q.device)
                 .transpose(1, 2) for t in (q, k, v)]
        rc = self.bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      None if bias is None else bias.data_ptr(),
                      do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                      *(g.data_ptr() for g in grads), b, h, lq, k.shape[2],
                      dh, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                      *do.stride()[:3],
                      *(s for g in grads for s in g.stride()[:3]),
                      dh ** -0.5, torch.cuda.current_stream().cuda_stream)
        assert rc == 0, f"{self.label} K3 launch failed ({rc})"
        return grads


def timed(fn, iters, device_time):
    """ms a call: CUDA events around `iters` calls after a warm-up; with
    `device_time` the calls wait behind a 100 ms spin kernel, so the
    events time the device alone."""
    import torch
    for _ in range(2):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    if device_time:
        torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--csrc", action="append", metavar="LABEL=DIR",
                        help="a copy of kernels/csrc; LABEL '53ef9b8' is "
                        "read with the launch layout of the tree at that "
                        "commit, any other with this tree's (default: "
                        "this=<this tree>)")
    parser.add_argument("--only", choices=("k2", "k3"))
    parser.add_argument("--shapes", action="append", metavar="B,H,L,DH[,m]",
                        help="profile shapes (',m': masked)")
    args = parser.parse_args()
    import torch
    import torch.nn.functional as F
    from chip_smoke import k2_bound_ms, k3_bound_ms
    from sais_tpu_torch.kernels.flash_attention import (
        _delta, flash_attention_bwd_reference, flash_attention_reference)

    copies = [c.split("=", 1) for c in (args.csrc or [
        f"this={os.path.join(ROOT, 'sais_tpu_torch', 'kernels', 'csrc')}"])]
    tmp = tempfile.mkdtemp(prefix="flash_profile_")
    jobs = {label: build(label, csrc, tmp) for label, csrc in copies}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    libs, codes, regs = {}, {}, {}
    for label, job in jobs.items():
        libs[label] = {}
        for name, (so, proc) in job.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                sys.exit(f"{label} {name}.cu: nvcc failed\n{log}")
            libs[label][name] = so
            for inst, lines in ptxas_report(log).items():
                regs[(label, inst)] = registers(lines)
                print(f"ptxas {label} {inst}: {'; '.join(lines)}"
                      + ("" if not spills(lines) else "  <- SPILLS"),
                      flush=True)
            for inst, code in sass(so).items():
                codes[(label, inst)] = code
                c, n = mix(code)
                ls = loops(code)
                body = [x for x in code if ls and ls[0][0] <= x[0] <= ls[0][1]]
                cb, nb = mix(body) if body else (Counter(), 0)
                print(f"sass {label} {inst}: {n} instructions: "
                      + ", ".join(f"{k} {100 * c[k] / n:.1f}%" for k, _ in
                                  CLASSES + (("rest", ()),))
                      + (f"; main loop {nb}: " + ", ".join(
                          f"{k} {100 * cb[k] / nb:.1f}%" for k, _ in
                          CLASSES + (("rest", ()),)) if nb else ""),
                      flush=True)
    runners = [Copy(label, libs[label]) for label, _ in copies]
    shapes = K2_SHAPES if args.only != "k3" else ()
    shapes3 = K3_SHAPES if args.only != "k2" else ()
    if args.shapes:
        parsed = [tuple(int(x) for x in s.split(",")[:4]) + (
            s.endswith(",m"),) for s in args.shapes]
        shapes = parsed if args.only != "k3" else ()
        shapes3 = parsed if args.only != "k2" else ()

    def report(kind, label, shape, ms, dev_ms, mhz):
        b, h, l, dh, _ = shape
        design = DESIGNS.get(label, launches_this)
        issued = 0
        notes = []
        d = min(x for x in (32, 64, 96, 128, 192) if x >= dh)
        for inst, blocks, warps, trips, rows, smem, hmma in design(
                kind, b * h, l, l, d):
            if (label, inst) not in codes:
                notes.append(f"{inst}: no SASS")
                continue
            copies_a_thread = cdiv(rows * d // 4, warps * 32)
            n, note = per_warp(codes[(label, inst)], trips, hmma,
                               copies_a_thread)
            issued += n * blocks * warps
            r = regs.get((label, inst), 0)
            per_sm = blocks_an_sm(r, warps, smem)
            notes.append(f"{inst} x {blocks} blocks of {warps} warps "
                         f"({blocks / (SMS * per_sm):.2f} waves), {trips} "
                         f"trips, {r} registers, {smem} B shared, "
                         f"theoretical occupancy {per_sm} blocks = "
                         f"{per_sm * warps} warps an SM: {note}")
        slots = dev_ms * 1e-3 * mhz * 1e6 * SMS * 4
        print(f"  {kind.upper()} {label} {shape}: {ms:.4f} ms (device "
              f"{dev_ms:.4f} ms at {mhz:.0f} MHz); issue-slot use (estimate) "
              f"{100 * issued / slots:.1f}% ({issued / 1e6:.1f} M warp "
              f"instructions); " + " | ".join(notes), flush=True)

    for shape in shapes:
        b, h, l, dh, masked = shape
        q, k, v, _, bias = inputs(b, h, l, dh, masked, seed=l + dh)
        ref, ref_lse = flash_attention_reference(q, k, v, bias)
        ok = slice(0, b - 1) if masked else slice(None)
        outs = {}
        for r in runners:
            out, lse = r.k2(q, k, v, bias)
            torch.cuda.synchronize()
            err = (out[ok] - ref[ok]).abs().max().item()
            scale = ref[ok].abs().max().item()
            lerr = (lse[ok] - ref_lse[ok]).abs().max().item()
            good = err <= 1e-4 * scale and lerr <= 1e-4 * max(
                1.0, ref_lse[ok].abs().max().item())
            print(f"K2 {r.label} {shape}: max|out-plain| {err:.3g} (max "
                  f"{scale:.3g}), max|lse-plain| {lerr:.3g}: "
                  f"{'ok' if good else 'DISAGREES'}", flush=True)
            outs[r.label] = (out, lse)
        labels = list(outs)
        valid = [l - (37 * i) % l for i in range(b - 1)] + [0] if masked \
            else [l] * b
        lib_mask = None if bias is None else bias[:, None, None, :]
        plain = timed(lambda: flash_attention_reference(q, k, v, bias), 3,
                      False)
        sdpa = timed(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=lib_mask), 10, False)
        bound = k2_bound_ms(b, h, l, dh, valid)
        print(f"  K2 {shape}: plain {plain:.4f} ms, SDPA (f32, additive "
              f"mask) {sdpa:.4f} ms, bound {bound[0]:.4f} ms by {bound[1]} "
              f"(K2's route {bound[5]:.4f})", flush=True)
        for a in labels[1:]:
            print(f"  K2 {labels[0]} vs {a} bitwise equal: "
                  f"{all(torch.equal(x, y) for x, y in zip(outs[labels[0]], outs[a]))}",
                  flush=True)
        del ref, ref_lse, outs
        times = {r.label: [] for r in runners}
        for r in runners + runners[::-1]:
            times[r.label].append(timed(lambda: r.k2(q, k, v, bias), 20,
                                        False))
        for r in runners:
            with SmClock() as clk:
                dev = timed(lambda: r.k2(q, k, v, bias), 200 if l < 1000
                            else 40, True)
            report("k2", r.label, shape, sum(times[r.label]) / 2, dev,
                   clk.mhz)
        del q, k, v
        torch.cuda.empty_cache()

    for shape in shapes3:
        b, h, l, dh, masked = shape
        q, k, v, do, bias = inputs(b, h, l, dh, masked, seed=l + dh + 1)
        out, lse = flash_attention_reference(q, k, v, bias)
        if masked:
            do[-1] = 0.0
        delta = _delta(out, do)
        want = flash_attention_bwd_reference(q, k, v, bias, out, lse, do)
        got = {}
        for r in runners:
            g = r.k3(q, k, v, bias, do, lse, delta)
            again = r.k3(q, k, v, bias, do, lse, delta)
            torch.cuda.synchronize()
            errs = [((x - y).abs().max().item(), y.abs().max().item())
                    for x, y in zip(g, want)]
            good = all(e <= 1e-4 * s for e, s in errs)
            print(f"K3 {r.label} {shape}: " + ", ".join(
                f"{n} {e:.3g} (max {s:.3g})" for n, (e, s) in
                zip(("dq", "dk", "dv"), errs))
                + f"; two runs bitwise equal "
                f"{all(torch.equal(x, y) for x, y in zip(g, again))}: "
                f"{'ok' if good else 'DISAGREES'}", flush=True)
            got[r.label] = g
        del want
        valid = [l - (37 * i) % l for i in range(b - 1)] + [0] if masked \
            else [l] * b
        plain = timed(lambda: flash_attention_bwd_reference(
            q, k, v, bias, out, lse, do), 3, False)
        lq_, lk_, lv_ = (x.detach().clone().requires_grad_()
                         for x in (q, k, v))
        lib_mask = None if bias is None else bias[:, None, None, :]

        def lib_fwd():
            return F.scaled_dot_product_attention(lq_, lk_, lv_,
                                                  attn_mask=lib_mask)

        with torch.no_grad():
            fwd_ms = timed(lib_fwd, 5, False)
        sdpa = timed(lambda: torch.autograd.grad(lib_fwd(), (lq_, lk_, lv_),
                                                 do), 5, False) - fwd_ms
        del lq_, lk_, lv_
        bound = k3_bound_ms(b, h, l, dh, valid)
        print(f"  K3 {shape}: plain {plain:.4f} ms, SDPA backward (f32, "
              f"additive mask) {sdpa:.4f} ms, bound {bound[0]:.4f} ms by "
              f"{bound[1]}", flush=True)
        times = {r.label: [] for r in runners}
        for r in runners + runners[::-1]:
            times[r.label].append(timed(
                lambda: r.k3(q, k, v, bias, do, lse, delta),
                10 if l > 1000 else 20, False))
        for r in runners:
            with SmClock() as clk:
                dev = timed(lambda: r.k3(q, k, v, bias, do, lse, delta),
                            100 if l < 1000 else 10, True)
            report("k3", r.label, shape, sum(times[r.label]) / 2, dev,
                   clk.mhz)
        del q, k, v, do, got
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
