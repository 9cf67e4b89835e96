"""K5 and K6 (the streamed attention forward and backward) site by site on
one H100, and an A/B of them between two checkouts.

    python3 tools/torch_flash_ab.py --measure <tree> [--no-time]
    python3 tools/torch_flash_ab.py --roots <tree A> <tree B> [--rounds N] [--out FILE]

`--measure` imports that tree's `xdiffusion_tpu_torch`, builds its K5 and K6
libraries (printing ptxas's registers, shared memory and spills), and at
every K5 and K6 site of the LTX paths (`chip_smoke.py`'s: self- and
cross-attention, 6 heads of 64, at the shipped 8x8x8 grid, batch 4 for K5
and 8 for K6, and at a 16x32x32 grid, 16,384 tokens, batch 1) in fp32 and
bf16, and at ragged shapes (Sq in 1, 63, 65, 200, 1000, Sk in 1 (K5 only), 2, 65, 1000;
head dims 64 and 128), it holds each kernel against its plain version with
`chip_smoke.py`'s tolerances (fp32: 1e-5 of each output's largest value;
bf16: 2 ulps there; lse: 1e-5 relative), runs it twice (bit for bit) and,
unless --no-time, times it, SDPA (its backward for K6) and, on the main
path's sites, the plain version, in device ms (back-to-back calls behind a
spin kernel, CUDA events around them), beside both bounds of fp32 (the CUDA
cores at 67 TFLOP/s, three TF32 products at 494.7) and bf16's. It prints
one JSON line. `--roots` measures A, B, B, A (x --rounds) in separate
processes and prints each site's median device ms per root. Compare two
trees only inside one call: cards and hosts differ.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

SEED = 0
HEADS, D = 6, 64
# Published H100 SXM peaks (dense): bf16 and TF32 tensor cores, fp32 CUDA
# cores, HBM, and the SFUs' exponentials per second.
PEAK_BF16, PEAK_TF32, PEAK_FP32 = 989e12, 494.7e12, 67e12
PEAK_BYTES, PEAK_EXP = 3.35e12, 3.9e12
LONG = 16 * 32 * 32
# (kernel, label, batch, Sq, Sk, sites per forward or training step)
SITES = [("K5", "self 8x8x8", 4, 512, 512, 12), ("K5", "cross 8x8x8", 4, 512, 128, 12),
         ("K5", "self 16x32x32", 1, LONG, LONG, 12), ("K5", "cross 16x32x32", 1, LONG, 128, 12),
         ("K6", "self 8x8x8", 8, 512, 512, 12), ("K6", "cross 8x8x8", 8, 512, 128, 12),
         ("K6", "self 16x32x32", 1, LONG, LONG, 12), ("K6", "cross 16x32x32", 1, LONG, 128, 12)]
# (Sq, Sk) checked at head dims 64 and 128: K5 with one key; K6 with two
# (with one, p = 1 and ds = p (dp - delta) is rounding noise on both sides).
RAGGED = [(sq, sk) for sq in (1, 63, 65, 200, 1000) for sk in (1, 2, 65, 1000)]


def device_ms(fn, iters: int = 20) -> float:
    """Mean device time of fn over `iters` calls queued behind a spin kernel."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    torch.cuda._sleep(int((4 * host_ms + 1) * 2e6))  # ~2 GHz: well past the enqueueing
    ev[1].record()
    for _ in range(iters):
        fn()
    ev[2].record()
    ev[2].synchronize()
    return ev[1].elapsed_time(ev[2]) / iters


def ptxas_lines(log: str):
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            sm = re.search(r"(\d+) bytes smem", line)
            out.append(f"{m.group(1)} regs, smem {sm.group(1) if sm else 0}: {name[:90]}")
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            out.append(f"spills {m.group(1)}/{m.group(2)}: {name[:90]}")
        if "warning" in line.lower():
            out.append(line.strip()[:200])
    return out


def bounds(kernel: str, b: int, sq: int, sk: int, d: int, item: int) -> dict:
    """Least times of one call, ms: bytes (inputs read once, outputs written
    once) over the memory rate; operations over each rate; exponentials."""
    n = b * HEADS
    if kernel == "K5":  # q, k, v read; o, lse written
        nbytes, flops = (2 * sq + 2 * sk) * d * n * item + 4 * n * sq, 4 * n * sq * sk * d
    else:  # q, k, v, o, g, lse read; dq, dk, dv written
        nbytes, flops = (4 * sq + 4 * sk) * d * n * item + 4 * n * sq, 10 * n * sq * sk * d
    out = {"bytes_ms": nbytes / PEAK_BYTES * 1e3, "exp_ms": n * sq * sk / PEAK_EXP * 1e3}
    if item == 4:
        out["cuda_core_ms"] = flops / PEAK_FP32 * 1e3
        out["tf32x3_ms"] = 3 * flops / PEAK_TF32 * 1e3
        ops = min(out["cuda_core_ms"], out["tf32x3_ms"])
    else:
        ops = out["bf16_ms"] = flops / PEAK_BF16 * 1e3
    out["bound_ms"] = max(out["bytes_ms"], out["exp_ms"], ops)
    return out


def kernel_ms(fn, calls: int = 3) -> dict:
    """Device ms a call of each CUDA kernel that fn launches (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key[:60]: e.self_device_time_total / 1e3 / calls for e in prof.key_averages()
            if e.device_type.name == "CUDA" and e.self_device_time_total > 0}


def measure(root: str, timed: bool) -> dict:
    sys.path.insert(0, root)
    import torch
    import torch.nn.functional as F

    from xdiffusion_tpu_torch.ops import _build
    from xdiffusion_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    logs = _build.build(["flash_attention", "flash_attention_bwd"], verbose=True)
    out = {"root": root, "ptxas": [f"{n}: {line}" for n in sorted(logs)
                                   for line in ptxas_lines(logs[n])],
           "sites": [], "failures": []}
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def heads_view(b, s, d, dt):  # (B, H, S, D) views of (B, S, H, D) storage
        return torch.randn((b, s, HEADS, d), generator=gen, device="cuda").to(dt).transpose(1, 2)

    def tol(ref, dt):
        top = ref.float().abs().max().item()
        return (1e-5 * max(1.0, top) if dt == torch.float32
                else 2 * 2.0 ** (math.floor(math.log2(top)) - 7))

    def bwd_plain(q, k, v, o, lse, g, scale):  # head by head: (Sq, Sk) fp32 tensors
        parts = [fa.flash_attention_bwd_plain(*(t[:, i:i + 1] for t in (q, k, v, o, lse, g)),
                                              scale) for i in range(q.shape[1])]
        return tuple(torch.cat(p, dim=1) for p in zip(*parts))

    def one(kernel, label, b, sq, sk, d, dt, n, timed_here):
        rec = {"kernel": kernel, "site": label, "dtype": str(dt)[6:], "b": b, "sq": sq, "sk": sk,
               "d": d, "n": n}
        plan = getattr(fa, "flash_plan", None)
        if plan is not None:
            p = plan(b, HEADS, sq, sk, d, dt, backward=kernel == "K6")
            rec["plan"] = {"variant": p.variant, "splits": p.splits,
                           "grids": [ln.grid for ln in p.launches]}
        scale = d ** -0.5
        q, k, v = heads_view(b, sq, d, dt), heads_view(b, sk, d, dt), heads_view(b, sk, d, dt)
        o, lse = fa.flash_attention(q, k, v, scale)
        errs, tols = [], []
        if kernel == "K5":
            want_o, want_lse = fa.flash_attention_plain(q, k, v, scale)
            again = fa.flash_attention(q, k, v, scale)
            rec["repeat"] = bool(torch.equal(o, again[0]) and torch.equal(lse, again[1]))
            errs.append((o.float() - want_o.float()).abs().max().item())
            tols.append(tol(want_o, dt))
            rec["lse_rel"] = ((lse - want_lse).abs().max() / want_lse.abs().max()).item()
            ok = rec["lse_rel"] <= 1e-5
            fn = lambda: fa.flash_attention(q, k, v, scale)  # noqa: E731
            plain = lambda: fa.flash_attention_plain(q, k, v, scale)  # noqa: E731
            lib = lambda: F.scaled_dot_product_attention(q, k, v, scale=scale)  # noqa: E731
            del want_o, want_lse, again
        else:
            g = heads_view(b, sq, d, dt)
            args = (q, k, v, o, lse, g, scale)
            got = fa.flash_attention_bwd(*args)
            again = fa.flash_attention_bwd(*args)
            rec["repeat"] = all(torch.equal(x, y) for x, y in zip(got, again))
            want = (fa.flash_attention_bwd_plain(*args) if sq * sk <= 512 * 512 * 8
                    else bwd_plain(*args))
            for x, y in zip(got, want):
                errs.append((x.float() - y.float()).abs().max().item())
                tols.append(tol(y, dt))
            ok = True
            del got, again, want
            torch.cuda.empty_cache()
            fn = lambda: fa.flash_attention_bwd(*args)  # noqa: E731
            plain = (lambda: fa.flash_attention_bwd_plain(*args))  # noqa: E731
            qh, kh, vh = (t.detach().clone().requires_grad_() for t in (q, k, v))
            sdpa = F.scaled_dot_product_attention(qh, kh, vh, scale=scale)
            lib = lambda: torch.autograd.grad(sdpa, (qh, kh, vh), g, retain_graph=True)  # noqa
        torch.cuda.synchronize()
        rec["err"], rec["tol"] = errs, tols
        ok = ok and rec["repeat"] and all(e <= t for e, t in zip(errs, tols))
        if not ok:
            out["failures"].append(f"{kernel} {label} {rec['dtype']} B={b} Sq={sq} Sk={sk} D={d}: "
                                   f"err {errs} tol {tols} lse {rec.get('lse_rel')} "
                                   f"repeat {rec['repeat']}")
        if timed_here:
            iters = 20 if sq * sk <= 512 * 512 else 4
            rec["ms"] = device_ms(fn, iters)
            rec["sdpa_ms"] = device_ms(lib, iters)
            if sq * sk <= 512 * 512:
                rec["plain_ms"] = device_ms(plain, iters)
            rec.update(bounds(kernel, b, sq, sk, d, 4 if dt == torch.float32 else 2))
            rec["by_kernel"] = kernel_ms(fn)
        return rec

    try:
        for d in (64, 128):
            for sq, sk in RAGGED:
                for dt in (torch.float32, torch.bfloat16):
                    for kernel in ("K5", "K6") if sk > 1 else ("K5",):
                        out["sites"].append(one(kernel, "ragged", 3, sq, sk, d, dt, 0, False))
        for kernel, label, b, sq, sk, n in SITES:
            for dt in (torch.float32, torch.bfloat16):
                out["sites"].append(one(kernel, label, b, sq, sk, D, dt, n, timed))
                torch.cuda.empty_cache()
    except Exception as e:  # a fault poisons the context: report and stop
        out["failures"].append(f"{type(e).__name__}: {e}"[:600])
    return out


def site_key(r) -> str:
    return f"{r['kernel']} {r['site']} {r['dtype']} B={r['b']} Sq={r['sq']} Sk={r['sk']}"


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--roots", nargs=2, metavar=("A", "B"))
    p.add_argument("--measure")
    p.add_argument("--no-time", action="store_true", help="check only (--measure)")
    p.add_argument("--rounds", type=int, default=1, help="A, B, B, A sequences")
    p.add_argument("--out", default="output/torch_flash_ab.json")
    args = p.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_flash_ab: no CUDA device", file=sys.stderr)
        return 2
    if args.measure:
        print(json.dumps(measure(os.path.abspath(args.measure), not args.no_time)), flush=True)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    runs = []
    for root in (args.roots[0], args.roots[1], args.roots[1], args.roots[0]) * args.rounds:
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--measure", root],
                             capture_output=True, text=True, timeout=1200)
        lines = res.stdout.strip().splitlines()
        if res.returncode != 0 or not lines:
            print(res.stdout[-4000:] + res.stderr[-4000:], file=sys.stderr)
            return 1
        run = json.loads(lines[-1])
        runs.append(run)
        for f in run["failures"]:
            print(f"  FAILED {os.path.basename(root)}: {f}")
        if run["failures"]:
            return 1
    roots = [os.path.abspath(r) for r in args.roots]
    for line in [r for r in runs if r["root"] == roots[1]][0]["ptxas"]:
        print(f"  ptxas B: {line}")
    timed = {}
    for run in runs:
        for site in run["sites"]:
            if "ms" in site:
                timed.setdefault((run["root"], site_key(site)), []).append(site)
    first = [s for s in [r for r in runs if r["root"] == roots[1]][0]["sites"] if "ms" in s]
    print(f"K5 and K6 device ms per call, medians, on {smi}: A = {args.roots[0]}, "
          f"B = {args.roots[1]}; bound: fp32 the smaller of the CUDA cores' and three TF32 "
          f"products', bf16 the tensor cores'")
    print(f"  {'site':46} {'A':>9} {'B':>9} {'A/B':>6} {'SDPA':>9} {'bound':>8} {'fp32 CUDA':>9} "
          f"{'3xTF32':>8} {'plain':>8}  plan of B")
    sums = {}
    for site in first:
        key = site_key(site)
        med = {r: {k: statistics.median(s[k] for s in timed[(r, key)])
                   for k in ("ms", "sdpa_ms")} for r in roots}
        a, b = med[roots[0]]["ms"], med[roots[1]]["ms"]
        plan = site.get("plan", {})
        nan = float("nan")
        print(f"  {key:46} {a:9.4f} {b:9.4f} {a / b:6.2f} {med[roots[1]]['sdpa_ms']:9.4f} "
              f"{site['bound_ms']:8.4f} {site.get('cuda_core_ms', nan):9.4f} "
              f"{site.get('tf32x3_ms', nan):8.4f} {site.get('plain_ms', nan):8.4f}"
              f"  {plan.get('variant', '')} splits={plan.get('splits', '')}")
        if site["b"] > 1:  # the main path: n sites a forward (K5) or step (K6)
            s = sums.setdefault(f"{site['kernel']} {site['dtype']} main path, x{site['n']} each",
                                [0.0] * 4)
            for i, x in enumerate((a, b, med[roots[1]]["sdpa_ms"], site["bound_ms"])):
                s[i] += site["n"] * x
    for label, (a, b, sdpa, bd) in sums.items():
        print(f"  sum {label:42} {a:9.4f} {b:9.4f} {a / b:6.2f} {sdpa:9.4f} {bd:8.4f}")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": smi, "runs": runs, "sums": sums}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
