"""K3 (the fused GroupNorm+SiLU) site by site on one H100, and an A/B of it
between two checkouts.

    python3 tools/torch_gn_ab.py --measure <tree> [--no-time]
    python3 tools/torch_gn_ab.py --roots <tree A> <tree B> [--rounds N] [--out FILE]
    python3 tools/torch_gn_ab.py --sweep <tree>

`--measure` imports that tree's `xdiffusion_tpu_torch`, builds its K3
library (printing ptxas's registers, shared memory and spills), and at
every K3 site of the flagship UNet
(`configs/image/mnist/ddpm_32x32_epsilon_discrete.yaml` in bf16: the 7 sites
of a batch-64 sampling forward and of a batch-128 training step's forward),
of `ddpm_8x8_epsilon.yaml` at batch 64, and at ragged shapes, it holds the
kernel against its plain version in bf16 (1 ulp at the reference's largest
value) and fp32 (1e-4) and runs it twice (bit for bit). At the UNet sites
it times, in device ms, the kernel with L2 warm (back-to-back calls behind
a spin kernel, CUDA events around them) and cold (a buffer of twice the L2
written before each call, outside the events), `F.group_norm` (+ `F.silu`)
on the channels-last NCHW view the same two ways, and the bound (one read
and one write of x at 3.35 TB/s). It prints one JSON line. `--roots`
measures A, B, B, A (x --rounds) in separate processes and prints each
site's median times per root, each set's sums and the plan B chose. Compare
two trees only inside one call: cards and hosts differ.
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
PEAK_FP32, PEAK_BYTES = 67e12, 3.35e12
FLAGSHIP = "configs/image/mnist/ddpm_32x32_epsilon_discrete.yaml"
SMALL = "configs/image/mnist/ddpm_8x8_epsilon.yaml"
# (x shape, groups, SiLU): the stream variant (C = 4 and C = 12 with
# scalar loads, slabs that no cluster of 8 stages), C = 48 (a vector
# spanning two groups), 7x7 maps (rows split unevenly), one pixel, wide C,
# and each cluster size.
RAGGED = [((2, 5, 5, 4), 1, True), ((3, 7, 7, 12), 3, False), ((3, 7, 7, 48), 12, True),
          ((2, 1, 1, 1024), 32, False), ((1, 128, 128, 128), 32, True),
          ((2, 64, 64, 512), 32, False), ((1, 16, 16, 256), 32, True),
          ((16, 32, 32, 64), 16, False), ((5, 9, 9, 2048), 32, True),
          ((130, 4, 4, 256), 32, False)]


def device_ms(fn, iters: int = 20) -> float:
    """Mean device time of fn over `iters` calls queued behind a spin kernel."""
    import torch

    for _ in range(3):
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


def cold_ms(fn, flush, iters: int = 10) -> float:
    """Mean device time of one call of fn with L2 cold: `flush` (twice the
    L2) is written before each call, outside the CUDA events around it; all
    of it queued behind a spin kernel."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        flush.fill_(1.0)
        fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in range(iters)]
    torch.cuda._sleep(int((4 * host_ms + 1) * 2e6))
    for start, end in ev:
        flush.fill_(1.0)
        start.record()
        fn()
        end.record()
    ev[-1][1].synchronize()
    return sum(s.elapsed_time(e) for s, e in ev) / iters


def sites_of(root: str, config: str, batch: int):
    """[(x shape, groups, silu)] of one UNet forward of `config` in bf16,
    read by hooks on FastGroupNorm's K3 form."""
    import torch

    from xdiffusion_tpu_torch.config import load_yaml
    from xdiffusion_tpu_torch.diffusion.ddpm import GaussianDiffusion_DDPM
    from xdiffusion_tpu_torch.layers.resnet import FastGroupNorm

    cfg = load_yaml(os.path.join(root, config))
    cfg.diffusion.score_network.params.to_dict()["dtype"] = "bfloat16"
    model = GaussianDiffusion_DDPM(cfg, device="cuda")
    found = []

    def hook(mod, args, kwargs, out):
        if not kwargs.get("return_coefficients") and kwargs.get("t_scale") is None:
            found.append((tuple(args[0].shape), mod.num_groups, mod.silu))

    hooks = [m.register_forward_hook(hook, with_kwargs=True)
             for m in model.score_network().modules() if isinstance(m, FastGroupNorm)]
    size = cfg.diffusion.score_network.params.input_spatial_size
    with torch.inference_mode():
        model.predict_score(torch.zeros((batch, size, size, 1), device="cuda"),
                            {"timestep": torch.zeros((batch,), dtype=torch.long, device="cuda")})
    for h in hooks:
        h.remove()
    return found


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
        if m and name and (m.group(1) != "0" or m.group(2) != "0"):
            out.append(f"spills {m.group(1)}/{m.group(2)}: {name[:90]}")
    return out


def measure(root: str, timed: bool) -> dict:
    sys.path.insert(0, root)
    import torch
    import torch.nn.functional as F

    from xdiffusion_tpu_torch.ops import _build
    from xdiffusion_tpu_torch.ops import group_norm as gn

    logs = _build.build(["group_norm_silu"], verbose=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    out = {"root": root, "ptxas": ptxas_lines(logs.get("group_norm_silu", "")),
           "sites": [], "failures": []}
    l2 = torch.cuda.get_device_properties(0).L2_cache_size
    flush = torch.empty(2 * l2 // 4 + 1, dtype=torch.float32, device="cuda")

    def randn(*shape, dtype=torch.float32, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale + shift).to(dtype)

    groups = [("flagship", sites_of(root, FLAGSHIP, 64)),
              ("train", sites_of(root, FLAGSHIP, 128)),
              ("8x8", sites_of(root, SMALL, 64)),
              ("ragged", RAGGED)]
    for group, found in groups:
        counts = {}
        for s in found:
            counts[s] = counts.get(s, 0) + 1
        for (shape, ng, silu), n in counts.items():
            c = shape[-1]
            hw = math.prod(shape[1:-1])
            rec = {"set": group, "shape": list(shape), "groups": ng, "silu": silu, "n": n}
            plan = getattr(gn, "gn_plan", None)
            if plan is not None:
                rec["plan"] = {str(dt)[6:]: plan(shape[0], hw, c, ng, dt)._asdict()
                               for dt in (torch.bfloat16, torch.float32)}
            scale, bias = randn(c, scale=0.1, shift=1.0), randn(c, scale=0.1)
            try:
                for dt in (torch.bfloat16, torch.float32):
                    x = randn(*shape, dtype=dt, scale=2.0, shift=0.5)
                    want = gn.group_norm_silu_plain(x, scale, bias, ng, 1e-5, silu).float()
                    got = gn.group_norm_silu(x, scale, bias, ng, 1e-5, silu)
                    again = gn.group_norm_silu(x, scale, bias, ng, 1e-5, silu)
                    torch.cuda.synchronize()
                    top = want.abs().max().item()
                    tol = (1e-4 if dt == torch.float32
                           else 2.0 ** (math.floor(math.log2(top)) - 7))
                    err = (got.float() - want).abs().max().item()
                    key = "bf16" if dt == torch.bfloat16 else "fp32"
                    rec[f"err_{key}"], rec[f"tol_{key}"] = err, tol
                    rec[f"repeat_{key}"] = bool(torch.equal(got, again))
                    if not (err <= tol and rec[f"repeat_{key}"]):
                        out["failures"].append(f"{group} {shape} {key}: err {err:.3e} "
                                               f"tol {tol:.3e} repeat {rec[f'repeat_{key}']}")
                    if dt != torch.bfloat16 or group == "ragged" or not timed:
                        continue
                    xn = x.permute(0, 3, 1, 2)  # channels-last NCHW view, no copy
                    sd, bd = scale.to(dt), bias.to(dt)
                    if silu:
                        lib = lambda: F.silu(F.group_norm(xn, ng, sd, bd, 1e-5), inplace=True)
                    else:
                        lib = lambda: F.group_norm(xn, ng, sd, bd, 1e-5)
                    kern = lambda: gn.group_norm_silu(x, scale, bias, ng, 1e-5, silu)
                    rec["ms"], rec["cold_ms"] = device_ms(kern), cold_ms(kern, flush)
                    rec["library_ms"], rec["library_cold_ms"] = device_ms(lib), cold_ms(lib, flush)
                    nbytes = 2 * x.numel() * x.element_size() + 2 * c * 4
                    rec["bound_ms"] = max(nbytes / PEAK_BYTES, 10 * x.numel() / PEAK_FP32) * 1e3
            except Exception as e:  # a fault poisons the context: report and stop
                out["failures"].append(f"{group} {shape}: {type(e).__name__}: {e}"[:400])
                out["sites"].append(rec)
                return out
            out["sites"].append(rec)
    if timed:
        for group in ("flagship", "train", "8x8"):
            mine = [r for r in out["sites"] if r["set"] == group]
            for k in ("ms", "cold_ms", "library_ms", "library_cold_ms", "bound_ms"):
                out[f"{group}_{k}"] = sum(r["n"] * r[k] for r in mine)
    return out


def sweep(root: str) -> None:
    """Every geometry gn_plan could name (variant, k, threads, pieces) at the
    flagship's bf16 sites at batch 64 and 128 and at one pixel: each checked
    against the plain version (1 ulp) and timed warm and cold beside the
    plan's own choice and a one-element add (the launch floor)."""
    sys.path.insert(0, root)
    import torch

    from xdiffusion_tpu_torch.ops import group_norm as gn

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    l2 = torch.cuda.get_device_properties(0).L2_cache_size
    flush = torch.empty(2 * l2 // 4 + 1, dtype=torch.float32, device="cuda")
    one = torch.zeros(1, device="cuda")
    print(f"floor: a one-element add {device_ms(lambda: one.add_(1.0)):.4f} ms warm, "
          f"{cold_ms(lambda: one.add_(1.0), flush):.4f} cold")
    for b, hw, c, silu in ((64, 256, 256, False), (64, 16, 256, False), (64, 1024, 128, True),
                           (128, 256, 256, False), (128, 1024, 128, True), (1, 1, 256, False)):
        x = (torch.randn((b, hw, c), generator=gen, device="cuda") * 2 + 0.5).to(torch.bfloat16)
        scale = 1.0 + 0.1 * torch.randn(c, generator=gen, device="cuda")
        bias = 0.1 * torch.randn(c, generator=gen, device="cuda")
        want = gn.group_norm_silu_plain(x, scale, bias, 32, 1e-5, silu).float()
        tol = 2.0 ** (math.floor(math.log2(want.abs().max().item())) - 7)
        chosen = gn.gn_plan(b, hw, c, 32, torch.bfloat16)
        print(f"x ({b}, {hw}, {c}) bf16 silu={silu}; gn_plan: {chosen}")
        for variant in gn.VARIANTS:
            for k in gn.CLUSTERS:
                for threads in (128, 256, 512):
                    for pieces in ((1, 2, 4, 8) if variant == "staged" else (1,)):
                        if k > hw or pieces > hw // k:
                            continue
                        smem = gn.gn_smem(variant, hw, c, 32, 2, k, threads, 8, pieces)
                        if smem > gn.SMEM_LIMIT:
                            continue
                        plan = gn.GnPlan(variant, k, threads, 8, pieces, smem)
                        run = lambda: gn._forward(x, scale, bias, 32, 1e-5, silu, plan)
                        err = (run().float() - want).abs().max().item()
                        mark = "*" if plan == chosen else " "
                        print(f" {mark} {variant:6} k={k} threads={threads:3d} pieces={pieces} "
                              f"smem={smem:6d}: {device_ms(run):.4f} warm "
                              f"{cold_ms(run, flush):.4f} cold, err {err:.2e} "
                              f"{'ok' if err <= tol else 'FAILED'}", flush=True)


def site_key(r) -> str:
    return f"{r['set']} {tuple(r['shape'])} g{r['groups']}{' silu' if r['silu'] else ''}"


KEYS = ("ms", "cold_ms", "library_ms", "library_cold_ms", "bound_ms")


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--roots", nargs=2, metavar=("A", "B"))
    p.add_argument("--measure")
    p.add_argument("--sweep", help="time every plan geometry at the flagship's sites")
    p.add_argument("--no-time", action="store_true", help="checks only (--measure)")
    p.add_argument("--rounds", type=int, default=1, help="A, B, B, A sequences")
    p.add_argument("--out", default="output/torch_gn_ab.json")
    args = p.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_gn_ab: no CUDA device", file=sys.stderr)
        return 2
    if args.sweep:
        sweep(os.path.abspath(args.sweep))
        return 0
    if args.measure:
        print(json.dumps(measure(os.path.abspath(args.measure), not args.no_time)), flush=True)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    runs = []
    order = (args.roots[0], args.roots[1], args.roots[1], args.roots[0]) * args.rounds
    for root in order:
        cmd = [sys.executable, os.path.abspath(__file__), "--measure", root]
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
        lines = res.stdout.strip().splitlines()
        if res.returncode != 0 or not lines:
            print(res.stdout[-4000:] + res.stderr[-4000:], file=sys.stderr)
            return 1
        run = json.loads(lines[-1])
        runs.append(run)
        for line in run["ptxas"]:
            print(f"  ptxas {os.path.basename(root)}: {line}")
        for f in run["failures"]:
            print(f"  FAILED {os.path.basename(root)}: {f}")
        if run["failures"]:
            return 1
    roots = [os.path.abspath(r) for r in args.roots]
    med = {}
    for root in roots:
        mine = [r for r in runs if r["root"] == root]
        for i, site in enumerate(mine[0]["sites"]):
            for k in KEYS:
                if k in site:
                    med[(root, site_key(site), k)] = statistics.median(
                        m["sites"][i][k] for m in mine)
    first = [r for r in runs if r["root"] == roots[1]][0]
    print(f"K3 device ms per call, medians, on {smi}: A = {args.roots[0]}, B = {args.roots[1]}")
    print(f"  {'site':44} {'n':>2} {'A':>7} {'B':>7} {'A/B':>5} {'A cold':>7} {'B cold':>7} "
          f"{'A/B':>5} {'lib':>7} {'lib cold':>8} {'bound':>7} {'cold %':>6}  plan of B (bf16)")
    sums = {}
    for site in first["sites"]:
        key = site_key(site)
        if (roots[1], key, "ms") not in med:
            continue
        a, b = med[(roots[0], key, "ms")], med[(roots[1], key, "ms")]
        ac, bc = med[(roots[0], key, "cold_ms")], med[(roots[1], key, "cold_ms")]
        lib, libc, bd = (med[(roots[1], key, k)] for k in ("library_ms", "library_cold_ms",
                                                          "bound_ms"))
        plan = site.get("plan", {}).get("bfloat16", {})
        print(f"  {key:44} {site['n']:2d} {a:7.4f} {b:7.4f} {a / b:5.2f} {ac:7.4f} {bc:7.4f} "
              f"{ac / bc:5.2f} {lib:7.4f} {libc:8.4f} {bd:7.4f} {100 * bd / bc:5.1f}%  "
              f"{plan.get('variant', '')} k={plan.get('k')} pieces={plan.get('pieces')} "
              f"smem={plan.get('smem')}")
        s = sums.setdefault(site["set"], [0.0] * 7)
        for i, v in enumerate((a, b, ac, bc, lib, libc, bd)):
            s[i] += site["n"] * v
    for group, (a, b, ac, bc, lib, libc, bd) in sums.items():
        print(f"  sum {group:40} {a:10.4f} {b:7.4f} {a / b:5.2f} {ac:7.4f} {bc:7.4f} "
              f"{ac / bc:5.2f} {lib:7.4f} {libc:8.4f} {bd:7.4f} {100 * bd / bc:5.1f}%")
    slower = [site_key(s) for s in first["sites"]
              if s["set"] == "flagship" and med[(roots[1], site_key(s), "ms")]
              >= med[(roots[0], site_key(s), "ms")]]
    print(f"  flagship sites where B is not faster than A (warm): {slower or 'none'}")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": smi, "runs": runs, "sums": sums}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
