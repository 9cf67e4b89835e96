"""K4 (the fused affine+SiLU+conv3x3) site by site on one H100, and an A/B
of it between two checkouts.

    python3 tools/torch_conv_ab.py --measure <tree> [--fp32]
    python3 tools/torch_conv_ab.py --roots <tree A> <tree B> [--rounds N] [--out FILE]

`--measure` imports that tree's `xdiffusion_tpu_torch`, builds its K4
library (printing ptxas's registers, shared memory and spills), and at
every K4 site of the UNet configs it runs
(`configs/image/mnist/ddpm_32x32_epsilon_discrete.yaml` in bf16: the 44
sites of a batch-64 sampling forward and the 22 conv1 sites of a batch-128
training step; `ddpm_8x8_epsilon.yaml` at batch 64, whose 2x2 maps the
flagship lacks) and at ragged shapes, it holds the kernel against its plain
version (bf16: 4 ulps at the reference's largest value; with --fp32 also
fp32 at 1e-4 of it), runs it twice (bit for bit) and times it, the plain
version, `F.conv2d` on the activated map and the bound, in device ms
(back-to-back calls behind a spin kernel, CUDA events around them). It
prints one JSON line. `--roots` measures A, B, B, A (x --rounds) in separate
processes and prints each site's median device ms per root, and the sums.
Compare two trees only inside one call: cards and hosts differ.
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
PEAK_BF16, PEAK_BYTES = 989e12, 3.35e12
FLAGSHIP = "configs/image/mnist/ddpm_32x32_epsilon_discrete.yaml"
SMALL = "configs/image/mnist/ddpm_8x8_epsilon.yaml"
# (B, H, W, C, Co, residual): ragged tiles (H*W not a multiple of 128 rows,
# a partial last tile), C = 96 (a half chunk), C = 48 and Co = 40.
RAGGED = [(3, 12, 12, 96, 40, True), (2, 8, 8, 48, 40, True), (5, 5, 7, 64, 136, False),
          (3, 33, 20, 32, 64, True), (4, 3, 3, 96, 128, False), (2, 1, 1, 64, 72, True)]


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


def sites_of(root: str, config: str, batch: int, train: bool):
    """[(x shape, Co, residual)] of one UNet forward of `config` in bf16,
    read by hooks on FusedAffineConv; for training, the conv1 sites (conv2
    leaves K4 while dropout is on)."""
    import torch

    from xdiffusion_tpu_torch.config import load_yaml
    from xdiffusion_tpu_torch.diffusion.ddpm import GaussianDiffusion_DDPM
    from xdiffusion_tpu_torch.layers.resnet import FusedAffineConv

    cfg = load_yaml(os.path.join(root, config))
    cfg.diffusion.score_network.params.to_dict()["dtype"] = "bfloat16"
    model = GaussianDiffusion_DDPM(cfg, device="cuda")
    found = []

    def hook(mod, args, kwargs, out):
        res = kwargs.get("residual", args[3] if len(args) > 3 else None)
        found.append((tuple(args[0].shape), mod.kernel.shape[-1], res is not None))

    hooks = [m.register_forward_hook(hook, with_kwargs=True)
             for m in model.score_network().modules() if isinstance(m, FusedAffineConv)]
    size = cfg.diffusion.score_network.params.input_spatial_size
    with torch.inference_mode():
        model.predict_score(torch.zeros((batch, size, size, 1), device="cuda"),
                            {"timestep": torch.zeros((batch,), dtype=torch.long, device="cuda")})
    for h in hooks:
        h.remove()
    return [s for s in found if not (train and s[2])]


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


def measure(root: str, fp32: bool) -> dict:
    sys.path.insert(0, root)
    import torch
    import torch.nn.functional as F

    from xdiffusion_tpu_torch.ops import _build
    from xdiffusion_tpu_torch.ops import fused_resblock as fr

    torch.backends.cudnn.allow_tf32 = False
    logs = _build.build(["affine_silu_conv3x3"], verbose=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    out = {"root": root, "ptxas": ptxas_lines(logs.get("affine_silu_conv3x3", "")),
           "sites": [], "failures": []}

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)

    groups = [("flagship", sites_of(root, FLAGSHIP, 64, False)),
              ("train", sites_of(root, FLAGSHIP, 128, True)),
              ("8x8", sites_of(root, SMALL, 64, False)),
              ("ragged", [((b, h, w, c), co, r) for b, h, w, c, co, r in RAGGED])]
    for group, found in groups:
        counts = {}
        for s in found:
            counts[s] = counts.get(s, 0) + 1
        for (shape, co, has_res), n in counts.items():
            b, h, w, c = shape
            rec = {"set": group, "shape": list(shape), "co": co, "res": has_res, "n": n}
            plan = getattr(fr, "conv_plan", None)
            if plan is not None:
                rec["plan"] = plan(b, h, w, c, co, torch.bfloat16)._asdict()
            a = 1.0 + randn(b, c, scale=0.2)
            off = randn(b, c, scale=0.2)
            bias = randn(co, scale=0.1)
            try:
                for dt in (torch.bfloat16, torch.float32) if fp32 else (torch.bfloat16,):
                    x = randn(b, h, w, c, dtype=dt)
                    kw = randn(3, 3, c, co, dtype=dt, scale=(9 * c) ** -0.5)
                    res = randn(b, h, w, co, dtype=dt) if has_res else None
                    want = fr.affine_silu_conv3x3_plain(x, a, off, kw, bias, res).float()
                    got = fr.affine_silu_conv3x3(x, a, off, kw, bias, res)
                    again = fr.affine_silu_conv3x3(x, a, off, kw, bias, res)
                    torch.cuda.synchronize()
                    top = want.abs().max().item()
                    tol = (1e-4 * max(1.0, top) if dt == torch.float32
                           else 4 * 2.0 ** (math.floor(math.log2(top)) - 7))
                    err = (got.float() - want).abs().max().item()
                    key = "bf16" if dt == torch.bfloat16 else "fp32"
                    rec[f"err_{key}"], rec[f"tol_{key}"] = err, tol
                    rec[f"repeat_{key}"] = bool(torch.equal(got, again))
                    if not (err <= tol and rec[f"repeat_{key}"]):
                        out["failures"].append(f"{group} {shape} Co={co} {key}: err {err:.3e} "
                                               f"tol {tol:.3e} repeat {rec[f'repeat_{key}']}")
                    if dt == torch.bfloat16:
                        y = F.silu(x * a[:, None, None, :].to(dt) + off[:, None, None, :].to(dt))
                        yn, wn, bd = y.permute(0, 3, 1, 2), kw.permute(3, 2, 0, 1), bias.to(dt)
                        rec["ms"] = device_ms(lambda: fr.affine_silu_conv3x3(x, a, off, kw, bias,
                                                                            res))
                        rec["conv2d_ms"] = device_ms(lambda: F.conv2d(yn, wn, bd, padding=1))
                        rec["plain_ms"] = device_ms(
                            lambda: fr.affine_silu_conv3x3_plain(x, a, off, kw, bias, res))
                        nbytes = ((x.numel() + kw.numel() + b * h * w * co * (2 if has_res else 1))
                                  * 2 + (2 * b * c + co) * 4)
                        ops = 2 * b * h * w * 9 * c * co
                        rec["bound_ms"] = max(nbytes / PEAK_BYTES, ops / PEAK_BF16) * 1e3
            except Exception as e:  # a fault poisons the context: report and stop
                out["failures"].append(f"{group} {shape} Co={co}: {type(e).__name__}: {e}"[:400])
                out["sites"].append(rec)
                return out
            out["sites"].append(rec)
    for group in ("flagship", "train", "8x8"):
        mine = [r for r in out["sites"] if r["set"] == group]
        for k in ("ms", "conv2d_ms", "plain_ms", "bound_ms"):
            out[f"{group}_{k}"] = sum(r["n"] * r[k] for r in mine)
    return out


def site_key(r) -> str:
    return f"{r['set']} {tuple(r['shape'])} Co={r['co']}{' +res' if r['res'] else ''}"


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--roots", nargs=2, metavar=("A", "B"))
    p.add_argument("--measure")
    p.add_argument("--fp32", action="store_true", help="also check fp32 (--measure)")
    p.add_argument("--rounds", type=int, default=1, help="A, B, B, A sequences")
    p.add_argument("--out", default="output/torch_conv_ab.json")
    args = p.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_conv_ab: no CUDA device", file=sys.stderr)
        return 2
    if args.measure:
        print(json.dumps(measure(os.path.abspath(args.measure), args.fp32)), flush=True)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    runs = []
    order = (args.roots[0], args.roots[1], args.roots[1], args.roots[0]) * args.rounds
    for i, root in enumerate(order):
        cmd = [sys.executable, os.path.abspath(__file__), "--measure", root]
        if i == 1:
            cmd.append("--fp32")
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
            for k in ("ms", "conv2d_ms", "plain_ms", "bound_ms"):
                med[(root, site_key(site), k)] = statistics.median(m["sites"][i][k] for m in mine)
    first = [r for r in runs if r["root"] == roots[1]][0]
    print(f"K4 device ms per call, medians, on {smi}: A = {args.roots[0]}, B = {args.roots[1]}")
    print(f"  {'site':52} {'n':>3} {'A':>8} {'B':>8} {'B/A':>6} {'conv2d':>8} {'bound':>8} "
          f"{'plain':>8}  plan of B")
    sums = {}
    for site in first["sites"]:
        key = site_key(site)
        a, b = med[(roots[0], key, "ms")], med[(roots[1], key, "ms")]
        c2, bd, pl = (med[(roots[1], key, k)] for k in ("conv2d_ms", "bound_ms", "plain_ms"))
        plan = site.get("plan", {})
        print(f"  {key:52} {site['n']:3d} {a:8.4f} {b:8.4f} {b / a:6.3f} {c2:8.4f} {bd:8.4f} "
              f"{pl:8.4f}  {plan.get('variant', '')} rows={plan.get('tile_rows')} "
              f"img={plan.get('images')} bn={plan.get('bn')} splits={plan.get('splits')}")
        s = sums.setdefault(site["set"], [0.0] * 5)
        for i, v in enumerate((a, b, c2, bd, pl)):
            s[i] += site["n"] * v
    for group, (a, b, c2, bd, pl) in sums.items():
        print(f"  sum {group:48} {a:12.4f} {b:8.4f} {b / a:6.3f} {c2:8.4f} {bd:8.4f} {pl:8.4f}")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": smi, "runs": runs, "sums": sums}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
