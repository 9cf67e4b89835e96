"""A/B of the port's K1 and K2 (the bsc attention forward and backward)
between two checkouts on one H100: their device ms at the flagship UNet's
and the DiT's sites, and the wall time of the host-bound paths they run on.

    python3 tools/torch_bsc_ab.py --roots <tree A> <tree B> [--rounds N] [--out FILE]

Each root is measured in its own process, importing that tree's
`xdiffusion_tpu_torch` (and building its kernels there), in the order A, B,
B, A, repeated --rounds times; each process prints one JSON line. The
script prints every run, each root's median and, per metric, how many of
the A-B pairs B won, and writes them to --out. Comparing two
versions is only meaningful inside one such call: the host's speed sets the
wall times and moves between machines.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

SEED = 0


def device_ms(fn, iters: int = 20) -> float:
    """Mean device time of fn over `iters` calls queued behind a spin kernel
    (CUDA events around them), so the host's dispatch gaps do not count."""
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


def measure(root: str) -> dict:
    sys.path.insert(0, root)
    import torch

    from xdiffusion_tpu_torch.config import load_yaml
    from xdiffusion_tpu_torch.diffusion.ddpm import GaussianDiffusion_DDPM
    from xdiffusion_tpu_torch.ops import _build
    from xdiffusion_tpu_torch.ops import flash_attention as fa
    from xdiffusion_tpu_torch.optim import default_optimizer
    from xdiffusion_tpu_torch.samplers.ddim import DDIMSampler
    from xdiffusion_tpu_torch.train_step import create_train_state, make_train_step
    from xdiffusion_tpu_torch.weights import randomize_

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build(["bsc_attention", "bsc_attention_bwd"])
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    out = {"root": root}

    def site(b, s, c, heads, dt):
        q, k, v = torch.randn((b, s, 3 * c), generator=gen, device="cuda").to(dt).chunk(3, -1)
        g = torch.randn((b, s, c), generator=gen, device="cuda").to(dt)
        scale = (c // heads) ** -0.5
        return (device_ms(lambda: fa.short_attention_bsc(q, k, v, heads, scale)),
                device_ms(lambda: fa.short_attention_bsc_bwd(q, k, v, g, heads, scale)))

    bf16, fp32 = torch.bfloat16, torch.float32
    # The flagship's 6 attention sites: 5 at 16x16 (S 256), 1 at 4x4 (S 16).
    out["k1_flagship_forward_ms"] = (5 * site(64, 256, 256, 4, bf16)[0]
                                     + site(64, 16, 256, 4, bf16)[0])
    out["k2_flagship_step_ms"] = (5 * site(128, 256, 256, 4, bf16)[1]
                                  + site(128, 16, 256, 4, bf16)[1])
    for name, dt in (("fp32", fp32), ("bf16", bf16)):
        k1, k2 = site(128, 16, 384, 6, dt)
        out[f"k1_dit_{name}_ms"], out[f"k2_dit_{name}_ms"] = k1, k2

    def build(path, dtype=None):
        config = load_yaml(os.path.join(root, path))
        if dtype:
            config.diffusion.score_network.params.to_dict()["dtype"] = dtype
        model = GaussianDiffusion_DDPM(config, device="cuda")
        randomize_(model.score_network(), SEED)
        return model

    def wall(fn, reps):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps

    dit = build("configs/image/mnist/dit.yaml")
    classes = torch.arange(64, device="cuda") % 10
    out["dit_guided_samples_per_s"] = 64 / wall(lambda: dit.sample(
        num_samples=64, context={"classes": classes}, classifier_free_guidance=1.0,
        num_sampling_steps=200, generator=torch.Generator(device="cuda").manual_seed(SEED)),
        2) * 200 / 1000  # per 1000-step sample, as chip_smoke.py reports it

    def steps_per_s(model, batch):
        state = create_train_state(model, default_optimizer().build(
            model.score_network().parameters()), seed=SEED)
        step = make_train_step(model)
        for _ in range(5):
            step(state, batch)
        return 1.0 / wall(lambda: step(state, batch)["loss"].item(), 20)

    out["dit_train_steps_per_s"] = steps_per_s(
        dit, {"images": torch.rand((128, 32, 32, 1), device="cuda"),
              "classes": torch.arange(128, device="cuda") % 10})
    del dit
    unet = build("configs/image/mnist/ddpm_32x32_epsilon_discrete.yaml", "bfloat16")
    out["flagship_ddim_samples_per_s"] = 64 / wall(lambda: unet.sample(
        num_samples=64, num_sampling_steps=50, sampler=DDIMSampler(),
        generator=torch.Generator(device="cuda").manual_seed(SEED)), 2)
    out["flagship_train_steps_per_s"] = steps_per_s(
        unet, {"images": torch.rand((128, 32, 32, 1), device="cuda")})
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--roots", nargs=2, metavar=("A", "B"))
    p.add_argument("--measure", help=argparse.SUPPRESS)
    p.add_argument("--rounds", type=int, default=1, help="A, B, B, A sequences")
    p.add_argument("--out", default="output/torch_bsc_ab.json")
    args = p.parse_args()
    if args.measure:
        print(json.dumps(measure(os.path.abspath(args.measure))), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("torch_bsc_ab: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    runs = []
    for root in (args.roots[0], args.roots[1], args.roots[1], args.roots[0]) * args.rounds:
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--measure", root],
                             capture_output=True, text=True, timeout=900)
        if res.returncode != 0:
            print(res.stdout + res.stderr, file=sys.stderr)
            return 1
        runs.append(json.loads(res.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    import statistics

    by_root = [[r for r in runs if r["root"] == os.path.abspath(root)] for root in args.roots]
    median = {root: {k: statistics.median(r[k] for r in mine) for k in mine[0] if k != "root"}
              for root, mine in zip(args.roots, by_root)}
    a, b = (median[r] for r in args.roots)
    # Pairs: each A run with the B run next to it (A B | B A per round).
    pairs = list(zip(by_root[0], by_root[1]))
    lower_is_better = lambda k: k.endswith("_ms")
    print(f"{'metric':32} {'A median':>10} {'B median':>10} {'B/A':>7} {'B wins':>7}   on {smi}")
    wins = {}
    for k in a:
        wins[k] = sum((pb[k] < pa[k]) if lower_is_better(k) else (pb[k] > pa[k])
                      for pa, pb in pairs)
        print(f"{k:32} {a[k]:10.4f} {b[k]:10.4f} {b[k] / a[k]:7.3f} {wins[k]:>3}/{len(pairs)}")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": smi, "runs": runs, "median": median, "b_wins": wins,
                   "pairs": len(pairs)}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
