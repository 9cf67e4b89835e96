"""Drives the PyTorch port's main path on one NVIDIA H100 and checks it.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. Set-up: the card's name and power limit; nvcc builds every kernel of
   the port from `xdiffusion_tpu_torch/csrc/` (one process per source).
2. Kernels: each hand-written kernel (K1 attention, K3 GroupNorm+SiLU,
   K4 affine+SiLU+conv3x3) against its plain PyTorch version on the card,
   in fp32 and bf16, at every shape the flagship UNet gives it at batch 64,
   with the tolerance stated beside it; then its time, the plain version's,
   one PyTorch library call's where one computes the same function, and the
   least time the card could take (`bound`), all summed over one forward.
3. Main path: the flagship config (configs/image/mnist/ddpm_32x32_epsilon_
   discrete.yaml) at full width in bf16 with seeded random weights,
   50-step DDIM at batch 64 through `GaussianDiffusion_DDPM.sample`, with
   the launches of each kernel counted over that one run; a few steps of
   the config's default ancestral sampler; and the sampling CLI
   (`python -m xdiffusion_tpu_torch.sample`) on a saved checkpoint.
4. Card against CPU: fp32, batch 4, 10 DDIM and 10 ancestral steps with
   the same weights and injected noise, the card's kernels against the
   CPU's plain versions.

The last two lines are the card's `nvidia-smi` name and power limit and
`{"ok": true, "device": {...}}`; the JSON line before them lists the
kernels. Without a CUDA device, or without the repository beside it, the
script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

CONFIG = os.path.join(ROOT, "configs/image/mnist/ddpm_32x32_epsilon_discrete.yaml")
DDIM_CONFIG = os.path.join(ROOT, "configs/image/mnist/samplers/ddim.yaml")
OUT_DIR = os.path.join(ROOT, "output", "chip_smoke")
BATCH, STEPS, SEED = 64, 50, 0
MIN_LAUNCHES = {"bsc_attention": 300, "group_norm_silu": 350, "affine_silu_conv3x3": 2200}
# Published H100 SXM peaks (dense): bf16 tensor cores, fp32 CUDA cores, HBM.
PEAK_BF16, PEAK_FP32, PEAK_BYTES = 989e12, 67e12, 3.35e12
REPLACES = {
    "bsc_attention": "xdiffusion_tpu/ops/flash_attention.py:266",
    "group_norm_silu": "xdiffusion_tpu/ops/group_norm.py:29",
    "affine_silu_conv3x3": "xdiffusion_tpu/ops/fused_resblock.py:62",
}


class PhaseError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn over `iters` launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bf16_tol(ref: torch.Tensor, ulps: int) -> float:
    """`ulps` units in the last place of bf16 (2^-7 relative) at the
    reference's largest magnitude (at least 1)."""
    return ulps * 2.0 ** -7 * max(1.0, ref.float().abs().max().item())


def build_model(dtype: str, device: str):
    from xdiffusion_tpu_torch.config import load_yaml
    from xdiffusion_tpu_torch.diffusion.ddpm import GaussianDiffusion_DDPM
    from xdiffusion_tpu_torch.weights import randomize_

    config = load_yaml(CONFIG)
    config.diffusion.score_network.params.to_dict()["dtype"] = dtype
    model = GaussianDiffusion_DDPM(config, device=device)
    randomize_(model.score_network(), SEED)
    return model


def main_path_sites(model):
    """The kernel call sites of one UNet forward, with their input shapes at
    batch BATCH, read by hooks on the modules that call the kernels."""
    from xdiffusion_tpu_torch.layers.attention import SpatialCrossAttention
    from xdiffusion_tpu_torch.layers.resnet import FastGroupNorm, FusedAffineConv

    sites = {"bsc_attention": [], "group_norm_silu": [], "affine_silu_conv3x3": []}

    def on_attn(mod, args, kwargs, out):
        b, h, w, c = args[0].shape
        sites["bsc_attention"].append((b, h * w, c, mod.num_heads))

    def on_norm(mod, args, kwargs, out):
        if not kwargs.get("return_coefficients") and kwargs.get("t_scale") is None:
            sites["group_norm_silu"].append((tuple(args[0].shape), mod.num_groups, mod.silu))

    def on_conv(mod, args, kwargs, out):
        res = kwargs.get("residual", args[3] if len(args) > 3 else None)
        sites["affine_silu_conv3x3"].append(
            (tuple(args[0].shape), mod.kernel.shape[-1], res is not None))

    hooks = []
    for m in model.score_network().modules():
        fn = {SpatialCrossAttention: on_attn, FastGroupNorm: on_norm,
              FusedAffineConv: on_conv}.get(type(m))
        if fn is not None:
            hooks.append(m.register_forward_hook(fn, with_kwargs=True))
    x = torch.zeros((BATCH, 32, 32, 1), device="cuda")
    t = torch.zeros((BATCH,), dtype=torch.long, device="cuda")
    with torch.inference_mode():
        model.predict_score(x, {"timestep": t})
    for h in hooks:
        h.remove()
    return sites


def counted(sites):
    """{shape: number of sites} in first-seen order."""
    out = {}
    for s in sites:
        out[s] = out.get(s, 0) + 1
    return out


def compare(label: str, got: torch.Tensor, want: torch.Tensor, tol: float) -> float:
    """max |kernel - plain|, logged beside its tolerance; fails the phase above it."""
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    log(f"{label}: max|kernel-plain|={err:.3e} tol={tol:.3e}")
    check(err <= tol, f"{label}: error {err} > {tol}")
    return err


def account(rec, n: int, kernel, plain, library, nbytes: int, ops: int, peak_ops: float):
    """Times one site shape (kernel, plain version, library call) and adds n
    sites' worth to the kernel's per-forward record, with the bound: the
    larger of nbytes over the card's memory rate and ops over `peak_ops`."""
    k_ms, p_ms, l_ms = time_ms(kernel), time_ms(plain), time_ms(library)
    bytes_ms, ops_ms = nbytes / PEAK_BYTES * 1e3, ops / peak_ops * 1e3
    log(f"  x{n} sites: kernel {k_ms:.4f} ms ({ops / k_ms / 1e9:.1f} TOP/s, "
        f"{nbytes / k_ms / 1e6:.0f} GB/s), plain {p_ms:.4f} ms, library {l_ms:.4f} ms, "
        f"bound {max(bytes_ms, ops_ms):.4f} ms")
    for key, v in (("ms", k_ms), ("plain_ms", p_ms), ("library_ms", l_ms),
                   ("bytes_ms", bytes_ms), ("ops_ms", ops_ms),
                   ("bound_ms", max(bytes_ms, ops_ms))):
        rec[key] += n * v


def phase_kernels(sites):
    """Each kernel against its plain version at the main path's shapes, fp32
    and bf16; returns the per-kernel JSON records (bf16 times, per forward)."""
    from xdiffusion_tpu_torch.ops import flash_attention, fused_resblock, group_norm

    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)

    def new_record():
        return dict.fromkeys(("ms", "plain_ms", "library_ms", "bytes_ms", "ops_ms",
                              "bound_ms", "err"), 0.0)

    records = []

    # ---- K1: fp32 exact but for summation order; bf16 2 ulps ------------
    rec = new_record()
    for (b, s, c, heads), n in counted(sites["bsc_attention"]).items():
        d = c // heads
        for dt in (torch.float32, torch.bfloat16):
            qkv = randn(b, s, 3 * c, dtype=dt)  # q, k, v as the qkv Dense's slices
            q, k, v = qkv.chunk(3, dim=-1)
            want = flash_attention.short_attention_bsc_plain(q, k, v, heads, d ** -0.5)
            err = compare(f"K1 bsc_attention B={b} S={s} C={c} heads={heads} {dt}",
                          flash_attention.short_attention_bsc(q, k, v, heads, d ** -0.5),
                          want, 1e-4 if dt == torch.float32 else bf16_tol(want, 2))
        rec["err"] = max(rec["err"], err)
        qh, kh, vh = (t.reshape(b, s, heads, d).transpose(1, 2).contiguous()
                      for t in (q, k, v))
        account(rec, n,
                lambda: flash_attention.short_attention_bsc(q, k, v, heads, d ** -0.5),
                lambda: flash_attention.short_attention_bsc_plain(q, k, v, heads, d ** -0.5),
                lambda: F.scaled_dot_product_attention(qh, kh, vh),
                nbytes=4 * b * s * c * 2, ops=4 * b * s * s * c, peak_ops=PEAK_BF16)
    records.append(("bsc_attention", flash_attention.KERNEL, rec))

    # ---- K3: fp32 exact but for summation order; bf16 1 ulp -------------
    rec = new_record()
    for (shape, groups, silu), n in counted(sites["group_norm_silu"]).items():
        c = shape[-1]
        scale, bias = 1.0 + randn(c, scale=0.1), randn(c, scale=0.1)
        for dt in (torch.float32, torch.bfloat16):
            x = randn(*shape, dtype=dt, scale=2.0) + 0.5
            want = group_norm.group_norm_silu_plain(x, scale, bias, groups, 1e-5, silu)
            err = compare(f"K3 group_norm_silu {shape} groups={groups} silu={silu} {dt}",
                          group_norm.group_norm_silu(x, scale, bias, groups, 1e-5, silu),
                          want, 1e-4 if dt == torch.float32 else bf16_tol(want, 1))
        rec["err"] = max(rec["err"], err)
        xn = x.permute(0, 3, 1, 2)
        sd, bd = scale.to(dt), bias.to(dt)
        if silu:  # no single call: F.group_norm, then F.silu in place
            lib = lambda: F.silu(F.group_norm(xn, groups, sd, bd, 1e-5), inplace=True)
        else:
            lib = lambda: F.group_norm(xn, groups, sd, bd, 1e-5)
        account(rec, n,
                lambda: group_norm.group_norm_silu(x, scale, bias, groups, 1e-5, silu),
                lambda: group_norm.group_norm_silu_plain(x, scale, bias, groups, 1e-5, silu),
                lib, nbytes=2 * x.numel() * 2 + 2 * c * 4, ops=10 * x.numel(),
                peak_ops=PEAK_FP32)
    records.append(("group_norm_silu", group_norm.KERNEL, rec))

    # ---- K4: fp32 sums K = 9*C products in another order; in bf16 the
    # plain version rounds the activation at each of its three elementwise
    # steps, the kernel once: 4 ulps ----------------------------------------
    rec = new_record()
    for (shape, co, has_res), n in counted(sites["affine_silu_conv3x3"]).items():
        b, h, w, c = shape
        a = 1.0 + randn(b, c, scale=0.2)
        off = randn(b, c, scale=0.2)
        bias = randn(co, scale=0.1)
        for dt in (torch.float32, torch.bfloat16):
            x = randn(b, h, w, c, dtype=dt)
            kw = randn(3, 3, c, co, dtype=dt, scale=(9 * c) ** -0.5)
            res = randn(b, h, w, co, dtype=dt) if has_res else None
            want = fused_resblock.affine_silu_conv3x3_plain(x, a, off, kw, bias, res)
            tol = (1e-4 * max(1.0, want.float().abs().max().item())
                   if dt == torch.float32 else bf16_tol(want, 4))
            err = compare(f"K4 affine_silu_conv3x3 x={shape} Co={co} residual={has_res} {dt}",
                          fused_resblock.affine_silu_conv3x3(x, a, off, kw, bias, res),
                          want, tol)
        rec["err"] = max(rec["err"], err)
        y = F.silu(x * a[:, None, None, :].to(dt) + off[:, None, None, :].to(dt))
        yn = y.permute(0, 3, 1, 2)  # channels-last NCHW view, no copy
        wn, bd = kw.permute(3, 2, 0, 1), bias.to(dt)
        account(rec, n,
                lambda: fused_resblock.affine_silu_conv3x3(x, a, off, kw, bias, res),
                lambda: fused_resblock.affine_silu_conv3x3_plain(x, a, off, kw, bias, res),
                lambda: F.conv2d(yn, wn, bd, padding=1),
                nbytes=(x.numel() + kw.numel() + b * h * w * co * (2 if has_res else 1)) * 2
                + (2 * b * c + co) * 4,
                ops=2 * b * h * w * 9 * c * co, peak_ops=PEAK_BF16)
    # K4's generic path (channel counts that are not multiples of 32 take
    # it; the flagship's never do), checked once off the main path.
    x = randn(2, 8, 8, 48, dtype=torch.bfloat16)
    kw = randn(3, 3, 48, 40, dtype=torch.bfloat16, scale=(9 * 48) ** -0.5)
    a, off, bias = 1.0 + randn(2, 48, scale=0.2), randn(2, 48, scale=0.2), randn(40)
    res = randn(2, 8, 8, 40, dtype=torch.bfloat16)
    want = fused_resblock.affine_silu_conv3x3_plain(x, a, off, kw, bias, res)
    compare("K4 generic path x=(2, 8, 8, 48) Co=40 bf16",
            fused_resblock.affine_silu_conv3x3(x, a, off, kw, bias, res), want,
            bf16_tol(want, 4))
    records.append(("affine_silu_conv3x3", fused_resblock.KERNEL, rec))
    return records


def phase_main_path(records):
    """50-step DDIM at batch 64 in bf16 with counted launches; ancestral;
    the CLI. Returns launches per kernel and samples/s."""
    from xdiffusion_tpu_torch.ops._build import kernels
    from xdiffusion_tpu_torch.samplers.ddim import DDIMSampler

    model = build_model("bfloat16", "cuda")
    ddim = DDIMSampler()

    def run(seed):
        g = torch.Generator(device="cuda").manual_seed(seed)
        return model.sample(num_samples=BATCH, num_sampling_steps=STEPS, sampler=ddim,
                            generator=g)

    run(SEED)  # warm-up: library autotuning, allocator
    torch.cuda.synchronize()
    ks = kernels()
    for k in ks.values():
        k.launches = 0
    out = run(SEED + 1)
    torch.cuda.synchronize()
    launches = {name: k.launches for name, k in ks.items()}
    log(f"main path: 50-step DDIM, batch {BATCH}, bf16: launches {launches}")
    for name, need in MIN_LAUNCHES.items():
        check(launches[name] >= need, f"{name}: {launches[name]} launches < {need}")
    check(tuple(out.shape) == (BATCH, 32, 32, 1), f"samples shape {tuple(out.shape)}")
    check(bool(torch.isfinite(out).all()), "samples not finite")
    check(out.min().item() >= 0.0 and out.max().item() <= 1.0, "samples outside [0, 1]")
    log(f"samples: mean {out.float().mean().item():.4f} std {out.float().std().item():.4f}")

    reps = 3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(reps):
        out = run(SEED + 2 + i)
    torch.cuda.synchronize()
    sps = BATCH * reps / (time.perf_counter() - t0)
    log(f"main path throughput: {sps:.2f} samples/s (50-step DDIM, batch {BATCH}, bf16)")
    profile_forward(model)

    for k in ks.values():
        k.launches = 0
    g = torch.Generator(device="cuda").manual_seed(SEED)
    anc = model.sample(num_samples=BATCH, num_sampling_steps=5, generator=g)
    torch.cuda.synchronize()
    anc_launches = {name: k.launches for name, k in ks.items()}
    log(f"ancestral (config default sampler), 5 steps: launches {anc_launches}")
    check(all(n > 0 for n in anc_launches.values()), "ancestral run missed a kernel")
    check(bool(torch.isfinite(anc).all()), "ancestral samples not finite")

    # The CLI on a saved port checkpoint (fp32 config as shipped).
    from xdiffusion_tpu_torch import sample as cli

    os.makedirs(OUT_DIR, exist_ok=True)
    ckpt = os.path.join(OUT_DIR, "random_weights.pt")
    torch.save(model.score_network().state_dict(), ckpt)
    samples = cli.main(["--config_path", CONFIG, "--checkpoint", ckpt,
                        "--num_samples", "4", "--sampling_steps", "2",
                        "--sampler_config_path", DDIM_CONFIG,
                        "--output_path", OUT_DIR, "--seed", str(SEED)])
    check(bool(torch.isfinite(samples).all()), "CLI samples not finite")
    check(os.path.getsize(os.path.join(OUT_DIR, "samples.png")) > 0, "CLI wrote no PNG")
    os.remove(ckpt)
    return launches, sps


def profile_forward(model):
    """Device time by kernel for one UNet forward at batch BATCH (the body of
    one denoising step), and the device's busy share of the forward's wall
    time; the full table goes to output/chip_smoke/profile.txt."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn((BATCH, 32, 32, 1), device="cuda")
    t = torch.full((BATCH,), 500, dtype=torch.long, device="cuda")
    with torch.inference_mode():
        for _ in range(3):
            model.predict_score(x, {"timestep": t})
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model.predict_score(x, {"timestep": t})
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    log(f"profile of one forward (batch {BATCH}, bf16): wall {wall_ms:.3f} ms, device busy "
        f"{device_ms:.3f} ms ({100 * device_ms / wall_ms:.1f}%), "
        f"{sum(e.count for e in events)} device launches")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"  {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<4d} {e.key[:90]}")
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "profile.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total", row_limit=60))


def phase_card_vs_cpu():
    """fp32, batch 4, 10 steps: the card (kernels) against the CPU (plain)."""
    from xdiffusion_tpu_torch.samplers.ancestral import AncestralSampler
    from xdiffusion_tpu_torch.samplers.ddim import DDIMSampler

    n, steps = 4, 10
    rng = np.random.default_rng(SEED)
    init = torch.from_numpy(rng.standard_normal((n, 32, 32, 1)).astype(np.float32))
    noise = torch.from_numpy(rng.standard_normal((steps, n, 32, 32, 1)).astype(np.float32))
    results = {}
    for device in ("cuda", "cpu"):
        model = build_model("float32", device)
        for name, sampler in (("ddim", DDIMSampler()), ("ancestral", AncestralSampler())):
            out = model.sample(num_samples=n, num_sampling_steps=steps, sampler=sampler,
                               initial_noise=init,
                               context={"sampling_noise": noise})
            results[(device, name)] = out.float().cpu()
    # Both sides clip x_hat to [-1, 1] every step; the only differences are
    # fp32 summation orders (kernels against oneDNN/cuDNN-free CPU code),
    # carried through 10 steps.
    tol = 2e-3
    for name in ("ddim", "ancestral"):
        err = (results[("cuda", name)] - results[("cpu", name)]).abs().max().item()
        log(f"card vs CPU, fp32 batch {n}, {steps}-step {name}: max|diff|={err:.3e} tol={tol}")
        check(err <= tol, f"card vs CPU {name}: {err} > {tol}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from xdiffusion_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = gpu_line()
    log(f"card: {smi}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    _build.build(["bsc_attention", "group_norm_silu", "affine_silu_conv3x3"], verbose=True)
    log(f"kernels built in {time.perf_counter() - t0:.1f} s")

    sites = main_path_sites(build_model("bfloat16", "cuda"))
    log("main-path sites per forward: "
        + ", ".join(f"{k}={len(v)}" for k, v in sites.items()))
    records = phase_kernels(sites)
    launches, sps = phase_main_path(records)
    phase_card_vs_cpu()

    kernels = []
    for name, kernel, rec in records:
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"xdiffusion_tpu_torch/csrc/{name}.cu",
            "replaces": REPLACES[name],
            "launches": launches[name],
            "max_abs_err": rec["err"],
            "ms": rec["ms"],
            "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"],
            "bound_by": "bytes" if rec["bytes_ms"] >= rec["ops_ms"] else "operations",
            "library_ms": rec["library_ms"],
        })
    log(f"per-forward kernel times are bf16 sums over each kernel's sites; "
        f"main path {sps:.2f} samples/s on {smi}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
