"""Drives the PyTorch port's main paths on one NVIDIA H100 and checks them.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. Set-up: the card's name and power limit; nvcc builds every kernel of
   the port from `xdiffusion_tpu_torch/csrc/` (one process per source);
   ptxas's registers, static shared memory and spills of each K1, K2, K3
   (both variants of `gn_plan`, fp32 and bf16), K4, K5 and K6 kernel (every
   variant of `flash_plan`), one line each.
2. Kernels: each hand-written kernel (K1 attention, K2 its backward, K3
   GroupNorm+SiLU, K4 affine+SiLU+conv3x3) against its plain PyTorch version
   on the card, in fp32 and bf16, at every shape the flagship UNet gives it
   (K1, K3, K4: a batch-64 sampling forward; K2: a batch-128 training step),
   with the tolerance stated beside it; then its time, the plain version's,
   one PyTorch library call's where one computes the same function (each
   device time: back-to-back calls queued behind a spin kernel; the
   wrapper's host time beside it), and the least time the card could take (`bound`), summed over one
   forward (K2: one training step). K4 also runs at the conv1 sites of a
   batch-128 training step, at ddpm_8x8_epsilon.yaml's sites (2x2 maps) and
   at ragged shapes (a half chunk, C = 48 on the generic kernel, Co = 40,
   partial tiles), twice each and bit for bit, every site timed beside its
   time before the redesign (K4_BEFORE_MS). K3 also runs at the sites of a
   batch-128 training step's forward, at ddpm_8x8_epsilon.yaml's sites and
   at ragged shapes (both `gn_plan` variants, every cluster size), twice each
   and bit for bit, every UNet site timed with L2 warm and cold (`cold_ms`)
   beside its time before the redesign (K3_BEFORE_MS). Then the gradients
   through each `torch.autograd.Function` (K1+K2, K3, K4 with and without
   residual) against autograd of the plain versions, and K4's and K3's
   plain-autograd backward times over a training step. K2 runs
   twice at each site and must repeat bit for bit. K1 and K2 also run at
   the ragged shapes of tests/test_torch_port_bsc_plan.py, on both sides
   of the threshold ROW_MAX_KEYS and at (4, 1024, C=512, 8 heads), in fp32
   and bf16 with the same tolerances (every variant of `bsc_plan` runs),
   and the row variant is timed against the stream one at 256 to 512 keys.
3. Sampling path: the flagship config (configs/image/mnist/ddpm_32x32_
   epsilon_discrete.yaml) at full width in bf16 with seeded random weights,
   50-step DDIM at batch 64 through `GaussianDiffusion_DDPM.sample`, with
   the launches of each kernel counted over that one run, and a profile of
   one forward (K4's share of its device time); a few steps of the
   config's default ancestral sampler; and the sampling CLI
   (`python -m xdiffusion_tpu_torch.sample`) on a saved checkpoint, which
   writes sample-step0.png (a bare state dict records no step). Then
   ddpm_32x32_v_discrete.yaml, ddpm_8x8_epsilon.yaml and
   rectified_flow_32x32.yaml in bf16 through the same CLI, 5 steps at batch
   16 each, one K4 launch per conv site and step.
4. Card against CPU, sampling: fp32, batch 4, 10 DDIM and 10 ancestral
   steps with the same weights and injected noise, the card's kernels
   against the CPU's plain versions.
5. Training path: the flagship in bf16 at batch 128 through `train()` on
   the synthetic digits, 5 warm-up and 20 timed steps with every step's
   loss and grad_norm, the launches of each kernel counted over the run
   against the counts the code implies, checkpoints and sample grids, a
   resume from the step-25 checkpoint that must repeat the uninterrupted
   run's step-25 loss, and a profile of one training step.
6. Card against CPU, training: fp32, full width, batch 4, one loss and
   backward with the same weights, batch, timesteps and noise and dropout
   off: the loss, the gradient norm and every parameter's gradient.
7. K5 (streamed attention forward): o and lse against the plain version in
   fp32 and bf16 at the four shapes the LTX path gives it (self- and
   cross-attention at the shipped 8x8x8 grid, batch 4, and at a 16x32x32
   grid, batch 1), with the tolerances stated, and twice bit for bit; its
   time, the plain version's, SDPA's and the bound at each (fp32 both by
   the CUDA cores' rate and by three TF32 products'); its refusals on CUDA
   (head dim 32, a causal call).
8. LTX main path: the shipped configs/video/moving_mnist/ltx_video/
   ltx_video_pixel_space.yaml (fp32, 12 layers, 6 x 64 heads) with seeded
   random weights, batch 4 with the prompts "0" to "3", the config's 1000
   Euler steps through `GaussianDiffusion_DDPM.sample` (timed, 24 K5
   launches per forward, nothing else launched; its frame strip goes to
   output/chip_smoke/ltx/samples.png); 10 steps through the video CLI
   (`python -m xdiffusion_tpu_torch.sample_video`), which must repeat
   `sample()` and write its strip; a profile of one forward.
9. Long video: the same config at a 16x32x32 grid (16,384 tokens), batch 1:
   one forward and a 10-step sample in fp32, then with the network cast to
   bf16.
10. Card against CPU, LTX: fp32, batch 2, one forward and 10 steps at the
    shipped shape with the same weights, initial noise and sampling noise.
11. K6 (streamed attention backward): dq, dk and dv against the plain
    version in fp32 and bf16 at the four shapes the LTX training path gives
    it (self- and cross-attention at the shipped 8x8x8 grid, batch 8, and
    at the 16x32x32 grid, batch 1), both sides from the same K5 o and lse,
    with the tolerances stated, and twice bit for bit; its time, the plain
    version's, SDPA's backward and the bound at each (fp32 by both rates,
    as phase 7); the gradients through `flash_attention`
    (K5 forward, K6 backward) against autograd of the plain path; its
    refusals (head dim 32, mixed dtypes).
12. LTX training: the shipped config in fp32 at batch 8 through the port's
    video `train()` on the synthetic Moving-MNIST, 5 warm-up and 20 timed
    steps with every step's loss and grad_norm, exactly 24 K5 and 24 K6
    launches a step (and 24 K5 a sampling forward), checkpoints and
    10-step frame strips, a resume from the step-25 checkpoint that must
    repeat step 25's loss bit for bit, a profile of one step
    (output/chip_smoke/ltx_train_profile.txt), and 3 steps through the
    video training CLI (`python -m xdiffusion_tpu_torch.train_video`).
13. Long video training: one loss and backward at the 16x32x32 grid, batch
    1, in fp32 and with the network cast to bf16, with K6's share of the
    step's device time.
14. Card against CPU, LTX training: fp32, batch 2, one loss and backward
    with the same weights, batch, mask, text embeddings, times and noise
    and no guidance drop: the loss, the gradient norm and every parameter's
    gradient.
15. K7 (attention on head-major (B, H, S, D), K1's device code with one
    head over the merged B*H axis): against its plain version in fp32 and
    bf16 at (128, 6, 16, 64) (the DiT's attention, head-major), (64, 4, 256,
    64) (the UNet's 16x16 attention, head-major) and (8, 8, 1024, 64), with
    the tolerances stated; its time, the wrapper's host time, the plain
    version's, SDPA's and the bound at each; the gradients through
    `short_attention` (the plain version's vjp) on the card against the
    CPU; its refusals (head dim 48, mixed dtypes). No path of the package
    calls K7, so it has no launches on a main path.
16. DiT sampling: the shipped configs/image/mnist/dit.yaml (fp32, 12
    blocks, 6 x 64 heads, 16 tokens) with seeded random weights, batch 64,
    classes arange(64) % 10, the config's guidance 1.0 (one forward on 128
    samples), dynamic thresholding, the config's 1000 ancestral steps
    through `sample()`, timed, with exactly 12 K1 launches per forward and
    nothing else launched; its grid goes to output/chip_smoke/dit/
    samples.png. Then 5 steps through the sampling CLI, which must repeat
    `sample()` and write sample-step0.png; a profile of one guided forward
    (output/chip_smoke/dit_profile.txt); K1's and K2's times at the DiT
    site (B 128, S 16, C 384) in fp32 and bf16 beside SDPA's and the bound,
    K2 twice bit for bit.
17. DiT training: the shipped config in fp32 at batch 128 (dropout 0.1,
    guidance drop 0.2) through `train()` on the synthetic digits and their
    labels, 30 steps, steps/s over steps 5-24, exactly 12 K1 and 12 K2
    launches a step (and 12 K1 a sampling forward), checkpoints and guided
    grids, a resume from step 25 that must repeat its loss bit for bit, a
    profile of one step (output/chip_smoke/dit_train_profile.txt); then
    configs/image/mnist/dit_moe.yaml (8 experts, top-1) for 30 steps at the
    same batch, each reporting a finite moe_aux_loss, and 10 guided
    sampling steps at batch 64, whose 128-sample forward runs as two
    64-sample chunks: exactly 24 K1 launches a step.
18. Card against CPU, DiT: fp32, batch 2, one loss and backward of the
    dense network with the same weights, batch, classes (one of them the
    null class), times and noise, no dropout and no guidance drop: the
    loss, the gradient norm and every gradient. For MoE, after checking
    that no token's top-2 router margin is under 1e-4 (a flip in a near
    tie is a discontinuity, not an error), the loss and the aux loss.

At the end a table sets K1, K2 and K7 per site beside their times before
the redesign of K1 and K2 (PERF.md), the library call's and the bound, one
sets K3 per site beside its time before its redesign, its cold time,
F.group_norm's, the bound and the plain version's, one sets K4 per site
beside its time before its redesign, F.conv2d's, the bound and the plain
version's, and one sets K5 and K6 per site beside
their times before their redesign (FLASH_BEFORE_MS), SDPA's and both fp32
bounds. The last two lines are the card's
`nvidia-smi` name and power limit and `{"ok": true, "device": {...}}`; the
JSON line before them lists the kernels. Without a CUDA device, or without the repository beside it, the
script exits non-zero and prints no result. The whole standard output also
goes to chiprun_out/chip_smoke.log beside the script.
"""

from __future__ import annotations

import json
import math
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
LTX_CONFIG = os.path.join(ROOT, "configs/video/moving_mnist/ltx_video/"
                          "ltx_video_pixel_space.yaml")
LTX_BATCH, LTX_LONG_GRID = 4, (16, 32, 32)
# LTX training: the video CLI's default batch, and the sampling steps of
# its frame strips.
LTX_TRAIN_BATCH, LTX_STRIP_STEPS = 8, 10
DIT_CONFIG = os.path.join(ROOT, "configs/image/mnist/dit.yaml")
DIT_MOE_CONFIG = os.path.join(ROOT, "configs/image/mnist/dit_moe.yaml")
# DiT: the sampling batch (a guided forward runs twice as many samples) and
# the sampling steps of the MoE check.
DIT_BATCH, DIT_MOE_STEPS = 64, 10
DDIM_CONFIG = os.path.join(ROOT, "configs/image/mnist/samplers/ddim.yaml")
OUT_DIR = os.path.join(ROOT, "output", "chip_smoke")
LOG_PATH = os.path.join(ROOT, "chiprun_out", "chip_smoke.log")
BATCH, STEPS, SEED = 64, 50, 0
MIN_LAUNCHES = {"bsc_attention": 300, "group_norm_silu": 350, "affine_silu_conv3x3": 2200}
# Training path: batch, warm-up and timed steps, the step whose checkpoint
# the resume starts from, and the grid size of the end-of-run samples.
TRAIN_BATCH, WARMUP_STEPS, TIMED_STEPS, NUM_SAMPLES = 128, 5, 20, 16
RESUME_STEP = WARMUP_STEPS + TIMED_STEPS
TRAIN_STEPS = RESUME_STEP + 5
# Published H100 SXM peaks (dense): bf16 tensor cores, fp32 CUDA cores, HBM;
# and the SFUs' exponentials per second (FlashAttention-3 paper). K5 and K6
# run fp32 as three TF32 products a product on the tensor cores, whose TF32
# rate is PEAK_TF32: fp32-accurate products at PEAK_TF32 / 3.
PEAK_BF16, PEAK_FP32, PEAK_BYTES, PEAK_EXP = 989e12, 67e12, 3.35e12, 3.9e12
PEAK_TF32 = 494.7e12
REPLACES = {
    "bsc_attention": "xdiffusion_tpu/ops/flash_attention.py:266",
    "bsc_attention_bwd": "xdiffusion_tpu/ops/flash_attention.py:350",
    "group_norm_silu": "xdiffusion_tpu/ops/group_norm.py:29",
    "affine_silu_conv3x3": "xdiffusion_tpu/ops/fused_resblock.py:62",
    "flash_attention": "xdiffusion_tpu/ops/flash_attention.py:48",
    "flash_attention_bwd": "xdiffusion_tpu/ops/flash_attention.py:445 and :489",
    "short_attention": "xdiffusion_tpu/ops/flash_attention.py:171",
}


class PhaseError(RuntimeError):
    pass


class Tee:
    """A text stream that writes to several: the console and the log file."""

    def __init__(self, *streams):
        self.streams = streams

    def write(self, data: str) -> int:
        for stream in self.streams:
            stream.write(data)
        return len(data)

    def flush(self) -> None:
        for stream in self.streams:
            stream.flush()


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
    """Mean time of one call of fn over `iters` back-to-back calls, CUDA
    events around the loop. Where a call's kernels are shorter than its
    host-side dispatch, this times the host (the `wrapper_ms` field)."""
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


_CYCLES_PER_MS = []


def cycles_per_ms() -> float:
    """The card's clock, read once by timing a spin kernel with CUDA events."""
    if not _CYCLES_PER_MS:
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(20_000_000)
        end.record()
        end.synchronize()
        _CYCLES_PER_MS.append(20_000_000 / start.elapsed_time(end))
    return _CYCLES_PER_MS[0]


def device_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call of fn over `iters` back-to-back calls
    (the `ms`, `plain_ms` and `library_ms` fields). A spin kernel ahead of
    the calls holds the stream while the host enqueues all of them, so the
    CUDA events around the calls see the kernels run back to back, without
    the host's dispatch gaps. The spin must outlast the enqueueing, which is
    checked; a time where it did not is logged as holding host time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    spin_ms = 2.0 * (time.perf_counter() - t0) * 1e3 + 1.0
    torch.cuda.synchronize()
    for _ in range(3):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        torch.cuda._sleep(int(spin_ms * cycles_per_ms()))
        ev[1].record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        ev[2].record()
        ev[2].synchronize()
        if ev[0].elapsed_time(ev[1]) > 1.1 * host_ms + 0.05:
            return ev[1].elapsed_time(ev[2]) / iters
        spin_ms *= 4.0
    log(f"  (device_ms: the host took {host_ms:.3f} ms to enqueue {iters} calls, longer "
        f"than the spin; this time holds host time)")
    return ev[1].elapsed_time(ev[2]) / iters


def bf16_tol(ref: torch.Tensor, ulps: int) -> float:
    """`ulps` units in the last place of bf16 at the reference's largest
    magnitude m: ulps * 2^(floor(log2 m) - 7)."""
    m = ref.float().abs().max().item()
    check(m > 0, "a bf16 reference that is all zeros")
    return ulps * 2.0 ** (math.floor(math.log2(m)) - 7)


def ptxas_summary(name: str, log_text: str) -> None:
    """One line per kernel of a library's `nvcc -Xptxas -v` output:
    registers, static shared memory (the kernels here take theirs dynamic,
    sized by the launch plan) and spills."""
    import re
    import shutil

    entries, cur = [], None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = {"name": m.group(1), "regs": "?", "smem": "0", "spill": "0/0"}
            entries.append(cur)
        elif cur is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                cur["spill"] = f"{m.group(1)}/{m.group(2)}"
            m = re.search(r"Used (\d+) registers", line)
            if m:
                cur["regs"] = m.group(1)
                sm = re.search(r"(\d+) bytes smem", line)
                cur["smem"] = sm.group(1) if sm else "0"
    if not entries:
        log(f"ptxas {name}: no compiler output (library already built)")
        return
    names = [e["name"] for e in entries]
    if shutil.which("c++filt"):
        out = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True,
                             text=True, timeout=60).stdout.splitlines()
        names = out if len(out) == len(names) else names
    log(f"ptxas {name}: {len(entries)} kernels (registers, static smem bytes, spill "
        f"stores/loads bytes; dynamic smem is the plan's)")
    for e, n in zip(entries, names):
        log(f"  {e['regs']:>3} regs  smem {e['smem']:>5}  spill {e['spill']:>7}  {n[:110]}")


def build_model(dtype: str, device: str, path: str = CONFIG):
    from xdiffusion_tpu_torch.config import load_yaml
    from xdiffusion_tpu_torch.diffusion.ddpm import GaussianDiffusion_DDPM
    from xdiffusion_tpu_torch.weights import randomize_

    config = load_yaml(path)
    config.diffusion.score_network.params.to_dict()["dtype"] = dtype
    model = GaussianDiffusion_DDPM(config, device=device)
    randomize_(model.score_network(), SEED)
    return model


def main_path_sites(model, batch: int = BATCH, size: int = 32):
    """The kernel call sites of one UNet forward on size x size images, with
    their input shapes at `batch`, read by hooks on the modules that call
    the kernels."""
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
    x = torch.zeros((batch, size, size, 1), device="cuda")
    t = torch.zeros((batch,), dtype=torch.long, device="cuda")
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


def new_record():
    return dict.fromkeys(("ms", "wrapper_ms", "plain_ms", "library_ms", "bytes_ms", "ops_ms",
                          "bound_ms", "err"), 0.0)


def account(rec, n: int, kernel, plain, library, nbytes: int, ops: int, peak_ops: float):
    """Times one site shape (kernel, plain version, library call: device
    time; the kernel's wrapper also by host time) and adds n sites' worth to
    the kernel's per-forward record, with the bound: the larger of nbytes
    over the card's memory rate and ops over `peak_ops`."""
    k_ms, p_ms, l_ms = device_ms(kernel), device_ms(plain), device_ms(library)
    w_ms = time_ms(kernel)
    bytes_ms, ops_ms = nbytes / PEAK_BYTES * 1e3, ops / peak_ops * 1e3
    log(f"  x{n} sites: kernel {k_ms:.4f} ms ({ops / k_ms / 1e9:.1f} TOP/s, "
        f"{nbytes / k_ms / 1e6:.0f} GB/s; wrapper {w_ms:.4f} ms host time), plain "
        f"{p_ms:.4f} ms, library {l_ms:.4f} ms, bound {max(bytes_ms, ops_ms):.4f} ms")
    for key, v in (("ms", k_ms), ("wrapper_ms", w_ms), ("plain_ms", p_ms),
                   ("library_ms", l_ms), ("bytes_ms", bytes_ms), ("ops_ms", ops_ms),
                   ("bound_ms", max(bytes_ms, ops_ms))):
        rec[key] += n * v


def phase_kernels(sites):
    """K1 against its plain version at the main path's shapes, fp32 and
    bf16; returns its JSON record (bf16 times, per forward)."""
    from xdiffusion_tpu_torch.ops import flash_attention

    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)

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
    return records


def phase_k2(train_sites):
    """K2 against its plain version at the training step's attention shapes
    (batch TRAIN_BATCH), fp32 and bf16; returns its JSON record (bf16 times,
    per training step)."""
    from xdiffusion_tpu_torch.ops import flash_attention

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    rec = new_record()
    # fp32: exact but for summation order; bf16: both sides round p and ds
    # alike, the products sum in another order: 2 ulps at each reference's
    # largest value.
    for (b, s, c, heads), n in counted(train_sites["bsc_attention"]).items():
        d = c // heads
        scale = d ** -0.5
        for dt in (torch.float32, torch.bfloat16):
            qkv = torch.randn((b, s, 3 * c), generator=gen, device="cuda").to(dt)
            q, k, v = qkv.chunk(3, dim=-1)  # the qkv Dense's column slices
            g = torch.randn((b, s, c), generator=gen, device="cuda").to(dt)
            want = flash_attention.short_attention_bsc_bwd_plain(q, k, v, g, heads, scale)
            got = flash_attention.short_attention_bsc_bwd(q, k, v, g, heads, scale)
            check_repeats(f"K2 B={b} S={s} C={c} heads={heads} {dt}", got,
                          flash_attention.short_attention_bsc_bwd(q, k, v, g, heads, scale))
            err = 0.0
            for name, x, y in zip(("dq", "dk", "dv"), got, want):
                tol = (1e-4 * max(1.0, y.float().abs().max().item()) if dt == torch.float32
                       else bf16_tol(y, 2))
                err = max(err, compare(f"K2 bsc_attention_bwd {name} B={b} S={s} C={c} "
                                       f"heads={heads} {dt}", x, y, tol))
        rec["err"] = max(rec["err"], err)
        qh, kh, vh = (t.reshape(b, s, heads, d).transpose(1, 2).contiguous().requires_grad_()
                      for t in (q, k, v))
        out = F.scaled_dot_product_attention(qh, kh, vh)
        gh = g.reshape(b, s, heads, d).transpose(1, 2).contiguous()
        account(rec, n,
                lambda: flash_attention.short_attention_bsc_bwd(q, k, v, g, heads, scale),
                lambda: flash_attention.short_attention_bsc_bwd_plain(q, k, v, g, heads, scale),
                lambda: torch.autograd.grad(out, (qh, kh, vh), gh, retain_graph=True),
                nbytes=(4 * q.numel() + 3 * k.numel()) * q.element_size(),
                ops=10 * b * s * s * c, peak_ops=PEAK_BF16)
    return ("bsc_attention_bwd", flash_attention.BWD_KERNEL, rec)


# K4 per site: device ms of the kernel before its redesign (the `fast::`
# wmma kernel of commit 67ad2f3; tools/torch_conv_ab.py on a checkout of it,
# median of two runs, NVIDIA H100 80GB HBM3, 700.00 W), keyed (set, x shape,
# Co, residual). Sets: the flagship's sampling forward (batch 64) and training
# conv1 sites (batch 128), ddpm_8x8_epsilon.yaml's forward (batch 64, 2x2
# maps) and ragged shapes.
K4_BEFORE_MS = {
    ("flagship", (64, 32, 32, 128), 128, False): 0.1658,
    ("flagship", (64, 32, 32, 128), 128, True): 0.1709,
    ("flagship", (64, 16, 16, 128), 256, False): 0.0838,
    ("flagship", (64, 16, 16, 256), 256, True): 0.1631,
    ("flagship", (64, 16, 16, 256), 256, False): 0.1617,
    ("flagship", (64, 8, 8, 256), 256, False): 0.0763,
    ("flagship", (64, 8, 8, 256), 256, True): 0.0768,
    ("flagship", (64, 4, 4, 256), 256, False): 0.0653,
    ("flagship", (64, 4, 4, 256), 256, True): 0.0661,
    ("flagship", (64, 4, 4, 512), 256, False): 0.1251,
    ("flagship", (64, 8, 8, 512), 256, False): 0.1532,
    ("flagship", (64, 16, 16, 512), 256, False): 0.3250,
    ("flagship", (64, 16, 16, 384), 256, False): 0.2440,
    ("flagship", (64, 32, 32, 384), 128, False): 0.4876,
    ("flagship", (64, 32, 32, 256), 128, False): 0.3243,
    ("train", (128, 32, 32, 128), 128, False): 0.3258,
    ("train", (128, 16, 16, 128), 256, False): 0.1648,
    ("train", (128, 16, 16, 256), 256, False): 0.3206,
    ("train", (128, 8, 8, 256), 256, False): 0.1170,
    ("train", (128, 4, 4, 256), 256, False): 0.0646,
    ("train", (128, 4, 4, 512), 256, False): 0.1249,
    ("train", (128, 8, 8, 512), 256, False): 0.2334,
    ("train", (128, 16, 16, 512), 256, False): 0.6453,
    ("train", (128, 16, 16, 384), 256, False): 0.4867,
    ("train", (128, 32, 32, 384), 128, False): 0.9620,
    ("train", (128, 32, 32, 256), 128, False): 0.6341,
    ("8x8", (64, 8, 8, 128), 128, False): 0.0362,
    ("8x8", (64, 8, 8, 128), 128, True): 0.0351,
    ("8x8", (64, 4, 4, 128), 256, False): 0.0369,
    ("8x8", (64, 4, 4, 256), 256, True): 0.0670,
    ("8x8", (64, 4, 4, 256), 256, False): 0.0653,
    ("8x8", (64, 2, 2, 256), 256, False): 0.0710,
    ("8x8", (64, 2, 2, 256), 256, True): 0.0712,
    ("8x8", (64, 2, 2, 512), 256, False): 0.1432,
    ("8x8", (64, 4, 4, 512), 256, False): 0.1251,
    ("8x8", (64, 4, 4, 384), 256, False): 0.0970,
    ("8x8", (64, 8, 8, 384), 128, False): 0.0956,
    ("8x8", (64, 8, 8, 256), 128, False): 0.0658,
    ("ragged", (3, 12, 12, 96), 40, True): 0.0256,
    ("ragged", (2, 8, 8, 48), 40, True): 0.0745,
    ("ragged", (5, 5, 7, 64), 136, False): 0.0183,
    ("ragged", (3, 33, 20, 32), 64, True): 0.0116,
    ("ragged", (4, 3, 3, 96), 128, False): 0.0260,
    ("ragged", (2, 1, 1, 64), 72, True): 0.0123,
}
# K4 summed over the flagship's bf16 sampling forward before the redesign
# (the final chip_smoke.py run of commit 67ad2f3) and F.conv2d's in that run.
K4_BEFORE_FORWARD_MS, K4_BEFORE_CONV2D_MS = 6.434, 1.925
SMALL_CONFIG = os.path.join(ROOT, "configs/image/mnist/ddpm_8x8_epsilon.yaml")


def phase_k4(sites, train_sites, small_sites):
    """K4 against its plain version, fp32 and bf16, at every site of the
    flagship's sampling forward and training step (conv1), of
    ddpm_8x8_epsilon.yaml's forward and at the ragged shapes of
    K4_BEFORE_MS (a half chunk, C = 48 on the generic kernel, Co = 40,
    partial tiles, 1x1 maps); twice each, bit for bit. Times every site
    (device ms: the kernel, its plain version, F.conv2d on the activated
    map, the bound). Returns the JSON record (bf16, per sampling forward)
    and the per-site rows for k4_table."""
    from xdiffusion_tpu_torch.ops import fused_resblock

    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)

    groups = {"flagship": sites, "train": [s for s in train_sites if not s[2]],
              "8x8": small_sites,
              "ragged": [((b, h, w, c), co, r) for (g, (b, h, w, c), co, r) in K4_BEFORE_MS
                         if g == "ragged"]}
    rec, rows = new_record(), []
    for group, found in groups.items():
        for (shape, co, has_res), n in counted(found).items():
            b, h, w, c = shape
            a, off = 1.0 + randn(b, c, scale=0.2), randn(b, c, scale=0.2)
            bias = randn(co, scale=0.1)
            plan = fused_resblock.conv_plan(b, h, w, c, co, torch.bfloat16)
            # fp32: 9*C products summed in another order, 1e-4 of the largest
            # output; bf16: the plain version rounds the activation at each of
            # its three elementwise steps, the kernel once: 4 ulps.
            for dt in (torch.float32, torch.bfloat16):
                x = randn(b, h, w, c, dtype=dt)
                kw = randn(3, 3, c, co, dtype=dt, scale=(9 * c) ** -0.5)
                res = randn(b, h, w, co, dtype=dt) if has_res else None
                want = fused_resblock.affine_silu_conv3x3_plain(x, a, off, kw, bias, res)
                tol = (1e-4 * max(1.0, want.float().abs().max().item())
                       if dt == torch.float32 else bf16_tol(want, 4))
                got = fused_resblock.affine_silu_conv3x3(x, a, off, kw, bias, res)
                again = fused_resblock.affine_silu_conv3x3(x, a, off, kw, bias, res)
                torch.cuda.synchronize()
                same = torch.equal(got, again)
                check(same, f"K4 {group} x={shape} Co={co} {dt}: two runs differ")
                err = compare(f"K4 {group} x={shape} Co={co} residual={has_res} {dt} "
                              f"({plan.variant}, splits {plan.splits}; repeat bit-identical)",
                              got, want, tol)
                if group == "flagship":
                    rec["err"] = max(rec["err"], err)
            y = F.silu(x * a[:, None, None, :].to(dt) + off[:, None, None, :].to(dt))
            yn = y.permute(0, 3, 1, 2)  # channels-last NCHW view, no copy
            wn, bd = kw.permute(3, 2, 0, 1), bias.to(dt)
            kernel = lambda: fused_resblock.affine_silu_conv3x3(x, a, off, kw, bias, res)
            plain = lambda: fused_resblock.affine_silu_conv3x3_plain(x, a, off, kw, bias, res)
            library = lambda: F.conv2d(yn, wn, bd, padding=1)
            nbytes = ((x.numel() + kw.numel() + b * h * w * co * (2 if has_res else 1)) * 2
                      + (2 * b * c + co) * 4)
            ops = 2 * b * h * w * 9 * c * co
            bytes_ms, ops_ms = nbytes / PEAK_BYTES * 1e3, ops / PEAK_BF16 * 1e3
            row = {"group": group, "shape": shape, "co": co, "res": has_res, "n": n,
                   "before": K4_BEFORE_MS.get((group, shape, co, has_res)),
                   "ms": device_ms(kernel), "library_ms": device_ms(library),
                   "plain_ms": device_ms(plain), "bound_ms": max(bytes_ms, ops_ms),
                   "plan": f"{plan.variant} rows {plan.tile_rows} img {plan.images} "
                           f"splits {plan.splits} stages {plan.stages}"}
            rows.append(row)
            if group == "flagship":  # the kernels line: per sampling forward
                for key, v in (("ms", row["ms"]), ("wrapper_ms", time_ms(kernel)),
                               ("plain_ms", row["plain_ms"]), ("library_ms", row["library_ms"]),
                               ("bytes_ms", bytes_ms), ("ops_ms", ops_ms),
                               ("bound_ms", row["bound_ms"])):
                    rec[key] += n * v
    # Without SiLU (the kernel's other activation path), at the smallest
    # flagship site with a residual, bf16: 4 ulps.
    (b, h, w, c), co, _ = min(groups["flagship"], key=lambda s: math.prod(s[0]))
    x = randn(b, h, w, c, dtype=torch.bfloat16)
    a, off, bias = 1.0 + randn(b, c, scale=0.2), randn(b, c, scale=0.2), randn(co, scale=0.1)
    kw = randn(3, 3, c, co, dtype=torch.bfloat16, scale=(9 * c) ** -0.5)
    res = randn(b, h, w, co, dtype=torch.bfloat16)
    want = fused_resblock.affine_silu_conv3x3_plain(x, a, off, kw, bias, res, apply_silu=False)
    compare(f"K4 x={(b, h, w, c)} Co={co} without SiLU bf16",
            fused_resblock.affine_silu_conv3x3(x, a, off, kw, bias, res, apply_silu=False),
            want, bf16_tol(want, 4))
    missing = [(r["group"], r["shape"], r["co"], r["res"]) for r in rows if r["before"] is None]
    check(not missing, f"K4 sites without a time before the redesign: {missing}")
    return ("affine_silu_conv3x3", fused_resblock.KERNEL, rec), rows


def k4_table(rows, smi: str) -> None:
    """K4 per site: its device ms before the redesign (K4_BEFORE_MS), this
    run's, F.conv2d's, the bound and the plain version's; each set's sums."""
    log(f"K4 per site, device ms a call on {smi} (before: the kernel of 67ad2f3, a run of "
        f"its tree by tools/torch_conv_ab.py):")
    log(f"  {'set':8} {'x (B, H, W, C)':20} {'Co':>4} {'res':>3} {'n':>3} {'before':>8} "
        f"{'now':>8} {'x faster':>8} {'conv2d':>8} {'bound':>8} {'plain':>8}  plan")
    sums = {}
    for r in rows:
        log(f"  {r['group']:8} {str(r['shape']):20} {r['co']:4d} {'yes' if r['res'] else 'no':>3} "
            f"{r['n']:3d} {r['before']:8.4f} {r['ms']:8.4f} {r['before'] / r['ms']:8.2f} "
            f"{r['library_ms']:8.4f} {r['bound_ms']:8.4f} {r['plain_ms']:8.4f}  {r['plan']}")
        acc = sums.setdefault(r["group"], [0.0] * 5)
        for i, k in enumerate(("before", "ms", "library_ms", "bound_ms", "plain_ms")):
            acc[i] += r["n"] * r[k]
    for group, (before, now, lib, bound, plain) in sums.items():
        log(f"  sum {group:8} before {before:.4f} now {now:.4f} ({before / now:.2f}x) conv2d "
            f"{lib:.4f} bound {bound:.4f} plain {plain:.4f}")
    slower = [(r["group"], r["shape"], r["co"], r["res"]) for r in rows
              if r["group"] == "flagship" and r["ms"] > r["before"]]
    log(f"K4 flagship sites slower than before the redesign: {slower or 'none'}; the "
        f"sampling forward's sum in 67ad2f3's final run: {K4_BEFORE_FORWARD_MS} ms "
        f"(F.conv2d {K4_BEFORE_CONV2D_MS})")


# K3 per site: device ms of the kernel before its redesign (the one-block-
# per-group kernel of commit 2d31e42; tools/torch_gn_ab.py --roots on a
# checkout of it, median of two runs, NVIDIA H100 80GB HBM3, 700.00 W), bf16,
# keyed (set, x shape, SiLU). Sets: the flagship's sampling forward (batch
# 64) and a training step's forward (batch 128), ddpm_8x8_epsilon.yaml's
# forward (batch 64).
K3_BEFORE_MS = {
    ("flagship", (64, 16, 16, 256), False): 0.0302,
    ("flagship", (64, 4, 4, 256), False): 0.0085,
    ("flagship", (64, 32, 32, 128), True): 0.0789,
    ("train", (128, 16, 16, 256), False): 0.0571,
    ("train", (128, 4, 4, 256), False): 0.0136,
    ("train", (128, 32, 32, 128), True): 0.1642,
    ("8x8", (64, 4, 4, 256), False): 0.0085,
    ("8x8", (64, 2, 2, 256), False): 0.0078,
    ("8x8", (64, 8, 8, 128), True): 0.0109,
}
# K3 summed over the flagship's bf16 sampling forward before the redesign
# (the final chip_smoke.py run of commit 2d31e42) and F.group_norm(+F.silu)'s.
K3_BEFORE_FORWARD_MS, K3_BEFORE_LIBRARY_MS = 0.2405, 0.4597
# K3 off the main paths, (x shape, groups, SiLU): the stream variant (C = 4
# and 12 in bf16: no 16-byte vector, scalar loads; slabs no cluster of 8
# stages), C = 48 (a vector across two groups), uneven rows (7x7), one
# pixel, C = 2048, and a batch of one (k = 8).
K3_RAGGED = [((2, 5, 5, 4), 1, True), ((3, 7, 7, 12), 3, False), ((3, 7, 7, 48), 12, True),
             ((2, 1, 1, 1024), 32, False), ((1, 128, 128, 128), 32, True),
             ((2, 64, 64, 512), 32, False), ((1, 16, 16, 256), 32, True),
             ((5, 9, 9, 2048), 32, True)]
_FLUSH = []


def cold_ms(fn, iters: int = 10) -> float:
    """Mean device time of one call of fn with L2 cold (`cold_ms`): a buffer
    of twice the L2 is written before each call, outside the CUDA events
    around it; everything queued behind a spin kernel."""
    if not _FLUSH:
        l2 = torch.cuda.get_device_properties(0).L2_cache_size
        _FLUSH.append(torch.empty(2 * l2 // 4 + 1, dtype=torch.float32, device="cuda"))
    flush = _FLUSH[0]
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        flush.fill_(1.0)
        fn()
    torch.cuda.synchronize()
    spin_ms = 2.0 * (time.perf_counter() - t0) * 1e3 + 1.0
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in range(iters)]
    torch.cuda._sleep(int(spin_ms * cycles_per_ms()))
    for start, end in ev:
        flush.fill_(1.0)
        start.record()
        fn()
        end.record()
    ev[-1][1].synchronize()
    return sum(s.elapsed_time(e) for s, e in ev) / iters


def phase_k3(sites, train_sites, small_sites):
    """K3 against its plain version, fp32 (1e-4: summation order) and bf16
    (1 ulp: one rounding on both sides), at every site of the flagship's
    sampling forward and training step, of ddpm_8x8_epsilon.yaml's forward
    and at K3_RAGGED; twice each, bit for bit (no atomics). Both variants of
    `gn_plan` and every cluster size must run. Times the UNet sites in bf16
    (device ms with L2 warm and cold, `F.group_norm` [+ `F.silu`], the plain
    version, the bound). Returns the JSON record (bf16, per sampling forward)
    and the per-site rows for k3_table."""
    from xdiffusion_tpu_torch.ops import group_norm

    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)

    def randn(*shape, dtype=torch.float32, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale + shift).to(dtype)

    groups = {"flagship": sites, "train": train_sites, "8x8": small_sites, "ragged": K3_RAGGED}
    rec, rows, seen = new_record(), [], set()
    rec["cold_ms"] = 0.0
    for group, found in groups.items():
        for (shape, ng, silu), n in counted(found).items():
            c, hw = shape[-1], math.prod(shape[1:-1])
            scale, bias = randn(c, scale=0.1, shift=1.0), randn(c, scale=0.1)
            for dt in (torch.float32, torch.bfloat16):
                plan = group_norm.gn_plan(shape[0], hw, c, ng, dt)
                seen.add((plan.variant, plan.k))
                x = randn(*shape, dtype=dt, scale=2.0, shift=0.5)
                want = group_norm.group_norm_silu_plain(x, scale, bias, ng, 1e-5, silu)
                got = group_norm.group_norm_silu(x, scale, bias, ng, 1e-5, silu)
                again = group_norm.group_norm_silu(x, scale, bias, ng, 1e-5, silu)
                torch.cuda.synchronize()
                check(torch.equal(got, again), f"K3 {group} x={shape} {dt}: two runs differ")
                err = compare(f"K3 {group} x={shape} groups={ng} silu={silu} {dt} ({plan.variant}, "
                              f"k {plan.k}, {plan.threads} threads, {plan.pieces} pieces; repeat "
                              f"bit-identical)", got, want,
                              1e-4 if dt == torch.float32 else bf16_tol(want, 1))
                if group == "flagship" and dt == torch.bfloat16:
                    rec["err"] = max(rec["err"], err)
            if group == "ragged":
                continue
            xn = x.permute(0, 3, 1, 2)  # channels-last NCHW view, no copy
            sd, bd = scale.to(dt), bias.to(dt)
            if silu:  # no single call: F.group_norm, then F.silu in place
                lib = lambda: F.silu(F.group_norm(xn, ng, sd, bd, 1e-5), inplace=True)
            else:
                lib = lambda: F.group_norm(xn, ng, sd, bd, 1e-5)
            kernel = lambda: group_norm.group_norm_silu(x, scale, bias, ng, 1e-5, silu)
            plain = lambda: group_norm.group_norm_silu_plain(x, scale, bias, ng, 1e-5, silu)
            bytes_ms = (2 * x.numel() * 2 + 2 * c * 4) / PEAK_BYTES * 1e3
            ops_ms = 10 * x.numel() / PEAK_FP32 * 1e3
            row = {"group": group, "shape": shape, "silu": silu, "n": n,
                   "before": K3_BEFORE_MS.get((group, shape, silu)),
                   "ms": device_ms(kernel), "cold_ms": cold_ms(kernel),
                   "library_ms": device_ms(lib), "plain_ms": device_ms(plain),
                   "bound_ms": max(bytes_ms, ops_ms),
                   "plan": f"{plan.variant} k {plan.k} threads {plan.threads} "
                           f"pieces {plan.pieces} smem {plan.smem}"}
            rows.append(row)
            if group == "flagship":  # the kernels line: per sampling forward
                for key, v in (("ms", row["ms"]), ("cold_ms", row["cold_ms"]),
                               ("wrapper_ms", time_ms(kernel)), ("plain_ms", row["plain_ms"]),
                               ("library_ms", row["library_ms"]), ("bytes_ms", bytes_ms),
                               ("ops_ms", ops_ms), ("bound_ms", row["bound_ms"])):
                    rec[key] += n * v
    variants = {v for v, _ in seen}
    ks = {k for _, k in seen}
    log(f"K3 plans run: variants {sorted(variants)}, cluster sizes {sorted(ks)}")
    check(variants == set(group_norm.VARIANTS), f"K3 variants run: {sorted(variants)}")
    check(ks == set(group_norm.CLUSTERS), f"K3 cluster sizes run: {sorted(ks)}")
    missing = [(r["group"], r["shape"], r["silu"]) for r in rows if r["before"] is None]
    check(not missing, f"K3 sites without a time before the redesign: {missing}")
    return ("group_norm_silu", group_norm.KERNEL, rec), rows


def k3_table(rows, smi: str) -> None:
    """K3 per site: its device ms before the redesign (K3_BEFORE_MS), this
    run's with L2 warm and cold, F.group_norm's (+ F.silu), the bound, the
    share of the bound reached cold, the plain version's and the plan; each
    set's sums."""
    log(f"K3 per site, device ms a call, bf16, on {smi} (before: the kernel of 2d31e42, a run "
        f"of its tree by tools/torch_gn_ab.py):")
    log(f"  {'set':8} {'x (B, H, W, C)':18} {'silu':>4} {'n':>2} {'before':>7} {'now':>7} "
        f"{'x faster':>8} {'cold':>7} {'library':>7} {'bound':>7} {'cold %':>6} {'plain':>7}  plan")
    sums = {}
    for r in rows:
        log(f"  {r['group']:8} {str(r['shape']):18} {'yes' if r['silu'] else 'no':>4} "
            f"{r['n']:2d} {r['before']:7.4f} {r['ms']:7.4f} {r['before'] / r['ms']:8.2f} "
            f"{r['cold_ms']:7.4f} {r['library_ms']:7.4f} {r['bound_ms']:7.4f} "
            f"{100 * r['bound_ms'] / r['cold_ms']:5.1f}% {r['plain_ms']:7.4f}  {r['plan']}")
        acc = sums.setdefault(r["group"], [0.0] * 6)
        for i, k in enumerate(("before", "ms", "cold_ms", "library_ms", "bound_ms", "plain_ms")):
            acc[i] += r["n"] * r[k]
    for group, (before, now, cold, lib, bound, plain) in sums.items():
        log(f"  sum {group:8} before {before:.4f} now {now:.4f} ({before / now:.2f}x) cold "
            f"{cold:.4f} ({100 * bound / cold:.1f}% of the bound) library {lib:.4f} bound "
            f"{bound:.4f} plain {plain:.4f}")
    slower = [(r["group"], r["shape"]) for r in rows
              if r["group"] == "flagship" and r["ms"] >= r["before"]]
    log(f"K3 flagship sites not faster than before the redesign: {slower or 'none'}; the "
        f"sampling forward's sum in 2d31e42's final run: {K3_BEFORE_FORWARD_MS} ms "
        f"(F.group_norm {K3_BEFORE_LIBRARY_MS})")


def check_repeats(label: str, first, second) -> None:
    """K2, K3, K4, K5 and K6 have no atomics: the same inputs give bit-identical
    outputs."""
    torch.cuda.synchronize()
    same = all(torch.equal(x, y) for x, y in zip(first, second))
    log(f"{label}: two runs bit-identical: {same}")
    check(same, f"{label}: two runs differ")


# K1 and K2 off the main paths: the ragged shapes of
# tests/test_torch_port_bsc_plan.py, both sides of the threshold and a long
# shape, as (B, Sq, Sk, C, heads); every variant and head dim runs.
BSC_SHAPES = [(3, 1, 1, 128, 2), (3, 15, 15, 64, 2), (3, 17, 17, 128, 2), (3, 17, 17, 256, 2),
              (2, 30, 24, 32, 2), (2, 100, 100, 128, 2), (2, 255, 255, 64, 1),
              (2, 256, 256, 32, 2), (2, 257, 257, 256, 2), (2, 16, 100, 128, 2),
              (2, 100, 17, 512, 4), (2, 33, 500, 256, 4)]
# The UNet's head layout at key counts around the threshold, batch 16: the
# row and stream variants of K1 and K2 timed against each other.
THRESHOLD_KEYS = (256, 384, 512)


def phase_bsc_shapes():
    """K1 and K2 against their plain versions, fp32 and bf16, at
    BSC_SHAPES, at ROW_MAX_KEYS and one key past it, and at the long shape
    (4, 1024, C=512, 8 heads), with the tolerances of phase 2; K2 twice,
    bit for bit; then row against stream around the threshold."""
    from xdiffusion_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    edge = fa.ROW_MAX_KEYS
    shapes = BSC_SHAPES + [(2, 64, edge, 256, 4), (2, 64, edge + 1, 256, 4),
                           (4, 1024, 1024, 512, 8)]
    seen = set()
    for b, sq, sk, c, heads in shapes:
        d = c // heads
        scale = d ** -0.5
        for dt in (torch.float32, torch.bfloat16):
            q = torch.randn((b, sq, 3 * c), generator=gen, device="cuda").to(dt)[..., :c]
            k, v = torch.randn((b, sk, 2 * c), generator=gen, device="cuda").to(dt).chunk(2, -1)
            g = torch.randn((b, sq, c), generator=gen, device="cuda").to(dt)
            plan = fa.bsc_plan(b, sq, sk, heads, d, dt)
            seen.add(plan.variant)
            tag = f"B={b} Sq={sq} Sk={sk} C={c} heads={heads} {dt} ({plan.variant})"
            want = fa.short_attention_bsc_plain(q, k, v, heads, scale)
            compare(f"K1 {tag}", fa.short_attention_bsc(q, k, v, heads, scale), want,
                    1e-4 if dt == torch.float32 else bf16_tol(want, 2))
            got = fa.short_attention_bsc_bwd(q, k, v, g, heads, scale)
            check_repeats(f"K2 {tag}", got, fa.short_attention_bsc_bwd(q, k, v, g, heads, scale))
            for name, x, y in zip(("dq", "dk", "dv"), got,
                                  fa.short_attention_bsc_bwd_plain(q, k, v, g, heads, scale)):
                scale_y = y.float().abs().max().item()
                # With one key p is exactly 1 and dq = dk = 0: held exactly.
                compare(f"K2 {name} {tag}", x, y,
                        1e-4 * max(1.0, scale_y) if dt == torch.float32
                        else bf16_tol(y, 2) if scale_y > 0 else 0.0)
    check(seen == set(fa.VARIANTS), f"variants run: {sorted(seen)}")

    log(f"K1 and K2, row variant against stream (ROW_MAX_KEYS = {edge}), B=16 C=256 "
        f"4 heads, device ms per call:")
    for s in THRESHOLD_KEYS:
        for dt in (torch.float32, torch.bfloat16):
            q, k, v = torch.randn((16, s, 3 * 256), generator=gen, device="cuda").to(dt).chunk(3, -1)
            g = torch.randn((16, s, 256), generator=gen, device="cuda").to(dt)
            ms = {}
            for variant, keys in (("row", s), ("stream", 0)):
                fwd = fa.bsc_plan(16, s, s, 4, 64, dt, max_row_keys=keys)
                bwd = fa.bsc_plan(16, s, s, 4, 64, dt, backward=True, max_row_keys=keys)
                check(fwd.variant == bwd.variant == variant, f"{variant} plan at S={s}")
                ms[variant] = (device_ms(lambda: fa._forward(q, k, v, 4, 0.125, fwd)),
                               device_ms(lambda: fa.short_attention_bsc_bwd(q, k, v, g, 4, 0.125,
                                                                            bwd)))
            log(f"  S={s} {dt}: K1 row {ms['row'][0]:.4f} stream {ms['stream'][0]:.4f}; "
                f"K2 row {ms['row'][1]:.4f} stream {ms['stream'][1]:.4f}")


def rel_err(got: torch.Tensor, want: torch.Tensor, floor: float = 0.0) -> float:
    """max |got - want| over max(max |want|, floor)."""
    scale = max(want.float().abs().max().item(), floor, 1e-30)
    return (got.float() - want.float()).abs().max().item() / scale


def phase_gradients(train_sites):
    """Gradients through each autograd.Function on the card (kernels forward,
    K2 or plain autograd backward) against autograd of the plain versions,
    fp32; then K4's backward time (plain autograd) over a training step's
    conv1 sites and K3's over its K3 sites, bf16. Returns both times."""
    from xdiffusion_tpu_torch.ops import flash_attention, fused_resblock, group_norm

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)

    def randn(*shape, scale=1.0, shift=0.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device="cuda") * scale + shift).to(dtype)

    def check_grads(label, fn, plain, inputs, tol):
        leaves = [t.clone().requires_grad_() for t in inputs]
        out = fn(*leaves)
        check(out.grad_fn is not None, f"{label}: the kernel's output has no grad_fn")
        g = randn(*out.shape)
        got = torch.autograd.grad(out, leaves, g)
        ref_leaves = [t.clone().requires_grad_() for t in inputs]
        want = torch.autograd.grad(plain(*ref_leaves), ref_leaves, g)
        err = max(rel_err(x, y) for x, y in zip(got, want))
        log(f"grad {label}: max|d grad| / max|grad| = {err:.3e} tol={tol:.0e}")
        check(err <= tol, f"grad {label}: {err} > {tol}")

    # K1 forward + K2 backward, q/k/v as column slices of one qkv tensor,
    # against autograd of the einsum attention: fp32 sums in other orders.
    b, s, c, heads = 4, 256, 256, 4
    scale = (c // heads) ** -0.5
    check_grads("K1+K2 short_attention_bsc (qkv slices)",
                lambda qkv: flash_attention.short_attention_bsc(*qkv.chunk(3, -1), heads, scale),
                lambda qkv: flash_attention.short_attention_bsc_plain(*qkv.chunk(3, -1), heads,
                                                                      scale),
                [randn(b, s, 3 * c)], 1e-4)
    check_grads("K3 group_norm_silu",
                lambda x, sc, bi: group_norm.group_norm_silu(x, sc, bi, 32),
                lambda x, sc, bi: group_norm.group_norm_silu_plain(x, sc, bi, 32),
                [randn(4, 16, 16, 256, scale=2.0, shift=0.5), randn(256, scale=0.1, shift=1.0),
                 randn(256, scale=0.1)], 1e-4)
    conv_in = [randn(4, 16, 16, 256), randn(4, 256, scale=0.2, shift=1.0),
               randn(4, 256, scale=0.2), randn(3, 3, 256, 128, scale=(9 * 256) ** -0.5),
               randn(128, scale=0.1)]
    check_grads("K4 affine_silu_conv3x3", fused_resblock.affine_silu_conv3x3,
                fused_resblock.affine_silu_conv3x3_plain, conv_in, 1e-4)
    check_grads("K4 affine_silu_conv3x3 + residual", fused_resblock.affine_silu_conv3x3,
                fused_resblock.affine_silu_conv3x3_plain,
                conv_in + [randn(4, 16, 16, 128)], 1e-4)

    total = 0.0
    for (shape, co, has_res), n in counted(train_sites["affine_silu_conv3x3"]).items():
        if has_res:  # conv2 runs as a plain convolution while dropout is on
            continue
        b, h, w, c = shape
        leaves = [randn(*shape, dtype=torch.bfloat16), randn(b, c, scale=0.2, shift=1.0),
                  randn(b, c, scale=0.2),
                  randn(3, 3, c, co, scale=(9 * c) ** -0.5, dtype=torch.bfloat16),
                  randn(co, scale=0.1)]
        leaves = [t.requires_grad_() for t in leaves]
        out = fused_resblock.affine_silu_conv3x3(*leaves)
        g = torch.randn_like(out)
        ms = device_ms(lambda: torch.autograd.grad(out, leaves, g, retain_graph=True))
        log(f"  K4 backward (plain autograd) x={shape} Co={co} x{n}: {ms:.4f} ms")
        total += n * ms
    log(f"K4 backward (plain autograd) per training step, batch {TRAIN_BATCH}, bf16: "
        f"{total:.3f} ms")

    k3 = 0.0
    for (shape, ng, silu), n in counted(train_sites["group_norm_silu"]).items():
        c = shape[-1]
        leaves = [randn(*shape, scale=2.0, shift=0.5, dtype=torch.bfloat16),
                  randn(c, scale=0.1, shift=1.0), randn(c, scale=0.1)]
        leaves = [t.requires_grad_() for t in leaves]
        out = group_norm.group_norm_silu(*leaves, ng, 1e-5, silu)
        g = torch.randn_like(out)
        ms = device_ms(lambda: torch.autograd.grad(out, leaves, g, retain_graph=True))
        log(f"  K3 backward (plain autograd) x={shape} silu={silu} x{n}: {ms:.4f} ms")
        k3 += n * ms
    log(f"K3 backward (plain autograd) per training step, batch {TRAIN_BATCH}, bf16: "
        f"{k3:.4f} ms")
    return total, k3


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
    check(all(anc_launches[name] > 0 for name in MIN_LAUNCHES),
          "ancestral run missed a kernel")
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
    # A bare state dict records no step: the JAX CLI's name with step 0.
    check(os.path.getsize(os.path.join(OUT_DIR, "sample-step0.png")) > 0, "CLI wrote no PNG")
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
    k1 = sum(e.self_device_time_total for e in events if is_k1(e.key)) / 1e3
    k4 = sum(e.self_device_time_total for e in events if is_k4(e.key)) / 1e3
    log(f"profile of one forward (batch {BATCH}, bf16): wall {wall_ms:.3f} ms, device busy "
        f"{device_ms:.3f} ms ({100 * device_ms / wall_ms:.1f}%), "
        f"{sum(e.count for e in events)} device launches; K1 {k1:.3f} ms, K4 {k4:.3f} ms "
        f"({100 * k4 / device_ms:.1f}%)")
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


def flagship_config_file(dtype: str, directory: str, source: str = CONFIG) -> str:
    """The flagship YAML (or `source`) with the score network's dtype set,
    written to `directory` under its own name (train() names its run by it)."""
    import yaml

    with open(source) as f:
        cfg = yaml.safe_load(f)
    cfg["diffusion"]["score_network"]["params"]["dtype"] = dtype
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, os.path.basename(source))
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


# UNet configs beside the flagship that the port runs: v target with the
# cosine schedule, an 8x8 UNet (K4 at 2x2 maps), rectified flow.
UNET_CONFIGS = ("ddpm_32x32_v_discrete.yaml", "ddpm_8x8_epsilon.yaml", "rectified_flow_32x32.yaml")
UNET_CLI_SAMPLES, UNET_CLI_STEPS = 16, 5


def phase_unet_configs():
    """Each of UNET_CONFIGS in bf16 with seeded random weights through the
    sampling CLI: UNET_CLI_STEPS steps of the config's own sampler at batch
    UNET_CLI_SAMPLES, finite samples in [0, 1], the PNG written, and exactly
    one K4 launch per FusedAffineConv site per step."""
    from xdiffusion_tpu_torch import sample as cli
    from xdiffusion_tpu_torch.ops._build import kernels

    ks = kernels()
    for name in UNET_CONFIGS:
        source = os.path.join(ROOT, "configs/image/mnist", name)
        out_dir = os.path.join(OUT_DIR, "unet_configs", name[:-5])
        config = flagship_config_file("bfloat16", out_dir, source)
        model = build_model("bfloat16", "cuda", source)
        size = model.config().diffusion.score_network.params.input_spatial_size
        per_forward = len(main_path_sites(model, UNET_CLI_SAMPLES, size)["affine_silu_conv3x3"])
        ckpt = os.path.join(out_dir, "random_weights.pt")
        torch.save(model.score_network().state_dict(), ckpt)
        del model
        for k in ks.values():
            k.launches = 0
        t0 = time.perf_counter()
        samples = cli.main(["--config_path", config, "--checkpoint", ckpt,
                            "--num_samples", str(UNET_CLI_SAMPLES),
                            "--sampling_steps", str(UNET_CLI_STEPS),
                            "--output_path", out_dir, "--seed", str(SEED)])
        torch.cuda.synchronize()
        k4 = ks["affine_silu_conv3x3"].launches
        log(f"{name} (bf16) through the sampling CLI, {UNET_CLI_STEPS} steps at batch "
            f"{UNET_CLI_SAMPLES}: {time.perf_counter() - t0:.2f} s, {k4} K4 launches "
            f"({per_forward} a forward), samples {tuple(samples.shape)} mean "
            f"{samples.float().mean().item():.4f}")
        check(k4 == UNET_CLI_STEPS * per_forward, f"{name}: {k4} K4 launches")
        check(tuple(samples.shape) == (UNET_CLI_SAMPLES, size, size, 1), f"{name}: samples shape")
        check(bool(torch.isfinite(samples).all()), f"{name}: samples not finite")
        check(samples.min().item() >= 0.0 and samples.max().item() <= 1.0,
              f"{name}: samples outside [0, 1]")
        check(os.path.getsize(os.path.join(out_dir, "sample-step0.png")) > 0, f"{name}: no PNG")
        os.remove(ckpt)



def read_metrics(out_dir: str):
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        return {r["step"]: r for r in map(json.loads, f)}


def phase_training(sites):
    """The flagship's training path in bf16 through train(): launches per
    kernel over the run against the counts the code implies, every step's
    loss and grad_norm, steps/s, checkpoints, sample grids and the resume.
    Returns the run's launches and steps/s."""
    import shutil

    from xdiffusion_tpu_torch.ops._build import kernels
    from xdiffusion_tpu_torch.training.image.train import train

    # Per training step (dropout on): K1 and K2 at every attention site, K3
    # at the attention norms and final_norm, K4 for conv1 of every residual
    # block (conv2 leaves the fused path while dropping). Per sampling
    # forward: K1, K3, and K4 for both convs.
    conv1 = sum(1 for _, _, has_res in sites["affine_silu_conv3x3"] if not has_res)
    per_step = {"bsc_attention": len(sites["bsc_attention"]),
                "bsc_attention_bwd": len(sites["bsc_attention"]),
                "group_norm_silu": len(sites["group_norm_silu"]),
                "affine_silu_conv3x3": conv1}
    per_forward = {"bsc_attention": len(sites["bsc_attention"]),
                   "group_norm_silu": len(sites["group_norm_silu"]),
                   "affine_silu_conv3x3": len(sites["affine_silu_conv3x3"])}
    log(f"training launches per step implied by the code: {per_step}")

    root = os.path.join(OUT_DIR, "train")
    shutil.rmtree(root, ignore_errors=True)
    config = flagship_config_file("bfloat16", root)
    common = dict(batch_size=TRAIN_BATCH, save_and_sample_every_n=RESUME_STEP,
                  num_samples=NUM_SAMPLES, seed=SEED, device="cuda", log_every=1)
    ks = kernels()
    for k in ks.values():
        k.launches = 0
    t0 = time.perf_counter()
    out_dir = train(config, num_training_steps=TRAIN_STEPS,
                    output_path=os.path.join(root, "run"), **common)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {name: k.launches for name, k in ks.items()}
    samplings = 2  # at RESUME_STEP and at the end
    sampling_forwards = samplings * 1000  # the config's 1000-step ancestral sampler
    expected = {name: TRAIN_STEPS * per_step.get(name, 0)
                + sampling_forwards * per_forward.get(name, 0) for name in ks}
    log(f"training run ({TRAIN_STEPS} steps + {samplings} x 1000-step sampling of "
        f"{NUM_SAMPLES}, {run_s:.1f} s): launches {launches}, expected {expected}")
    check(launches == expected, f"training launches {launches} != {expected}")

    metrics = read_metrics(out_dir)
    check(sorted(metrics) == list(range(TRAIN_STEPS)), "metrics.jsonl misses steps")
    for step in range(TRAIN_STEPS):
        r = metrics[step]
        log(f"  step {step:2d}: loss {r['loss']:.6f} grad_norm {r['grad_norm']:.4f}")
        check(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]),
              f"step {step}: loss or grad_norm not finite")
    k = min(5, TRAIN_STEPS // 2)
    first = np.mean([metrics[i]["loss"] for i in range(k)])
    last = np.mean([metrics[i]["loss"] for i in range(TRAIN_STEPS - k, TRAIN_STEPS)])
    log(f"loss trend (not gated): first {k} steps {first:.4f}, last {k} steps {last:.4f}")
    span = metrics[RESUME_STEP - 1]["time"] - metrics[WARMUP_STEPS - 1]["time"]
    sps = TIMED_STEPS / span
    log(f"training throughput: {sps:.3f} steps/s, {sps * TRAIN_BATCH:.1f} images/s "
        f"(steps {WARMUP_STEPS}-{RESUME_STEP - 1}, batch {TRAIN_BATCH}, bf16, a host "
        f"read of the metrics after every step)")
    for name in (f"checkpoints/{RESUME_STEP}.pt", f"checkpoints/{TRAIN_STEPS}.pt",
                 f"sample-{RESUME_STEP}.png", f"sample-{TRAIN_STEPS}.png"):
        path = os.path.join(out_dir, name)
        check(os.path.isfile(path) and os.path.getsize(path) > 0, f"train wrote no {name}")

    resumed = train(config, num_training_steps=RESUME_STEP + 1,
                    output_path=os.path.join(root, "resumed"),
                    resume_from=os.path.join(out_dir, "checkpoints", f"{RESUME_STEP}.pt"),
                    **common)
    want = metrics[RESUME_STEP]["loss"]
    got = read_metrics(resumed)[RESUME_STEP]["loss"]
    log(f"resume from step {RESUME_STEP}: loss {got!r} against the uninterrupted "
        f"run's {want!r} (|diff| {abs(got - want):.3e})")
    check(abs(got - want) <= 1e-6 * abs(want), "the resumed step's loss differs")
    return launches, sps


def profile_train_step():
    """Device time by kernel for one bf16 training step at batch TRAIN_BATCH,
    and the device's busy share of its wall time; the full table goes to
    output/chip_smoke/train_profile.txt."""
    from torch.profiler import ProfilerActivity, profile

    from xdiffusion_tpu_torch.optim import default_optimizer
    from xdiffusion_tpu_torch.train_step import create_train_state, make_train_step

    model = build_model("bfloat16", "cuda")
    state = create_train_state(model, default_optimizer().build(
        model.score_network().parameters()), seed=SEED)
    step = make_train_step(model)
    batch = {"images": torch.rand((TRAIN_BATCH, 32, 32, 1), device="cuda")}
    for _ in range(3):
        step(state, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    k1 = sum(e.self_device_time_total for e in events if is_k1(e.key)) / 1e3
    k2 = sum(e.self_device_time_total for e in events if is_k2(e.key)) / 1e3
    k4 = sum(e.self_device_time_total for e in events if is_k4(e.key)) / 1e3
    log(f"profile of one training step (batch {TRAIN_BATCH}, bf16): wall {wall_ms:.3f} ms, "
        f"device busy {device_ms:.3f} ms ({100 * device_ms / wall_ms:.1f}%), "
        f"{sum(e.count for e in events)} device launches; K1 {k1:.3f} ms, K2 {k2:.3f} ms, "
        f"K4 forward {k4:.3f} ms")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"  {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<4d} {e.key[:90]}")
    with open(os.path.join(OUT_DIR, "train_profile.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total", row_limit=60))


def phase_train_card_vs_cpu():
    """fp32, full width, batch 4: one loss and backward with dropout off and
    the same weights, batch, timesteps and noise, card (kernels) against CPU
    (plain versions)."""
    from xdiffusion_tpu_torch.optim import global_norm

    n = 4
    rng = np.random.default_rng(SEED)
    images = torch.from_numpy(rng.random((n, 32, 32, 1)).astype(np.float32))
    t = torch.from_numpy(rng.integers(0, 1000, size=n))
    noise = torch.from_numpy(rng.standard_normal((n, 32, 32, 1)).astype(np.float32))
    results = {}
    for device in ("cuda", "cpu"):
        model = build_model("float32", device)
        net = model.score_network()
        loss, _ = model.loss_on_batch(images.to(device), {}, timesteps=t.to(device),
                                      noise=noise.to(device), deterministic=True)
        loss.backward()
        grads = {name: p.grad.detach().float().cpu() for name, p in net.named_parameters()}
        results[device] = (loss.item(), global_norm(list(grads.values())).item(), grads)
    (l_gpu, n_gpu, g_gpu), (l_cpu, n_cpu, g_cpu) = results["cuda"], results["cpu"]
    # fp32 on both sides with TF32 off; sums in other orders through the
    # whole network. Each gradient is held to 1e-3 of its largest magnitude,
    # floored at 1e-3 of the network's largest gradient (a bias ahead of a
    # GroupNorm whose groups hold one channel has a true gradient of 0).
    floor = 1e-3 * max(g.abs().max().item() for g in g_cpu.values())
    worst = max((rel_err(g_gpu[k], g_cpu[k], floor), k) for k in g_cpu)
    log(f"card vs CPU training, fp32 batch {n}: loss {l_gpu:.7f} vs {l_cpu:.7f}, "
        f"grad_norm {n_gpu:.6f} vs {n_cpu:.6f}, worst gradient {worst[1]} at {worst[0]:.3e}")
    check(all(g_gpu[k] is not None for k in g_cpu), "a parameter got no gradient on the card")
    check(abs(l_gpu - l_cpu) <= 1e-4 * abs(l_cpu), f"loss {l_gpu} vs {l_cpu}")
    check(abs(n_gpu - n_cpu) <= 1e-4 * abs(n_cpu), f"grad_norm {n_gpu} vs {n_cpu}")
    check(worst[0] <= 1e-3, f"gradient {worst[1]}: {worst[0]} > 1e-3")

# ---- the LTX-Video path (K5) ------------------------------------------------


def ltx_config(directory: str, grid) -> str:
    """The shipped LTX YAML at another (frames, size, size) grid, written to
    `directory`."""
    import yaml

    with open(LTX_CONFIG) as f:
        cfg = yaml.safe_load(f)
    frames, size, _ = grid
    cfg["diffusion"]["score_network"]["params"].update(
        input_spatial_size=size, input_number_of_frames=frames)
    cfg["diffusion"]["sampling"].update(output_spatial_size=size, output_frames=frames)
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, os.path.basename(LTX_CONFIG))
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def build_ltx(device: str, path: str = LTX_CONFIG):
    from xdiffusion_tpu_torch.config import load_yaml
    from xdiffusion_tpu_torch.diffusion.ddpm import GaussianDiffusion_DDPM
    from xdiffusion_tpu_torch.weights import randomize_

    model = GaussianDiffusion_DDPM(load_yaml(path), device=device)
    randomize_(model.score_network(), SEED)
    return model


def ltx_context(model, prompts, t: float = 0.5):
    """One forward's context: the prompts' embeddings and the time t."""
    ctx = model.preprocess_context({"text_prompts": list(prompts)})
    return {"text_embeddings": ctx["text_embeddings"].to(model.device),
            "timestep": torch.full((len(prompts),), t, device=model.device)}


# K5 and K6 per call at each site before their redesign (the final
# chip_smoke.py run of ee190ae, NVIDIA H100 80GB HBM3, 700.00 W), device
# ms: (kernel, site, dtype) -> ms.
FLASH_BEFORE_MS = {
    ("K5", "self 8x8x8", "fp32"): 0.0783, ("K5", "self 8x8x8", "bf16"): 0.0195,
    ("K5", "cross 8x8x8", "fp32"): 0.0234, ("K5", "cross 8x8x8", "bf16"): 0.0084,
    ("K5", "self 16x32x32", "fp32"): 14.0099, ("K5", "self 16x32x32", "bf16"): 2.4543,
    ("K5", "cross 16x32x32", "fp32"): 0.1324, ("K5", "cross 16x32x32", "bf16"): 0.0347,
    ("K6", "self 8x8x8", "fp32"): 0.5455, ("K6", "self 8x8x8", "bf16"): 0.0754,
    ("K6", "cross 8x8x8", "fp32"): 0.1775, ("K6", "cross 8x8x8", "bf16"): 0.0407,
    ("K6", "self 16x32x32", "fp32"): 64.5087, ("K6", "self 16x32x32", "bf16"): 6.5325,
    ("K6", "cross 16x32x32", "fp32"): 3.4919, ("K6", "cross 16x32x32", "bf16"): 0.7108,
}
FLASH_ROWS = []  # per-site rows of phases 7 and 11, for flash_table


def flash_bounds(flops: int, exps: int, nbytes: int, dt) -> dict:
    """The least times of one K5 or K6 call, ms: bytes over the memory rate,
    exponentials over the SFUs' rate, operations over the rate of the
    dtype's units: bf16 on the tensor cores; fp32 both on the CUDA cores
    (PEAK_FP32) and as three TF32 products (PEAK_TF32 / 3). The bound is
    the largest of bytes, exponentials and the smaller operations time."""
    out = {"bytes_ms": nbytes / PEAK_BYTES * 1e3, "exp_ms": exps / PEAK_EXP * 1e3}
    if dt == torch.float32:
        out["cuda_core_ms"] = flops / PEAK_FP32 * 1e3
        out["tf32x3_ms"] = 3 * flops / PEAK_TF32 * 1e3
        ops, unit = min((out["cuda_core_ms"], "fp32 CUDA cores"),
                        (out["tf32x3_ms"], "3 TF32 products"))
    else:
        out["bf16_ms"] = flops / PEAK_BF16 * 1e3
        ops, unit = out["bf16_ms"], "bf16 tensor cores"
    bound = max(out["bytes_ms"], out["exp_ms"], ops)
    out.update(ops_ms=max(ops, out["exp_ms"]), bound_ms=bound,
               binds=("bytes" if bound == out["bytes_ms"] else
                      "exponentials" if bound == out["exp_ms"] else f"flops on the {unit}"))
    return out


def log_flash_site(kernel: str, label: str, dt, n: int, k_ms: float, w_ms: float, p_ms: float,
                   l_ms: float, flops: int, bd: dict) -> None:
    """One site's times beside its bounds, and a row for flash_table."""
    fp32 = dt == torch.float32
    lib = "SDPA" if kernel == "K5" else "SDPA backward"
    rates = (f"fp32 CUDA cores {bd['cuda_core_ms']:.4f}, 3 TF32 products {bd['tf32x3_ms']:.4f}"
             if fp32 else f"bf16 tensor cores {bd['bf16_ms']:.4f}")
    log(f"  x{n} sites: kernel {k_ms:.4f} ms ({flops / k_ms / 1e9:.1f} TFLOP/s; wrapper "
        f"{w_ms:.4f} ms host time), plain {p_ms:.4f} ms, {lib} {l_ms:.4f} ms, bound "
        f"{bd['bound_ms']:.4f} ms ({bd['binds']}; bytes {bd['bytes_ms']:.4f}, exp "
        f"{bd['exp_ms']:.4f}, {rates})")
    dtn = "fp32" if fp32 else "bf16"
    FLASH_ROWS.append({"kernel": kernel, "site": label, "dtype": dtn, "n": n, "ms": k_ms,
                       "wrapper_ms": w_ms, "library_ms": l_ms, "plain_ms": p_ms,
                       "before": FLASH_BEFORE_MS[(kernel, label, dtn)], **bd})


def flash_table(smi: str) -> None:
    """K5 and K6 per site: ee190ae's device ms (FLASH_BEFORE_MS), this run's,
    SDPA's (its backward for K6), the bound and, for fp32, both operations
    bounds."""
    log(f"K5 and K6 per site, device ms a call on {smi} (before: ee190ae's final run; "
        f"bound: fp32 by the smaller of the CUDA cores' and three TF32 products' times):")
    log(f"  {'kernel':6} {'site':15} {'dtype':5} {'x':>3} {'before':>9} {'now':>9} "
        f"{'x faster':>8} {'library':>9} {'bound':>8} {'fp32 CUDA':>9} {'3xTF32':>8} binds")
    for r in FLASH_ROWS:
        log(f"  {r['kernel']:6} {r['site']:15} {r['dtype']:5} {r['n']:3d} {r['before']:9.4f} "
            f"{r['ms']:9.4f} {r['before'] / r['ms']:8.2f} {r['library_ms']:9.4f} "
            f"{r['bound_ms']:8.4f} {r.get('cuda_core_ms', float('nan')):9.4f} "
            f"{r.get('tf32x3_ms', float('nan')):8.4f} {r['binds']}")
    for kernel, unit in (("K5", "LTX forward at batch 4"), ("K6", "LTX training step at batch 8")):
        for dtn in ("fp32", "bf16"):
            rows = [r for r in FLASH_ROWS if r["kernel"] == kernel and r["dtype"] == dtn
                    and "8x8x8" in r["site"]]
            sums = {k: sum(r["n"] * r[k] for r in rows)
                    for k in ("before", "ms", "library_ms", "bound_ms", "wrapper_ms")}
            log(f"  {kernel} {dtn} per {unit}: before {sums['before']:.4f}, now "
                f"{sums['ms']:.4f} (wrapper {sums['wrapper_ms']:.4f} host), library "
                f"{sums['library_ms']:.4f}, bound {sums['bound_ms']:.4f}")


def phase_k5():
    """K5 against its plain version at the LTX path's four site shapes, fp32
    and bf16: o within a tolerance, lse within a relative bound. Times (K5,
    plain, SDPA) and the bound at each; the main path's per-forward sums
    (fp32, batch 4, shipped grid) go into the returned JSON record."""
    from xdiffusion_tpu_torch.ops import flash_attention as fa
    from xdiffusion_tpu_torch.ops.attention import dot_product_attention

    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    heads, d = 6, 64
    n_long = LTX_LONG_GRID[0] * LTX_LONG_GRID[1] * LTX_LONG_GRID[2]
    # (label, batch, Sq, Sk, sites per forward); the first two are the main path's.
    shapes = [("self 8x8x8", LTX_BATCH, 512, 512, 12), ("cross 8x8x8", LTX_BATCH, 512, 128, 12),
              ("self 16x32x32", 1, n_long, n_long, 12), ("cross 16x32x32", 1, n_long, 128, 12)]
    rec = new_record()
    for label, b, sq, sk, n in shapes:
        for dt in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn((b, heads, s, d), generator=gen, device="cuda").to(dt)
                       for s in (sq, sk, sk))
            scale = d ** -0.5
            o, lse = fa.flash_attention(q, k, v, scale)
            want_o, want_lse = fa.flash_attention_plain(q, k, v, scale)
            # fp32: sums in another order (and K5's online rescaling): 1e-5
            # of the output's scale. bf16: K5 rounds the unnormalised p of
            # each 64-key tile where the plain version rounds the normalised
            # p: 2 bf16 ulps at the reference's largest value, with no floor
            # (at 16,384 keys |o| peaks near 0.08). lse: fp32 on both sides,
            # relative 1e-5.
            tol = (1e-5 * max(1.0, want_o.float().abs().max().item())
                   if dt == torch.float32 else bf16_tol(want_o, 2))
            err = compare(f"K5 flash_attention {label} B={b} H={heads} Sq={sq} Sk={sk} "
                          f"D={d} {dt} o", o, want_o, tol)
            lse_err = rel_err(lse, want_lse)
            log(f"  lse: max|kernel-plain| / max|plain| = {lse_err:.3e} tol 1e-5")
            check(lse_err <= 1e-5, f"K5 {label} {dt}: lse error {lse_err}")
            if (label, dt) in ((shapes[0][0], torch.float32), (shapes[1][0], torch.float32)):
                rec["err"] = max(rec["err"], err)
            del want_o, want_lse
            check_repeats(f"K5 {label} {dt}", (o, lse), fa.flash_attention(q, k, v, scale))
            flops, exps = 4 * b * heads * sq * sk * d, b * heads * sq * sk
            nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size() + lse.numel() * 4
            iters = 20 if sq * sk <= 512 * 512 else 5
            k_ms = device_ms(lambda: fa.flash_attention(q, k, v, scale), iters)
            w_ms = time_ms(lambda: fa.flash_attention(q, k, v, scale), iters)
            p_ms = device_ms(lambda: fa.flash_attention_plain(q, k, v, scale), iters)
            l_ms = device_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale),
                             iters)
            bd = flash_bounds(flops, exps, nbytes, dt)
            log_flash_site("K5", label, dt, n, k_ms, w_ms, p_ms, l_ms, flops, bd)
            if label in (shapes[0][0], shapes[1][0]) and dt == torch.float32:
                for key, val in (("ms", k_ms), ("wrapper_ms", w_ms), ("plain_ms", p_ms),
                                 ("library_ms", l_ms), ("bytes_ms", bd["bytes_ms"]),
                                 ("ops_ms", bd["ops_ms"]), ("bound_ms", bd["bound_ms"])):
                    rec[key] += n * val
            del q, k, v, o, lse
            torch.cuda.empty_cache()

    # What K5 refuses on CUDA tensors: a head dim it has no variant for, and
    # (through the dispatch) a causal call.
    q = torch.randn((1, 2, 64, 32), device="cuda")
    try:
        fa.flash_attention(q, q, q, 0.125)
    except ValueError as e:
        log(f"K5 refuses head dim 32: {e}")
    else:
        raise PhaseError("K5 took head dim 32")
    q = torch.randn((1, 2, 64, 64), device="cuda")
    try:
        dot_product_attention(q, q, q, is_causal=True)
    except NotImplementedError as e:
        log(f"a causal call on CUDA raises: {e}")
    else:
        raise PhaseError("a causal call on CUDA did not raise")
    return ("flash_attention", fa.FLASH_KERNEL, rec)


def reset_launches():
    from xdiffusion_tpu_torch.ops._build import kernels

    ks = kernels()
    for k in ks.values():
        k.launches = 0
    return ks


def phase_ltx_main_path():
    """The shipped LTX config, fp32, batch 4, 1000 Euler steps timed through
    `sample`: exactly 24 K5 launches per forward and no other kernel; then
    10 steps through the video CLI. Returns (K5 launches of the timed run,
    samples/s)."""
    from xdiffusion_tpu_torch import sample_video as cli
    from xdiffusion_tpu_torch.ops import flash_attention as fa

    model = build_ltx("cuda")
    prompts = [str(i) for i in range(LTX_BATCH)]
    steps = model.noise_scheduler().steps()

    def run(num_steps):
        g = torch.Generator(device="cuda").manual_seed(SEED)
        return model.sample(num_samples=LTX_BATCH, context={"text_prompts": prompts},
                            num_sampling_steps=num_steps, generator=g)

    run(3)  # warm-up: kernel load, cuBLAS handles, allocator
    torch.cuda.synchronize()
    ks = reset_launches()
    t0 = time.perf_counter()
    out = run(steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: k.launches for name, k in ks.items()}
    sps = LTX_BATCH / wall
    log(f"LTX main path: {steps}-step rectified flow, batch {LTX_BATCH}, fp32: {wall:.2f} s, "
        f"{sps:.4f} samples/s, launches {launches}")
    want = {name: 0 for name in launches}
    want["flash_attention"] = 24 * steps
    check(launches == want, f"LTX launches {launches} != {want}")
    check(tuple(out.shape) == (LTX_BATCH, 8, 8, 8, 1), f"LTX samples shape {tuple(out.shape)}")
    check(bool(torch.isfinite(out).all()), "LTX samples not finite")
    log(f"LTX samples: mean {out.mean().item():.4f} std {out.std().item():.4f}")

    out_dir = os.path.join(OUT_DIR, "ltx")
    cli.save_video_strip(out.cpu().numpy(), os.path.join(out_dir, "samples.png"))

    # The CLI, from a saved checkpoint, for the last 10 of the 1000 steps:
    # with the same seed it must repeat sample()'s samples and write a strip.
    cli_steps = 10
    ckpt = os.path.join(out_dir, "random_weights.pt")
    torch.save(model.score_network().state_dict(), ckpt)
    want = run(cli_steps)
    cli_dir = os.path.join(out_dir, "cli")
    reset_launches()
    cli_out = cli.main(["--config_path", LTX_CONFIG, "--checkpoint", ckpt,
                        "--num_samples", str(LTX_BATCH), "--output_path", cli_dir,
                        "--seed", str(SEED), "--sampling_steps", str(cli_steps)])
    torch.cuda.synchronize()
    check(fa.FLASH_KERNEL.launches == 24 * cli_steps, "the CLI run missed K5 launches")
    diff = (cli_out - want).abs().max().item()
    log(f"video CLI: {cli_steps} steps, max|CLI - sample()| = {diff:.3e}")
    check(diff <= 1e-6, f"the CLI's samples differ from sample()'s by {diff}")
    png = os.path.join(cli_dir, "samples.png")
    check(os.path.isfile(png) and os.path.getsize(png) > 0, "the video CLI wrote no PNG")
    os.remove(ckpt)

    profile_ltx_forward(model, prompts)
    return launches["flash_attention"], sps


def profile_ltx_forward(model, prompts):
    """Device time by kernel for one LTX forward at batch LTX_BATCH, fp32,
    the device's busy share of its wall time, and launches per forward; the
    table goes to output/chip_smoke/ltx_profile.txt."""
    from torch.profiler import ProfilerActivity, profile

    from xdiffusion_tpu_torch.ops import flash_attention as fa

    x = torch.randn((LTX_BATCH, 8, 8, 8, 1), device="cuda")
    ctx = ltx_context(model, prompts)
    with torch.inference_mode():
        for _ in range(3):
            model.predict_score(x, ctx)
        torch.cuda.synchronize()
        fa.FLASH_KERNEL.launches = 0
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model.predict_score(x, ctx)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    log(f"profile of one LTX forward (batch {LTX_BATCH}, fp32, 512 tokens): wall "
        f"{wall_ms:.3f} ms, device busy {device_ms:.3f} ms ({100 * device_ms / wall_ms:.1f}%), "
        f"{sum(e.count for e in events)} device launches, {fa.FLASH_KERNEL.launches} of K5")
    check(fa.FLASH_KERNEL.launches == 24, "one LTX forward did not launch K5 24 times")
    k5_ms = sum(e.self_device_time_total for e in events if "flash_fwd" in e.key) / 1e3
    log(f"  K5 in that forward: {k5_ms:.4f} ms of device time over "
        f"{sum(e.count for e in events if 'flash_fwd' in e.key)} kernels")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"  {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<4d} {e.key[:90]}")
    with open(os.path.join(OUT_DIR, "ltx_profile.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total", row_limit=60))


def phase_ltx_long():
    """The LTX config at a 16x32x32 grid, batch 1: one forward and a 10-step
    sample, fp32 and then with the network cast to bf16. Returns the
    seconds per forward by dtype."""
    from xdiffusion_tpu_torch.ops import flash_attention as fa

    path = ltx_config(os.path.join(OUT_DIR, "ltx_long"), LTX_LONG_GRID)
    model = build_ltx("cuda", path)
    steps = 10
    x = torch.randn((1, *LTX_LONG_GRID, 1), generator=torch.Generator(device="cuda")
                    .manual_seed(SEED), device="cuda")
    ctx = ltx_context(model, ["0"])
    per_forward, outs = {}, {}
    for name, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        model.score_network().to(dt)
        with torch.inference_mode():
            model.predict_score(x, ctx)  # warm-up
            torch.cuda.synchronize()
            fa.FLASH_KERNEL.launches = 0
            t0 = time.perf_counter()
            out = model.predict_score(x, ctx)
            torch.cuda.synchronize()
            fwd_s = time.perf_counter() - t0
        check(fa.FLASH_KERNEL.launches == 24, f"long {name} forward: K5 launches "
              f"{fa.FLASH_KERNEL.launches} != 24")
        check(tuple(out.shape) == (1, *LTX_LONG_GRID, 1) and bool(torch.isfinite(out).all()),
              f"long {name} forward: shape {tuple(out.shape)} or not finite")
        outs[name] = out.float()
        g = torch.Generator(device="cuda").manual_seed(SEED)
        t0 = time.perf_counter()
        samples = model.sample(num_samples=1, context={"text_prompts": ["0"]},
                               num_sampling_steps=steps, generator=g)
        torch.cuda.synchronize()
        sample_s = time.perf_counter() - t0
        check(bool(torch.isfinite(samples).all()), f"long {name} samples not finite")
        per_forward[name] = fwd_s
        log(f"LTX long video {LTX_LONG_GRID} (16,384 tokens), batch 1, {name}: "
            f"{fwd_s:.4f} s/forward, {steps}-step sample {sample_s:.3f} s "
            f"({sample_s / steps:.4f} s/step), peak memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    log(f"long video, bf16 against fp32 forward (not gated): max|diff| / max|fp32| = "
        f"{rel_err(outs['bf16'], outs['fp32']):.3e}")
    return per_forward


def phase_ltx_card_vs_cpu():
    """fp32, batch 2, the shipped shape: one forward and 10 Euler steps with
    the same weights, prompts, initial noise and sampling noise, the card
    (K5) against the CPU (plain)."""
    n, steps = 2, 10
    rng = np.random.default_rng(SEED)
    x = torch.from_numpy(rng.standard_normal((n, 8, 8, 8, 1)).astype(np.float32))
    init = torch.from_numpy(rng.standard_normal((n, 8, 8, 8, 1)).astype(np.float32))
    noise = torch.from_numpy(rng.standard_normal((steps, n, 8, 8, 8, 1)).astype(np.float32))
    prompts = ["0", "1"]
    fwd, samples = {}, {}
    for device in ("cuda", "cpu"):
        model = build_ltx(device)
        with torch.inference_mode():
            fwd[device] = model.predict_score(x.to(device), ltx_context(model, prompts, 0.3)).cpu()
        samples[device] = model.sample(num_samples=n, num_sampling_steps=steps,
                                       initial_noise=init,
                                       context={"text_prompts": prompts,
                                                "sampling_noise": noise}).cpu()
    # fp32 on both sides (TF32 off); sums in other orders through 12 blocks.
    f_err = rel_err(fwd["cuda"], fwd["cpu"])
    s_err = (samples["cuda"] - samples["cpu"]).abs().max().item()
    log(f"LTX card vs CPU, fp32 batch {n}: one forward max|diff| / max|CPU| = {f_err:.3e} "
        f"(tol 1e-4); {steps}-step samples max|diff| = {s_err:.3e} (tol 1e-4)")
    check(f_err <= 1e-4, f"LTX card vs CPU forward: {f_err}")
    check(s_err <= 1e-4, f"LTX card vs CPU samples: {s_err}")


# ---- the LTX-Video training path (K6) ----------------------------------------


def heads_view(gen, b: int, s: int, h: int, d: int, dtype) -> torch.Tensor:
    """A random (B, H, S, D) view of (B, S, H, D) storage, as LTX's head
    split gives K5 and K6 their operands."""
    return torch.randn((b, s, h, d), generator=gen, device="cuda").to(dtype).transpose(1, 2)


def bwd_plain_by_head(q, k, v, o, lse, g, scale):
    """K6's plain version one head at a time: at 16,384 tokens each of its
    (Sq, Sk) fp32 tensors holds 6.4 GB over six heads."""
    from xdiffusion_tpu_torch.ops import flash_attention as fa

    parts = [fa.flash_attention_bwd_plain(*(t[:, i:i + 1] for t in (q, k, v, o, lse, g)), scale)
             for i in range(q.shape[1])]
    return tuple(torch.cat(p, dim=1) for p in zip(*parts))


def phase_k6():
    """K6 against its plain version at the LTX training path's four site
    shapes, fp32 and bf16, both from the same K5 o and lse; times (K6,
    plain, SDPA's backward) and the bound at each; the main path's
    per-step sums (fp32, batch 8, shipped grid) go into the returned JSON
    record. Then the gradients through `flash_attention` and K6's refusals."""
    from xdiffusion_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    heads, d = 6, 64
    scale = d ** -0.5
    n_long = LTX_LONG_GRID[0] * LTX_LONG_GRID[1] * LTX_LONG_GRID[2]
    # (label, batch, Sq, Sk, sites per training step); the first two are the
    # main path's.
    shapes = [("self 8x8x8", LTX_TRAIN_BATCH, 512, 512, 12),
              ("cross 8x8x8", LTX_TRAIN_BATCH, 512, 128, 12),
              ("self 16x32x32", 1, n_long, n_long, 12), ("cross 16x32x32", 1, n_long, 128, 12)]
    rec = new_record()
    for label, b, sq, sk, n in shapes:
        main_path = b == LTX_TRAIN_BATCH
        plain = fa.flash_attention_bwd_plain if main_path else bwd_plain_by_head
        for dt in (torch.float32, torch.bfloat16):
            q, g = heads_view(gen, b, sq, heads, d, dt), heads_view(gen, b, sq, heads, d, dt)
            k, v = heads_view(gen, b, sk, heads, d, dt), heads_view(gen, b, sk, heads, d, dt)
            o, lse = fa.flash_attention(q, k, v, scale)
            args = (q, k, v, o, lse, g, scale)
            want = plain(*args)
            got = fa.flash_attention_bwd(*args)
            # fp32: sums in other orders: 1e-5 of each output's scale. bf16:
            # both sides round ds (and dv's p) alike; the products sum in
            # another order: 2 bf16 ulps at each reference's largest value,
            # with no floor.
            err = 0.0
            for name, x, y in zip(("dq", "dk", "dv"), got, want):
                tol = (1e-5 * max(1.0, y.float().abs().max().item()) if dt == torch.float32
                       else bf16_tol(y, 2))
                err = max(err, compare(f"K6 flash_attention_bwd {name} {label} B={b} "
                                       f"H={heads} Sq={sq} Sk={sk} D={d} {dt}", x, y, tol))
            if main_path and dt == torch.float32:
                rec["err"] = max(rec["err"], err)
            del want
            check_repeats(f"K6 {label} {dt}", got, fa.flash_attention_bwd(*args))
            del got
            torch.cuda.empty_cache()
            flops, exps = 10 * b * heads * sq * sk * d, b * heads * sq * sk
            nbytes = (4 * q.numel() + 4 * k.numel()) * q.element_size() + lse.numel() * 4
            iters = 20 if main_path else 3
            k_ms = device_ms(lambda: fa.flash_attention_bwd(*args), iters)
            w_ms = time_ms(lambda: fa.flash_attention_bwd(*args), iters)
            p_ms = device_ms(lambda: plain(*args), iters, warmup=1)
            torch.cuda.empty_cache()
            qh, kh, vh = (t.detach().clone().requires_grad_() for t in (q, k, v))
            out = F.scaled_dot_product_attention(qh, kh, vh, scale=scale)
            l_ms = device_ms(lambda: torch.autograd.grad(out, (qh, kh, vh), g,
                                                         retain_graph=True), iters)
            bd = flash_bounds(flops, exps, nbytes, dt)
            log_flash_site("K6", label, dt, n, k_ms, w_ms, p_ms, l_ms, flops, bd)
            if main_path and dt == torch.float32:
                for key, val in (("ms", k_ms), ("wrapper_ms", w_ms), ("plain_ms", p_ms),
                                 ("library_ms", l_ms), ("bytes_ms", bd["bytes_ms"]),
                                 ("ops_ms", bd["ops_ms"]), ("bound_ms", bd["bound_ms"])):
                    rec[key] += n * val
            del q, k, v, g, o, lse, qh, kh, vh, out, args
            torch.cuda.empty_cache()

    # The Function: K5 forward and K6 backward on LTX's strided views (q, k
    # and v as column slices of one projection; cross-attention's k and v
    # from another), against autograd of the plain forward. fp32: 1e-5.
    b, s, sk, c = 2, 512, 128, heads * d

    def split(t, rows):
        return t.reshape(b, rows, heads, d).transpose(1, 2)

    def self_attn(attn):
        return lambda qkv: attn(*(split(t, s) for t in qkv.chunk(3, -1)), scale)[0]

    def cross_attn(attn):
        return lambda q, kv: attn(split(q, s), *(split(t, sk) for t in kv.chunk(2, -1)),
                                  scale)[0]

    for label, kernel, plain, inputs in (
            ("self (qkv slices)", self_attn(fa.flash_attention),
             self_attn(fa.flash_attention_plain),
             [torch.randn((b, s, 3 * c), generator=gen, device="cuda")]),
            ("cross", cross_attn(fa.flash_attention), cross_attn(fa.flash_attention_plain),
             [torch.randn((b, s, c), generator=gen, device="cuda"),
              torch.randn((b, sk, 2 * c), generator=gen, device="cuda")])):
        leaves = [t.clone().requires_grad_() for t in inputs]
        before = fa.FLASH_BWD_KERNEL.launches
        out = kernel(*leaves)
        gout = torch.randn(out.shape, generator=gen, device="cuda")
        got = torch.autograd.grad(out, leaves, gout)
        check(fa.FLASH_BWD_KERNEL.launches == before + 1, f"grad {label}: K6 not launched")
        ref = [t.clone().requires_grad_() for t in inputs]
        want = torch.autograd.grad(plain(*ref), ref, gout)
        err = max(rel_err(x, y) for x, y in zip(got, want))
        log(f"grad K5+K6 flash_attention {label}: max|d grad| / max|grad| = {err:.3e} tol 1e-5")
        check(err <= 1e-5, f"grad K5+K6 {label}: {err}")

    # What K6 refuses on CUDA tensors: a head dim it has no variant for,
    # and operands of mixed dtypes.
    t32 = torch.randn((1, 2, 64, 32), device="cuda")
    lse = torch.zeros((1, 2, 64, 1), device="cuda")
    t64 = torch.randn((1, 2, 64, 64), device="cuda")
    for label, args, exc in (("head dim 32", (t32,) * 4 + (lse, t32), ValueError),
                             ("mixed dtypes", (t64, t64.bfloat16(), t64, t64, lse, t64),
                              TypeError)):
        try:
            fa.flash_attention_bwd(*args, 0.125)
        except exc as e:
            log(f"K6 refuses {label}: {e}")
        else:
            raise PhaseError(f"K6 took {label}")
    return ("flash_attention_bwd", fa.FLASH_BWD_KERNEL, rec)


def phase_ltx_training():
    """The shipped LTX config, fp32, batch 8, through the video train():
    launches per kernel against the counts the code implies, every step's
    loss and grad_norm, steps/s, checkpoints, strips, the bit-exact resume,
    then the CLI. Returns (K6 launches of the run, steps/s)."""
    import shutil

    from xdiffusion_tpu_torch import train_video as cli
    from xdiffusion_tpu_torch.training.video.train import train

    # Per training step K5 and K6 at each of the 24 attention sites (12
    # self, 12 caption cross); per sampling forward K5 at the 24 sites.
    samplings = 2  # at RESUME_STEP and at the end
    expected = {name: 0 for name in reset_launches()}
    expected["flash_attention"] = 24 * TRAIN_STEPS + 24 * samplings * LTX_STRIP_STEPS
    expected["flash_attention_bwd"] = 24 * TRAIN_STEPS
    root = os.path.join(OUT_DIR, "ltx_train")
    shutil.rmtree(root, ignore_errors=True)
    common = dict(batch_size=LTX_TRAIN_BATCH, save_and_sample_every_n=RESUME_STEP,
                  num_samples=LTX_BATCH, sampling_steps=LTX_STRIP_STEPS, seed=SEED,
                  log_every=1)
    ks = reset_launches()
    t0 = time.perf_counter()
    out_dir = train(LTX_CONFIG, num_training_steps=TRAIN_STEPS,
                    output_path=os.path.join(root, "run"), **common)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {name: k.launches for name, k in ks.items()}
    log(f"LTX training run ({TRAIN_STEPS} steps at batch {LTX_TRAIN_BATCH}, fp32, + "
        f"{samplings} x {LTX_STRIP_STEPS}-step strips of {LTX_BATCH}, {run_s:.1f} s): "
        f"launches {launches}, expected {expected}")
    check(launches == expected, f"LTX training launches {launches} != {expected}")

    metrics = read_metrics(out_dir)
    check(sorted(metrics) == list(range(TRAIN_STEPS)), "LTX metrics.jsonl misses steps")
    for step in range(TRAIN_STEPS):
        r = metrics[step]
        log(f"  step {step:2d}: loss {r['loss']:.6f} grad_norm {r['grad_norm']:.4f}")
        check(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]),
              f"LTX step {step}: loss or grad_norm not finite")
    span = metrics[RESUME_STEP - 1]["time"] - metrics[WARMUP_STEPS - 1]["time"]
    sps = TIMED_STEPS / span
    log(f"LTX training throughput: {sps:.3f} steps/s, {sps * LTX_TRAIN_BATCH:.1f} videos/s "
        f"(steps {WARMUP_STEPS}-{RESUME_STEP - 1}, batch {LTX_TRAIN_BATCH}, fp32, a host "
        f"read of the metrics after every step)")
    for name in (f"checkpoints/{RESUME_STEP}.pt", f"checkpoints/{TRAIN_STEPS}.pt",
                 f"sample-{RESUME_STEP}.png", f"sample-{TRAIN_STEPS}.png"):
        path = os.path.join(out_dir, name)
        check(os.path.isfile(path) and os.path.getsize(path) > 0, f"LTX train wrote no {name}")

    resumed = train(LTX_CONFIG, num_training_steps=RESUME_STEP + 1,
                    output_path=os.path.join(root, "resumed"),
                    resume_from=os.path.join(out_dir, "checkpoints", f"{RESUME_STEP}.pt"),
                    **common)
    want = metrics[RESUME_STEP]["loss"]
    got = read_metrics(resumed)[RESUME_STEP]["loss"]
    log(f"LTX resume from step {RESUME_STEP}: loss {got!r} against the uninterrupted "
        f"run's {want!r}")
    check(got == want, "the resumed LTX step's loss differs")

    cli_steps = 3
    cli_dir = cli.main(["--config_path", LTX_CONFIG, "--num_training_steps", str(cli_steps),
                        "--batch_size", str(LTX_TRAIN_BATCH), "--sampling_steps", "2",
                        "--output_path", os.path.join(root, "cli")])
    cli_metrics = read_metrics(cli_dir)  # the first and the last step
    check(sorted(cli_metrics) == [0, cli_steps - 1], "the video training CLI missed steps")
    check(all(np.isfinite(r["loss"]) for r in cli_metrics.values()), "CLI loss not finite")
    for name in (f"checkpoints/{cli_steps}.pt", f"sample-{cli_steps}.png"):
        check(os.path.isfile(os.path.join(cli_dir, name)),
              f"the video training CLI wrote no {name}")
    log(f"video training CLI: {cli_steps} steps, losses "
        f"{[round(r['loss'], 6) for r in cli_metrics.values()]}")
    return launches["flash_attention_bwd"], sps


def ltx_train_batch(model, b: int, grid, seed: int = SEED):
    """(images, context, timesteps, noise) of one LTX training step: seeded
    videos in [0, 1], the prompts' embeddings, an all-True frame mask (the
    identity mask generator's), logit-normal-like times and noise; on the
    host, as numpy draws."""
    rng = np.random.default_rng(seed)
    shape = (b, *grid, 1)
    images = torch.from_numpy(rng.random(shape).astype(np.float32))
    t = torch.from_numpy((1.0 / (1.0 + np.exp(-rng.standard_normal(b)))).astype(np.float32))
    noise = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    emb = model.preprocess_context({"text_prompts": [str(i % 10) for i in range(b)]})
    context = {"text_embeddings": emb["text_embeddings"],
               "video_mask": torch.ones((b, grid[0]), dtype=torch.bool)}
    return images, context, t, noise


def on(device, images, context, t, noise):
    return (images.to(device), {k: v.to(device) for k, v in context.items()}, t.to(device),
            noise.to(device))


def profile_step(label: str, step, out_file=None):
    """Profiles one call of `step` (which ends on the host): wall time, the
    device's busy time and share, K5's and K6's device time and the top
    kernels; returns (wall ms, device ms, K6 ms)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    busy = sum(e.self_device_time_total for e in events) / 1e3
    k6 = sum(e.self_device_time_total for e in events
             if any(n in e.key for n in ("flash_dq_", "flash_dkv_", "flash_split_sum"))) / 1e3
    k5 = sum(e.self_device_time_total for e in events if "flash_fwd" in e.key) / 1e3
    log(f"profile of {label}: wall {wall_ms:.3f} ms, device busy {busy:.3f} ms "
        f"({100 * busy / wall_ms:.1f}%), {sum(e.count for e in events)} device launches; "
        f"K5 {k5:.3f} ms, K6 {k6:.3f} ms ({100 * k6 / busy:.1f}% of device time)")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"  {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<4d} {e.key[:90]}")
    if out_file:
        with open(os.path.join(OUT_DIR, out_file), "w") as f:
            f.write(prof.key_averages().table(sort_by="self_device_time_total", row_limit=60))
    return wall_ms, busy, k6


def profile_ltx_train_step():
    """One fp32 LTX training step at batch 8 (the train step of phase 12 on
    a seeded batch), profiled into output/chip_smoke/ltx_train_profile.txt;
    exactly 24 K5 and 24 K6 launches."""
    from xdiffusion_tpu_torch.optim import default_optimizer
    from xdiffusion_tpu_torch.train_step import create_train_state, make_train_step

    model = build_ltx("cuda")
    state = create_train_state(model, default_optimizer().build(
        model.score_network().parameters()), seed=SEED)
    step = make_train_step(model)
    images, context, t, _ = on("cuda", *ltx_train_batch(model, LTX_TRAIN_BATCH, (8, 8, 8)))
    batch = {"images": images, **context}
    for _ in range(3):
        step(state, batch)
    ks = reset_launches()
    profile_step(f"one LTX training step (batch {LTX_TRAIN_BATCH}, fp32, 512 tokens)",
                 lambda: step(state, batch)["loss"].item(), "ltx_train_profile.txt")
    counts = {name: k.launches for name, k in ks.items() if k.launches}
    check(counts == {"flash_attention": 24, "flash_attention_bwd": 24},
          f"one LTX training step launched {counts}")


def phase_ltx_long_training():
    """One loss and backward of the LTX network at the 16x32x32 grid (16,384
    tokens), batch 1, fp32 and with the network cast to bf16: K6's share of
    the step's device time. Returns {dtype: (wall ms, K6 ms)}."""
    from xdiffusion_tpu_torch.ops import flash_attention as fa

    path = ltx_config(os.path.join(OUT_DIR, "ltx_long"), LTX_LONG_GRID)
    model = build_ltx("cuda", path)
    net = model.score_network()
    images, context, t, noise = on("cuda", *ltx_train_batch(model, 1, LTX_LONG_GRID))
    out = {}
    for name, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        net.to(dt)

        def step():
            net.zero_grad(set_to_none=True)
            gen = torch.Generator(device="cuda").manual_seed(SEED)  # the guidance drop
            loss, _ = model.loss_on_batch(images, context, timesteps=t, noise=noise,
                                          generator=gen)
            loss.backward()
            return loss.item()

        step()  # warm-up
        fa.FLASH_BWD_KERNEL.launches = 0
        wall, busy, k6 = profile_step(f"one LTX loss + backward at 16,384 tokens, batch 1, "
                                      f"{name}", step)
        check(fa.FLASH_BWD_KERNEL.launches == 24, f"long {name} step: K6 launches "
              f"{fa.FLASH_BWD_KERNEL.launches} != 24")
        check(all(p.grad is not None and bool(torch.isfinite(p.grad).all())
                  for p in net.parameters()), f"long {name} step: a gradient missing or "
              f"not finite")
        log(f"LTX long video training step {LTX_LONG_GRID}, {name}: {wall:.1f} ms wall, K6 "
            f"{k6:.1f} ms = {100 * k6 / wall:.1f}% of the step, peak memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
        out[name] = (wall, k6)
    return out


def phase_ltx_train_card_vs_cpu():
    """fp32, batch 2, the shipped shape: one loss and backward with the same
    weights, batch, mask, text embeddings, times and noise, no guidance drop
    and no dropout: card (K5, K6) against CPU (plain versions)."""
    import yaml

    from xdiffusion_tpu_torch.optim import global_norm

    with open(LTX_CONFIG) as f:
        cfg = yaml.safe_load(f)
    cfg["diffusion"]["classifier_free_guidance"]["unconditional_guidance_probability"] = 0.0
    path = os.path.join(OUT_DIR, "ltx_no_drop", os.path.basename(LTX_CONFIG))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    results = {}
    for device in ("cuda", "cpu"):
        model = build_ltx(device, path)
        net = model.score_network()
        images, context, t, noise = on(device, *ltx_train_batch(model, 2, (8, 8, 8)))
        loss, _ = model.loss_on_batch(images, context, timesteps=t, noise=noise,
                                      deterministic=True)
        loss.backward()
        grads = {n: p.grad.detach().float().cpu() for n, p in net.named_parameters()}
        results[device] = (loss.item(), global_norm(list(grads.values())).item(), grads)
    (l_gpu, n_gpu, g_gpu), (l_cpu, n_cpu, g_cpu) = results["cuda"], results["cpu"]
    # fp32 on both sides with TF32 off; sums in other orders through 12
    # blocks. Each gradient is held to 1e-3 of its largest magnitude,
    # floored at 1e-3 of the network's largest gradient, as phase 6 holds
    # the UNet's.
    floor = 1e-3 * max(g.abs().max().item() for g in g_cpu.values())
    worst = max((rel_err(g_gpu[k], g_cpu[k], floor), k) for k in g_cpu)
    log(f"LTX card vs CPU training, fp32 batch 2: loss {l_gpu:.7f} vs {l_cpu:.7f}, grad_norm "
        f"{n_gpu:.6f} vs {n_cpu:.6f}, worst gradient {worst[1]} at {worst[0]:.3e}")
    check(abs(l_gpu - l_cpu) <= 1e-5 * abs(l_cpu), f"LTX loss {l_gpu} vs {l_cpu}")
    check(abs(n_gpu - n_cpu) <= 1e-4 * abs(n_cpu), f"LTX grad_norm {n_gpu} vs {n_cpu}")
    check(worst[0] <= 1e-3, f"LTX gradient {worst[1]}: {worst[0]} > 1e-3")


# ---- K7 and the DiT path ------------------------------------------------------


def attention_bound(b: int, h: int, sq: int, sk: int, d: int, dtype):
    """(bound ms, what binds it, bytes ms, operations ms) of non-causal
    attention: q, k, v read and o written once; 4 b h sq sk d flops at the
    dtype's peak (fp32: the CUDA cores); b h sq sk exponentials."""
    item = 4 if dtype == torch.float32 else 2
    nbytes = (2 * b * h * sq * d + 2 * b * h * sk * d) * item
    peak = PEAK_FP32 if dtype == torch.float32 else PEAK_BF16
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    flops_ms = 4 * b * h * sq * sk * d / peak * 1e3
    exp_ms = b * h * sq * sk / PEAK_EXP * 1e3
    bound = max(bytes_ms, flops_ms, exp_ms)
    binds = "bytes" if bound == bytes_ms else "flops" if bound == flops_ms else "exponentials"
    return bound, binds, bytes_ms, max(flops_ms, exp_ms)


def phase_k7():
    """K7 against its plain version at three head-major shapes, fp32 and
    bf16, with its times; the gradients through `short_attention` on the
    card against the CPU; its refusals. Returns its JSON record (the DiT
    site's shape, fp32, one call)."""
    from xdiffusion_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    shapes = [("DiT site", 128, 6, 16, 64), ("UNet 16x16 site", 64, 4, 256, 64),
              ("S=1024", 8, 8, 1024, 64)]
    rec = new_record()
    for label, b, h, s, d in shapes:
        scale = d ** -0.5
        for dt in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn((b, h, s, d), generator=gen, device="cuda").to(dt)
                       for _ in range(3))
            want = fa.short_attention_plain(q, k, v, scale)
            # fp32: sums in another order (K1's two passes over 64-key
            # tiles): 1e-5 of the output's scale. bf16: both sides round the
            # normalised p to bf16 before PV and the output once; the sums
            # run in other orders: 2 bf16 ulps at the binade of the
            # reference's largest magnitude, no floor.
            tol = (1e-5 * max(1.0, want.float().abs().max().item()) if dt == torch.float32
                   else bf16_tol(want, 2))
            err = compare(f"K7 short_attention {label} (B, H, S, D)=({b}, {h}, {s}, {d}) {dt}",
                          fa.short_attention(q, k, v, scale), want, tol)
            k_ms = device_ms(lambda: fa.short_attention(q, k, v, scale))
            w_ms = time_ms(lambda: fa.short_attention(q, k, v, scale))
            p_ms = device_ms(lambda: fa.short_attention_plain(q, k, v, scale))
            l_ms = device_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale))
            bound, binds, bytes_ms, ops_ms = attention_bound(b, h, s, s, d, dt)
            log(f"  kernel {k_ms:.4f} ms (wrapper {w_ms:.4f} ms host time), plain {p_ms:.4f} "
                f"ms, SDPA {l_ms:.4f} ms, bound {bound:.4f} ms ({binds}: bytes "
                f"{bytes_ms:.4f}, operations {ops_ms:.4f})")
            if label == "DiT site" and dt == torch.float32:
                rec.update(ms=k_ms, wrapper_ms=w_ms, plain_ms=p_ms, library_ms=l_ms,
                           bytes_ms=bytes_ms, ops_ms=ops_ms, bound_ms=bound, err=err)
            del q, k, v, want
            torch.cuda.empty_cache()

    # The backward (autograd of the plain version, recomputed from the saved
    # inputs) on the card against the CPU: fp32 sums in other orders.
    for b, h, s, d in ((4, 6, 16, 64), (2, 4, 256, 64)):
        rng = np.random.default_rng(SEED)
        inputs = [torch.from_numpy(rng.standard_normal((b, h, s, d)).astype(np.float32))
                  for _ in range(4)]
        grads = {}
        for device in ("cuda", "cpu"):
            leaves = [t.to(device).requires_grad_() for t in inputs[:3]]
            out = fa.short_attention(*leaves, d ** -0.5)
            grads[device] = [g.cpu() for g in torch.autograd.grad(out, leaves,
                                                                   inputs[3].to(device))]
        err = max(rel_err(x, y) for x, y in zip(grads["cuda"], grads["cpu"]))
        log(f"grad K7 short_attention ({b}, {h}, {s}, {d}), card vs CPU: max|d grad| / "
            f"max|grad| = {err:.3e} tol 1e-5")
        check(err <= 1e-5, f"K7 gradients, card vs CPU: {err}")

    # What K7 refuses on CUDA tensors.
    q = torch.randn((2, 2, 16, 48), device="cuda")
    try:
        fa.short_attention(q, q, q, 0.125)
    except ValueError as e:
        log(f"K7 refuses head dim 48: {e}")
    else:
        raise PhaseError("K7 took head dim 48")
    q = torch.randn((2, 2, 16, 64), device="cuda")
    try:
        fa.short_attention(q, q.bfloat16(), q, 0.125)
    except TypeError as e:
        log(f"K7 refuses mixed dtypes: {e}")
    else:
        raise PhaseError("K7 took mixed dtypes")
    return ("short_attention", fa.SHORT_KERNEL, rec)


def build_dit(device: str, path: str = DIT_CONFIG):
    from xdiffusion_tpu_torch.config import load_yaml
    from xdiffusion_tpu_torch.diffusion.ddpm import GaussianDiffusion_DDPM
    from xdiffusion_tpu_torch.weights import randomize_

    model = GaussianDiffusion_DDPM(load_yaml(path), device=device)
    randomize_(model.score_network(), SEED)
    return model


def dit_classes(n: int, device: str = "cuda") -> torch.Tensor:
    return torch.arange(n, device=device) % 10


def is_k1(key: str) -> bool:
    """A profiler key of K1's device code (K7 runs the same kernels)."""
    return any(n in key for n in ("bsc::packed_fwd", "bsc::row_fwd", "bsc_stream::"))


def is_k4(key: str) -> bool:
    """A profiler key of K4's kernels: the staged kernel, its split sum, the
    generic kernel."""
    return any(n in key for n in ("staged::conv_kernel", "staged::reduce_kernel",
                                  "affine_silu_conv3x3_kernel"))


def is_k2(key: str) -> bool:
    return any(n in key for n in ("bsc::packed_bwd", "bsc::row_dq", "bsc::dkv",
                                  "bsc_stream_bwd::"))


def profile_dit(label: str, step, out_file: str):
    """Profiles one call of `step` (which ends on the host): wall time, the
    device's busy time and share, K1's and K2's device time and the top
    kernels, the table to output/chip_smoke/<out_file>."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    busy = sum(e.self_device_time_total for e in events) / 1e3
    k1 = sum(e.self_device_time_total for e in events if is_k1(e.key)) / 1e3
    k2 = sum(e.self_device_time_total for e in events if is_k2(e.key)) / 1e3
    log(f"profile of {label}: wall {wall_ms:.3f} ms, device busy {busy:.3f} ms "
        f"({100 * busy / wall_ms:.1f}%), {sum(e.count for e in events)} device launches; "
        f"K1 {k1:.3f} ms, K2 {k2:.3f} ms")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"  {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<4d} {e.key[:90]}")
    with open(os.path.join(OUT_DIR, out_file), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total", row_limit=60))


def dit_site_times():
    """K1 and K2 at the DiT site, held against their plain versions and
    timed per call: q, k, v the column slices of one (128, 16, 1152) qkv
    projection, 6 heads of 64; fp32 and bf16; K2 twice, bit for bit.
    Returns ((K1's largest error, K2's), {(kernel, dtype): its record})."""
    from xdiffusion_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    b, s, c, heads = 2 * DIT_BATCH, 16, 384, 6
    d = c // heads
    scale = d ** -0.5
    site = f"at the DiT site B={b} S={s} C={c} heads={heads}"
    errs = [0.0, 0.0]
    recs = {}

    def tol(ref, dt):
        # fp32: sums in another order: 1e-5 of the reference's scale. bf16:
        # both sides round p (and ds) alike, the sums run in other orders: 2
        # bf16 ulps at the binade of the reference's largest magnitude.
        return (1e-5 * max(1.0, ref.float().abs().max().item()) if dt == torch.float32
                else bf16_tol(ref, 2))

    for dt in (torch.float32, torch.bfloat16):
        q, k, v = torch.randn((b, s, 3 * c), generator=gen, device="cuda").to(dt).chunk(3, -1)
        g = torch.randn((b, s, c), generator=gen, device="cuda").to(dt)
        want = fa.short_attention_bsc_plain(q, k, v, heads, scale)
        errs[0] = max(errs[0], compare(f"K1 bsc_attention {site} {dt}",
                                       fa.short_attention_bsc(q, k, v, heads, scale), want,
                                       tol(want, dt)))
        for name, x, y in zip(("dq", "dk", "dv"), fa.short_attention_bsc_bwd(q, k, v, g, heads,
                                                                             scale),
                              fa.short_attention_bsc_bwd_plain(q, k, v, g, heads, scale)):
            errs[1] = max(errs[1], compare(f"K2 bsc_attention_bwd {name} {site} {dt}", x, y,
                                           tol(y, dt)))
        qh, kh, vh = (t.reshape(b, s, heads, d).transpose(1, 2).contiguous().requires_grad_()
                      for t in (q, k, v))
        out = F.scaled_dot_product_attention(qh, kh, vh)
        gh = g.reshape(b, s, heads, d).transpose(1, 2).contiguous()
        peak = PEAK_FP32 if dt == torch.float32 else PEAK_BF16
        log(f"K1 at the DiT site B={b} S={s} C={c} heads={heads} {dt}, one call:")
        recs[("K1", dt)] = new_record()
        account(recs[("K1", dt)], 1, lambda: fa.short_attention_bsc(q, k, v, heads, scale),
                lambda: fa.short_attention_bsc_plain(q, k, v, heads, scale),
                lambda: F.scaled_dot_product_attention(qh, kh, vh),
                nbytes=4 * b * s * c * q.element_size(), ops=4 * b * s * s * c, peak_ops=peak)
        log(f"K2 at the DiT site B={b} S={s} C={c} heads={heads} {dt}, one call:")
        recs[("K2", dt)] = new_record()
        account(recs[("K2", dt)], 1,
                lambda: fa.short_attention_bsc_bwd(q, k, v, g, heads, scale),
                lambda: fa.short_attention_bsc_bwd_plain(q, k, v, g, heads, scale),
                lambda: torch.autograd.grad(out, (qh, kh, vh), gh, retain_graph=True),
                nbytes=7 * b * s * c * q.element_size(), ops=10 * b * s * s * c,
                peak_ops=peak)
        check_repeats(f"K2 {site} {dt}", fa.short_attention_bsc_bwd(q, k, v, g, heads, scale),
                      fa.short_attention_bsc_bwd(q, k, v, g, heads, scale))
    return tuple(errs), recs


def phase_dit_sampling():
    """The shipped DiT, fp32, batch 64, guided, 1000 ancestral steps through
    `sample()`: exactly 12 K1 launches per forward and nothing else; then 5
    steps through the CLI, a profile, and K1 and K2 held against their plain
    versions at the DiT site with their times. Returns (every kernel's
    launches in the run, samples/s, K1's and K2's largest error at the
    site, their records there)."""
    from xdiffusion_tpu_torch import sample as cli
    from xdiffusion_tpu_torch.ops import flash_attention as fa

    model = build_dit("cuda")
    steps = model.noise_scheduler().steps()
    guidance = model.classifier_free_guidance()

    def run(num_steps, seed=SEED):
        g = torch.Generator(device="cuda").manual_seed(seed)
        return model.sample(num_samples=DIT_BATCH, context={"classes": dit_classes(DIT_BATCH)},
                            classifier_free_guidance=guidance, num_sampling_steps=num_steps,
                            generator=g)

    run(3)  # warm-up: kernel load, cuBLAS handles, allocator
    torch.cuda.synchronize()
    ks = reset_launches()
    t0 = time.perf_counter()
    out = run(steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: k.launches for name, k in ks.items()}
    sps = DIT_BATCH / wall
    log(f"DiT main path: {steps}-step ancestral, batch {DIT_BATCH}, guidance {guidance} "
        f"(forwards of {2 * DIT_BATCH}), dynamic thresholding, fp32: {wall:.2f} s, "
        f"{sps:.3f} samples/s, launches {launches}")
    want = {name: 0 for name in launches}
    want["bsc_attention"] = 12 * steps
    check(launches == want, f"DiT launches {launches} != {want}")
    check(tuple(out.shape) == (DIT_BATCH, 32, 32, 1), f"DiT samples shape {tuple(out.shape)}")
    check(bool(torch.isfinite(out).all()), "DiT samples not finite")
    check(out.min().item() >= 0.0 and out.max().item() <= 1.0, "DiT samples outside [0, 1]")
    log(f"DiT samples: mean {out.mean().item():.4f} std {out.std().item():.4f}")
    out_dir = os.path.join(OUT_DIR, "dit")
    cli.save_image_grid(out.cpu().numpy(), os.path.join(out_dir, "samples.png"))

    # The CLI, from a saved checkpoint, for 5 guided steps: with the same
    # seed it must repeat sample()'s samples.
    cli_steps = 5
    ckpt = os.path.join(out_dir, "random_weights.pt")
    torch.save(model.score_network().state_dict(), ckpt)
    want = run(cli_steps)
    reset_launches()
    cli_out = cli.main(["--config_path", DIT_CONFIG, "--checkpoint", ckpt,
                        "--num_samples", str(DIT_BATCH), "--guidance", str(guidance),
                        "--sampling_steps", str(cli_steps), "--output_path",
                        os.path.join(out_dir, "cli"), "--seed", str(SEED)])
    torch.cuda.synchronize()
    check(fa.KERNEL.launches == 12 * cli_steps, "the CLI run missed K1 launches")
    diff = (cli_out - want).abs().max().item()
    log(f"sampling CLI: {cli_steps} guided steps, max|CLI - sample()| = {diff:.3e}")
    check(diff <= 1e-6, f"the CLI's samples differ from sample()'s by {diff}")
    check(os.path.getsize(os.path.join(out_dir, "cli", "sample-step0.png")) > 0,
          "the DiT CLI wrote no sample-step0.png")
    os.remove(ckpt)

    x = torch.randn((2 * DIT_BATCH, 32, 32, 1), device="cuda")
    ctx = {"timestep": torch.full((2 * DIT_BATCH,), 500, device="cuda"),
           "classes": torch.cat([dit_classes(DIT_BATCH), torch.full((DIT_BATCH,), 10,
                                                                    device="cuda")])}
    with torch.inference_mode():
        for _ in range(3):
            model.predict_score(x, ctx)
        reset_launches()
        profile_dit(f"one guided DiT forward ({2 * DIT_BATCH} samples, fp32, 16 tokens)",
                    lambda: model.predict_score(x, ctx).sum().item(), "dit_profile.txt")
    check(fa.KERNEL.launches == 12, "one DiT forward did not launch K1 12 times")
    site_errs, site_recs = dit_site_times()
    return launches, sps, site_errs, site_recs


def phase_dit_training():
    """The shipped DiT, fp32, batch 128, through train(): launches against
    the counts the code implies, every step's loss, steps/s, checkpoints,
    guided grids, the bit-exact resume and a profile; then the MoE DiT's
    training and chunked guided sampling. Returns (K2 launches, steps/s)."""
    import shutil

    from xdiffusion_tpu_torch.ops import flash_attention as fa
    from xdiffusion_tpu_torch.optim import default_optimizer
    from xdiffusion_tpu_torch.train_step import create_train_state, make_train_step
    from xdiffusion_tpu_torch.training.image.train import train

    # Per training step K1 and K2 at each of the 12 blocks; per sampling
    # forward (guided: one forward on the doubled batch) K1 at the 12.
    samplings = 2  # at RESUME_STEP and at the end
    expected = {name: 0 for name in reset_launches()}
    expected["bsc_attention"] = 12 * TRAIN_STEPS + 12 * samplings * 1000
    expected["bsc_attention_bwd"] = 12 * TRAIN_STEPS
    root = os.path.join(OUT_DIR, "dit_train")
    shutil.rmtree(root, ignore_errors=True)
    common = dict(batch_size=TRAIN_BATCH, save_and_sample_every_n=RESUME_STEP,
                  num_samples=NUM_SAMPLES, sample_with_guidance=True, seed=SEED,
                  device="cuda", log_every=1)
    ks = reset_launches()
    t0 = time.perf_counter()
    out_dir = train(DIT_CONFIG, num_training_steps=TRAIN_STEPS,
                    output_path=os.path.join(root, "run"), **common)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {name: k.launches for name, k in ks.items()}
    log(f"DiT training run ({TRAIN_STEPS} steps at batch {TRAIN_BATCH}, fp32, + {samplings} "
        f"x 1000-step guided grids of {NUM_SAMPLES}, {run_s:.1f} s): launches {launches}, "
        f"expected {expected}")
    check(launches == expected, f"DiT training launches {launches} != {expected}")
    metrics = read_metrics(out_dir)
    check(sorted(metrics) == list(range(TRAIN_STEPS)), "DiT metrics.jsonl misses steps")
    for step in range(TRAIN_STEPS):
        r = metrics[step]
        log(f"  step {step:2d}: loss {r['loss']:.6f} grad_norm {r['grad_norm']:.4f}")
        check(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]),
              f"DiT step {step}: loss or grad_norm not finite")
    span = metrics[RESUME_STEP - 1]["time"] - metrics[WARMUP_STEPS - 1]["time"]
    sps = TIMED_STEPS / span
    log(f"DiT training throughput: {sps:.3f} steps/s, {sps * TRAIN_BATCH:.1f} images/s "
        f"(steps {WARMUP_STEPS}-{RESUME_STEP - 1}, batch {TRAIN_BATCH}, fp32, a host read of "
        f"the metrics after every step)")
    for name in (f"checkpoints/{RESUME_STEP}.pt", f"checkpoints/{TRAIN_STEPS}.pt",
                 f"sample-{RESUME_STEP}.png", f"sample-{TRAIN_STEPS}.png"):
        path = os.path.join(out_dir, name)
        check(os.path.isfile(path) and os.path.getsize(path) > 0, f"DiT train wrote no {name}")
    resumed = train(DIT_CONFIG, num_training_steps=RESUME_STEP + 1,
                    output_path=os.path.join(root, "resumed"),
                    resume_from=os.path.join(out_dir, "checkpoints", f"{RESUME_STEP}.pt"),
                    **common)
    want = metrics[RESUME_STEP]["loss"]
    got = read_metrics(resumed)[RESUME_STEP]["loss"]
    log(f"DiT resume from step {RESUME_STEP}: loss {got!r} against the uninterrupted run's "
        f"{want!r}")
    check(got == want, "the resumed DiT step's loss differs")

    model = build_dit("cuda")
    state = create_train_state(model, default_optimizer().build(
        model.score_network().parameters()), seed=SEED)
    step = make_train_step(model)
    batch = {"images": torch.rand((TRAIN_BATCH, 32, 32, 1), device="cuda"),
             "classes": dit_classes(TRAIN_BATCH)}
    for _ in range(3):
        step(state, batch)
    ks = reset_launches()
    profile_dit(f"one DiT training step (batch {TRAIN_BATCH}, fp32)",
                lambda: step(state, batch)["loss"].item(), "dit_train_profile.txt")
    counts = {name: k.launches for name, k in ks.items() if k.launches}
    check(counts == {"bsc_attention": 12, "bsc_attention_bwd": 12},
          f"one DiT training step launched {counts}")
    del model, state, step

    # The MoE DiT: 30 steps, then 10 guided steps at batch 64 whose
    # 128-sample forwards run as two 64-sample chunks.
    moe_dir = train(DIT_MOE_CONFIG, num_training_steps=TRAIN_STEPS,
                    output_path=os.path.join(root, "moe"),
                    **{**common, "save_and_sample_every_n": 10 ** 9})
    moe_metrics = read_metrics(moe_dir)
    check(sorted(moe_metrics) == list(range(TRAIN_STEPS)), "MoE metrics.jsonl misses steps")
    for step_i in (0, TRAIN_STEPS // 2, TRAIN_STEPS - 1):
        r = moe_metrics[step_i]
        log(f"  MoE step {step_i:2d}: loss {r['loss']:.6f} mse {r['mse_loss']:.6f} "
            f"moe_aux_loss {r['moe_aux_loss']:.6f} grad_norm {r['grad_norm']:.4f}")
    check(all(np.isfinite(r["loss"]) and np.isfinite(r["moe_aux_loss"])
              for r in moe_metrics.values()), "MoE loss or moe_aux_loss not finite")
    moe_span = moe_metrics[RESUME_STEP - 1]["time"] - moe_metrics[WARMUP_STEPS - 1]["time"]
    log(f"MoE DiT training throughput: {TIMED_STEPS / moe_span:.3f} steps/s (batch "
        f"{TRAIN_BATCH}, fp32)")
    moe = build_dit("cuda", DIT_MOE_CONFIG)
    reset_launches()
    g = torch.Generator(device="cuda").manual_seed(SEED)
    out = moe.sample(num_samples=DIT_BATCH, context={"classes": dit_classes(DIT_BATCH)},
                     classifier_free_guidance=moe.classifier_free_guidance(),
                     num_sampling_steps=DIT_MOE_STEPS, generator=g)
    torch.cuda.synchronize()
    log(f"MoE DiT: {DIT_MOE_STEPS} guided steps at batch {DIT_BATCH}: "
        f"{fa.KERNEL.launches} K1 launches")
    check(fa.KERNEL.launches == 24 * DIT_MOE_STEPS,
          f"MoE sampling: K1 launches {fa.KERNEL.launches} != {24 * DIT_MOE_STEPS}")
    check(bool(torch.isfinite(out).all()), "MoE samples not finite")
    return launches["bsc_attention_bwd"], sps


def no_drop_config(path: str) -> str:
    """`path` without the training guidance drop and dropout, written to
    output/chip_smoke/<name>/."""
    import yaml

    with open(path) as f:
        cfg = yaml.safe_load(f)
    cfg["diffusion"]["classifier_free_guidance"]["unconditional_guidance_probability"] = 0.0
    cfg["diffusion"]["score_network"]["params"]["dropout"] = 0.0
    name = os.path.splitext(os.path.basename(path))[0]
    out = os.path.join(OUT_DIR, f"{name}_no_drop", os.path.basename(path))
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        yaml.safe_dump(cfg, f)
    return out


def phase_dit_card_vs_cpu():
    """fp32, batch 2: one loss and backward of the dense DiT and the loss and
    aux loss of the MoE DiT, card against CPU."""
    from xdiffusion_tpu_torch.layers.moe import MoEMlp
    from xdiffusion_tpu_torch.optim import global_norm

    rng = np.random.default_rng(SEED)
    images = torch.from_numpy(rng.random((2, 32, 32, 1)).astype(np.float32))
    t = torch.from_numpy(rng.integers(0, 1000, size=2))
    noise = torch.from_numpy(rng.standard_normal((2, 32, 32, 1)).astype(np.float32))
    classes = torch.tensor([3, 10])  # the second sample takes the null class
    results = {}
    for device in ("cuda", "cpu"):
        model = build_dit(device, no_drop_config(DIT_CONFIG))
        net = model.score_network()
        loss, _ = model.loss_on_batch(images.to(device), {"classes": classes.to(device)},
                                      timesteps=t.to(device), noise=noise.to(device),
                                      deterministic=True)
        loss.backward()
        grads = {n: p.grad.detach().float().cpu() for n, p in net.named_parameters()}
        results[device] = (loss.item(), global_norm(list(grads.values())).item(), grads)
    (l_gpu, n_gpu, g_gpu), (l_cpu, n_cpu, g_cpu) = results["cuda"], results["cpu"]
    # fp32 on both sides with TF32 off; sums in other orders through 12
    # blocks. Each gradient is held to 1e-3 of its largest magnitude,
    # floored at 1e-3 of the network's largest gradient, as phase 14 holds
    # the LTX network's.
    floor = 1e-3 * max(g.abs().max().item() for g in g_cpu.values())
    worst = max((rel_err(g_gpu[k], g_cpu[k], floor), k) for k in g_cpu)
    log(f"DiT card vs CPU training, fp32 batch 2: loss {l_gpu:.7f} vs {l_cpu:.7f}, grad_norm "
        f"{n_gpu:.6f} vs {n_cpu:.6f}, worst gradient {worst[1]} at {worst[0]:.3e}")
    check(abs(l_gpu - l_cpu) <= 1e-5 * abs(l_cpu), f"DiT loss {l_gpu} vs {l_cpu}")
    check(abs(n_gpu - n_cpu) <= 1e-4 * abs(n_cpu), f"DiT grad_norm {n_gpu} vs {n_cpu}")
    check(worst[0] <= 1e-3, f"DiT gradient {worst[1]}: {worst[0]} > 1e-3")

    moe_results = {}
    for device in ("cpu", "cuda"):
        model = build_dit(device, no_drop_config(DIT_MOE_CONFIG))
        gates = []
        hooks = [m.router.register_forward_hook(
            lambda mod, args, out: gates.append(torch.softmax(out.detach(), -1).cpu()))
            for m in model.score_network().modules() if isinstance(m, MoEMlp)]
        with torch.no_grad():
            loss, metrics = model.loss_on_batch(
                images.to(device), {"classes": classes.to(device)}, timesteps=t.to(device),
                noise=noise.to(device), deterministic=True)
        for h in hooks:
            h.remove()
        top2 = torch.cat(gates).topk(2, dim=-1).values
        margin = (top2[:, 0] - top2[:, 1]).min().item()
        log(f"MoE DiT on {device}: the least top-2 router margin over "
            f"{top2.shape[0]} token-blocks is {margin:.3e}")
        check(margin >= 1e-4, f"a router near-tie on {device} ({margin}): routing may flip")
        moe_results[device] = (loss.item(), metrics["moe_aux_loss"].item())
    (l_gpu, a_gpu), (l_cpu, a_cpu) = moe_results["cuda"], moe_results["cpu"]
    log(f"MoE DiT card vs CPU, fp32 batch 2: loss {l_gpu:.7f} vs {l_cpu:.7f}, moe_aux_loss "
        f"{a_gpu:.7f} vs {a_cpu:.7f}")
    check(abs(l_gpu - l_cpu) <= 1e-5 * abs(l_cpu), f"MoE loss {l_gpu} vs {l_cpu}")
    check(abs(a_gpu - a_cpu) <= 1e-5 * abs(a_cpu), f"MoE aux {a_gpu} vs {a_cpu}")


# Device ms of K1, K2 and K7 before their redesign (PERF.md: the two-pass
# kernels' final chip_smoke.py run, NVIDIA H100 80GB HBM3, 700.00 W), the
# yardstick of the redesigned ones.
BEFORE_MS = {("K1", "flagship"): 0.775, ("K2", "flagship"): 5.455,
          ("K1", torch.float32): 0.1856, ("K1", torch.bfloat16): 0.0288,
          ("K2", torch.float32): 0.5873, ("K2", torch.bfloat16): 0.0951,
          ("K7", torch.float32): 0.1845}


def site_table(records, dit_recs, smi: str) -> None:
    """K1, K2 and K7 per site: their device ms before the redesign, this
    run's, the library call's (SDPA, its backward alone for K2) and the
    bound."""
    by_name = {name: rec for name, _, rec in records}
    rows = [("K1", "flagship, 6 sites per sampling forward, B 64", "bf16",
             BEFORE_MS[("K1", "flagship")], by_name["bsc_attention"]),
            ("K2", "flagship, 6 sites per training step, B 128", "bf16",
             BEFORE_MS[("K2", "flagship")], by_name["bsc_attention_bwd"])]
    for kernel in ("K1", "K2"):
        for dt in (torch.float32, torch.bfloat16):
            rows.append((kernel, "DiT (128, 16, C 384, 6 heads), per call", str(dt)[6:],
                         BEFORE_MS[(kernel, dt)], dit_recs[(kernel, dt)]))
    rows.append(("K7", "(128, 6, 16, 64) head-major, per call", "float32",
                 BEFORE_MS[("K7", torch.float32)], by_name["short_attention"]))
    log(f"K1, K2 and K7 per site, device ms on {smi} (before: the two-pass kernels' "
        f"final run, PERF.md):")
    log(f"  {'kernel':6} {'site':46} {'dtype':9} {'before':>8} {'now':>8} {'x faster':>8} "
        f"{'library':>8} {'bound':>8}")
    for kernel, site, dt, before, rec in rows:
        log(f"  {kernel:6} {site:46} {dt:9} {before:8.4f} {rec['ms']:8.4f} "
            f"{before / rec['ms']:8.2f} {rec['library_ms']:8.4f} {rec['bound_ms']:8.4f}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    # The run's output outgrows the tail a remote runner returns: keep it all.
    os.makedirs(os.path.dirname(LOG_PATH), exist_ok=True)
    log_file = open(LOG_PATH, "w")
    sys.stdout = Tee(sys.stdout, log_file)
    try:
        return run()
    finally:
        sys.stdout.flush()
        sys.stdout = sys.stdout.streams[0]
        log_file.close()


def run() -> int:
    from xdiffusion_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = gpu_line()
    log(f"card: {smi}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    logs = _build.build(list(_build.kernels()), verbose=True)
    log(f"kernels built in {time.perf_counter() - t0:.1f} s")
    for name in ("bsc_attention", "bsc_attention_bwd", "group_norm_silu", "affine_silu_conv3x3",
                 "flash_attention", "flash_attention_bwd"):
        ptxas_summary(name, logs.get(name, ""))

    model = build_model("bfloat16", "cuda")
    sites = main_path_sites(model)
    train_sites = main_path_sites(model, TRAIN_BATCH)
    small_sites = main_path_sites(build_model("bfloat16", "cuda", SMALL_CONFIG), BATCH, 8)
    del model
    log("main-path sites per forward: "
        + ", ".join(f"{k}={len(v)}" for k, v in sites.items()))
    records = phase_kernels(sites)
    records.append(phase_k2(train_sites))
    k3_record, k3_rows = phase_k3(sites["group_norm_silu"], train_sites["group_norm_silu"],
                                  small_sites["group_norm_silu"])
    records.append(k3_record)
    k4_record, k4_rows = phase_k4(sites["affine_silu_conv3x3"],
                                  train_sites["affine_silu_conv3x3"],
                                  small_sites["affine_silu_conv3x3"])
    records.append(k4_record)
    phase_bsc_shapes()
    _, k3_backward_ms = phase_gradients(train_sites)
    launches, sps = phase_main_path(records)
    phase_unet_configs()
    phase_card_vs_cpu()
    train_launches, train_sps = phase_training(sites)
    launches["bsc_attention_bwd"] = train_launches["bsc_attention_bwd"]
    profile_train_step()
    phase_train_card_vs_cpu()

    records.append(phase_k5())
    launches["flash_attention"], ltx_sps = phase_ltx_main_path()
    long_s = phase_ltx_long()
    phase_ltx_card_vs_cpu()

    records.append(phase_k6())
    launches["flash_attention_bwd"], ltx_train_sps = phase_ltx_training()
    profile_ltx_train_step()
    long_train = phase_ltx_long_training()
    phase_ltx_train_card_vs_cpu()

    records.append(phase_k7())
    dit_launches, dit_sps, dit_errs, dit_recs = phase_dit_sampling()
    dit_k1 = dit_launches["bsc_attention"]
    # No path of the package calls K7: its count from the DiT run, checked
    # there to be 0.
    launches["short_attention"] = dit_launches["short_attention"]
    site_errs = dict(zip(("bsc_attention", "bsc_attention_bwd"), dit_errs))
    for name, _, rec in records:
        rec["err"] = max(rec["err"], site_errs.get(name, 0.0))
    dit_k2, dit_train_sps = phase_dit_training()
    phase_dit_card_vs_cpu()

    site_table(records, dit_recs, smi)
    k3_table(k3_rows, smi)
    k4_table(k4_rows, smi)
    flash_table(smi)

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
            "wrapper_ms": rec["wrapper_ms"],
            "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"],
            "bound_by": "bytes" if rec["bytes_ms"] >= rec["ops_ms"] else "operations",
            "library_ms": rec["library_ms"],
        })
    kernels[-1]["path"] = "none: no module of the JAX package or the port calls it"
    k3 = next(k for k in kernels if k["name"] == "group_norm_silu")
    k3["cold_ms"] = k3_record[2]["cold_ms"]
    k3["backward_ms"] = k3_backward_ms
    log(f"K3 per flagship bf16 forward: {k3['ms']:.4f} ms warm, {k3['cold_ms']:.4f} cold against "
        f"a bound of {k3['bound_ms']:.4f} ({100 * k3['bound_ms'] / k3['cold_ms']:.1f}% reached "
        f"cold); {K3_BEFORE_FORWARD_MS} before the redesign; its plain-autograd backward "
        f"{k3_backward_ms:.4f} ms a training step")
    log(f"kernel times (device time; wrapper_ms: the wrapper's host time) are bf16 sums "
        f"over each kernel's sites, per sampling forward at "
        f"batch {BATCH} (K2: per training step at batch {TRAIN_BATCH}; K5: fp32, per LTX "
        f"forward at batch {LTX_BATCH}; K6: fp32, per LTX training step at batch "
        f"{LTX_TRAIN_BATCH}); launches are per 50-step DDIM run (K2: per training run; K5: "
        f"per 1000-step LTX run; K6: per {TRAIN_STEPS}-step LTX training run); sampling "
        f"{sps:.2f} samples/s, training {train_sps:.3f} steps/s, LTX {ltx_sps:.4f} "
        f"samples/s, LTX training {ltx_train_sps:.3f} steps/s, long video "
        f"{long_s['fp32']:.4f} s/forward fp32, {long_s['bf16']:.4f} bf16, long training "
        f"step {long_train['fp32'][0]:.1f} ms fp32 (K6 {long_train['fp32'][1]:.1f}), "
        f"{long_train['bf16'][0]:.1f} ms bf16 (K6 {long_train['bf16'][1]:.1f}); K7: fp32, one "
        f"call at the DiT site (128, 6, 16, 64), no path launches it; DiT sampling "
        f"{dit_sps:.3f} samples/s ({dit_k1} K1 launches in 1000 guided steps), DiT training "
        f"{dit_train_sps:.3f} steps/s ({dit_k2} K2 launches in {TRAIN_STEPS} steps) on {smi}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
