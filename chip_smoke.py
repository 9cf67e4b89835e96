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
   the synthetic digits, TRAIN_STEPS steps (WARMUP_STEPS warm-up and
   TIMED_STEPS timed) with every step's loss and grad_norm, the launches of
   each kernel counted over the run against the counts the code implies,
   checkpoints and sample grids, a resume from the step-RESUME_STEP
   checkpoint that must repeat the uninterrupted run's loss there, and a
   profile of one training step.
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
   random weights, batch 4 with the prompts "0" to "3", MAIN_STEPS of the
   config's 1000 Euler steps through `GaussianDiffusion_DDPM.sample` (timed, 24 K5
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
    video `train()` on the synthetic Moving-MNIST, TRAIN_STEPS steps
    (WARMUP_STEPS warm-up and TIMED_STEPS timed) with every step's loss and
    grad_norm, exactly 24 K5 and 24 K6 launches a step (and 24 K5 a
    sampling forward), checkpoints and 10-step frame strips, a resume from
    the step-RESUME_STEP checkpoint that must repeat its loss bit for bit, a
    profile of one step
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
    samples), dynamic thresholding, MAIN_STEPS of the config's 1000
    ancestral steps through `sample()`, timed, with exactly 12 K1 launches per forward and
    nothing else launched; its grid goes to output/chip_smoke/dit/
    samples.png. Then 5 steps through the sampling CLI, which must repeat
    `sample()` and write sample-step0.png; a profile of one guided forward
    (output/chip_smoke/dit_profile.txt); K1's and K2's times at the DiT
    site (B 128, S 16, C 384) in fp32 and bf16 beside SDPA's and the bound,
    K2 twice bit for bit.
17. DiT training: the shipped config in fp32 at batch 128 (dropout 0.1,
    guidance drop 0.2) through `train()` on the synthetic digits and their
    labels, TRAIN_STEPS steps, steps/s over the timed ones, exactly 12 K1
    and 12 K2 launches a step (and 12 K1 a sampling forward), checkpoints
    and guided grids, a resume from step RESUME_STEP that must repeat its
    loss bit for bit, a
    profile of one step (output/chip_smoke/dit_train_profile.txt); then
    configs/image/mnist/dit_moe.yaml (8 experts, top-1) for TRAIN_STEPS at the
    same batch, each reporting a finite moe_aux_loss, and 10 guided
    sampling steps at batch 64, whose 128-sample forward runs as two
    64-sample chunks: exactly 24 K1 launches a step.
18. Card against CPU, DiT: fp32, batch 2, one loss and backward of the
    dense network with the same weights, batch, classes (one of them the
    null class), times and noise, no dropout and no guidance drop: the
    loss, the gradient norm and every gradient. For MoE, after checking
    that no token's top-2 router margin is under 1e-4 (a flip in a near
    tie is a discontinuity, not an error), the loss and the aux loss.

19. K1 and K2 at the text-conditioned paths' sites (TEXT_SITE_SHAPES):
    cross-attention, whose encoder keys come before the image's (256
    queries against 333 keys and 16 against 93 in the headline, 384 and 144
    in GLIDE, 93 and 81 in Imagen's base stage) and GLIDE's text
    transformer (128 tokens, one head of 128), fp32 and bf16, against their
    plain versions with phase 2's tolerances, K2 twice bit for bit, each
    with the `bsc_plan` variant it takes (the row variant, its logit strip
    the key count rounded up to 64); K1's and K2's device time at the
    headline's sites beside SDPA's (its backward alone) and the bound.
20. Headline sampling: configs/image/mnist/ddpm_32x32_v_continuous_clip.yaml
    (cosine logSNR over 1024 scales, v target, 77 x 768 hash CLIP
    embeddings projected to 512, cross-attention with 4 heads of 64) in
    bf16 with seeded random weights, 50-step DDIM at batch 64 with prompts
    "0" to "9" in turn and the config's guidance 1.0 (one forward on 128
    samples a step), timed, with every K1, K3 and K4 launch counted against
    the counts the network's structure implies; its grid goes to
    output/chip_smoke/text/samples.png; a profile of one guided forward
    (output/chip_smoke/text_profile.txt).
21. Card against CPU, headline: fp32, batch 4, prompts "0" to "3": one
    forward and 10 guided DDIM steps with the same weights and initial
    noise.
22. Headline training: the same config in bf16 at batch 128 through
    `train()`, TRAIN_STEPS steps with prompts from the digits' labels
    (surface forms drawn from (seed, step)), steps/s over the timed ones,
    launches against the
    code's counts (K1, K2, K3 and K4 a step, and the end grid's GRID_STEPS
    unguided ancestral forwards), a profile of one step
    (output/chip_smoke/text_train_profile.txt).
23. The configs beside the headline, in bf16 at full width with seeded
    random weights: glide.yaml, imagen_base.yaml, ddpm_epsilon_clip.yaml and
    ddpm_32x32_v_continuous.yaml, each through the sampling CLI (5 steps at
    batch 16, `--text_prompts` "0" to "9" and the config's guidance where it
    takes text) and 3 training steps at batch 32 through the trainer's step
    (prompts from digit labels, dropout and the guidance drop on), with
    the launches of each against the code's counts.

24. K1/K2 and K5/K6 at the PixArt family's sites: self-attention on 16
    tokens (C 384 over 6 heads at batch 128 and 32; C 768 over 12 heads,
    the deep WideFormer's, at 32) and cross-attention of 16 queries against
    77 caption keys (6 heads of 64 at batch 128 and 32; 12 heads at 32),
    K5's operands head views of the q and kv projections; fp32 and bf16
    against the plain versions with phases 2's, 7's and 11's tolerances;
    K2, K5 and K6 twice bit for bit; each plan's variant, K5's lse shape.
    K5's and K6's device time at the headline's cross-attention site and
    K1's and K2's at the deep WideFormer's (fp32), beside SDPA's and the
    bound.
25. PixArt sampling: configs/image/mnist/pixart_alpha.yaml as shipped
    (fp32, 12 blocks, 6 x 64 heads, 16 tokens, T5 tokens of length 77) with
    seeded random weights, batch 64 with prompts "0" to "9" in turn, the
    config's guidance 1.0 (one forward on 128 samples) and dynamic
    thresholding, MAIN_STEPS of its 1000 ancestral steps through `sample()`:
    12 K1 and 12 K5 launches a forward and nothing else; the grid to
    output/chip_smoke/pixart/samples.png; a profile of one guided forward
    (output/chip_smoke/pixart_profile.txt).
26. Card against CPU, PixArt: fp32, prompts "0" to "3": one forward and 10
    guided ancestral steps at batch 4 (injected initial and per-step
    noise), one loss and backward at batch 2 without drop-path or the
    guidance drop (the loss, the gradient norm, every gradient).
27. PixArt training: the same config (fp32) at batch 128 through
    `train()`, TRAIN_STEPS steps with prompts from the digits' labels
    through the network's host-side T5 tokens, steps/s over the timed ones,
    launches
    against the code's counts (12 K1, K2, K5 and K6 a step, and the end
    grid's GRID_STEPS unguided forwards), a profile of one step
    (output/chip_smoke/pixart_train_profile.txt).
28. The configs beside it, fp32 at full width with seeded random weights:
    pixart_alpha_class_conditional.yaml (no K5), pixart_alpha_dyt.yaml,
    wideformer_pixart_deep.yaml (20 blocks, 12 heads) and
    ddpm_unconditional_learned_sigma.yaml (the doubled head, the hybrid
    loss, learned-range sampling), each through the sampling CLI (5 steps
    at batch 16 with the config's guidance) and 3 training steps at batch
    32 through the trainer's step, with the launches of each against the
    code's counts; the CIFAR-10 and moving-MNIST image configs train 3 steps
    each through the training CLI on their datasets (`--dataset_name
    image/cifar10`, `image/moving_mnist`). wideformer_pixart.yaml (head dim
    256) runs in phases 35-38.
29. FID: since PR 21 part of phase 76, whose measure_fid trains the LeNet
    feature extractor (xdiffusion_tpu_torch/eval/fid.py) once on the card;
    with it the real-against-real floor, noise's FID and the FID of phase
    25's samples (random weights: finite, no threshold).
30. K1 and K2 at head dim 256 (`bsc_plan`'s wide variant): ptxas's
    registers and spills of its kernels; both against their plain versions
    at every SongUNet site (one head of C = 256 at 256 and 64 tokens, batch
    64 and 128: EDM_SITES) and ragged shapes, fp32 and bf16, each twice bit
    for bit, with each site's plan; their fp32 device time per sampling
    forward (K1) and training step (K2) beside the plain version's, SDPA's
    on (B, 1, S, 256) and the bound (fp32 products as three TF32 products,
    as K5/K6's; the fp32 CUDA cores' time beside it). K3 at every GroupNorm
    site of edm.yaml's forward (batch 64) and step (128) and of the
    companions' (16, 32), with each site's eps (1e-6 in the Song blocks),
    against its plain version in fp32 and bf16, twice bit for bit.
31. EDM sampling: configs/image/mnist/edm.yaml as shipped (fp32, the
    SongUNet, EDM preconditioning) with seeded random weights, its 18-step
    stochastic Heun sampler at batch 64 through `sample()` (35 network
    evaluations: 210 K1 and 35 x 73 K3 launches, nothing else); the grid to
    output/chip_smoke/edm/samples.png; a profile of one forward
    (output/chip_smoke/edm_profile.txt).
32. Card against CPU, EDM: fp32, batch 2: the preconditioned forward, 3
    Heun steps with injected draws, one loss and backward with injected
    sigma and noise (the loss, the gradient norm, every gradient).
33. EDM training: a profile of one step at batch 128
    (output/chip_smoke/edm_train_profile.txt), then 10 steps through
    `train()`: losses, steps/s, launches against the code's counts (6 K1,
    6 K2, 73 K3 a step and the end grid's 35 forwards), checkpoint, grid.
34. The companions, fp32 at full width with seeded random weights:
    edm_ddpmpp.yaml, edm_ncsnpp.yaml, edm_adm.yaml (their Euler samplers cut
    from 512 to EDM_CLI_STEPS steps) and the three score_sde_*.yaml
    (EDM_CLI_STEPS of 1000 predictor-corrector steps, `--sampling_steps`)
    through the sampling CLI
    at batch 16, then 3 training steps at batch 32 through the trainer's
    step, each launch count against the code's.
35. K5 and K6 at head dim 256 (`flash_plan`'s wide variant): ptxas's
    registers and spills of its kernels; both against their plain versions
    at WideFormer-PixArt's cross-attention sites (8 heads of 256, 16 queries
    against 77 caption keys, batch 128 and 32: WIDE_FLASH_SITES) and ragged
    shapes, fp32 and bf16, each twice bit for bit; K1 and K2 at its
    self-attention site (B 128, 16 tokens, C 2048, 8 heads); fp32 device
    times of K5, K6 (B 128) and K1, K2 beside the plain version, SDPA and
    the bound.
36. WideFormer sampling: configs/image/mnist/wideformer_pixart.yaml as
    shipped (fp32, hidden 2048, depth 2) with seeded random weights, 50
    guided ancestral steps at batch 64 with prompts (one forward on 128
    samples): exactly 2 K1 and 2 K5 launches a forward; the grid to
    output/chip_smoke/wideformer/samples.png; a profile of one guided
    forward (output/chip_smoke/wideformer_profile.txt).
37. Card against CPU, WideFormer: fp32, batch 2, one forward (K1 and K5 at
    head dim 256) and one loss and backward (K2, K6) without drop-path or
    the guidance drop: the forward, the loss, the gradient norm, every
    gradient.
38. WideFormer training: a profiled step (output/chip_smoke/
    wideformer_train_profile.txt), then 10 steps at batch 128 through
    `train()` with prompts: 2 K1, K2, K5 and K6 a step and the end grid's
    GRID_STEPS forwards, losses, checkpoint, grid.
39. Consistency models: card against CPU for one training loss
    (consistency_model.yaml) and one distillation loss
    (consistency_model_distillation.yaml, edm.yaml's network as teacher),
    fp32 at full width, batch 2, injected indices and noise (the loss, the
    gradient norm, every gradient); then the distill_consistency CLI at
    batch 64 for 5 steps on each config, the distillation from phase 33's
    port-trained edm.yaml checkpoint (24 K1, 6 K2 and 4 x 73 K3 a
    distillation step, 12 K1, 6 K2, 2 x 73 K3 a training step, and the end
    grid's one-step forward); the sampling CLI on each checkpoint at batch
    64 with the config's one-step sampler and the one-step and multistep
    overrides (1, 1 and 3 forwards), and the euler_ancestral override
    refused with JAX's ValueError; one-step sampling at batch 64 timed.
40. Progressive distillation: ddpm_32x32_v_continuous.yaml trained 3 steps
    at batch 128 by the trainer's step as the teacher, then the `distill` CLI
    from its checkpoint for 2 iterations of 3 steps (N 512, then 256): K1,
    K3 and K4 three forwards' worth a step and the student's K2, losses,
    a checkpoint per iteration.

41. K5 and K6 at the MM-DiT family's joint attention (MMDIT_FLASH_SITES:
    SD3's 93 tokens, Flux's 144, SD3.5's image-only 16 at head dim 64, and
    AuraFlow's 152 at head dim 256, batch 128) and MMDIT_FLASH_MORE (the
    companions' guided CLI batch 32, ragged 92, 145 and 151 tokens, one key,
    and 128 tokens) against their plain versions, fp32 and bf16, each twice
    bit for bit, on the blocks' operand layouts; fp32 device times at each
    site beside the plain version, SDPA (its backward) and the bound, and
    128 tokens beside 144 (one fp32 row tile against two).
42. flux.yaml, sd3.yaml and auraflow.yaml (fp32, full width, seeded random
    weights) through the sampling CLI at batch 64 with prompts, the config's
    Euler sampler and guidance 1.0 (MMDIT_HEADLINES' steps: Flux 50, SD3
    25, AuraFlow 25): K5 once a block with attention (Flux 18, SD3 12,
    AuraFlow 14) and nothing else, every call at its site's shape;
    samples/s;
    a profile of one guided forward (output/chip_smoke/<config>_profile.txt).
43. Their training: a profiled step at batch 128, then `train()` with
    prompts (6 steps each, steps 2-5 timed): K5 and
    K6 once a block a step and the end grid's GRID_STEPS forwards, losses,
    checkpoint, grid.
44. Card against CPU for each of the three: fp32, batch 2, one forward and
    one loss and backward with injected times and noise.
45. The companions (MMDIT_COMPANIONS: sd3.5, flux_dyt, chewie, diffussm)
    through the sampling CLI (5 steps at batch 16, guidance) and 3 training
    steps at batch 32, each launch count against the code's; DiffuSSM
    launches no kernel of the port, and its profiled forward shows its S4D
    convolutions as cuFFT kernels on the card.

46. K5 and K6 at head dim 576 (the wide variant with 9 warps): Sana's
    cross-attention site (SANA_FLASH_SITE: 2 heads, 16 queries against 300
    caption keys, batch 128) and SANA_FLASH_MORE (Sq 1 and 17, Sk 1, 299 and
    301, batch 32) against their plain versions, fp32 and bf16, each twice
    bit for bit, on the operands as Sana's block hands them; device times in
    both dtypes beside the plain version, SDPA (its backward; which of its
    backends take head dim 576 is logged) and the bound.
    Then both cascades' sites (CASCADE_CONFIGS as shipped, fp32): one
    forward of each stage at batch 64 (imagen guided) and one at 128 read by
    hooks and from K1's arguments; K1/K2 at every attention call, K3 at
    every GroupNorm site (down to the Efficient UNet's 2x2 maps) and K4 at
    the UNet stages' convs against their plain versions, each twice bit for
    bit; the cascades' resize (`resize_bilinear`) card against CPU.
47. sana.yaml as shipped (fp32, d 1152, 12 blocks) through the sampling CLI:
    GRID_STEPS guided ancestral steps at batch 64 (forwards of 128), 12 K5 a
    forward at SANA_FLASH_SITE and nothing else; a profile of one guided
    forward (output/chip_smoke/sana_profile.txt).
48. Its training: a profiled step at batch 128 (12 K5, 12 K6), then
    `train()` with prompts for SANA_TRAIN_STEPS steps (steps SANA_WARMUP to
    SANA_RESUME - 1 timed) and the two grids' forwards, losses, checkpoints,
    grids, and a resume from step SANA_RESUME that repeats its loss bit for
    bit; card against CPU (fp32, batch 2: one forward, one loss and every
    gradient).
49. Each cascade through `train()` (CASCADE_TRAIN_STEPS steps at batch 128,
    both stages a step; the stages' launch counts, both stages in one
    checkpoint, the chained grid) and the sampling CLI (GRID_STEPS steps a
    stage at batch 64; imagen with prompts and guidance), launches against
    the stages' counts.
50. Each cascade card against CPU: the SR stage's loss with injected
    timesteps, noise and augmentation draws, and its gradient norm; a
    10-step chained sample of both stages with every draw injected.
51. The video UNets' kernel sites, fp32 and bf16 against the plain
    versions with the earlier phases' tolerances: K1/K2 at
    video_diffusion_models.yaml's 16x16, 8x8 and middle attention over B*F
    = 128 maps, Make-A-Video's cross-attention against 77 caption keys and
    Imagen-Video's at 4x4 (VIDEO_K1_SITES); K5/K6 at AnimateDiff's 32x32
    motion attention, 8,192 and 16,384 sequences of 16 frames (the grid's
    B*H up to 32,768), and a ragged site (MOTION_SITE, MOTION_MORE); K4 at
    a shared-frame conv2 (coefficients over an example's 16 frames,
    repeated per frame); K2, K4, K5 and K6 twice bit for bit. fp32 device
    ms of one call beside the plain version, the library call (SDPA and its
    backward, F.conv2d) and the bound.
52. video_diffusion_models.yaml as shipped (fp32) through the video
    trainer: the launches its structure implies a forward and a training
    step (hooks), a profiled training step at batch 8, VIDEO_TRAIN_STEPS
    steps at batch 8 with strips and checkpoints, launches against the
    counts, steps/s, a resume whose first step repeats its loss bit for
    bit; then the video sampling CLI, VIDEO_SAMPLING_STEPS of the config's
    1024 ancestral steps at batch 8: launches per forward, samples/s.
53. imagen_video_8x16x16, make_a_video, video_ldm and animate_diff (fp32,
    as shipped): VIDEO_COMPANION_STEPS training steps at batch 8 and a
    VIDEO_CLI_STEPS-step CLI sample at batch 8 each, launches against their
    structure's counts, every kernel of each path launched; K3 at every
    GroupNorm site of the five configs (the temporal attentions' (B*H*W,
    F, C) views, pseudo-3D's per-frame norm1) in fp32 and bf16.
54. Reconstruction guidance and the splice: video_diffusion_models.yaml
    sampled 3 steps at batch 4 with conditioning frames x_a on its 4
    overlap frames and frames 12-15 observed: the gradient non-zero past
    the overlap, K2 launched in the sampler, the observed frames equal to
    x0 after every step.
55. video_diffusion_models.yaml and animate_diff.yaml at reduced depth
    (`video_cut_config`) card against CPU: the loss with injected times and
    noise, its gradient norm, a 5-step trajectory with injected noise.
56. flexible_diffusion_modeling.yaml as shipped (fp32) at batch 8: the
    launches its structure implies (23 K3, 44 K4 a forward and a training
    step: its residual blocks never drop, as in JAX); K3 at every site in
    fp32 and bf16 and K4 at every conv site in fp32, twice bit for bit,
    their fp32 device ms (K3 warm and cold) beside the plain version, the
    library call and the bound; its spatial einsum attention beside K1 and
    SDPA; a profile of one forward and one training step.
57. FDM through the entry points: FDM_TRAIN_STEPS trainer steps with FDM
    batches and a resume that repeats its loss, the sampling CLI, the
    autoregressive scheme (160 frames in 13 windows), the extend CLI to 32
    frames (hard on FDM; guided on video_diffusion_models.yaml, FDM's
    guided form refused); launches against the counts of every run.
58. FDM at reduced depth (`fdm_cut_config`) card against CPU.
59. imagen_video.yaml: K1/K2, K3 and K4 at the temporal SR stage's sites,
    fp32 times of K3/K4 there; the three stages chained (CHAIN_STEPS a
    stage) with launches against each stage's counts; the 5-D loss refused.
60. The warm start: an image run of video_ldm.yaml's spatial network,
    then video_ldm.yaml and animate_diff.yaml warm-started from it with
    temporal-only training: the restored parameters bit-equal afterwards,
    the temporal ones moved from init, launches against the frozen
    network's counts (K2 only where a gradient flows back through K1).
61. video/moving_mnist_256 through the video trainer on FDM, launches
    against FDM's counts.
62. The autoencoders' kernel sites (`phase_vae_sites`): K1/K2 at one head
    of 256 over the KL VAEs' mid-block tokens (64 and 512 keys at batch 64,
    and ragged) in fp32 and bf16, twice bit for bit, their fp32 times beside
    the plain version, SDPA and the bound; urbansound8k_4x16x32.yaml at full
    width encoding and decoding 64 log-mels of 64x128 (it trains in phase
    70); K3 at every GroupNorm site of vae.yaml's forward and of the
    Hunyuan and OpenSora VAEs' (5-D maps, 1-4 channels a group, one (B,
    F*H*W, C) problem) in fp32, twice bit for bit, timed warm and cold
    beside F.group_norm; K5/K6 at ltx_video.yaml's 3x4x4 latent grid (self
    and 128-key cross-attention at batch 8), fp32 and bf16, timed in fp32.
63. The four trainable VAE configs at full width through the port's
    autoencoder CLIs (disc_start lowered to 0 in a copy): a few steps, a
    resume that repeats its logged loss bit for bit, the reconstruct CLI on
    the run, every run's K1/K2/K3 launches against the structure read by a
    global forward hook (`structure_counts`), each config's steps/s and a
    profiled VAE-GAN step. The video VAEs read 20-frame clips written as
    the real Moving-MNIST archive (`vae_video_data`, `video_data`): on the
    16-frame stand-in the Hunyuan and OpenSora decoders return fewer frames
    than they were given and the loss fails, as JAX's does.
64. ltx_video.yaml at full width through the video training CLI with
    --load_vae_weights_from_checkpoint on phase 63's LTX VAE run: 24 K5 a
    forward and 24 K6 a step at the latent grid's shapes, a resume that
    recomputes the same latent scale and repeats its loss, decoded strips
    and samples (steps/s, samples/s, a profiled step), and the video
    sampling CLI refusing the config, which loads no VAE, as JAX's fails.
65. Card against CPU at reduced depth: one VAE-GAN step of the KL, LTX and
    Hunyuan VAEs; ltx_video.yaml's latent loss and a 5-step decoded
    trajectory.
66. K5/K6 at Sora's sites (batch 8: spatial (128, 6, 64, 64), temporal
    (512, 6, 16, 16), caption (8, 6, 1024 queries, 120 keys)) and
    HunyuanVideo's (joint (8, 6, 400, 400), token refiner (8, 6, 256,
    256)) in fp32 and bf16, twice bit for bit, fp32 times beside the plain
    version, SDPA and the bound (`phase_transformer_sites`).
67. The CLAP audio config's sites (`phase_audio_sites`): K1/K2 at its 4
    heads of 64 over 256 and 16 tokens, K3 at every GroupNorm site and K4
    at every conv site of a forward and a training step at batch 64, each
    twice bit for bit; fp32 times of K1/K2 at the 16x16 site and of K3/K4
    per forward; a profiled training step.
68. sora.yaml at full width, batch 8: 48 K5 a forward and 48 K6 a step
    (read by a global forward hook, `structure_counts`), a profiled step,
    the video training CLI (OpenSora frame masks from its mask_ratios) with
    a resume that repeats its loss, the video sampling CLI.
69. hunyuan_video.yaml at full width, batch 8, over phase 63's Hunyuan VAE
    run: 20 K5 a forward and 20 K6 a step, the VAE's K3; a profiled step;
    the video training CLI with --load_vae_weights_from_checkpoint and a
    resume (the same latent scale, the same loss); the video sampling CLI
    refusing the latent config, as JAX's fails.
70. The audio path on the synthetic UrbanSound8k: the CLAP config through
    `train_audio` at batch 64 with a resume, `sample_audio` (WAVs from
    Griffin-Lim on the card), both audio VAEs through
    `train_audio_autoencoder` (32x32 and 64x128 log-mels); every run's
    launches against the structure.
71. Card against CPU at reduced depth: sora.yaml (with a frame mask),
    hunyuan_video.yaml (decoded) and the CLAP config: loss, gradient norm
    and a 5-step trajectory.
72. LoRA fine-tuning of the flagship (bf16, batch 128) over phase 5's
    final checkpoint (`phase_lora`): LORA_STEPS steps through `train()` with
    `use_lora_training` (each step a flagship step's K1-K4 launches, every
    base parameter bit for bit unchanged, lora_weights.pkl), a resume
    through the `train_lora` CLI that repeats its step's loss, the sampling
    CLI with --lora_weights (LORA_SAMPLING_STEPS DDIM steps at batch 64)
    equal bit for bit to sampling the merged network, and card against CPU
    (fp32, batch 2): one LoRA loss, the factors' gradients, the merged
    forward.
73. Gradient accumulation (`phase_accumulation`, k = ACCUM_K): 4 mini-steps
    of the train step with EMA, the parameters moving only after mini-steps
    2 and 4; `train(gradient_accumulation_steps=2)` for ACCUM_STEPS
    mini-steps, its checkpoint after mini-step 3 carrying the accumulator,
    and a resume from it repeating mini-step 4's loss; card against CPU
    (fp32, batch 2): the mini-batches' gradient norms and their mean, and
    on the card the accumulated update bit for bit one step on that mean.
74. Importance sampling (`phase_importance`): `ImportanceSampler`'s
    device update on 20 batches of 128 (timestep, loss) pairs with
    duplicates, the card's state bit for bit the CPU's and the float64 host
    path's, its weights within 1e-6 and 1e-5; the flagship with the
    sampler as the config's override (written under output/) from a seeded
    warmed history (`warmed_importance`) through `train()`, the checkpoint
    carrying the moved history, a resume repeating its step's loss.
75. Observability (`phase_observability`): a `train()` run with the model
    summary on (printed at start-up) and `profile_start_step`
    PROFILE_START: its torch.profiler trace holds K1-K4's kernels of its 3
    steps and none of the others' or the grid's; its TensorBoard events
    (read back, each record's crc checked) hold every logged scalar and
    the sample grid, whose pixels are sample-<step>.png's; `debug_nans`
    leaves a clean run's losses bit for bit and raises FloatingPointError
    at a conv1 kernel poisoned with a NaN; the summary's and the
    TensorBoard writer's start-up wall times; the native batch assembler
    built by g++ and equal to numpy bit for bit. Then the steps/s and
    device time of a flagship, LoRA, accumulation and importance step
    (`extras_step_times`).
76. Checkpoint interchange and FID (`phase_interchange`): phase 5's final
    flagship checkpoint exported into the reference layout
    (importers/export_torch.py) as a `.pt` and a `.safetensors`, each
    through the import CLI (every parameter and the EMA bit for bit phase
    5's; its wall time), then measure_fid on the import (FID_SAMPLES
    samples, FID_STEPS DDIM steps, batch FID_BATCH; a finite FID above a
    finite floor; K1/K3/K4 launches against FID_STEPS forwards a batch) and
    phase 29's FID on the extractor it trained; the bytes written logged,
    then removed.
77. measure_video_fid on phase 52's last video_diffusion_models.yaml
    checkpoint (`phase_video_fid`: VIDEO_FID_VIDEOS videos,
    VIDEO_SAMPLING_STEPS steps; launches against the structure's).
78. The perceptual filter bank's trainer (`phase_perceptual`): one step
    card against CPU, the train_perceptual_features CLI on the card into
    output/chip_smoke/, the shipped asset's sha256 unchanged.

At the end a table sets K1, K2 and K7 per site beside their times before
the redesign of K1 and K2 (PERF.md), the library call's and the bound, one
sets K3 per site beside its time before its redesign, its cold time,
F.group_norm's, the bound and the plain version's, one sets K4 per site
beside its time before its redesign, F.conv2d's, the bound and the plain
version's, and one sets K5 and K6 per site beside
their times before their redesign (FLASH_BEFORE_MS), SDPA's and both fp32
bounds. The `kernels` line gives K1 and K2 also at the headline's
cross-attention sites (`cross_attention`), at the deep WideFormer's
(`wideformer_deep`) and at head dim 256, edm.yaml's sites
(`edm_head_dim_256`), K3's largest fp32 error at the EDM and score-SDE
configs' sites (`edm_max_abs_err_fp32`), K5 and K6 at PixArt's cross-attention site
(`pixart_cross_attention`) and at head dim 256, WideFormer's
(`wideformer_head_dim_256`), K1 and K2 at WideFormer's self-attention
(`wideformer_self_attention`), K5 and K6 at the MM-DiT family's joint
attention (`mmdit_joint_attention`: each site's times and bound, the
launches on each headline's and companion's paths), and K1's launches on
the consistency and progressive-distillation paths; K5 and K6 at Sana's
site (`sana_cross_attention`: one fp32 call's times and bound, bf16 beside
them, the launches on sana.yaml's sampling and training runs), and K1-K4's
launches on the cascades' training and sampling-CLI runs with their largest
fp32 error at the stages' sites (`cascades`); K1-K6 at the video UNets'
sites (`video_unets`: each site's times and bound, K3's largest fp32
error at their GroupNorm sites, and the launches of each video config's
training and sampling-CLI runs and of the reconstruction-guided sampling,
which also count in each kernel's `launches`); K1-K6's launches on the
long-video paths of phases 57-61 with K3/K4 per FDM forward and per
temporal-SR-stage forward (`long_video`; these launches count in
`launches` too); K1/K2, K3 and K5/K6 at the autoencoders' sites with their
launches in phases 63-64's runs (`autoencoders`; counted in `launches`
too); K3/K5/K6 on Sora's and HunyuanVideo's runs with K5/K6 at their sites
(`long_video_transformers`) and K1-K4 on the audio path's runs with their
times at the audio UNet's sites (`audio`; both counted in `launches`
too), K1-K4 on phases 72-75's runs (`trainer_extras`; counted in
`launches` too), and K1/K3/K4 in phases 76-77's evaluation CLIs
(`evaluation`; counted in `launches` too). The trainers' start-up model summary stays off in this
run (XDIFFUSION_MODEL_SUMMARY=0) but in phase 75: its forward would add
launches to every run's count. The last two lines are the card's
`nvidia-smi` name and power limit and `{"ok": true, "device": {...}}`; the
JSON line before them lists the kernels. The image trainer's sample grids
walk GRID_STEPS sampling steps in this run, not the configs' 1000
(`short_grids`), and the trainers build each dataset once a run
(`cached_datasets`): the run's time limit is shared by every slice's
phases, and each phase logs its wall time. Without a CUDA device, or without the repository beside it, the
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
# the resume starts from, and the grid size of the end-of-run samples (5,
# 20 and 30 steps until the video UNets' phases came, 10 timed steps until
# the autoencoders' came: the script's time limit).
TRAIN_BATCH, WARMUP_STEPS, TIMED_STEPS, NUM_SAMPLES = 128, 3, 6, 16
RESUME_STEP = WARMUP_STEPS + TIMED_STEPS
TRAIN_STEPS = RESUME_STEP + 3
# The sampling steps of the image trainer's grids (`sample_and_save`) in
# this run, where the configs walk 1000 (the continuous ones 1024): a grid
# forward at NUM_SAMPLES is launch-bound (a UNet's about 35 ms on an H100
# 80GB HBM3 at 700 W), and with 1000-step grids the whole script took 1199
# s of its 1200 once phases 41-45 came, the grids some 390 s of it. A cut
# of depth (`short_grids`): 100 steps, then 25 once Sana's and the
# cascades' phases came, when the whole script took 962 s on one host and
# 1229 s on a slower one; 5 once the video UNets' phases (51-55, about 100
# s) came; 3 once the trainer extras' (72-75) came.
GRID_STEPS = 3
# The timed sampling runs of LTX, the DiT and PixArt: the last MAIN_STEPS
# of their configs' 1000 steps (the whole 1000 until Sana's and the
# cascades' phases came, 250 until the video UNets' came, 50 until the
# autoencoders' came: the script's time limit; the launch counts and
# samples/s are per this run).
MAIN_STEPS = 30
# Published H100 SXM peaks (dense): bf16 tensor cores, fp32 CUDA cores, HBM;
# and the SFUs' exponentials per second (FlashAttention-3 paper). K5 and K6
# run fp32 as three TF32 products a product on the tensor cores, whose TF32
# rate is PEAK_TF32: fp32-accurate products at PEAK_TF32 / 3.
PEAK_BF16, PEAK_FP32, PEAK_BYTES, PEAK_EXP = 989e12, 67e12, 3.35e12, 3.9e12
PEAK_TF32 = 494.7e12
# The activities of every profile of a forward or a step: the card's
# kernels, copies and sets only (busy time, kernel shares, launches). With
# the host's operators as well (until phases 72-75 came), each profile of a
# training step cost some 4 s of host time to record and walk, about a
# tenth of the whole run over its profiles, and a profiled flagship step
# read 57.0 ms of device time against 49.9 with the card's activity alone.
PROFILED = [torch.profiler.ProfilerActivity.CUDA]
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


def ptxas_summary(name: str, log_text: str, only: str = "") -> None:
    """One line per kernel of a library's `nvcc -Xptxas -v` output:
    registers, static shared memory (the kernels here take theirs dynamic,
    sized by the launch plan) and spills; with `only`, the kernels whose
    mangled name holds it."""
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
    entries = [e for e in entries if only in e["name"]]
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


def main_path_sites(model, batch: int = BATCH, size: int = 32, run=None):
    """The kernel call sites of one UNet forward on size x size images, with
    their input shapes at `batch`, read by hooks on the modules that call
    the kernels; `run()`, when given, is the forward (or one sampling step)
    to read them from. Token-sequence attention (the GLIDE transformer's)
    goes to "token_attention"."""
    from xdiffusion_tpu_torch.layers.attention import (
        MultiHeadSelfAttention,
        SpatialCrossAttention,
    )
    from xdiffusion_tpu_torch.layers.resnet import FastGroupNorm, FusedAffineConv

    sites = {"bsc_attention": [], "group_norm_silu": [], "affine_silu_conv3x3": [],
             "token_attention": []}

    def on_attn(mod, args, kwargs, out):
        b, h, w, c = args[0].shape
        sites["bsc_attention"].append((b, h * w, c, mod.num_heads))

    def on_mhsa(mod, args, kwargs, out):
        b, n, c = args[0].shape
        sites["token_attention"].append((b, n, c, mod.num_heads))

    def on_norm(mod, args, kwargs, out):
        if not kwargs.get("return_coefficients") and kwargs.get("t_scale") is None:
            sites["group_norm_silu"].append((tuple(args[0].shape), mod.num_groups, mod.silu,
                                             mod.epsilon))

    def on_conv(mod, args, kwargs, out):
        res = kwargs.get("residual", args[3] if len(args) > 3 else None)
        sites["affine_silu_conv3x3"].append(
            (tuple(args[0].shape), mod.kernel.shape[-1], res is not None))

    hooks = []
    for m in model.score_network().modules():
        fn = {SpatialCrossAttention: on_attn, FastGroupNorm: on_norm,
              FusedAffineConv: on_conv, MultiHeadSelfAttention: on_mhsa}.get(type(m))
        if fn is not None:
            hooks.append(m.register_forward_hook(fn, with_kwargs=True))
    if run is None:
        x = torch.zeros((batch, size, size, 1), device="cuda")
        t = torch.zeros((batch,), dtype=torch.long, device="cuda")
        with torch.inference_mode():
            model.predict_score(x, {"timestep": t})
    else:
        run()
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
K3_RAGGED = [((2, 5, 5, 4), 1, True, 1e-5), ((3, 7, 7, 12), 3, False, 1e-5),
             ((3, 7, 7, 48), 12, True, 1e-5), ((2, 1, 1, 1024), 32, False, 1e-5),
             ((1, 128, 128, 128), 32, True, 1e-5), ((2, 64, 64, 512), 32, False, 1e-5),
             ((1, 16, 16, 256), 32, True, 1e-5), ((5, 9, 9, 2048), 32, True, 1e-5)]
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


def k3_compare(group: str, site, gen, seen, dtypes=(torch.float32, torch.bfloat16)):
    """K3 at one site (x's shape, groups, silu, eps) against its plain
    version in each of `dtypes`: fp32 at 1e-4 (summation order), bf16 at 1
    ulp (one rounding on both sides); twice, bit for bit (no atomics). Adds
    each plan's (variant, cluster size) to `seen`. Returns (x of the last
    dtype, scale, bias, {dtype: max|kernel - plain|})."""
    from xdiffusion_tpu_torch.ops import group_norm

    def randn(*shape, dtype=torch.float32, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale + shift).to(dtype)

    shape, ng, silu, eps = site
    c, hw = shape[-1], math.prod(shape[1:-1])
    scale, bias = randn(c, scale=0.1, shift=1.0), randn(c, scale=0.1)
    errs = {}
    for dt in dtypes:
        plan = group_norm.gn_plan(shape[0], hw, c, ng, dt)
        seen.add((plan.variant, plan.k))
        x = randn(*shape, dtype=dt, scale=2.0, shift=0.5)
        want = group_norm.group_norm_silu_plain(x, scale, bias, ng, eps, silu)
        got = group_norm.group_norm_silu(x, scale, bias, ng, eps, silu)
        again = group_norm.group_norm_silu(x, scale, bias, ng, eps, silu)
        torch.cuda.synchronize()
        check(torch.equal(got, again), f"K3 {group} x={shape} {dt}: two runs differ")
        errs[dt] = compare(f"K3 {group} x={shape} groups={ng} silu={silu} eps={eps:g} {dt} "
                           f"({plan.variant}, k {plan.k}, {plan.threads} threads, {plan.pieces} "
                           f"pieces; repeat bit-identical)", got, want,
                           1e-4 if dt == torch.float32 else bf16_tol(want, 1))
    return x, scale, bias, errs


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
    groups = {"flagship": sites, "train": train_sites, "8x8": small_sites, "ragged": K3_RAGGED}
    rec, rows, seen = new_record(), [], set()
    rec["cold_ms"] = 0.0
    for group, found in groups.items():
        for site, n in counted(found).items():
            shape, ng, silu, eps = site
            c = shape[-1]
            x, scale, bias, errs = k3_compare(group, site, gen, seen)
            if group == "flagship":
                rec["err"] = max(rec["err"], errs[torch.bfloat16])
            if group == "ragged":
                continue
            dt = x.dtype
            plan = group_norm.gn_plan(shape[0], math.prod(shape[1:-1]), c, ng, dt)
            xn = x.permute(0, 3, 1, 2)  # channels-last NCHW view, no copy
            sd, bd = scale.to(dt), bias.to(dt)
            if silu:  # no single call: F.group_norm, then F.silu in place
                lib = lambda: F.silu(F.group_norm(xn, ng, sd, bd, eps), inplace=True)
            else:
                lib = lambda: F.group_norm(xn, ng, sd, bd, eps)
            kernel = lambda: group_norm.group_norm_silu(x, scale, bias, ng, eps, silu)
            plain = lambda: group_norm.group_norm_silu_plain(x, scale, bias, ng, eps, silu)
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
# shape, as (B, Sq, Sk, C, heads); every variant and head dim runs (head
# dim 256: the wide variant, with one key, one head and two).
BSC_SHAPES = [(3, 1, 1, 128, 2), (3, 15, 15, 64, 2), (3, 17, 17, 128, 2), (3, 17, 17, 256, 2),
              (2, 30, 24, 32, 2), (2, 100, 100, 128, 2), (2, 255, 255, 64, 1),
              (2, 256, 256, 32, 2), (2, 257, 257, 256, 2), (2, 16, 100, 128, 2),
              (2, 100, 17, 512, 4), (2, 33, 500, 256, 4), (3, 1, 1, 256, 1),
              (3, 17, 17, 256, 1), (2, 100, 37, 512, 2)]
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
    for (shape, ng, silu, eps), n in counted(train_sites["group_norm_silu"]).items():
        c = shape[-1]
        leaves = [randn(*shape, scale=2.0, shift=0.5, dtype=torch.bfloat16),
                  randn(c, scale=0.1, shift=1.0), randn(c, scale=0.1)]
        leaves = [t.requires_grad_() for t in leaves]
        out = group_norm.group_norm_silu(*leaves, ng, eps, silu)
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
    from torch.profiler import profile

    x = torch.randn((BATCH, 32, 32, 1), device="cuda")
    t = torch.full((BATCH,), 500, dtype=torch.long, device="cuda")
    with torch.inference_mode():
        for _ in range(3):
            model.predict_score(x, {"timestep": t})
        torch.cuda.synchronize()
        with profile(activities=PROFILED) as prof:
            t0 = time.perf_counter()
            model.predict_score(x, {"timestep": t})
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    table = prof.key_averages()  # once: each call walks every host and device event
    events = [e for e in table if e.device_type.name == "CUDA"]
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
        f.write(table.table(sort_by="self_device_time_total", row_limit=60))


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
UNET_CLI_SAMPLES, UNET_CLI_STEPS = 16, 3  # 5 until phases 76-78 came


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


class resumed_run:
    """While active, the trainers write no checkpoint file (each save only
    logs): a resumed run's check is its logged loss, and its checkpoint at
    the end, the network and its optimizer state (3.1 GB for Sana), would
    only add to the run's disk writes, which the full-width checkpoints of
    every phase bring to tens of GB."""

    def __enter__(self):
        from xdiffusion_tpu_torch import checkpoints

        self.saved = checkpoints.write_payload
        checkpoints.write_payload = (
            lambda directory, step, payload, max_to_keep=3: os.path.join(directory, f"{step}.pt"))
        return self

    def __exit__(self, *exc):
        from xdiffusion_tpu_torch import checkpoints

        checkpoints.write_payload = self.saved


def flagship_counts(sites):
    """(launches per bf16 training step, per sampling forward) of the
    flagship UNet with the kernel `sites` of a forward. Per training step
    (dropout on): K1 and K2 at every attention site, K3 at the attention
    norms and final_norm, K4 for conv1 of every residual block (conv2 leaves
    the fused path while dropping). Per sampling forward: K1, K3, and K4 for
    both convs."""
    conv1 = sum(1 for _, _, has_res in sites["affine_silu_conv3x3"] if not has_res)
    per_step = {"bsc_attention": len(sites["bsc_attention"]),
                "bsc_attention_bwd": len(sites["bsc_attention"]),
                "group_norm_silu": len(sites["group_norm_silu"]),
                "affine_silu_conv3x3": conv1}
    per_forward = {"bsc_attention": len(sites["bsc_attention"]),
                   "group_norm_silu": len(sites["group_norm_silu"]),
                   "affine_silu_conv3x3": len(sites["affine_silu_conv3x3"])}
    return per_step, per_forward


def phase_training(sites):
    """The flagship's training path in bf16 through train(): launches per
    kernel over the run against the counts the code implies, every step's
    loss and grad_norm, steps/s, checkpoints, sample grids and the resume.
    Returns the run's launches, steps/s and run directory."""
    import shutil

    from xdiffusion_tpu_torch.ops._build import kernels
    from xdiffusion_tpu_torch.training.image.train import train

    per_step, per_forward = flagship_counts(sites)
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
    sampling_forwards = samplings * GRID_STEPS
    expected = {name: TRAIN_STEPS * per_step.get(name, 0)
                + sampling_forwards * per_forward.get(name, 0) for name in ks}
    log(f"training run ({TRAIN_STEPS} steps + {samplings} x {GRID_STEPS}-step sampling of "
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

    with resumed_run():
        resumed = train(config, num_training_steps=RESUME_STEP + 1,
                        output_path=os.path.join(root, "resumed"),
                        resume_from=os.path.join(out_dir, "checkpoints", f"{RESUME_STEP}.pt"),
                        **common)
    want = metrics[RESUME_STEP]["loss"]
    got = read_metrics(resumed)[RESUME_STEP]["loss"]
    log(f"resume from step {RESUME_STEP}: loss {got!r} against the uninterrupted "
        f"run's {want!r} (|diff| {abs(got - want):.3e})")
    check(abs(got - want) <= 1e-6 * abs(want), "the resumed step's loss differs")
    return launches, sps, out_dir


def profile_train_step():
    """Device time by kernel for one bf16 training step at batch TRAIN_BATCH,
    and the device's busy share of its wall time; the full table goes to
    output/chip_smoke/train_profile.txt."""
    from torch.profiler import profile

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
    with profile(activities=PROFILED) as prof:
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    table = prof.key_averages()  # once: each call walks every host and device event
    events = [e for e in table if e.device_type.name == "CUDA"]
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
        f.write(table.table(sort_by="self_device_time_total", row_limit=60))


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
    """The shipped LTX config, fp32, batch 4, MAIN_STEPS Euler steps timed through
    `sample`: exactly 24 K5 launches per forward and no other kernel; then
    10 steps through the video CLI. Returns (K5 launches of the timed run,
    samples/s)."""
    from xdiffusion_tpu_torch import sample_video as cli
    from xdiffusion_tpu_torch.ops import flash_attention as fa

    model = build_ltx("cuda")
    prompts = [str(i) for i in range(LTX_BATCH)]
    steps = MAIN_STEPS

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
    # with the same seed it must repeat sample()'s samples and write the GIF
    # (video-step0.gif: a bare state dict records no step).
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
    gif = os.path.join(cli_dir, "video-step0.gif")
    check(os.path.isfile(gif) and os.path.getsize(gif) > 0, "the video CLI wrote no GIF")
    with open(gif, "rb") as f:
        check(f.read(6) == b"GIF89a", "the video CLI's GIF has no GIF89a header")
    os.remove(ckpt)

    profile_ltx_forward(model, prompts)
    return launches["flash_attention"], sps


def profile_ltx_forward(model, prompts):
    """Device time by kernel for one LTX forward at batch LTX_BATCH, fp32,
    the device's busy share of its wall time, and launches per forward; the
    table goes to output/chip_smoke/ltx_profile.txt."""
    from torch.profiler import profile

    from xdiffusion_tpu_torch.ops import flash_attention as fa

    x = torch.randn((LTX_BATCH, 8, 8, 8, 1), device="cuda")
    ctx = ltx_context(model, prompts)
    with torch.inference_mode():
        for _ in range(3):
            model.predict_score(x, ctx)
        torch.cuda.synchronize()
        fa.FLASH_KERNEL.launches = 0
        with profile(activities=PROFILED) as prof:
            t0 = time.perf_counter()
            model.predict_score(x, ctx)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    table = prof.key_averages()  # once: each call walks every host and device event
    events = [e for e in table if e.device_type.name == "CUDA"]
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
        f.write(table.table(sort_by="self_device_time_total", row_limit=60))


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

    with resumed_run():
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
    from torch.profiler import profile

    torch.cuda.synchronize()
    with profile(activities=PROFILED) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    table = prof.key_averages()  # once: each call walks every host and device event
    events = [e for e in table if e.device_type.name == "CUDA"]
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
            f.write(table.table(sort_by="self_device_time_total", row_limit=60))
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
    return any(n in key for n in ("bsc::packed_fwd", "bsc::row_fwd", "bsc::wide_fwd",
                                  "bsc_stream::"))


def is_k4(key: str) -> bool:
    """A profiler key of K4's kernels: the staged kernel, its split sum, the
    generic kernel."""
    return any(n in key for n in ("staged::conv_kernel", "staged::reduce_kernel",
                                  "affine_silu_conv3x3_kernel"))


def is_k2(key: str) -> bool:
    return any(n in key for n in ("bsc::packed_bwd", "bsc::row_dq", "bsc::dkv",
                                  "bsc::wide_dq", "bsc::wide_dkv", "bsc_stream_bwd::"))


def profile_dit(label: str, step, out_file: str):
    """Profiles one call of `step` (which ends on the host): wall time, the
    device's busy time and share, K1's and K2's device time and the top
    kernels, the table to output/chip_smoke/<out_file>."""
    from torch.profiler import profile

    torch.cuda.synchronize()
    with profile(activities=PROFILED) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    table = prof.key_averages()  # once: each call walks every host and device event
    events = [e for e in table if e.device_type.name == "CUDA"]
    busy = sum(e.self_device_time_total for e in events) / 1e3
    k1 = sum(e.self_device_time_total for e in events if is_k1(e.key)) / 1e3
    k2 = sum(e.self_device_time_total for e in events if is_k2(e.key)) / 1e3
    log(f"profile of {label}: wall {wall_ms:.3f} ms, device busy {busy:.3f} ms "
        f"({100 * busy / wall_ms:.1f}%), {sum(e.count for e in events)} device launches; "
        f"K1 {k1:.3f} ms, K2 {k2:.3f} ms")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"  {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<4d} {e.key[:90]}")
    with open(os.path.join(OUT_DIR, out_file), "w") as f:
        f.write(table.table(sort_by="self_device_time_total", row_limit=60))


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
    """The shipped DiT, fp32, batch 64, guided, MAIN_STEPS ancestral steps through
    `sample()`: exactly 12 K1 launches per forward and nothing else; then 5
    steps through the CLI, a profile, and K1 and K2 held against their plain
    versions at the DiT site with their times. Returns (every kernel's
    launches in the run, samples/s, K1's and K2's largest error at the
    site, their records there)."""
    from xdiffusion_tpu_torch import sample as cli
    from xdiffusion_tpu_torch.ops import flash_attention as fa

    model = build_dit("cuda")
    steps = MAIN_STEPS
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
    expected["bsc_attention"] = 12 * TRAIN_STEPS + 12 * samplings * GRID_STEPS
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
        f"x {GRID_STEPS}-step guided grids of {NUM_SAMPLES}, {run_s:.1f} s): launches {launches}, "
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
    with resumed_run():
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

    # The MoE DiT: TRAIN_STEPS steps, then 10 guided steps at batch 64 whose
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
    """`path` without the training guidance drop, dropout and drop-path,
    written to output/chip_smoke/<name>/."""
    import yaml

    with open(path) as f:
        cfg = yaml.safe_load(f)
    cfg["diffusion"]["classifier_free_guidance"]["unconditional_guidance_probability"] = 0.0
    params = cfg["diffusion"]["score_network"]["params"]
    params["dropout"] = 0.0
    if "drop_path" in params:
        params["drop_path"] = 0.0
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


# ---- text-conditioned and continuous-time UNets (phases 19-23) --------------

TEXT_CONFIG = os.path.join(ROOT, "configs/image/mnist/ddpm_32x32_v_continuous_clip.yaml")
# Beside the headline, at full width: GLIDE (GPT-2 BPE tokens, its 6-layer
# text transformer, 384-key cross-attention), Imagen's base stage (T5 tokens,
# pooled text to time, the context LayerNorm, dynamic thresholding), CLIP
# text on the discrete schedule, and the continuous v target without text.
TEXT_COMPANIONS = ("glide.yaml", "imagen_base.yaml", "ddpm_epsilon_clip.yaml",
                   "ddpm_32x32_v_continuous.yaml")
TEXT_CLI_SAMPLES, TEXT_CLI_STEPS, TEXT_TRAIN_STEPS, TEXT_TRAIN_BATCH = 16, 5, 3, 32
# K1 and K2 at the new sites, as (B, Sq, Sk, C, heads): the headline's
# cross-attention at 16x16 (256 queries against 77 + 256 keys) and in the
# middle block (16 against 77 + 16), at the guided sampling batch (128) and
# in training (128); GLIDE's at 16x16 (256 against 128 + 256), in the middle
# (16 against 128 + 16) and its text transformer (128 tokens, one head of
# 128), at the CLI's guided batch (32); Imagen's 4x4 (16 against 77 + 16) and
# 2x2 (4 against 77 + 4) sites.
TEXT_SITE_SHAPES = [(128, 256, 333, 256, 4), (128, 16, 93, 256, 4), (32, 256, 384, 256, 4),
                    (32, 16, 144, 256, 4), (32, 128, 128, 128, 1), (32, 16, 93, 256, 4),
                    (32, 4, 81, 256, 4)]


def digit_prompts(n: int):
    return [str(i % 10) for i in range(n)]


def bsc_calls(run):
    """(B, Sq, Sk, C, heads) of every K1 call `run()` makes, read from the
    wrapper's arguments."""
    from xdiffusion_tpu_torch.ops import flash_attention as fa

    calls, original = [], fa.short_attention_bsc

    def recording(q, k, v, heads, scale):
        calls.append((q.shape[0], q.shape[1], k.shape[1], q.shape[2], heads))
        return original(q, k, v, heads, scale)

    fa.short_attention_bsc = recording
    try:
        run()
    finally:
        fa.short_attention_bsc = original
    return calls


def per_call_counts(sites, training: bool = False):
    """Launches per forward (or, `training`, per training step with dropout
    on) that the network's structure implies: K1 at every attention call
    (spatial and token), K2 at each of them in training, K3 at the
    attention norms and final_norm, K4 at every residual conv (in training
    conv1 only: conv2 leaves the fused path while dropping)."""
    k1 = len(sites["bsc_attention"]) + len(sites["token_attention"])
    conv = sites["affine_silu_conv3x3"]
    counts = {"bsc_attention": k1, "group_norm_silu": len(sites["group_norm_silu"]),
              "affine_silu_conv3x3": (sum(1 for _, _, res in conv if not res) if training
                                      else len(conv))}
    if training:
        counts["bsc_attention_bwd"] = k1
    return counts


def profile_text(label: str, step, out_file: str, expect=None):
    """Profiles one call of `step`: wall time, the device's busy time and
    share, K1-K6's device time and the top kernels; the table to
    output/chip_smoke/<out_file>. Returns (wall ms, busy ms). `expect`, the
    launches of K1 and K5 the step makes ({"K1": n, "K5": m}), checks that
    the profile saw them all: late in a long process the profiler can lose
    device events, and the busy time is then reported as not measured
    (nan)."""
    from torch.profiler import profile

    torch.cuda.synchronize()
    with profile(activities=PROFILED) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    table = prof.key_averages()  # once: each call walks every host and device event
    events = [e for e in table if e.device_type.name == "CUDA"]
    busy = sum(e.self_device_time_total for e in events) / 1e3
    if expect is not None:
        seen = {"K1": sum(e.count for e in events if is_k1(e.key)),
                "K5": sum(e.count for e in events if "flash_fwd" in e.key)}
        if seen != expect:
            log(f"profile of {label}: it saw {seen} launches of K1 and K5 where {expect} ran: "
                f"the profiler lost device events; the busy time is not measured")
            busy = float("nan")

    def ms(pred):
        return sum(e.self_device_time_total for e in events if pred(e.key)) / 1e3

    log(f"profile of {label}: wall {wall_ms:.3f} ms, device busy {busy:.3f} ms "
        f"({100 * busy / wall_ms:.1f}%), {sum(e.count for e in events)} device launches; "
        f"K1 {ms(is_k1):.3f} ms, K2 {ms(is_k2):.3f} ms, K3 {ms(lambda k: 'gn_kernel' in k):.3f} "
        f"ms, K4 {ms(is_k4):.3f} ms, K5 {ms(lambda k: 'flash_fwd' in k):.3f} ms, K6 "
        f"{ms(lambda k: any(n in k for n in ('flash_dq_', 'flash_dkv_', 'flash_split'))):.3f} ms")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"  {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<4d} {e.key[:90]}")
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, out_file), "w") as f:
        f.write(table.table(sort_by="self_device_time_total", row_limit=60))
    return wall_ms, busy


def check_bsc_sites(shapes, gen):
    """K1 and K2 at each (B, Sq, Sk, C, heads) of `shapes` against their
    plain versions, fp32 and bf16, with phase 2's tolerances, K1 and K2 twice
    bit for bit, each with the `bsc_plan` variant it takes (head dim 256:
    the wide variant; else past 32 tokens and up to ROW_MAX_KEYS keys: the
    row variant, its logit strip the key count rounded up to 64). q, k and
    v are column slices of one qkv projection
    at a self-attention site (Sq == Sk), else q of its own and k, v of a kv
    projection, as the layers give them. Returns {"K1": err, "K2": err}."""
    from xdiffusion_tpu_torch.ops import flash_attention as fa

    errs = {"K1": 0.0, "K2": 0.0}
    for b, sq, sk, c, heads in shapes:
        d = c // heads
        scale = d ** -0.5
        for dt in (torch.float32, torch.bfloat16):
            if sq == sk:
                q, k, v = torch.randn((b, sq, 3 * c), generator=gen,
                                      device="cuda").to(dt).chunk(3, -1)
            else:
                q = torch.randn((b, sq, 3 * c), generator=gen, device="cuda").to(dt)[..., :c]
                k, v = torch.randn((b, sk, 2 * c), generator=gen,
                                   device="cuda").to(dt).chunk(2, -1)
            g = torch.randn((b, sq, c), generator=gen, device="cuda").to(dt)
            plan = fa.bsc_plan(b, sq, sk, heads, d, dt)
            bwd = fa.bsc_plan(b, sq, sk, heads, d, dt, backward=True)
            tag = (f"B={b} Sq={sq} Sk={sk} C={c} heads={heads} {dt} ({plan.variant}, tile "
                   f"{plan.tile}, {plan.slices_per_block} warps; K2 {bwd.variant})")
            if d == fa.WIDE_HEAD_DIM:
                check(plan.variant == bwd.variant == "wide", f"{tag}: not the wide variant")
            elif sk <= fa.ROW_MAX_KEYS and max(sq, sk) > 32:
                check(plan.variant == bwd.variant == "row" and plan.tile == -(-sk // 64) * 64,
                      f"{tag}: not the row variant on a {-(-sk // 64) * 64}-key strip")
            want = fa.short_attention_bsc_plain(q, k, v, heads, scale)
            out = fa.short_attention_bsc(q, k, v, heads, scale)
            errs["K1"] = max(errs["K1"], compare(
                f"K1 {tag}", out, want, 1e-4 if dt == torch.float32 else bf16_tol(want, 2)))
            check_repeats(f"K1 {tag}", (out,), (fa.short_attention_bsc(q, k, v, heads, scale),))
            got = fa.short_attention_bsc_bwd(q, k, v, g, heads, scale)
            check_repeats(f"K2 {tag}", got, fa.short_attention_bsc_bwd(q, k, v, g, heads, scale))
            for name, x, y in zip(("dq", "dk", "dv"), got,
                                  fa.short_attention_bsc_bwd_plain(q, k, v, g, heads, scale)):
                scale_y = y.float().abs().max().item()
                errs["K2"] = max(errs["K2"], compare(
                    f"K2 {name} {tag}", x, y,
                    1e-4 * max(1.0, scale_y) if dt == torch.float32 else bf16_tol(y, 2)))
    return errs


def phase_text_sites():
    """K1 and K2 at TEXT_SITE_SHAPES (`check_bsc_sites`); then K1's and
    K2's device time at the headline's two bf16 sites beside SDPA's
    (forward; backward alone) and the bound, summed over a guided sampling
    forward (five 16x16 sites, one middle site). Returns {"K1": {...},
    "K2": {...}} of those sums."""
    from xdiffusion_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    errs = check_bsc_sites(TEXT_SITE_SHAPES, gen)

    sums = {kernel: dict.fromkeys(("ms", "sdpa_ms", "bound_ms"), 0.0) for kernel in ("K1", "K2")}
    for (b, sq, sk, c, heads), n in (((128, 256, 333, 256, 4), 5), ((128, 16, 93, 256, 4), 1)):
        d = c // heads
        q, g = (torch.randn((b, sq, c), generator=gen, device="cuda").to(torch.bfloat16)
                for _ in range(2))
        k, v = torch.randn((b, sk, 2 * c), generator=gen, device="cuda").to(
            torch.bfloat16).chunk(2, -1)
        qh, kh, vh, gh = (t.reshape(b, -1, heads, d).transpose(1, 2).contiguous()
                          for t in (q, k, v, g))
        leaves = [t.clone().requires_grad_() for t in (qh, kh, vh)]
        o = F.scaled_dot_product_attention(*leaves)
        # Each input read once, each output written once, in bf16; 4 (K1) or
        # 10 (K2: S again, dV, dP, dQ, dK) products of b sq sk c each.
        fwd_bound = max((2 * b * sq * c + 2 * b * sk * c) * 2 / PEAK_BYTES,
                        4 * b * sq * sk * c / PEAK_BF16) * 1e3
        bwd_bound = max((3 * b * sq * c + 4 * b * sk * c) * 2 / PEAK_BYTES,
                        10 * b * sq * sk * c / PEAK_BF16) * 1e3
        row = {
            "K1": (device_ms(lambda: fa.short_attention_bsc(q, k, v, heads, d ** -0.5)),
                   device_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh)), fwd_bound),
            "K2": (device_ms(lambda: fa.short_attention_bsc_bwd(q, k, v, g, heads, d ** -0.5)),
                   device_ms(lambda: torch.autograd.grad(o, leaves, gh, retain_graph=True)),
                   bwd_bound),
        }
        for kernel, (k_ms, l_ms, b_ms) in row.items():
            log(f"  {kernel} bf16 (B={b} Sq={sq} Sk={sk} C={c} heads={heads}) x{n}: "
                f"{k_ms:.4f} ms, SDPA{' backward' if kernel == 'K2' else ''} {l_ms:.4f} ms, "
                f"bound {b_ms:.4f} ms")
            for key, val in (("ms", k_ms), ("sdpa_ms", l_ms), ("bound_ms", b_ms)):
                sums[kernel][key] += n * val
    b, sq, sk, c, heads = TEXT_SITE_SHAPES[0]
    q, k, v = (torch.randn((b, s_, c), generator=gen, device="cuda").to(torch.bfloat16)
               for s_ in (sq, sk, sk))
    g = torch.randn_like(q)
    times = {}
    for variant, keys in (("row", fa.ROW_MAX_KEYS), ("stream", 0)):
        fwd = fa.bsc_plan(b, sq, sk, heads, c // heads, torch.bfloat16, max_row_keys=keys)
        bwd = fa.bsc_plan(b, sq, sk, heads, c // heads, torch.bfloat16, backward=True,
                          max_row_keys=keys)
        times[variant] = (device_ms(lambda: fa._forward(q, k, v, heads, 0.125, fwd)),
                          device_ms(lambda: fa.short_attention_bsc_bwd(q, k, v, g, heads, 0.125,
                                                                       bwd)))
        log(f"  {variant} plan at the headline's 16x16 site (bf16): {fwd.slices_per_block} "
            f"warps a block, {fwd.launches[0].smem} B of shared memory (K2's dq launch "
            f"{bwd.launches[0].smem} B); K1 {times[variant][0]:.4f} ms, K2 "
            f"{times[variant][1]:.4f} ms")
    for kernel, rec in sums.items():
        rec["err"] = errs[kernel]
        log(f"{kernel} at the headline's cross-attention sites, per guided sampling forward "
            f"(batch 128, bf16): {rec['ms']:.4f} ms, SDPA {rec['sdpa_ms']:.4f} ms, bound "
            f"{rec['bound_ms']:.4f} ms")
    return sums


def text_context(model, prompts, guided: bool, t: float = 0.5):
    """The context of one forward with `prompts` on the card: the prompts'
    tensors (guided: concatenated with the empty prompt's, as the sampler
    runs them), the time and its logSNR."""
    ctx = model.preprocess_context({"text_prompts": prompts})
    ctx = {k: v.to("cuda") for k, v in ctx.items() if isinstance(v, torch.Tensor)}
    if guided:
        unc = model.preprocess_context(model.unconditional_context({"text_prompts": prompts}))
        ctx = {k: torch.cat([v, unc[k].to("cuda")]) for k, v in ctx.items()}
    b = len(prompts) * (2 if guided else 1)
    ctx["timestep"] = torch.full((b,), t, device="cuda")
    ctx["logsnr_t"] = model.noise_scheduler().logsnr(ctx["timestep"])
    return ctx


def phase_text_sampling():
    """The headline in bf16, 50-step DDIM at batch 64 with prompts "0" to
    "9" in turn and the config's guidance (one forward on 128 samples a
    step): launches against the counts its structure implies, the samples,
    samples/s, a profile of one guided forward. Returns (launches,
    samples/s, the forward's (wall, busy) ms)."""
    from xdiffusion_tpu_torch.samplers.ddim import DDIMSampler

    model = build_model("bfloat16", "cuda", TEXT_CONFIG)
    guidance = model.classifier_free_guidance()
    prompts = digit_prompts(BATCH)
    ddim = DDIMSampler()

    def run(seed, steps=STEPS):
        g = torch.Generator(device="cuda").manual_seed(seed)
        return model.sample(num_samples=BATCH, num_sampling_steps=steps, sampler=ddim,
                            context={"text_prompts": prompts},
                            classifier_free_guidance=guidance, generator=g)

    sites = main_path_sites(model, run=lambda: run(SEED, steps=1))
    per_forward = per_call_counts(sites)
    calls = sorted(set(bsc_calls(lambda: run(SEED, steps=1))))
    log(f"headline {os.path.basename(TEXT_CONFIG)}: guidance {guidance}, K1 sites of a guided "
        f"forward {calls}; launches per forward implied by the code: {per_forward}")
    check(all(c in [s[:5] for s in TEXT_SITE_SHAPES] for c in calls),
          f"a K1 site off TEXT_SITE_SHAPES: {calls}")
    run(SEED)  # warm-up
    torch.cuda.synchronize()
    ks = reset_launches()
    out = run(SEED + 1)
    torch.cuda.synchronize()
    launches = {name: k.launches for name, k in ks.items()}
    expected = {name: STEPS * per_forward.get(name, 0) for name in ks}
    log(f"headline: 50-step guided DDIM, batch {BATCH}, bf16: launches {launches}, "
        f"expected {expected}")
    check(launches == expected, f"headline launches {launches} != {expected}")
    check(tuple(out.shape) == (BATCH, 32, 32, 1), f"samples shape {tuple(out.shape)}")
    check(bool(torch.isfinite(out).all()), "headline samples not finite")
    check(out.min().item() >= 0.0 and out.max().item() <= 1.0, "samples outside [0, 1]")
    from xdiffusion_tpu_torch.sample import save_image_grid

    grid = os.path.join(OUT_DIR, "text", "samples.png")
    save_image_grid(out.float().cpu().numpy(), grid)
    reps = 2
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(reps):
        run(SEED + 2 + i)
    torch.cuda.synchronize()
    sps = BATCH * reps / (time.perf_counter() - t0)
    log(f"headline throughput: {sps:.2f} samples/s (50-step guided DDIM, batch {BATCH}, "
        f"bf16; grid in {grid})")

    x = torch.randn((2 * BATCH, 32, 32, 1), device="cuda")
    ctx = text_context(model, prompts, guided=True)
    with torch.inference_mode():
        for _ in range(3):
            model.predict_score(x, ctx)

        def forward():
            model.predict_score(x, ctx)

        fwd = profile_text(f"one guided headline forward (batch {2 * BATCH}, bf16)", forward,
                           "text_profile.txt")
    return launches, sps, fwd


def phase_text_card_vs_cpu():
    """fp32, batch 4, prompts "0" to "3": one forward, and 10 guided DDIM
    steps with the same weights and injected noise, card (kernels) against
    CPU (plain versions)."""
    from xdiffusion_tpu_torch.samplers.ddim import DDIMSampler

    n, steps = 4, 10
    prompts = digit_prompts(n)
    rng = np.random.default_rng(SEED + 3)
    x = torch.from_numpy(rng.standard_normal((n, 32, 32, 1)).astype(np.float32))
    init = torch.from_numpy(rng.standard_normal((n, 32, 32, 1)).astype(np.float32))
    t = torch.from_numpy(rng.uniform(0.05, 0.95, size=n).astype(np.float32))
    results = {}
    for device in ("cuda", "cpu"):
        model = build_model("float32", device, TEXT_CONFIG)
        ctx = {k: v.to(device) for k, v in
               model.preprocess_context({"text_prompts": prompts}).items()
               if isinstance(v, torch.Tensor)}
        ctx["timestep"] = t.to(device)
        ctx["logsnr_t"] = model.noise_scheduler().logsnr(t.to(device))
        with torch.inference_mode():
            fwd = model.predict_score(x.to(device), ctx).float().cpu()
        traj = model.sample(num_samples=n, num_sampling_steps=steps, sampler=DDIMSampler(),
                            initial_noise=init, classifier_free_guidance=1.0,
                            context={"text_prompts": prompts}).float().cpu()
        results[device] = fwd, traj
    err_f = rel_err(results["cuda"][0], results["cpu"][0])
    err_t = (results["cuda"][1] - results["cpu"][1]).abs().max().item()
    log(f"card vs CPU, headline fp32 batch {n}: forward max|diff| / max|out| = {err_f:.3e} "
        f"(tol 1e-4), {steps}-step guided DDIM max|diff| = {err_t:.3e} (tol 2e-3)")
    check(err_f <= 1e-4, f"headline forward card vs CPU: {err_f}")
    check(err_t <= 2e-3, f"headline trajectory card vs CPU: {err_t}")


def phase_text_training():
    """The headline in bf16 at batch 128 through train(): TRAIN_STEPS steps
    with prompts from the digits' labels, launches against the counts the
    code implies (and one GRID_STEPS-step unguided grid of NUM_SAMPLES at
    the end), every step's loss and grad_norm, steps/s over steps
    WARMUP_STEPS to RESUME_STEP - 1; then a profile of one step. Returns
    (launches, steps/s, the step's (wall, busy) ms)."""
    import shutil

    from xdiffusion_tpu_torch.optim import default_optimizer
    from xdiffusion_tpu_torch.train_step import create_train_state, make_train_step
    from xdiffusion_tpu_torch.training.image.train import train

    model = build_model("bfloat16", "cuda", TEXT_CONFIG)
    sites = main_path_sites(model, run=lambda: model.sample(
        num_samples=NUM_SAMPLES, num_sampling_steps=1,
        context={"text_prompts": digit_prompts(NUM_SAMPLES)}))
    per_step = per_call_counts(sites, training=True)
    per_forward = per_call_counts(sites)
    ctx = text_context(model, digit_prompts(TRAIN_BATCH), guided=False)
    del ctx["timestep"], ctx["logsnr_t"]
    state = create_train_state(model, default_optimizer().build(
        model.score_network().parameters()), seed=SEED)
    step = make_train_step(model)
    batch = {"images": torch.rand((TRAIN_BATCH, 32, 32, 1), device="cuda"), **ctx}
    for _ in range(3):
        step(state, batch)
    step_prof = profile_text(f"one headline training step (batch {TRAIN_BATCH}, bf16)",
                             lambda: step(state, batch), "text_train_profile.txt")
    del model, state, step, batch

    root = os.path.join(OUT_DIR, "text_train")
    shutil.rmtree(root, ignore_errors=True)
    config = flagship_config_file("bfloat16", root, TEXT_CONFIG)
    ks = reset_launches()
    t0 = time.perf_counter()
    out_dir = train(config, num_training_steps=TRAIN_STEPS, batch_size=TRAIN_BATCH,
                    save_and_sample_every_n=TRAIN_STEPS, num_samples=NUM_SAMPLES, seed=SEED,
                    device="cuda", log_every=1, output_path=os.path.join(root, "run"))
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {name: k.launches for name, k in ks.items()}
    grid_steps = GRID_STEPS
    expected = {name: TRAIN_STEPS * per_step.get(name, 0) + grid_steps * per_forward.get(name, 0)
                for name in ks}
    log(f"headline training ({TRAIN_STEPS} steps + a {grid_steps}-step grid of {NUM_SAMPLES}, "
        f"{run_s:.1f} s): launches {launches}, expected {expected} (per step {per_step}, per "
        f"sampling forward {per_forward})")
    check(launches == expected, f"headline training launches {launches} != {expected}")
    metrics = read_metrics(out_dir)
    check(sorted(metrics) == list(range(TRAIN_STEPS)), "metrics.jsonl misses steps")
    for i in range(TRAIN_STEPS):
        r = metrics[i]
        check(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]),
              f"headline step {i}: loss or grad_norm not finite")
    log("headline losses: " + " ".join(f"{metrics[i]['loss']:.4f}" for i in range(TRAIN_STEPS)))
    span = metrics[RESUME_STEP - 1]["time"] - metrics[WARMUP_STEPS - 1]["time"]
    sps = TIMED_STEPS / span
    log(f"headline training throughput: {sps:.3f} steps/s (steps {WARMUP_STEPS}-"
        f"{RESUME_STEP - 1}, batch {TRAIN_BATCH}, bf16, prompts embedded on the host each step)")
    for name in (f"checkpoints/{TRAIN_STEPS}.pt", f"sample-{TRAIN_STEPS}.png"):
        path = os.path.join(out_dir, name)
        check(os.path.isfile(path) and os.path.getsize(path) > 0, f"train wrote no {name}")
    return launches, sps, step_prof


def phase_text_companions():
    """Each of TEXT_COMPANIONS in bf16 with seeded random weights: the
    sampling CLI (TEXT_CLI_STEPS steps at batch TEXT_CLI_SAMPLES, prompts
    "0" to "9" and the config's guidance for a text-conditional config),
    launches against the counts the code implies, finite samples in [0, 1];
    then TEXT_TRAIN_STEPS training steps at batch TEXT_TRAIN_BATCH through
    the trainer's step (`make_train_step`, dropout and the guidance drop
    on), prompts from random digit labels through the config's
    preprocessors as the trainer makes them: finite losses, and each step's
    launches against the code's counts. (Phase 22 runs `train()` whole.)"""
    from xdiffusion_tpu_torch import sample as cli
    from xdiffusion_tpu_torch.datasets.mnist import convert_labels_to_prompts
    from xdiffusion_tpu_torch.optim import default_optimizer
    from xdiffusion_tpu_torch.train_step import create_train_state, make_train_step

    for name in TEXT_COMPANIONS:
        source = os.path.join(ROOT, "configs/image/mnist", name)
        out_dir = os.path.join(OUT_DIR, "text_configs", name[:-5])
        config = flagship_config_file("bfloat16", out_dir, source)
        model = build_model("bfloat16", "cuda", source)
        size = model.config().diffusion.score_network.params.input_spatial_size
        texted = any(type(p).__name__ != "IgnoreContextAdapter"
                     for p in model._context_preprocessors)
        guidance = model.classifier_free_guidance() if texted else None
        prompts = digit_prompts(TEXT_CLI_SAMPLES) if texted else []

        def one_step():
            return model.sample(num_samples=TEXT_CLI_SAMPLES, num_sampling_steps=1,
                                context={"text_prompts": prompts} if texted else {},
                                classifier_free_guidance=guidance)

        sites = main_path_sites(model, run=one_step)
        per_forward = per_call_counts(sites)
        calls = sorted(set(bsc_calls(one_step)))
        ckpt = os.path.join(out_dir, "random_weights.pt")
        torch.save(model.score_network().state_dict(), ckpt)
        args = ["--config_path", config, "--checkpoint", ckpt, "--num_samples",
                str(TEXT_CLI_SAMPLES), "--sampling_steps", str(TEXT_CLI_STEPS),
                "--output_path", out_dir, "--seed", str(SEED)]
        if texted:
            args += ["--text_prompts", ",".join(digit_prompts(10)), "--guidance", str(guidance)]
        ks = reset_launches()
        t0 = time.perf_counter()
        samples = cli.main(args)
        torch.cuda.synchronize()
        launches = {k: v.launches for k, v in ks.items()}
        expected = {k: TEXT_CLI_STEPS * per_forward.get(k, 0) for k in ks}
        log(f"{name} (bf16) through the sampling CLI, {TEXT_CLI_STEPS} steps at batch "
            f"{TEXT_CLI_SAMPLES}{f', guidance {guidance}' if texted else ''}: "
            f"{time.perf_counter() - t0:.2f} s, K1 sites {calls}, launches {launches}, "
            f"expected {expected}, samples mean {samples.float().mean().item():.4f}")
        check(launches == expected, f"{name}: launches {launches} != {expected}")
        check(tuple(samples.shape) == (TEXT_CLI_SAMPLES, size, size, 1), f"{name}: samples shape")
        check(bool(torch.isfinite(samples).all()), f"{name}: samples not finite")
        check(samples.min().item() >= 0.0 and samples.max().item() <= 1.0,
              f"{name}: samples outside [0, 1]")
        check(os.path.getsize(os.path.join(out_dir, "sample-step0.png")) > 0, f"{name}: no PNG")
        os.remove(ckpt)

        per_step = per_call_counts(sites, training=True)
        state = create_train_state(model, default_optimizer().build(
            model.score_network().parameters()), seed=SEED)
        train_step = make_train_step(model)
        losses = []
        t0 = time.perf_counter()
        for i in range(TEXT_TRAIN_STEPS):
            rng = np.random.default_rng((SEED, i))
            batch = {"images": torch.rand((TEXT_TRAIN_BATCH, size, size, 1), device="cuda")}
            if texted:
                labels = rng.integers(0, 10, size=TEXT_TRAIN_BATCH)
                ctx = model.preprocess_context(
                    {"text_prompts": convert_labels_to_prompts(labels, rng=rng)})
                batch.update({k: v.to("cuda") for k, v in ctx.items()
                              if isinstance(v, torch.Tensor)})
            ks = reset_launches()
            losses.append(train_step(state, batch)["loss"].item())
            launches = {k: v.launches for k, v in ks.items()}
            expected = {k: per_step.get(k, 0) for k in ks}
            check(launches == expected, f"{name} training step {i}: launches {launches} != "
                                        f"{expected}")
        log(f"{name} (bf16), {TEXT_TRAIN_STEPS} training steps at batch {TEXT_TRAIN_BATCH}: "
            f"{time.perf_counter() - t0:.2f} s, losses {[round(x, 4) for x in losses]}, "
            f"launches a step {per_step}")
        check(all(np.isfinite(losses)), f"{name}: training losses {losses}")
        del model, state, train_step


# ---- the PixArt family, learned sigma, the image datasets, the FID (24-29) --

PIXART_CONFIG = os.path.join(ROOT, "configs/image/mnist/pixart_alpha.yaml")
# Beside the headline, at full width: the class-conditional variant (no
# cross-attention), DyT norms, the deep WideFormer (hidden 768, 12 heads of
# 64, 20 blocks) and the learned-sigma UNet (fp32, cosine schedule).
PIXART_COMPANIONS = ("pixart_alpha_class_conditional.yaml", "pixart_alpha_dyt.yaml",
                     "wideformer_pixart_deep.yaml", "ddpm_unconditional_learned_sigma.yaml")
# The two image configs that train on the new datasets, through the CLI's
# --dataset_name.
DATASET_CONFIGS = (("configs/image/cifar10/ddpm_32x32_epsilon_discrete_clip.yaml", "image/cifar10"),
                   ("configs/image/moving_mnist/ddpm_32x32_v_continuous_clip.yaml",
                    "image/moving_mnist"))
# K1 sites as (B, Sq, Sk, C, heads) and K5/K6 sites as (B, H, Sq, Sk, D): the
# headline's self-attention and cross-attention to the 77 caption tokens at
# the guided sampling batch and in training (128), the companions' at the
# CLI's guided batch and in training (32), and the deep WideFormer's.
PIXART_K1_SITES = [(128, 16, 16, 384, 6), (32, 16, 16, 384, 6), (32, 16, 16, 768, 12)]
PIXART_FLASH_SITES = [(128, 6, 16, 77, 64), (32, 6, 16, 77, 64), (32, 12, 16, 77, 64)]
WIDEFORMER = os.path.join(ROOT, "configs/image/mnist/wideformer_pixart.yaml")


def pixart_counts(model, training: bool = False):
    """Launches per PixArt forward (or training step): K1 at every block's
    self-attention, K5 at its cross-attention where the config has a
    caption; K2 and K6 beside them in training."""
    blocks = model.score_network()._blocks
    cross = sum(1 for b in blocks if b.cross_attn is not None)
    counts = {"bsc_attention": len(blocks), "flash_attention": cross}
    if training:
        counts.update(bsc_attention_bwd=len(blocks), flash_attention_bwd=cross)
    return counts


def caption_operands(gen, b: int, h: int, sq: int, sk: int, d: int, dt):
    """K5's and K6's operands at a PixArt cross-attention site: q a head view
    of the (B, Sq, C) q projection, k and v of the two halves of the (B, Sk,
    2C) kv projection, as CrossAttention gives them; and a cotangent g."""
    q = heads_view(gen, b, sq, h, d, dt)
    kv = torch.randn((b, sk, 2 * h * d), generator=gen, device="cuda").to(dt)
    k, v = (t.reshape(b, sk, h, d).transpose(1, 2) for t in kv.chunk(2, -1))
    return q, k, v, heads_view(gen, b, sq, h, d, dt)


def one_key_floors(q, k, v, g, scale: float) -> dict:
    """K6's absolute floors for dq and dk at one key. There p = 1, o = v and
    ds = dp - delta, with dp = g . v and delta = g . o each summed over D in
    fp32: dq = dk = 0 exactly, and the kernel and the plain version are each
    left with the rounding of their two sums, in their own orders (the
    all-zero reference of phase 2's K2, which takes delta from p, not o).
    The floor on ds is 8 fp32 ulps of the largest row sum of |g v| (log2 D
    roundings of a pairwise sum over D = 256), carried through
    dq = scale ds k and dk = scale (sum over queries of ds q). A fault
    misses by the data's own scale, some 1e4 times more."""
    gv = (g.float() * v.float()).abs().sum(-1, keepdim=True)  # (B, H, Sq, 1)
    ds = 8 * 2.0 ** -24 * gv
    return {"dq": scale * (ds * k.float().abs().amax(-1, keepdim=True)).max().item(),
            "dk": scale * (ds * q.float().abs()).sum(-2).max().item()}


def check_caption_flash_sites(shapes, gen, operands=None):
    """K5 and K6 at each (B, H, Sq, Sk, D) of `shapes` (on `operands`, by
    default `caption_operands`) against their plain versions, fp32 and bf16,
    with phases 7's and 11's tolerances, each twice bit for bit, with the
    plan each takes. Returns {"K5": err, "K6": err}."""
    from xdiffusion_tpu_torch.ops import flash_attention as fa

    def tol(ref, dt):
        # fp32: sums in other orders: 1e-5 of the reference's scale. bf16:
        # both sides round p (ds) alike, the sums run in other orders: 2
        # bf16 ulps at the binade of the reference's largest magnitude.
        return (1e-5 * max(1.0, ref.float().abs().max().item()) if dt == torch.float32
                else bf16_tol(ref, 2))

    errs = {"K5": 0.0, "K6": 0.0}
    for b, h, sq, sk, d in shapes:
        scale = d ** -0.5
        for dt in (torch.float32, torch.bfloat16):
            q, k, v, g = (operands or caption_operands)(gen, b, h, sq, sk, d, dt)
            fwd = fa.flash_plan(b, h, sq, sk, d, dt)
            bwd = fa.flash_plan(b, h, sq, sk, d, dt, backward=True)
            tag = (f"B={b} H={h} Sq={sq} Sk={sk} D={d} {dt} ({fwd.variant}, "
                   f"{fwd.launches[0].rows} query rows a block; K6 dq "
                   f"{bwd.launches[0].rows} rows, dk/dv {bwd.launches[1].rows} keys, "
                   f"{bwd.splits} split(s) of {bwd.tiles_per_split} tiles)")
            o, lse = fa.flash_attention(q, k, v, scale)
            check(lse.shape == (b, h, sq, 1) and lse.is_contiguous()
                  and lse.dtype == torch.float32, f"K5 {tag}: lse {tuple(lse.shape)}")
            want_o, want_lse = fa.flash_attention_plain(q, k, v, scale)
            errs["K5"] = max(errs["K5"], compare(f"K5 o {tag}", o, want_o, tol(want_o, dt)))
            lse_err = rel_err(lse, want_lse)
            log(f"  lse: max|kernel-plain| / max|plain| = {lse_err:.3e} tol 1e-5")
            check(lse_err <= 1e-5, f"K5 {tag}: lse error {lse_err}")
            check_repeats(f"K5 {tag}", (o, lse), fa.flash_attention(q, k, v, scale))
            args = (q, k, v, o, lse, g, scale)
            got = fa.flash_attention_bwd(*args)
            check_repeats(f"K6 {tag}", got, fa.flash_attention_bwd(*args))
            floors = one_key_floors(q, k, v, g, scale) if sk == 1 else {}
            for name, x, y in zip(("dq", "dk", "dv"), got, fa.flash_attention_bwd_plain(*args)):
                t = max(tol(y, dt) if y.abs().max().item() > 0 else 0.0, floors.get(name, 0.0))
                errs["K6"] = max(errs["K6"], compare(f"K6 {name} {tag}", x, y, t))
            del q, k, v, g, o, lse, want_o, want_lse, got, args
    return errs


def phase_pixart_sites():
    """K1 and K2 at PIXART_K1_SITES (`check_bsc_sites`) and K5 and K6 at
    PIXART_FLASH_SITES against their plain versions, fp32 and bf16, with
    phases 7's and 11's tolerances; K5 and K6 twice bit for bit; the plan
    each takes. K5's q is a head view of the (B, 16, C) q projection, its k
    and v of the two halves of the (B, 77, 2C) kv projection, as
    CrossAttention gives them. Then K5's and K6's device time at the headline's cross-attention
    site (fp32, as shipped) and K1's and K2's at the deep WideFormer's
    (fp32), each beside SDPA's (its backward alone) and the bound, per call
    and per forward (training step). Returns {"K1"|"K2"|"K5"|"K6": record}."""
    from xdiffusion_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    errs = check_bsc_sites(PIXART_K1_SITES, gen)
    errs.update(check_caption_flash_sites(PIXART_FLASH_SITES, gen))

    out = {}
    b, h, sq, sk, d = PIXART_FLASH_SITES[0]
    q, k, v, g = caption_operands(gen, b, h, sq, sk, d, torch.float32)
    scale = d ** -0.5
    o, lse = fa.flash_attention(q, k, v, scale)
    args = (q, k, v, o, lse, g, scale)
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    sdpa_o = F.scaled_dot_product_attention(*leaves, scale=scale)
    flops, exps = 4 * b * h * sq * sk * d, b * h * sq * sk
    item = 4
    for kernel, fn, plain, lib, nbytes, kflops in (
            ("K5", lambda: fa.flash_attention(q, k, v, scale),
             lambda: fa.flash_attention_plain(q, k, v, scale),
             lambda: F.scaled_dot_product_attention(q, k, v, scale=scale),
             (2 * q.numel() + k.numel() + v.numel()) * item + lse.numel() * 4, flops),
            ("K6", lambda: fa.flash_attention_bwd(*args),
             lambda: fa.flash_attention_bwd_plain(*args),
             lambda: torch.autograd.grad(sdpa_o, leaves, g, retain_graph=True),
             (4 * q.numel() + 4 * k.numel()) * item + lse.numel() * 4, 10 * flops // 4)):
        k_ms, p_ms, l_ms = device_ms(fn), device_ms(plain), device_ms(lib)
        bd = flash_bounds(kflops, exps, nbytes, torch.float32)
        log(f"{kernel} at the PixArt cross-attention site B={b} H={h} Sq={sq} Sk={sk} D={d} "
            f"fp32, one call: {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
            f"SDPA{' backward' if kernel == 'K6' else ''} {l_ms:.4f} ms, bound "
            f"{bd['bound_ms']:.4f} ms ({bd['binds']}); x12 a "
            f"{'forward' if kernel == 'K5' else 'training step'}: {12 * k_ms:.4f} ms, SDPA "
            f"{12 * l_ms:.4f}, bound {12 * bd['bound_ms']:.4f}")
        out[kernel] = {"ms": 12 * k_ms, "plain_ms": 12 * p_ms, "library_ms": 12 * l_ms,
                       "bound_ms": 12 * bd["bound_ms"], "err": errs[kernel]}
    del q, k, v, g, o, lse, args, leaves, sdpa_o

    b, sq, _, c, heads = PIXART_K1_SITES[2]
    d = c // heads
    q, k, v = torch.randn((b, sq, 3 * c), generator=gen, device="cuda").chunk(3, -1)
    g = torch.randn((b, sq, c), generator=gen, device="cuda")
    qh, kh, vh = (t.reshape(b, sq, heads, d).transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    sdpa_o = F.scaled_dot_product_attention(qh, kh, vh)
    gh = g.reshape(b, sq, heads, d).transpose(1, 2).contiguous()
    for kernel, fn, plain, lib, nbytes, ops in (
            ("K1", lambda: fa.short_attention_bsc(q, k, v, heads, d ** -0.5),
             lambda: fa.short_attention_bsc_plain(q, k, v, heads, d ** -0.5),
             lambda: F.scaled_dot_product_attention(qh, kh, vh), 4 * b * sq * c * 4,
             4 * b * sq * sq * c),
            ("K2", lambda: fa.short_attention_bsc_bwd(q, k, v, g, heads, d ** -0.5),
             lambda: fa.short_attention_bsc_bwd_plain(q, k, v, g, heads, d ** -0.5),
             lambda: torch.autograd.grad(sdpa_o, (qh, kh, vh), gh, retain_graph=True),
             7 * b * sq * c * 4, 10 * b * sq * sq * c)):
        k_ms, p_ms, l_ms = device_ms(fn), device_ms(plain), device_ms(lib)
        bound = max(nbytes / PEAK_BYTES, ops / PEAK_FP32) * 1e3
        log(f"{kernel} at the deep WideFormer's site B={b} S={sq} C={c} heads={heads} fp32, one "
            f"call: {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
            f"SDPA{' backward' if kernel == 'K2' else ''} {l_ms:.4f} ms, bound {bound:.4f} ms; "
            f"x20 a {'forward' if kernel == 'K1' else 'training step'}: {20 * k_ms:.4f} ms, "
            f"SDPA {20 * l_ms:.4f}, bound {20 * bound:.4f}")
        out[kernel] = {"ms": 20 * k_ms, "plain_ms": 20 * p_ms, "library_ms": 20 * l_ms,
                       "bound_ms": 20 * bound, "err": errs[kernel]}
    return out


def pixart_context(model, prompts, guided: bool, t: int = 500):
    """One forward's context on the card: the prompts' T5 tokens (guided:
    with the empty prompts' after them, as the sampler runs them) and the
    step t."""
    ctx = {"text_tokens": model.preprocess_context({"text_prompts": prompts})["text_tokens"]}
    if guided:
        unc = model.preprocess_context(model.unconditional_context({"text_prompts": prompts}))
        ctx["text_tokens"] = torch.cat([ctx["text_tokens"], unc["text_tokens"]])
    ctx = {k: v.to("cuda") for k, v in ctx.items()}
    ctx["timestep"] = torch.full((ctx["text_tokens"].shape[0],), t, device="cuda")
    return ctx


def phase_pixart_sampling():
    """pixart_alpha as shipped (fp32), batch 64 with prompts "0" to "9" in
    turn, the config's guidance 1.0 (one forward on 128 samples a step) and
    dynamic thresholding, MAIN_STEPS ancestral steps through `sample()`: 12 K1
    and 12 K5 launches a forward and nothing else; the samples; a profile
    of one guided forward. Returns (launches, samples/s, the forward's
    (wall, busy) ms, the samples)."""
    from xdiffusion_tpu_torch.sample import save_image_grid

    model = build_model("float32", "cuda", PIXART_CONFIG)
    steps = MAIN_STEPS
    guidance = model.classifier_free_guidance()
    prompts = digit_prompts(DIT_BATCH)

    def run(num_steps, seed=SEED):
        g = torch.Generator(device="cuda").manual_seed(seed)
        return model.sample(num_samples=DIT_BATCH, context={"text_prompts": prompts},
                            classifier_free_guidance=guidance, num_sampling_steps=num_steps,
                            generator=g)

    run(3)  # warm-up
    torch.cuda.synchronize()
    ks = reset_launches()
    t0 = time.perf_counter()
    out = run(steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: k.launches for name, k in ks.items()}
    sps = DIT_BATCH / wall
    per_forward = pixart_counts(model)
    expected = {name: steps * per_forward.get(name, 0) for name in ks}
    log(f"PixArt main path: {steps}-step ancestral, batch {DIT_BATCH}, guidance {guidance} "
        f"(forwards of {2 * DIT_BATCH}), fp32: {wall:.2f} s, {sps:.3f} samples/s, launches "
        f"{launches}, expected {expected}")
    check(launches == expected, f"PixArt launches {launches} != {expected}")
    check(tuple(out.shape) == (DIT_BATCH, 32, 32, 1), f"PixArt samples shape {tuple(out.shape)}")
    check(bool(torch.isfinite(out).all()), "PixArt samples not finite")
    check(out.min().item() >= 0.0 and out.max().item() <= 1.0, "PixArt samples outside [0, 1]")
    log(f"PixArt samples: mean {out.mean().item():.4f} std {out.std().item():.4f}")
    save_image_grid(out.cpu().numpy(), os.path.join(OUT_DIR, "pixart", "samples.png"))

    x = torch.randn((2 * DIT_BATCH, 32, 32, 1), device="cuda")
    ctx = pixart_context(model, prompts, guided=True)
    with torch.inference_mode():
        for _ in range(3):
            model.predict_score(x, ctx)
        ks = reset_launches()
        fwd = profile_text(f"one guided PixArt forward ({2 * DIT_BATCH} samples, fp32, 16 tokens "
                           f"against 77 caption keys)", lambda: model.predict_score(x, ctx).sum().item(),
                           "pixart_profile.txt")
    one = {name: k.launches for name, k in ks.items() if k.launches}
    check(one == {k: v for k, v in per_forward.items() if v},
          f"one PixArt forward launched {one}")
    return launches, sps, fwd, out.cpu().numpy()


def phase_pixart_card_vs_cpu():
    """fp32, prompts "0" to "3": one forward and 10 guided ancestral steps
    (injected initial and per-step noise) at batch 4, then one loss and
    backward at batch 2 without drop-path or the guidance drop, card
    (K1, K5; K2, K6) against CPU (plain versions)."""
    from xdiffusion_tpu_torch.optim import global_norm

    n, steps = 4, 10
    prompts = digit_prompts(n)
    rng = np.random.default_rng(SEED + 7)
    x = torch.from_numpy(rng.standard_normal((n, 32, 32, 1)).astype(np.float32))
    init = torch.from_numpy(rng.standard_normal((n, 32, 32, 1)).astype(np.float32))
    noise = torch.from_numpy(rng.standard_normal((steps, n, 32, 32, 1)).astype(np.float32))
    t = torch.from_numpy(rng.integers(0, 1000, size=n))
    images = torch.from_numpy(rng.random((2, 32, 32, 1)).astype(np.float32))
    eps = torch.from_numpy(rng.standard_normal((2, 32, 32, 1)).astype(np.float32))
    config = no_drop_config(PIXART_CONFIG)
    results = {}
    for device in ("cuda", "cpu"):
        model = build_model("float32", device, config)
        tokens = model.preprocess_context({"text_prompts": prompts})["text_tokens"].to(device)
        with torch.inference_mode():
            fwd = model.predict_score(x.to(device), {"text_tokens": tokens,
                                                     "timestep": t.to(device)}).cpu()
        traj = model.sample(num_samples=n, num_sampling_steps=steps, initial_noise=init,
                            classifier_free_guidance=1.0,
                            context={"text_prompts": prompts, "sampling_noise": noise}).cpu()
        loss, _ = model.loss_on_batch(images.to(device), {"text_tokens": tokens[:2]},
                                      timesteps=t[:2].to(device), noise=eps.to(device),
                                      deterministic=True)
        loss.backward()
        grads = {k: p.grad.detach().cpu() for k, p in model.score_network().named_parameters()}
        results[device] = fwd, traj, loss.item(), global_norm(list(grads.values())).item(), grads
        del model
    (f_gpu, t_gpu, l_gpu, n_gpu, g_gpu), (f_cpu, t_cpu, l_cpu, n_cpu, g_cpu) = (
        results["cuda"], results["cpu"])
    err_f = rel_err(f_gpu, f_cpu)
    err_t = (t_gpu - t_cpu).abs().max().item()
    # fp32 on both sides with TF32 off on the card (K5 splits its products
    # into three TF32 ones); sums in other orders through 12 blocks. Each
    # gradient is held to 1e-3 of its largest magnitude, floored at 1e-3 of
    # the network's largest gradient, as phase 18 holds the DiT's.
    floor = 1e-3 * max(g.abs().max().item() for g in g_cpu.values())
    worst = max((rel_err(g_gpu[k], g_cpu[k], floor), k) for k in g_cpu)
    log(f"card vs CPU, PixArt fp32: forward (batch {n}) max|diff| / max|out| = {err_f:.3e} "
        f"(tol 1e-4); {steps}-step guided ancestral max|diff| = {err_t:.3e} (tol 2e-3); loss "
        f"(batch 2) {l_gpu:.7f} vs {l_cpu:.7f}, grad_norm {n_gpu:.6f} vs {n_cpu:.6f}, worst "
        f"gradient {worst[1]} at {worst[0]:.3e} (tol 1e-3)")
    check(err_f <= 1e-4, f"PixArt forward card vs CPU: {err_f}")
    check(err_t <= 2e-3, f"PixArt trajectory card vs CPU: {err_t}")
    check(abs(l_gpu - l_cpu) <= 1e-5 * abs(l_cpu), f"PixArt loss {l_gpu} vs {l_cpu}")
    check(abs(n_gpu - n_cpu) <= 1e-4 * abs(n_cpu), f"PixArt grad_norm {n_gpu} vs {n_cpu}")
    check(worst[0] <= 1e-3, f"PixArt gradient {worst[1]}: {worst[0]} > 1e-3")


def phase_pixart_training():
    """pixart_alpha (fp32) at batch 128 through train(): TRAIN_STEPS steps
    with prompts from the digits' labels through the network's host-side
    T5 tokens (surface forms drawn from (seed, step)), launches against the
    counts the code implies (and one GRID_STEPS-step unguided grid of
    NUM_SAMPLES at the end), every step's loss and grad_norm, steps/s over steps
    WARMUP_STEPS to RESUME_STEP - 1; a profile of one step. Returns
    (launches, steps/s, the step's (wall, busy) ms)."""
    import shutil

    from xdiffusion_tpu_torch.datasets.mnist import convert_labels_to_prompts
    from xdiffusion_tpu_torch.optim import default_optimizer
    from xdiffusion_tpu_torch.train_step import create_train_state, make_train_step
    from xdiffusion_tpu_torch.training.image.train import train

    model = build_model("float32", "cuda", PIXART_CONFIG)
    per_step, per_forward = pixart_counts(model, training=True), pixart_counts(model)
    labels = np.random.default_rng(SEED).integers(0, 10, size=TRAIN_BATCH)
    ctx = model.preprocess_context({"text_prompts": convert_labels_to_prompts(
        labels, rng=np.random.default_rng(SEED))})
    state = create_train_state(model, default_optimizer().build(
        model.score_network().parameters()), seed=SEED)
    step = make_train_step(model)
    batch = {"images": torch.rand((TRAIN_BATCH, 32, 32, 1), device="cuda"),
             "text_tokens": ctx["text_tokens"].to("cuda")}
    for _ in range(3):
        step(state, batch)
    ks = reset_launches()
    step_prof = profile_text(f"one PixArt training step (batch {TRAIN_BATCH}, fp32)",
                             lambda: step(state, batch)["loss"].item(), "pixart_train_profile.txt")
    one = {name: k.launches for name, k in ks.items() if k.launches}
    check(one == per_step, f"one PixArt training step launched {one}")
    del model, state, step, batch

    root = os.path.join(OUT_DIR, "pixart_train")
    shutil.rmtree(root, ignore_errors=True)
    ks = reset_launches()
    t0 = time.perf_counter()
    out_dir = train(PIXART_CONFIG, num_training_steps=TRAIN_STEPS, batch_size=TRAIN_BATCH,
                    save_and_sample_every_n=TRAIN_STEPS, num_samples=NUM_SAMPLES, seed=SEED,
                    device="cuda", log_every=1, output_path=os.path.join(root, "run"))
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {name: k.launches for name, k in ks.items()}
    grid_steps = GRID_STEPS
    expected = {name: TRAIN_STEPS * per_step.get(name, 0) + grid_steps * per_forward.get(name, 0)
                for name in ks}
    log(f"PixArt training ({TRAIN_STEPS} steps + a {grid_steps}-step grid of {NUM_SAMPLES}, "
        f"{run_s:.1f} s): launches {launches}, expected {expected}")
    check(launches == expected, f"PixArt training launches {launches} != {expected}")
    metrics = read_metrics(out_dir)
    check(sorted(metrics) == list(range(TRAIN_STEPS)), "PixArt metrics.jsonl misses steps")
    check(all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in metrics.values()),
          "PixArt loss or grad_norm not finite")
    log("PixArt losses: " + " ".join(f"{metrics[i]['loss']:.4f}" for i in range(TRAIN_STEPS)))
    span = metrics[RESUME_STEP - 1]["time"] - metrics[WARMUP_STEPS - 1]["time"]
    sps = TIMED_STEPS / span
    log(f"PixArt training throughput: {sps:.3f} steps/s (steps {WARMUP_STEPS}-{RESUME_STEP - 1}, "
        f"batch {TRAIN_BATCH}, fp32, prompts tokenized on the host each step)")
    for name in (f"checkpoints/{TRAIN_STEPS}.pt", f"sample-{TRAIN_STEPS}.png"):
        path = os.path.join(out_dir, name)
        check(os.path.isfile(path) and os.path.getsize(path) > 0, f"PixArt train wrote no {name}")
    return launches, sps, step_prof


def phase_pixart_companions():
    """Each of PIXART_COMPANIONS (fp32) with seeded random weights: the
    sampling CLI (TEXT_CLI_STEPS steps at batch TEXT_CLI_SAMPLES with the
    config's guidance, prompts "0" to "9" or classes 0-9), launches against
    the code's counts, finite samples in [0, 1]; then TEXT_TRAIN_STEPS
    steps at batch TEXT_TRAIN_BATCH through the trainer's step (drop-path,
    dropout and the guidance drop on), each step's launches against the
    code's counts. Then each of DATASET_CONFIGS trains 3 steps through the
    training CLI on its dataset (wideformer_pixart.yaml, head dim 256, runs
    in phases 35-38). Returns K1's and K2's launches in the deep
    WideFormer's CLI run and training steps."""
    from xdiffusion_tpu_torch import sample as cli
    from xdiffusion_tpu_torch import train as train_cli
    from xdiffusion_tpu_torch.datasets.mnist import convert_labels_to_prompts
    from xdiffusion_tpu_torch.optim import default_optimizer
    from xdiffusion_tpu_torch.train_step import create_train_state, make_train_step
    from xdiffusion_tpu_torch.training.common import is_text_conditional

    wide = {}
    for name in PIXART_COMPANIONS:
        source = os.path.join(ROOT, "configs/image/mnist", name)
        out_dir = os.path.join(OUT_DIR, "pixart_configs", name[:-5])
        os.makedirs(out_dir, exist_ok=True)
        model = build_model("float32", "cuda", source)
        sn = model.config().diffusion.score_network.params
        texted = is_text_conditional(model)
        classed = bool(sn.get("is_class_conditional", False))
        guidance = model.classifier_free_guidance()
        prompts = digit_prompts(TEXT_CLI_SAMPLES) if texted else []

        def one_step():
            ctx = {"text_prompts": prompts} if texted else {}
            if classed:
                ctx["classes"] = torch.arange(TEXT_CLI_SAMPLES, device="cuda") % 10
            return model.sample(num_samples=TEXT_CLI_SAMPLES, num_sampling_steps=1,
                                context=ctx, classifier_free_guidance=guidance)

        if "hidden_size" in sn:
            per_forward, per_step = pixart_counts(model), pixart_counts(model, training=True)
        else:
            sites = main_path_sites(model, run=one_step)
            per_forward, per_step = per_call_counts(sites), per_call_counts(sites, training=True)
        ckpt = os.path.join(out_dir, "random_weights.pt")
        torch.save(model.score_network().state_dict(), ckpt)
        args = ["--config_path", source, "--checkpoint", ckpt, "--num_samples",
                str(TEXT_CLI_SAMPLES), "--sampling_steps", str(TEXT_CLI_STEPS), "--guidance",
                str(guidance), "--output_path", out_dir, "--seed", str(SEED)]
        if texted:
            args += ["--text_prompts", ",".join(digit_prompts(10))]
        ks = reset_launches()
        t0 = time.perf_counter()
        samples = cli.main(args)
        torch.cuda.synchronize()
        launches = {k: v.launches for k, v in ks.items()}
        expected = {k: TEXT_CLI_STEPS * per_forward.get(k, 0) for k in ks}
        log(f"{name} (fp32) through the sampling CLI, {TEXT_CLI_STEPS} steps at batch "
            f"{TEXT_CLI_SAMPLES}, guidance {guidance}: {time.perf_counter() - t0:.2f} s, "
            f"launches {launches}, expected {expected}, samples mean "
            f"{samples.float().mean().item():.4f}")
        check(launches == expected, f"{name}: launches {launches} != {expected}")
        check(tuple(samples.shape) == (TEXT_CLI_SAMPLES, 32, 32, 1), f"{name}: samples shape")
        check(bool(torch.isfinite(samples).all()), f"{name}: samples not finite")
        check(samples.min().item() >= 0.0 and samples.max().item() <= 1.0,
              f"{name}: samples outside [0, 1]")
        check(os.path.getsize(os.path.join(out_dir, "sample-step0.png")) > 0, f"{name}: no PNG")
        os.remove(ckpt)
        if name.startswith("wideformer"):
            wide["bsc_attention"] = launches["bsc_attention"]

        state = create_train_state(model, default_optimizer().build(
            model.score_network().parameters()), seed=SEED)
        train_step = make_train_step(model)
        records = []
        t0 = time.perf_counter()
        for i in range(TEXT_TRAIN_STEPS):
            rng = np.random.default_rng((SEED, i))
            labels = rng.integers(0, 10, size=TEXT_TRAIN_BATCH)
            batch = {"images": torch.rand((TEXT_TRAIN_BATCH, 32, 32, 1), device="cuda")}
            if texted:
                ctx = model.preprocess_context(
                    {"text_prompts": convert_labels_to_prompts(labels, rng=rng)})
                batch.update({k: v.to("cuda") for k, v in ctx.items()
                              if isinstance(v, torch.Tensor)})
            if classed:
                batch["classes"] = torch.from_numpy(labels).to("cuda")
            ks = reset_launches()
            m = train_step(state, batch)
            records.append((m["loss"].item(), m["vb_loss"].item()))
            launches = {k: v.launches for k, v in ks.items()}
            expected = {k: per_step.get(k, 0) for k in ks}
            check(launches == expected, f"{name} training step {i}: launches {launches} != "
                                        f"{expected}")
        log(f"{name} (fp32), {TEXT_TRAIN_STEPS} training steps at batch {TEXT_TRAIN_BATCH}: "
            f"{time.perf_counter() - t0:.2f} s, (loss, vb_loss) "
            f"{[(round(a, 4), round(b, 6)) for a, b in records]}, launches a step {per_step}")
        check(bool(np.isfinite(records).all()), f"{name}: training losses {records}")
        if model.is_learned_sigma():
            check(all(vb > 0 for _, vb in records), f"{name}: the vb term is not positive")
        if name.startswith("wideformer"):
            wide["bsc_attention_bwd"] = TEXT_TRAIN_STEPS * per_step["bsc_attention_bwd"]
        del model, state, train_step

    for rel, dataset in DATASET_CONFIGS:
        out = os.path.join(OUT_DIR, "datasets")
        t0 = time.perf_counter()
        run_dir = train_cli.main(["--config_path", os.path.join(ROOT, rel), "--dataset_name",
                                  dataset, "--num_training_steps", "3", "--batch_size",
                                  str(TEXT_TRAIN_BATCH), "--num_samples", "4", "--output_path",
                                  out, "--seed", str(SEED)])
        metrics = read_metrics(run_dir)
        log(f"{rel} on {dataset} through the training CLI, 3 steps at batch "
            f"{TEXT_TRAIN_BATCH}: {time.perf_counter() - t0:.2f} s (its end grid included), "
            f"losses {[round(metrics[i]['loss'], 4) for i in sorted(metrics)]}")
        # The CLI logs every 50 steps and the last: steps 0 and 2.
        check(sorted(metrics) == [0, 2] and all(np.isfinite(r["loss"])
                                                for r in metrics.values()),
              f"{dataset}: metrics {metrics}")
        check(os.path.getsize(os.path.join(run_dir, "sample-3.png")) > 0, f"{dataset}: no grid")
    return wide


def phase_fid(samples: np.ndarray, model):
    """The LeNet-feature FID on the card with the extractor `model` (phase
    76's measure_fid trained it 500 steps on its real synthetic digits at
    32x32): the real-against-real floor (1,000 test digits against 1,000
    other training digits), noise's FID and the PixArt headline's 64
    samples' (random weights: no threshold but finite)."""
    from xdiffusion_tpu_torch.config import load_yaml
    from xdiffusion_tpu_torch.datasets import load_dataset
    from xdiffusion_tpu_torch.eval.fid import compute_fid

    # The flagship's config: the run's cached digits at 32x32 (`cached_datasets`).
    train_set, test_set = (load_dataset("image/mnist", load_yaml(CONFIG), split)[0]
                           for split in ("train", "test"))
    check(next(model.parameters()).is_cuda, "the FID extractor is not on the card")
    real = test_set.images[:1000].astype(np.float32) / 255.0
    other = train_set.images[50000:51000].astype(np.float32) / 255.0
    noise = np.random.default_rng(SEED).random(real.shape).astype(np.float32)
    floor = compute_fid(real, other, extractor=model)
    noise_fid = compute_fid(real, noise, extractor=model)
    sample_fid = compute_fid(real, samples, extractor=model)
    log(f"FID (LeNet features, synthetic digits{', real' if not train_set.synthetic else ''}, "
        f"measure_fid's extractor): real-against-real floor {floor:.4f}, noise {noise_fid:.4f}, the PixArt headline's "
        f"{samples.shape[0]} samples (random weights) {sample_fid:.4f}")
    check(all(np.isfinite([floor, noise_fid, sample_fid])), "an FID is not finite")
    check(floor < noise_fid, f"the real floor {floor} is not below noise's {noise_fid}")
    return floor, sample_fid


EDM_CONFIG = os.path.join(ROOT, "configs/image/mnist/edm.yaml")
# The SongUNet's attention sites, one head of C = 256 (B, Sq, Sk, C, heads):
# 256 tokens (the 16x16 maps: five a forward) and 64 (the 8x8 decoder entry:
# one), at the sampling batch and the training batch; and ragged shapes.
EDM_SITES = [(BATCH, 256, 256, 256, 1), (BATCH, 64, 64, 256, 1),
             (TRAIN_BATCH, 256, 256, 256, 1), (TRAIN_BATCH, 64, 64, 256, 1)]
EDM_RAGGED = [(3, 17, 17, 256, 1), (2, 100, 37, 256, 1), (3, 513, 129, 256, 1),
              (128, 16, 16, 2048, 8)]
# The companions through the sampling CLI (the 512- and 1000-step configs
# run EDM_CLI_STEPS steps: 50 until the video UNets' phases came) and the
# trainer's step.
EDM_COMPANIONS = ("edm_ddpmpp.yaml", "edm_ncsnpp.yaml", "edm_adm.yaml",
                  "score_sde_vpsde_continuous.yaml", "score_sde_vpsde_discrete.yaml",
                  "score_sde_subvpsde.yaml")
EDM_CLI_STEPS, EDM_TRAIN_STEPS = 10, 6  # training 10 until phases 72-75 came
EDM_HEUN_STEPS = 18


def build_process(path: str, device: str = "cuda"):
    """The process a config names (build_model), seeded random weights."""
    from xdiffusion_tpu_torch.config import load_yaml
    from xdiffusion_tpu_torch.training.image.train import build_model as build
    from xdiffusion_tpu_torch.weights import randomize_

    torch.manual_seed(SEED)  # the Fourier embedding's frequencies
    model = build(load_yaml(path), device=device)
    randomize_(model.score_network(), SEED)
    return model


def edm_counts(model, training: bool = False):
    """Launches per EDM forward (or training step) as the blocks call the
    kernels: K1 at each attention block (K2 beside it in training), K3 at
    norm0, at norm1 where it is not the adaptive scale-shift (plain, as in
    the JAX package), at norm2 of an attention block, and at out_norm."""
    from xdiffusion_tpu_torch.score_networks.edm import UNetBlockEDM

    blocks = [m for m in model.score_network().modules() if isinstance(m, UNetBlockEDM)]
    attn = sum(b.attention for b in blocks)
    counts = {"bsc_attention": attn,
              "group_norm_silu": 1 + sum(1 + (not b.adaptive_scale) + b.attention
                                         for b in blocks)}
    if training:
        counts["bsc_attention_bwd"] = attn
    return counts


def edm_k3_sites():
    """K3 at the GroupNorm sites of edm.yaml's sampling forward (batch 64)
    and training step (batch 128), and of each of EDM_COMPANIONS' forward
    and training step at the batches phase 34 runs them (TEXT_CLI_SAMPLES,
    TEXT_TRAIN_BATCH), read by hooks on the modules (`main_path_sites`) with
    their eps (1e-6 in the Song blocks): against its plain version in fp32
    (the configs' dtype) and bf16 through `k3_compare`. Returns the largest
    fp32 error."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 32)
    found = {}
    for name, b_fwd, b_train in (("edm.yaml", BATCH, TRAIN_BATCH),
                                 *((n, TEXT_CLI_SAMPLES, TEXT_TRAIN_BATCH)
                                   for n in EDM_COMPANIONS)):
        model = build_process(os.path.join(ROOT, "configs/image/mnist", name))
        for b, train in ((b_fwd, False), (b_train, True)):
            x = torch.rand((b, 32, 32, 1), device="cuda")
            if train:
                run = lambda: model.loss_on_batch(x, {}, generator=gen)  # noqa: E731
            elif hasattr(model, "predict_score"):
                run = lambda: model.predict_score(  # noqa: E731
                    x, torch.full((b,), 0.5, device="cuda"))
            else:
                run = lambda: model.score_network()(x, 2.0)  # noqa: E731
            with torch.set_grad_enabled(train):
                for site in main_path_sites(model, run=run)["group_norm_silu"]:
                    found.setdefault(site, f"{name} {'step' if train else 'forward'} B={b}")
        del model
    seen, worst = set(), 0.0
    for site, label in found.items():
        _, _, _, errs = k3_compare(label, site, gen, seen)
        worst = max(worst, errs[torch.float32])
    log(f"K3 at the EDM and score-SDE configs' {len(found)} distinct GroupNorm sites: plans run "
        f"{sorted(seen)}, largest fp32 error {worst:.3e}")
    return worst


def phase_edm_sites(logs):
    """K1 and K2 at head dim 256 (the wide variant, `bsc_plan`): ptxas's
    registers and spills of its kernels; K1 and K2 at EDM_SITES and
    EDM_RAGGED against their plain versions in fp32 and bf16 with phase 2's
    tolerances (`check_bsc_sites`), each twice bit for bit; then their device
    time in fp32 (edm.yaml's dtype) per sampling forward (K1, batch 64) and
    per training step (K2, batch 128), five sites at 256 tokens and one at
    64, beside the plain version's, SDPA's on (B, 1, S, 256) (its backward
    alone for K2) and the bounds of `flash_bounds`: the fp32 products as
    three TF32 products on the tensor cores (the fastest fp32-accurate rate
    the port uses, K5/K6's) hold the kernel, the CUDA cores' time is logged
    beside it. K3 at the EDM configs' sites (`edm_k3_sites`). Returns
    {"K1"|"K2"|"K3": record}."""
    from xdiffusion_tpu_torch.ops import flash_attention as fa

    for name in ("bsc_attention", "bsc_attention_bwd"):
        ptxas_summary(f"{name} (head dim 256)", logs.get(name, ""), only="wide_")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 30)
    errs = check_bsc_sites(EDM_SITES + EDM_RAGGED, gen)
    for b, s, _, c, heads in EDM_SITES:
        for dt in (torch.float32, torch.bfloat16):
            plan = fa.bsc_plan(b, s, s, heads, c // heads, dt)
            bwd = fa.bsc_plan(b, s, s, heads, c // heads, dt, backward=True)
            log(f"  wide plan B={b} S={s} {dt}: K1 {plan.slices_per_block} warps, grid "
                f"{plan.launches[0].grid}, {plan.launches[0].smem} B; K2 dq "
                f"{bwd.launches[0].grid} {bwd.launches[0].smem} B, dk/dv "
                f"{bwd.launches[1].grid} {bwd.launches[1].smem} B")
    out = {"K3": {"err": edm_k3_sites()}}
    for kernel, b in (("K1", BATCH), ("K2", TRAIN_BATCH)):
        rec = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
               "bytes_ms": 0.0, "ops_ms": 0.0, "cuda_core_ms": 0.0, "err": errs[kernel]}
        for s, n in ((256, 5), (64, 1)):
            c = 256
            q, k, v = torch.randn((b, s, 3 * c), generator=gen, device="cuda").chunk(3, -1)
            g = torch.randn((b, s, c), generator=gen, device="cuda")
            heads_last = [t.reshape(b, s, 1, c).transpose(1, 2).contiguous().requires_grad_()
                          for t in (q, k, v)]
            if kernel == "K1":
                fn = lambda: fa.short_attention_bsc(q, k, v, 1, c ** -0.5)  # noqa: E731
                plain = lambda: fa.short_attention_bsc_plain(q, k, v, 1, c ** -0.5)  # noqa: E731
                lib = lambda: F.scaled_dot_product_attention(*heads_last)  # noqa: E731
                nbytes, ops = 4 * b * s * c * 4, 4 * b * s * s * c
            else:
                sdpa_o = F.scaled_dot_product_attention(*heads_last)
                gh = g.reshape(b, s, 1, c).transpose(1, 2).contiguous()
                fn = lambda: fa.short_attention_bsc_bwd(q, k, v, g, 1, c ** -0.5)  # noqa: E731
                plain = lambda: fa.short_attention_bsc_bwd_plain(  # noqa: E731
                    q, k, v, g, 1, c ** -0.5)
                lib = lambda: torch.autograd.grad(  # noqa: E731
                    sdpa_o, heads_last, gh, retain_graph=True)
                nbytes, ops = 7 * b * s * c * 4, 10 * b * s * s * c
            k_ms, p_ms, l_ms = device_ms(fn), device_ms(plain), device_ms(lib)
            # One exponential a score (K2 recomputes P once).
            bd = flash_bounds(ops, b * s * s, nbytes, torch.float32)
            log(f"{kernel} at the SongUNet site B={b} S={s} C={c} 1 head fp32, one call: "
                f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, SDPA{' backward' if kernel == 'K2' else ''} "
                f"{l_ms:.4f} ms, bound {bd['bound_ms']:.4f} ms ({bd['binds']}; bytes "
                f"{bd['bytes_ms']:.4f}, exp {bd['exp_ms']:.4f}, 3 TF32 products "
                f"{bd['tf32x3_ms']:.4f}, fp32 CUDA cores {bd['cuda_core_ms']:.4f}); "
                f"x{n} a {'forward' if kernel == 'K1' else 'training step'}")
            for key in ("bound_ms", "bytes_ms", "ops_ms", "cuda_core_ms"):
                rec[key] += n * bd[key]
            for key, val in (("ms", k_ms), ("plain_ms", p_ms), ("library_ms", l_ms)):
                rec[key] += n * val
        rec["bound_by"] = "bytes" if rec["bytes_ms"] >= rec["ops_ms"] else "operations"
        per = "sampling forward (batch 64)" if kernel == "K1" else "training step (batch 128)"
        log(f"{kernel} at head dim 256 per {per}: {rec['ms']:.4f} ms, plain "
            f"{rec['plain_ms']:.4f}, SDPA {rec['library_ms']:.4f}, bound {rec['bound_ms']:.4f} "
            f"(fp32 products as 3 TF32 products at {PEAK_TF32 / 3e12:.1f} TFLOP/s; on the fp32 "
            f"CUDA cores at {PEAK_FP32 / 1e12:.0f} TFLOP/s {rec['cuda_core_ms']:.4f})")
        out[kernel] = rec
    return out


def phase_edm_sampling():
    """edm.yaml as shipped (fp32: a SongUNet of 56M parameters, EDM
    preconditioning) with seeded random weights: its 18-step stochastic Heun
    sampler at batch 64 through `sample()`, 35 network evaluations (the
    last step takes no correction): the launches against the code's counts
    (6 K1 and 73 K3 a forward: 210 K1), finite samples in [0, 1] to
    output/chip_smoke/edm/samples.png, and a profile of one forward
    (output/chip_smoke/edm_profile.txt). Returns (launches, samples/s, the
    forward's (wall, busy) ms)."""
    from xdiffusion_tpu_torch.sample import save_image_grid
    from xdiffusion_tpu_torch.samplers.edm import StochasticSampler

    model = build_process(EDM_CONFIG)
    per_forward = edm_counts(model)
    evals = 2 * EDM_HEUN_STEPS - 1
    model.sample(num_samples=BATCH, sampler=StochasticSampler(num_steps=2))  # warm-up
    torch.cuda.synchronize()
    ks = reset_launches()
    t0 = time.perf_counter()
    out = model.sample(num_samples=BATCH,
                       generator=torch.Generator(device="cuda").manual_seed(SEED))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: k.launches for name, k in ks.items()}
    expected = {name: evals * per_forward.get(name, 0) for name in ks}
    sps = BATCH / wall
    log(f"EDM main path: edm.yaml (fp32), {EDM_HEUN_STEPS}-step stochastic Heun at batch {BATCH} "
        f"({evals} evaluations): {wall:.2f} s, {sps:.3f} samples/s, launches {launches}, "
        f"expected {expected}")
    check(launches == expected, f"EDM launches {launches} != {expected}")
    check(launches["bsc_attention"] == 210, f"EDM K1 launches {launches['bsc_attention']} != 210")
    check(tuple(out.shape) == (BATCH, 32, 32, 1), f"EDM samples shape {tuple(out.shape)}")
    check(bool(torch.isfinite(out).all()), "EDM samples not finite")
    check(out.min().item() >= 0.0 and out.max().item() <= 1.0, "EDM samples outside [0, 1]")
    log(f"EDM samples: mean {out.mean().item():.4f} std {out.std().item():.4f}")
    save_image_grid(out.cpu().numpy(), os.path.join(OUT_DIR, "edm", "samples.png"))

    net = model.score_network()
    x = torch.randn((BATCH, 32, 32, 1), device="cuda")
    with torch.inference_mode():
        for _ in range(3):
            net(x, 2.0)
        ks = reset_launches()
        fwd = profile_text(f"one EDM forward (edm.yaml, batch {BATCH}, fp32)",
                           lambda: net(x, 2.0).sum().item(), "edm_profile.txt")
    one = {name: k.launches for name, k in ks.items() if k.launches}
    check(one == per_forward, f"one EDM forward launched {one}, expected {per_forward}")
    return launches, sps, fwd


def phase_edm_card_vs_cpu():
    """edm.yaml (fp32, full width, the same seeded weights) card against CPU
    at batch 2: the preconditioned forward at sigma 0.05 and 5, 3 steps of
    the stochastic Heun sampler (5 evaluations) from the same latents with
    injected per-step draws, and one loss and backward with injected sigma
    and noise, dropout off (the loss, the gradient norm, every gradient)."""
    from xdiffusion_tpu_torch.optim import global_norm
    from xdiffusion_tpu_torch.samplers.edm import StochasticSampler

    n = 2
    rng = np.random.default_rng(SEED + 31)
    x = torch.from_numpy(2.0 * rng.standard_normal((n, 32, 32, 1)).astype(np.float32))
    sigma = torch.tensor([0.05, 5.0])
    latents = torch.from_numpy(rng.standard_normal((n, 32, 32, 1)).astype(np.float32))
    noise = torch.from_numpy(rng.standard_normal((3, n, 32, 32, 1)).astype(np.float32))
    images = torch.from_numpy(rng.random((n, 32, 32, 1)).astype(np.float32))
    unit = torch.from_numpy(rng.standard_normal((n, 32, 32, 1)).astype(np.float32))
    results = {}
    for device in ("cuda", "cpu"):
        model = build_process(EDM_CONFIG, device)
        net = model.score_network()
        with torch.inference_mode():
            fwd = net(x.to(device), sigma.to(device)).cpu()
        traj = model.sample(num_samples=n, sampler=StochasticSampler(num_steps=3),
                            initial_noise=latents,
                            context={"sampling_noise": noise.to(device)}).cpu()
        loss, _ = model.loss_on_batch(images.to(device), {}, sigma=sigma.to(device),
                                      noise=unit.to(device), deterministic=True)
        loss.backward()
        grads = {k: p.grad.detach().cpu() for k, p in net.named_parameters()}
        results[device] = fwd, traj, loss.item(), global_norm(list(grads.values())).item(), grads
        del model, net
    (f_gpu, t_gpu, l_gpu, n_gpu, g_gpu), (f_cpu, t_cpu, l_cpu, n_cpu, g_cpu) = (
        results["cuda"], results["cpu"])
    err_f = rel_err(f_gpu, f_cpu)
    err_t = (t_gpu - t_cpu).abs().max().item()
    # fp32 on both sides with TF32 off: sums in other orders through 33
    # blocks (K1 and K3 on the card, their plain versions on the CPU).
    floor = 1e-3 * max(g.abs().max().item() for g in g_cpu.values())
    worst = max((rel_err(g_gpu[k], g_cpu[k], floor), k) for k in g_cpu)
    log(f"card vs CPU, edm.yaml fp32: forward (batch {n}) max|diff| / max|out| = {err_f:.3e} "
        f"(tol 1e-4); 3-step Heun max|diff| = {err_t:.3e} (tol 2e-3); loss {l_gpu:.7f} vs "
        f"{l_cpu:.7f}, grad_norm {n_gpu:.6f} vs {n_cpu:.6f}, worst gradient {worst[1]} at "
        f"{worst[0]:.3e} (tol 1e-3)")
    check(err_f <= 1e-4, f"EDM forward card vs CPU: {err_f}")
    check(err_t <= 2e-3, f"EDM trajectory card vs CPU: {err_t}")
    check(abs(l_gpu - l_cpu) <= 1e-5 * abs(l_cpu), f"EDM loss {l_gpu} vs {l_cpu}")
    check(abs(n_gpu - n_cpu) <= 1e-4 * abs(n_cpu), f"EDM grad_norm {n_gpu} vs {n_cpu}")
    check(worst[0] <= 1e-3, f"EDM gradient {worst[1]}: {worst[0]} > 1e-3")


def phase_edm_training():
    """edm.yaml (fp32) at batch 128: a profile of one training step
    (output/chip_smoke/edm_train_profile.txt) with its launches, then
    EDM_TRAIN_STEPS steps through `train()` on the synthetic digits: every
    step's loss and grad_norm, steps/s over steps 2-9, launches against the
    code's counts (6 K1, 6 K2 and 73 K3 a step, and the end grid's 35
    forwards), the checkpoint and the grid. Returns (launches, steps/s, the
    step's (wall, busy) ms, the run's directory: the consistency phase's
    teacher)."""
    import shutil

    from xdiffusion_tpu_torch.optim import default_optimizer
    from xdiffusion_tpu_torch.train_step import create_train_state, make_train_step
    from xdiffusion_tpu_torch.training.image.train import train

    model = build_process(EDM_CONFIG)
    per_step, per_forward = edm_counts(model, training=True), edm_counts(model)
    state = create_train_state(model, default_optimizer().build(
        model.score_network().parameters()), seed=SEED)
    step = make_train_step(model)
    batch = {"images": torch.rand((TRAIN_BATCH, 32, 32, 1), device="cuda")}
    for _ in range(2):
        step(state, batch)
    ks = reset_launches()
    step_prof = profile_text(f"one EDM training step (edm.yaml, batch {TRAIN_BATCH}, fp32)",
                             lambda: step(state, batch)["loss"].item(), "edm_train_profile.txt")
    one = {name: k.launches for name, k in ks.items() if k.launches}
    check(one == per_step, f"one EDM training step launched {one}, expected {per_step}")
    del model, state, step, batch

    root = os.path.join(OUT_DIR, "edm_train")
    shutil.rmtree(root, ignore_errors=True)
    ks = reset_launches()
    t0 = time.perf_counter()
    out_dir = train(EDM_CONFIG, num_training_steps=EDM_TRAIN_STEPS, batch_size=TRAIN_BATCH,
                    save_and_sample_every_n=EDM_TRAIN_STEPS, num_samples=NUM_SAMPLES, seed=SEED,
                    device="cuda", log_every=1, output_path=os.path.join(root, "run"))
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {name: k.launches for name, k in ks.items()}
    evals = 2 * EDM_HEUN_STEPS - 1
    expected = {name: EDM_TRAIN_STEPS * per_step.get(name, 0) + evals * per_forward.get(name, 0)
                for name in ks}
    log(f"EDM training ({EDM_TRAIN_STEPS} steps + a {EDM_HEUN_STEPS}-step grid of {NUM_SAMPLES}, "
        f"{run_s:.1f} s): launches {launches}, expected {expected}")
    check(launches == expected, f"EDM training launches {launches} != {expected}")
    metrics = read_metrics(out_dir)
    check(sorted(metrics) == list(range(EDM_TRAIN_STEPS)), "EDM metrics.jsonl misses steps")
    check(all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in metrics.values()),
          "EDM loss or grad_norm not finite")
    log("EDM losses: " + " ".join(f"{metrics[i]['loss']:.4f}" for i in range(EDM_TRAIN_STEPS)))
    sps = (EDM_TRAIN_STEPS - 2) / (metrics[EDM_TRAIN_STEPS - 1]["time"] - metrics[1]["time"])
    log(f"EDM training throughput: {sps:.3f} steps/s (steps 2-{EDM_TRAIN_STEPS - 1}, batch "
        f"{TRAIN_BATCH}, fp32)")
    for name in (f"checkpoints/{EDM_TRAIN_STEPS}.pt", f"sample-{EDM_TRAIN_STEPS}.png"):
        path = os.path.join(out_dir, name)
        check(os.path.isfile(path) and os.path.getsize(path) > 0, f"EDM train wrote no {name}")
    return launches, sps, step_prof, out_dir


def _edm_cli_config(source: str, directory: str) -> str:
    """An EDM companion's config with its sampler cut to EDM_CLI_STEPS steps
    (the process samples the sampler's steps, as in the JAX package)."""
    import yaml

    with open(source) as f:
        cfg = yaml.safe_load(f)
    cfg["diffusion"]["sampling"]["params"]["num_steps"] = EDM_CLI_STEPS
    path = os.path.join(directory, os.path.basename(source))
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def phase_edm_companions():
    """Each of EDM_COMPANIONS (fp32, full width, seeded random weights)
    through the sampling CLI at batch TEXT_CLI_SAMPLES: the EDM configs at
    EDM_CLI_STEPS Euler steps (their 512 cut), the score-SDE configs at
    `--sampling_steps` EDM_CLI_STEPS (of 1000) predictor-corrector steps;
    launches against the code's counts, finite samples in [0, 1]; then
    TEXT_TRAIN_STEPS steps at batch TEXT_TRAIN_BATCH through the trainer's
    step, each step's launches against the code's counts. Returns K1's
    launches over the companions' CLI runs and K2's over their steps."""
    from xdiffusion_tpu_torch import sample as cli
    from xdiffusion_tpu_torch.diffusion.edm import GaussianDiffusion_EDM
    from xdiffusion_tpu_torch.optim import default_optimizer
    from xdiffusion_tpu_torch.train_step import create_train_state, make_train_step

    total = {"bsc_attention": 0, "bsc_attention_bwd": 0}
    for name in EDM_COMPANIONS:
        source = os.path.join(ROOT, "configs/image/mnist", name)
        out_dir = os.path.join(OUT_DIR, "edm_configs", name[:-5])
        os.makedirs(out_dir, exist_ok=True)
        model = build_process(source)
        if isinstance(model, GaussianDiffusion_EDM):
            per_forward, per_step = edm_counts(model), edm_counts(model, training=True)
            config, steps_args = _edm_cli_config(source, out_dir), []
            evals = EDM_CLI_STEPS * (2 if model._sampler.solver == "heun" else 1) - (
                1 if model._sampler.solver == "heun" else 0)
        else:
            x = torch.zeros((TEXT_CLI_SAMPLES, 32, 32, 1), device="cuda")
            t = torch.full((TEXT_CLI_SAMPLES,), 0.5, device="cuda")

            def one_forward():
                with torch.inference_mode():
                    model.predict_score(x, t)

            sites = main_path_sites(model, run=one_forward)
            per_forward, per_step = per_call_counts(sites), per_call_counts(sites, training=True)
            config, steps_args = source, ["--sampling_steps", str(EDM_CLI_STEPS)]
            corrector = model._sampler._corrector_cfg
            langevin = "Langevin" in corrector["target"]
            evals = EDM_CLI_STEPS * (1 + (int(corrector["params"].get("n_steps", 1))
                                          if langevin else 0))
        ckpt = os.path.join(out_dir, "random_weights.pt")
        torch.save(model.score_network().state_dict(), ckpt)
        ks = reset_launches()
        t0 = time.perf_counter()
        samples = cli.main(["--config_path", config, "--checkpoint", ckpt, "--num_samples",
                            str(TEXT_CLI_SAMPLES), "--output_path", out_dir, "--seed", str(SEED),
                            *steps_args])
        torch.cuda.synchronize()
        launches = {k: v.launches for k, v in ks.items()}
        expected = {k: evals * per_forward.get(k, 0) for k in ks}
        log(f"{name} (fp32) through the sampling CLI, {evals} evaluations at batch "
            f"{TEXT_CLI_SAMPLES}: {time.perf_counter() - t0:.2f} s, launches {launches}, "
            f"expected {expected}, samples mean {samples.float().mean().item():.4f}")
        check(launches == expected, f"{name}: launches {launches} != {expected}")
        check(tuple(samples.shape) == (TEXT_CLI_SAMPLES, 32, 32, 1), f"{name}: samples shape")
        check(bool(torch.isfinite(samples).all()), f"{name}: samples not finite")
        check(samples.min().item() >= 0.0 and samples.max().item() <= 1.0,
              f"{name}: samples outside [0, 1]")
        check(os.path.getsize(os.path.join(out_dir, "sample-step0.png")) > 0, f"{name}: no PNG")
        os.remove(ckpt)
        total["bsc_attention"] += launches["bsc_attention"]

        state = create_train_state(model, default_optimizer().build(
            model.score_network().parameters()), seed=SEED)
        train_step = make_train_step(model)
        losses = []
        t0 = time.perf_counter()
        for i in range(TEXT_TRAIN_STEPS):
            batch = {"images": torch.rand((TEXT_TRAIN_BATCH, 32, 32, 1), device="cuda")}
            ks = reset_launches()
            losses.append(train_step(state, batch)["loss"].item())
            launches = {k: v.launches for k, v in ks.items()}
            expected = {k: per_step.get(k, 0) for k in ks}
            check(launches == expected, f"{name} training step {i}: launches {launches} != "
                                        f"{expected}")
        log(f"{name} (fp32), {TEXT_TRAIN_STEPS} training steps at batch {TEXT_TRAIN_BATCH}: "
            f"{time.perf_counter() - t0:.2f} s, losses {[round(v, 4) for v in losses]}, "
            f"launches a step {per_step}")
        check(bool(np.isfinite(losses).all()), f"{name}: training losses {losses}")
        total["bsc_attention_bwd"] += TEXT_TRAIN_STEPS * per_step.get("bsc_attention_bwd", 0)
        del model, state, train_step
    return total


# ---- phases 35-40: head dim 256 on K5/K6, WideFormer, consistency, distillation --

# WideFormer-PixArt (wideformer_pixart.yaml: hidden 2048 over 8 heads of 256,
# depth 2): K5/K6 sites (B, H, Sq, Sk, D), 16 queries against the 77 caption
# keys at the guided sampling batch and the training batch (both 128) and the
# CLI's (32); ragged shapes on every side of the wide variant's 16-row blocks
# and 32-row tiles; its K1/K2 self-attention site (B, Sq, Sk, C, heads).
WIDE_FLASH_SITES = [(128, 8, 16, 77, 256), (32, 8, 16, 77, 256)]
WIDE_FLASH_RAGGED = [(2, 2, 100, 65, 256), (1, 2, 200, 300, 256), (2, 3, 33, 31, 256),
                     (3, 2, 1, 1, 256), (3, 2, 1, 2, 256)]
WIDE_K1_SITE = (128, 16, 16, 2048, 8)
# WideFormer's guided sampling steps (50 until the video UNets' phases came)
# and training steps.
WIDE_SAMPLING_STEPS, WIDE_TRAIN_STEPS = 25, 6  # training 10 until phases 72-75 came
CONSISTENCY_CONFIG = os.path.join(ROOT, "configs/image/mnist/consistency_model.yaml")
CONSISTENCY_DISTILL_CONFIG = os.path.join(ROOT,
                                          "configs/image/mnist/consistency_model_distillation.yaml")
SAMPLERS_DIR = os.path.join(ROOT, "configs/image/mnist/samplers")
# distill_consistency's steps at its default batch (64; 5 steps until the
# video UNets' phases came); the multistep override's network evaluations
# ([0, 22, 39]: two steps and a last denoise).
CONSISTENCY_STEPS, CONSISTENCY_BATCH, MULTISTEP_EVALS = 3, 64, 3
V_CONTINUOUS_CONFIG = os.path.join(ROOT, "configs/image/mnist/ddpm_32x32_v_continuous.yaml")
# Progressive distillation: the teacher's training steps, the distill CLI's
# iterations and steps each at its default batch (128).
TEACHER_STEPS, DISTILL_ITERATIONS, DISTILL_STEPS = 3, 2, 3


def phase_wide_sites(logs):
    """K5 and K6 at head dim 256 (`flash_plan`'s wide variant): ptxas's
    registers and spills of its kernels; both against their plain versions
    at WIDE_FLASH_SITES and WIDE_FLASH_RAGGED in fp32 and bf16
    (`check_caption_flash_sites`: phases 7's and 11's tolerances, each twice
    bit for bit); K1 and K2 at WideFormer's self-attention site
    (`check_bsc_sites`). Then fp32 device times (the config's dtype): K5 and
    K6 at the headline site (B 128) and K1 and K2 at WIDE_K1_SITE, each beside
    the plain version, SDPA (its backward alone for K6 and K2) and the bound
    of `flash_bounds`, per call and per forward or training step (two calls
    each). Returns {"K1"|"K2"|"K5"|"K6": record per forward or step}."""
    from xdiffusion_tpu_torch.ops import flash_attention as fa

    for name in ("flash_attention", "flash_attention_bwd"):
        ptxas_summary(f"{name} (head dim 256)", logs.get(name, ""), only="_wide")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 35)
    errs = check_caption_flash_sites(WIDE_FLASH_SITES + WIDE_FLASH_RAGGED, gen)
    errs.update(check_bsc_sites([WIDE_K1_SITE], gen))
    for b, h, sq, sk, d in WIDE_FLASH_SITES:
        for dt in (torch.float32, torch.bfloat16):
            check(fa.flash_plan(b, h, sq, sk, d, dt).variant == "wide"
                  and fa.flash_plan(b, h, sq, sk, d, dt, backward=True).variant == "wide",
                  f"K5/K6 at B={b} D={d} {dt}: not the wide variant")

    out, per = {}, 2  # calls a forward (K1, K5) or a training step (K2, K6)
    b, h, sq, sk, d = WIDE_FLASH_SITES[0]
    q, k, v, g = caption_operands(gen, b, h, sq, sk, d, torch.float32)
    scale = d ** -0.5
    o, lse = fa.flash_attention(q, k, v, scale)
    args = (q, k, v, o, lse, g, scale)
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    sdpa_o = F.scaled_dot_product_attention(*leaves, scale=scale)
    flops, exps = 4 * b * h * sq * sk * d, b * h * sq * sk
    cases = [
        ("K5", lambda: fa.flash_attention(q, k, v, scale),
         lambda: fa.flash_attention_plain(q, k, v, scale),
         lambda: F.scaled_dot_product_attention(q, k, v, scale=scale),
         (2 * q.numel() + k.numel() + v.numel()) * 4 + lse.numel() * 4, flops, exps,
         f"the WideFormer cross-attention site B={b} H={h} Sq={sq} Sk={sk} D={d}"),
        ("K6", lambda: fa.flash_attention_bwd(*args),
         lambda: fa.flash_attention_bwd_plain(*args),
         lambda: torch.autograd.grad(sdpa_o, leaves, g, retain_graph=True),
         (4 * q.numel() + 4 * k.numel()) * 4 + lse.numel() * 4, 10 * flops // 4, exps,
         f"the WideFormer cross-attention site B={b} H={h} Sq={sq} Sk={sk} D={d}")]
    b1, s1, _, c1, heads1 = WIDE_K1_SITE
    d1 = c1 // heads1
    q1, k1, v1 = torch.randn((b1, s1, 3 * c1), generator=gen, device="cuda").chunk(3, -1)
    g1 = torch.randn((b1, s1, c1), generator=gen, device="cuda")
    qh, kh, vh = (t.reshape(b1, s1, heads1, d1).transpose(1, 2).contiguous().requires_grad_()
                  for t in (q1, k1, v1))
    sdpa_o1 = F.scaled_dot_product_attention(qh, kh, vh)
    gh = g1.reshape(b1, s1, heads1, d1).transpose(1, 2).contiguous()
    cases += [
        ("K1", lambda: fa.short_attention_bsc(q1, k1, v1, heads1, d1 ** -0.5),
         lambda: fa.short_attention_bsc_plain(q1, k1, v1, heads1, d1 ** -0.5),
         lambda: F.scaled_dot_product_attention(qh, kh, vh), 4 * b1 * s1 * c1 * 4,
         4 * b1 * s1 * s1 * c1, b1 * heads1 * s1 * s1,
         f"the WideFormer self-attention site B={b1} S={s1} C={c1} heads={heads1}"),
        ("K2", lambda: fa.short_attention_bsc_bwd(q1, k1, v1, g1, heads1, d1 ** -0.5),
         lambda: fa.short_attention_bsc_bwd_plain(q1, k1, v1, g1, heads1, d1 ** -0.5),
         lambda: torch.autograd.grad(sdpa_o1, (qh, kh, vh), gh, retain_graph=True),
         7 * b1 * s1 * c1 * 4, 10 * b1 * s1 * s1 * c1, b1 * heads1 * s1 * s1,
         f"the WideFormer self-attention site B={b1} S={s1} C={c1} heads={heads1}")]
    for kernel, fn, plain, lib, nbytes, kflops, kexps, site in cases:
        k_ms, p_ms, l_ms = device_ms(fn), device_ms(plain), device_ms(lib)
        bd = flash_bounds(kflops, kexps, nbytes, torch.float32)
        unit = "forward" if kernel in ("K1", "K5") else "training step"
        log(f"{kernel} at {site} fp32, one call: {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
            f"SDPA{' backward' if kernel in ('K2', 'K6') else ''} {l_ms:.4f} ms, bound "
            f"{bd['bound_ms']:.4f} ms ({bd['binds']}; bytes {bd['bytes_ms']:.4f}, 3 TF32 "
            f"products {bd['tf32x3_ms']:.4f}, fp32 CUDA cores {bd['cuda_core_ms']:.4f}); x{per} "
            f"a {unit}: {per * k_ms:.4f} ms, SDPA {per * l_ms:.4f}, bound "
            f"{per * bd['bound_ms']:.4f}")
        out[kernel] = {"ms": per * k_ms, "plain_ms": per * p_ms, "library_ms": per * l_ms,
                       "bound_ms": per * bd["bound_ms"],
                       "bound_by": "bytes" if bd["binds"] == "bytes" else "operations",
                       "err": errs[kernel]}
    return out


def phase_wide_sampling():
    """wideformer_pixart.yaml as shipped (fp32, hidden 2048 over 8 heads of
    256, depth 2) with seeded random weights: WIDE_SAMPLING_STEPS guided
    ancestral steps at batch 64 with prompts "0" to "9" in turn (one forward
    on 128 samples a step) through `sample()`: 2 K1 and 2 K5 launches a
    forward, both on their wide variants, and nothing else; the grid to
    output/chip_smoke/wideformer/samples.png; a profile of one guided
    forward (output/chip_smoke/wideformer_profile.txt). Returns (launches,
    samples/s, the forward's (wall, busy) ms)."""
    from xdiffusion_tpu_torch.sample import save_image_grid

    model = build_model("float32", "cuda", WIDEFORMER)
    guidance = model.classifier_free_guidance()
    prompts = digit_prompts(DIT_BATCH)

    def run(num_steps):
        g = torch.Generator(device="cuda").manual_seed(SEED)
        return model.sample(num_samples=DIT_BATCH, context={"text_prompts": prompts},
                            classifier_free_guidance=guidance, num_sampling_steps=num_steps,
                            generator=g)

    run(2)  # warm-up
    torch.cuda.synchronize()
    ks = reset_launches()
    t0 = time.perf_counter()
    out = run(WIDE_SAMPLING_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: k.launches for name, k in ks.items()}
    sps = DIT_BATCH / wall
    per_forward = pixart_counts(model)
    check(per_forward == {"bsc_attention": 2, "flash_attention": 2},
          f"WideFormer's structure: {per_forward}")
    expected = {name: WIDE_SAMPLING_STEPS * per_forward.get(name, 0) for name in ks}
    log(f"WideFormer main path: {WIDE_SAMPLING_STEPS}-step guided ancestral, batch {DIT_BATCH}, "
        f"guidance {guidance} (forwards of {2 * DIT_BATCH}), fp32: {wall:.2f} s, {sps:.3f} "
        f"samples/s, launches {launches}, expected {expected}")
    check(launches == expected, f"WideFormer launches {launches} != {expected}")
    check(tuple(out.shape) == (DIT_BATCH, 32, 32, 1), f"WideFormer samples {tuple(out.shape)}")
    check(bool(torch.isfinite(out).all()), "WideFormer samples not finite")
    check(out.min().item() >= 0.0 and out.max().item() <= 1.0,
          "WideFormer samples outside [0, 1]")
    log(f"WideFormer samples: mean {out.mean().item():.4f} std {out.std().item():.4f}")
    save_image_grid(out.cpu().numpy(), os.path.join(OUT_DIR, "wideformer", "samples.png"))

    x = torch.randn((2 * DIT_BATCH, 32, 32, 1), device="cuda")
    ctx = pixart_context(model, prompts, guided=True)
    with torch.inference_mode():
        for _ in range(3):
            model.predict_score(x, ctx)
        ks = reset_launches()
        fwd = profile_text(f"one guided WideFormer forward ({2 * DIT_BATCH} samples, fp32, 16 "
                           f"tokens, 8 heads of 256, against 77 caption keys)",
                           lambda: model.predict_score(x, ctx).sum().item(),
                           "wideformer_profile.txt", expect={"K1": 2, "K5": 2})
    one = {name: k.launches for name, k in ks.items() if k.launches}
    check(one == per_forward, f"one WideFormer forward launched {one}")
    return launches, sps, fwd


def phase_wide_card_vs_cpu():
    """wideformer_pixart.yaml (fp32, full width, the same seeded weights, no
    drop-path or guidance drop) card against CPU: one forward at batch 2
    with prompts (K1 and K5 at head dim 256 against their plain versions),
    then one loss and backward with injected steps and noise (K2 and K6):
    the loss, the gradient norm and every gradient."""
    from xdiffusion_tpu_torch.optim import global_norm

    n = 2
    prompts = digit_prompts(n)
    rng = np.random.default_rng(SEED + 36)
    x = torch.from_numpy(rng.standard_normal((n, 32, 32, 1)).astype(np.float32))
    t = torch.from_numpy(rng.integers(0, 1000, size=n))
    images = torch.from_numpy(rng.random((n, 32, 32, 1)).astype(np.float32))
    eps = torch.from_numpy(rng.standard_normal((n, 32, 32, 1)).astype(np.float32))
    config = no_drop_config(WIDEFORMER)
    results = {}
    for device in ("cuda", "cpu"):
        model = build_model("float32", device, config)
        tokens = model.preprocess_context({"text_prompts": prompts})["text_tokens"].to(device)
        ks = reset_launches()
        with torch.inference_mode():
            fwd = model.predict_score(x.to(device), {"text_tokens": tokens,
                                                     "timestep": t.to(device)}).cpu()
        launched = {name: k.launches for name, k in ks.items() if k.launches}
        loss, _ = model.loss_on_batch(images.to(device), {"text_tokens": tokens},
                                      timesteps=t.to(device), noise=eps.to(device),
                                      deterministic=True)
        loss.backward()
        grads = {k: p.grad.detach().cpu() for k, p in model.score_network().named_parameters()}
        results[device] = (fwd, loss.item(), global_norm(list(grads.values())).item(), grads,
                           launched)
        del model
    (f_gpu, l_gpu, n_gpu, g_gpu, launched), (f_cpu, l_cpu, n_cpu, g_cpu, _) = (
        results["cuda"], results["cpu"])
    check(launched == {"bsc_attention": 2, "flash_attention": 2},
          f"the card's WideFormer forward launched {launched}")
    err_f = rel_err(f_gpu, f_cpu)
    # fp32 on both sides with TF32 off on the card (K5/K6 split their
    # products into three TF32 ones); sums in other orders through 2 blocks.
    floor = 1e-3 * max(g.abs().max().item() for g in g_cpu.values())
    worst = max((rel_err(g_gpu[k], g_cpu[k], floor), k) for k in g_cpu)
    log(f"card vs CPU, WideFormer fp32 (head dim 256): forward (batch {n}) max|diff| / max|out| "
        f"= {err_f:.3e} (tol 1e-4); loss {l_gpu:.7f} vs {l_cpu:.7f}, grad_norm {n_gpu:.6f} vs "
        f"{n_cpu:.6f}, worst gradient {worst[1]} at {worst[0]:.3e} (tol 1e-3)")
    check(err_f <= 1e-4, f"WideFormer forward card vs CPU: {err_f}")
    check(abs(l_gpu - l_cpu) <= 1e-5 * abs(l_cpu), f"WideFormer loss {l_gpu} vs {l_cpu}")
    check(abs(n_gpu - n_cpu) <= 1e-4 * abs(n_cpu), f"WideFormer grad_norm {n_gpu} vs {n_cpu}")
    check(worst[0] <= 1e-3, f"WideFormer gradient {worst[1]}: {worst[0]} > 1e-3")


def phase_wide_training():
    """wideformer_pixart.yaml (fp32) at batch 128: a profile of one training
    step (output/chip_smoke/wideformer_train_profile.txt) with its launches,
    then WIDE_TRAIN_STEPS steps through `train()` with prompts from the
    digits' labels: every step's loss and grad_norm, steps/s over steps
    2-9, launches against the code's counts (2 K1, K2, K5 and K6 a step, and
    the end grid's GRID_STEPS unguided forwards), the checkpoint and the grid.
    Returns (launches, steps/s, the step's (wall, busy) ms)."""
    import shutil

    from xdiffusion_tpu_torch.datasets.mnist import convert_labels_to_prompts
    from xdiffusion_tpu_torch.optim import default_optimizer
    from xdiffusion_tpu_torch.train_step import create_train_state, make_train_step
    from xdiffusion_tpu_torch.training.image.train import train

    model = build_model("float32", "cuda", WIDEFORMER)
    per_step, per_forward = pixart_counts(model, training=True), pixart_counts(model)
    labels = np.random.default_rng(SEED).integers(0, 10, size=TRAIN_BATCH)
    ctx = model.preprocess_context({"text_prompts": convert_labels_to_prompts(
        labels, rng=np.random.default_rng(SEED))})
    state = create_train_state(model, default_optimizer().build(
        model.score_network().parameters()), seed=SEED)
    step = make_train_step(model)
    batch = {"images": torch.rand((TRAIN_BATCH, 32, 32, 1), device="cuda"),
             "text_tokens": ctx["text_tokens"].to("cuda")}
    for _ in range(2):
        step(state, batch)
    ks = reset_launches()
    step_prof = profile_text(f"one WideFormer training step (batch {TRAIN_BATCH}, fp32)",
                             lambda: step(state, batch)["loss"].item(),
                             "wideformer_train_profile.txt", expect={"K1": 2, "K5": 2})
    one = {name: k.launches for name, k in ks.items() if k.launches}
    check(one == per_step, f"one WideFormer training step launched {one}, expected {per_step}")
    del model, state, step, batch

    root = os.path.join(OUT_DIR, "wideformer_train")
    shutil.rmtree(root, ignore_errors=True)
    ks = reset_launches()
    t0 = time.perf_counter()
    out_dir = train(WIDEFORMER, num_training_steps=WIDE_TRAIN_STEPS, batch_size=TRAIN_BATCH,
                    save_and_sample_every_n=WIDE_TRAIN_STEPS, num_samples=NUM_SAMPLES,
                    seed=SEED, device="cuda", log_every=1, output_path=os.path.join(root, "run"))
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {name: k.launches for name, k in ks.items()}
    grid_steps = GRID_STEPS
    expected = {name: WIDE_TRAIN_STEPS * per_step.get(name, 0)
                + grid_steps * per_forward.get(name, 0) for name in ks}
    log(f"WideFormer training ({WIDE_TRAIN_STEPS} steps + a {grid_steps}-step grid of "
        f"{NUM_SAMPLES}, {run_s:.1f} s): launches {launches}, expected {expected}")
    check(launches == expected, f"WideFormer training launches {launches} != {expected}")
    metrics = read_metrics(out_dir)
    check(sorted(metrics) == list(range(WIDE_TRAIN_STEPS)), "WideFormer metrics.jsonl misses steps")
    check(all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in metrics.values()),
          "WideFormer loss or grad_norm not finite")
    log("WideFormer losses: " + " ".join(f"{metrics[i]['loss']:.4f}"
                                         for i in range(WIDE_TRAIN_STEPS)))
    sps = (WIDE_TRAIN_STEPS - 2) / (metrics[WIDE_TRAIN_STEPS - 1]["time"] - metrics[1]["time"])
    log(f"WideFormer training throughput: {sps:.3f} steps/s (steps 2-{WIDE_TRAIN_STEPS - 1}, "
        f"batch {TRAIN_BATCH}, fp32)")
    for name in (f"checkpoints/{WIDE_TRAIN_STEPS}.pt", f"sample-{WIDE_TRAIN_STEPS}.png"):
        path = os.path.join(out_dir, name)
        check(os.path.isfile(path) and os.path.getsize(path) > 0,
              f"WideFormer train wrote no {name}")
    return launches, sps, step_prof


def build_consistency(path: str, device: str = "cuda"):
    """The consistency process of `path` with seeded random weights, its
    score, target and EMA networks each on its own draw."""
    from xdiffusion_tpu_torch.weights import randomize_

    model = build_process(path, device)
    for i, name in enumerate(("target", "ema")):
        randomize_(model.networks()[name], SEED + 1 + i)
    return model


def phase_consistency_card_vs_cpu():
    """consistency_model.yaml's training loss and consistency_model_
    distillation.yaml's distillation loss (teacher: edm.yaml's network on
    its own seeded weights), fp32 at full width, batch 2, card against CPU
    on the same weights, boundary indices (N = 18) and noise: the loss, the
    gradient norm and every score-network gradient (K1/K2 at head dim 256
    and K3 on the card, their plain versions on the CPU)."""
    from xdiffusion_tpu_torch.optim import global_norm

    n, num_scales = 2, 18
    rng = np.random.default_rng(SEED + 38)
    images = torch.from_numpy(rng.random((n, 32, 32, 1)).astype(np.float32))
    indices = torch.from_numpy(rng.integers(0, num_scales - 1, size=n))
    noise = torch.from_numpy(rng.standard_normal((n, 32, 32, 1)).astype(np.float32))
    for kind, path in (("training", CONSISTENCY_CONFIG),
                       ("distillation", CONSISTENCY_DISTILL_CONFIG)):
        results = {}
        for device in ("cuda", "cpu"):
            model = build_consistency(path, device)
            kwargs = {}
            if kind == "distillation":
                teacher = build_process(EDM_CONFIG, device).score_network()
                kwargs["teacher_denoise_fn"] = lambda x, s: teacher(x, s)
            loss, _ = model.loss_on_batch(images.to(device), {"num_scales": num_scales},
                                          indices=indices.to(device), noise=noise.to(device),
                                          **kwargs)
            loss.backward()
            grads = {k: p.grad.detach().cpu()
                     for k, p in model.score_network().named_parameters()}
            results[device] = loss.item(), global_norm(list(grads.values())).item(), grads
            del model, kwargs
        (l_gpu, n_gpu, g_gpu), (l_cpu, n_cpu, g_cpu) = results["cuda"], results["cpu"]
        # fp32 with TF32 off: sums in other orders through the score
        # network, the target and (distillation) the teacher's two Heun
        # evaluations, whose outputs feed the target's input: the loss to
        # 1e-4 relative, each gradient as phase 32 holds EDM's.
        floor = 1e-3 * max(g.abs().max().item() for g in g_cpu.values())
        worst = max((rel_err(g_gpu[k], g_cpu[k], floor), k) for k in g_cpu)
        log(f"card vs CPU, consistency {kind} loss (fp32, batch {n}, N {num_scales}): loss "
            f"{l_gpu:.7f} vs {l_cpu:.7f} (tol 1e-4 relative), grad_norm {n_gpu:.6f} vs "
            f"{n_cpu:.6f}, worst gradient {worst[1]} at {worst[0]:.3e} (tol 1e-3)")
        check(abs(l_gpu - l_cpu) <= 1e-4 * abs(l_cpu), f"consistency {kind} loss {l_gpu} vs "
                                                        f"{l_cpu}")
        check(abs(n_gpu - n_cpu) <= 1e-4 * abs(n_cpu), f"consistency {kind} grad_norm")
        check(worst[0] <= 1e-3, f"consistency {kind} gradient {worst[1]}: {worst[0]} > 1e-3")


def phase_consistency(teacher_checkpoint: str):
    """The consistency slice through its CLIs, fp32 at full width: the
    distill_consistency CLI on consistency_model_distillation.yaml from
    `teacher_checkpoint` (phase 33's edm.yaml run: the port-trained teacher)
    for CONSISTENCY_STEPS steps at batch 64, then on consistency_model.yaml
    (consistency training: the loss reads no teacher), each with its
    launches against the code's counts (a distillation step: the student's
    forward and backward, two teacher forwards, the target's forward: 24 K1,
    6 K2, 4 x 73 K3; a training step 12 K1, 6 K2, 2 x 73 K3; the end grid
    one one-step forward of 16), losses, grid and checkpoint. Then the
    sampling CLI on each checkpoint: one-step at batch 64 (the config's
    sampler, timed), the one-step and multistep overrides (1 and 3
    evaluations), and the euler_ancestral override refused with JAX's
    ValueError before any launch. Returns (the K1 launches of the
    distillation run, the one-step sampling's samples/s, steps/s of
    distillation and of training)."""
    from xdiffusion_tpu_torch import distill_consistency as dc
    from xdiffusion_tpu_torch import sample as cli

    per_forward = edm_counts(build_process(CONSISTENCY_CONFIG))
    k1, k3 = per_forward["bsc_attention"], per_forward["group_norm_silu"]
    check((k1, k3) == (6, 73), f"the consistency SongUNet's counts {per_forward}")
    out = {}
    for kind, path, forwards in (("distillation", CONSISTENCY_DISTILL_CONFIG, 4),
                                 ("training", CONSISTENCY_CONFIG, 2)):
        run_dir = os.path.join(OUT_DIR, f"consistency_{kind}")
        ks = reset_launches()
        t0 = time.perf_counter()
        dc.main(["--teacher_config_path", EDM_CONFIG, "--student_config_path", path,
                 "--teacher_checkpoint", teacher_checkpoint, "--num_training_steps",
                 str(CONSISTENCY_STEPS), "--batch_size", str(CONSISTENCY_BATCH),
                 "--output_path", run_dir, "--seed", str(SEED)])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = {name: k.launches for name, k in ks.items()}
        expected = {name: 0 for name in ks}
        expected.update(bsc_attention=CONSISTENCY_STEPS * forwards * k1 + k1,
                        bsc_attention_bwd=CONSISTENCY_STEPS * k1,
                        group_norm_silu=CONSISTENCY_STEPS * forwards * k3 + k3)
        log(f"distill_consistency ({kind}, {os.path.basename(path)}), {CONSISTENCY_STEPS} steps at "
            f"batch {CONSISTENCY_BATCH} + a one-step grid of 16: {run_s:.1f} s, launches "
            f"{launches}, expected {expected}")
        check(launches == expected, f"consistency {kind} launches {launches} != {expected}")
        if kind == "distillation":
            out["launches"] = launches["bsc_attention"]
        records = [json.loads(line) for line in open(os.path.join(run_dir, "metrics.jsonl"))]
        check([r["step"] for r in records] == [0] and np.isfinite(records[0]["loss"]),
              f"consistency {kind} metrics {records}")
        ckpt = os.path.join(run_dir, "checkpoints", f"{CONSISTENCY_STEPS}.pt")
        payload = torch.load(ckpt, map_location="cpu", weights_only=True)
        check({"params", "target", "ema"} <= set(payload) and payload["ema"] is not None,
              f"consistency {kind} checkpoint keys {sorted(payload)}")
        check(all(torch.isfinite(v).all() for v in payload["params"].values()
                  if v.is_floating_point()), f"consistency {kind}: parameters not finite")
        check(os.path.getsize(os.path.join(run_dir, f"sample-{CONSISTENCY_STEPS}.png")) > 0,
              f"consistency {kind}: no grid")
        log(f"consistency {kind} step-0 loss {records[0]['loss']:.5f}, N "
            f"{records[0]['num_scales']:.0f}")
        out[f"{kind}_sps"] = CONSISTENCY_STEPS / run_s

        for label, override, evals in (("config", "", 1),
                                       ("onestep", "consistency_model_onestep.yaml", 1),
                                       ("multistep", "consistency_model_multistep.yaml",
                                        MULTISTEP_EVALS)):
            args = ["--config_path", path, "--checkpoint", ckpt, "--num_samples",
                    str(CONSISTENCY_BATCH), "--output_path",
                    os.path.join(run_dir, f"samples_{label}"), "--seed", str(SEED)]
            if override:
                args += ["--sampler_config_path", os.path.join(SAMPLERS_DIR, override)]
            ks = reset_launches()
            t0 = time.perf_counter()
            samples = cli.main(args)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {name: k.launches for name, k in ks.items() if k.launches}
            want = {"bsc_attention": evals * k1, "group_norm_silu": evals * k3}
            log(f"consistency {kind}: sampling CLI ({label}) at batch {CONSISTENCY_BATCH}: "
                f"{wall:.2f} s (process build and checkpoint load included), launches "
                f"{launches}, samples mean {samples.float().mean().item():.4f}")
            check(launches == want, f"consistency {kind} {label} sampling launches {launches}")
            check(tuple(samples.shape) == (CONSISTENCY_BATCH, 32, 32, 1)
                  and bool(torch.isfinite(samples).all())
                  and 0.0 <= samples.min().item() <= samples.max().item() <= 1.0,
                  f"consistency {kind} {label} samples")
            check(os.path.getsize(os.path.join(run_dir, f"samples_{label}",
                                               f"sample-step{CONSISTENCY_STEPS}.png")) > 0,
                  f"consistency {kind} {label}: no PNG")
        ks = reset_launches()
        try:
            cli.main(["--config_path", path, "--checkpoint", ckpt, "--num_samples", "4",
                      "--sampler_config_path",
                      os.path.join(SAMPLERS_DIR, "consistency_model_euler_ancestral.yaml"),
                      "--output_path", os.path.join(run_dir, "samples_euler_ancestral")])
        except ValueError as e:
            log(f"consistency {kind}: the euler_ancestral override raises: {e}")
            check(str(e) == "unknown consistency sampler 'euler_ancestral'", f"refusal: {e}")
        else:
            raise PhaseError("the euler_ancestral override sampled")
        check(not any(k.launches for k in ks.values()), "euler_ancestral launched kernels")

    # One-step sampling at batch 64 through `sample()`, timed apart from the
    # CLI's set-up.
    model = build_consistency(CONSISTENCY_DISTILL_CONFIG)
    model.sample(num_samples=CONSISTENCY_BATCH)  # warm-up
    torch.cuda.synchronize()
    ks = reset_launches()
    t0 = time.perf_counter()
    samples = model.sample(num_samples=CONSISTENCY_BATCH,
                           generator=torch.Generator(device="cuda").manual_seed(SEED))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: k.launches for name, k in ks.items() if k.launches}
    check(launches == {"bsc_attention": k1, "group_norm_silu": k3},
          f"one-step sampling launched {launches}")
    out["onestep_sps"] = CONSISTENCY_BATCH / wall
    log(f"consistency one-step sampling at batch {CONSISTENCY_BATCH} (fp32): {wall * 1e3:.2f} ms, "
        f"{out['onestep_sps']:.1f} samples/s, launches {launches}")
    return out


def phase_progressive_distillation():
    """ddpm_32x32_v_continuous.yaml as shipped: TEACHER_STEPS steps of the
    trainer's step at batch 128 on the synthetic digits and a checkpoint
    (the teacher; `train()` would add its 1024-step grid), then the
    `distill` CLI from that checkpoint for DISTILL_ITERATIONS iterations of
    DISTILL_STEPS steps at batch 128 (N 512 then 256): launches against the
    code's counts (a step: two teacher forwards and the student's forward,
    K1, K3 and K4 three times a forward's, and the student's K2), finite
    losses, a checkpoint per iteration. Returns (K1 launches, steps/s)."""
    import shutil

    from xdiffusion_tpu_torch import checkpoints, distill
    from xdiffusion_tpu_torch.datasets import load_dataset
    from xdiffusion_tpu_torch.datasets.utils import batch_iterator
    from xdiffusion_tpu_torch.optim import default_optimizer
    from xdiffusion_tpu_torch.train_step import create_train_state, make_train_step

    root = os.path.join(OUT_DIR, "progressive_distillation")
    shutil.rmtree(root, ignore_errors=True)
    model = build_process(V_CONTINUOUS_CONFIG)
    state = create_train_state(model, default_optimizer().build(
        model.score_network().parameters()), seed=SEED)
    step = make_train_step(model)
    dataset, _ = load_dataset("image/mnist", config=model.config(), split="train")
    batches = batch_iterator(dataset, TRAIN_BATCH, seed=SEED)
    losses = [step(state, {"images": torch.from_numpy(next(batches)["images"]).to("cuda")}
                   )["loss"].item() for _ in range(TEACHER_STEPS)]
    teacher = checkpoints.save_checkpoint(os.path.join(root, "teacher"), state, TEACHER_STEPS)
    log(f"progressive distillation's teacher: {TEACHER_STEPS} training steps of "
        f"{os.path.basename(V_CONTINUOUS_CONFIG)} at batch {TRAIN_BATCH}, losses "
        f"{[round(v, 4) for v in losses]}, checkpoint {os.path.relpath(teacher, ROOT)}")
    check(bool(np.isfinite(losses).all()), f"the teacher's losses {losses}")
    x = torch.zeros((TRAIN_BATCH, 32, 32, 1), device="cuda")
    t = torch.full((TRAIN_BATCH,), 0.5, device="cuda")

    def one_forward():
        with torch.inference_mode():
            model.predict_score(x, {"timestep": t, "logsnr_t": model.noise_scheduler().logsnr(t)})

    forward = per_call_counts(main_path_sites(model, run=one_forward))
    per_step = {name: 3 * v for name, v in forward.items()}
    per_step["bsc_attention_bwd"] = forward["bsc_attention"]
    del model, state, step
    ks = reset_launches()
    t0 = time.perf_counter()
    out = distill.main(["--config_path", V_CONTINUOUS_CONFIG, "--teacher_model_checkpoint",
                        teacher, "--distillation_iterations", str(DISTILL_ITERATIONS),
                        "--initial_sampling_steps", "1024", "--steps_per_iteration",
                        str(DISTILL_STEPS), "--output_path", os.path.join(root, "distilled"),
                        "--seed", str(SEED)])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {name: k.launches for name, k in ks.items()}
    steps = DISTILL_ITERATIONS * DISTILL_STEPS
    expected = {name: steps * per_step.get(name, 0) for name in ks}
    log(f"progressive distillation: {DISTILL_ITERATIONS} iterations x {DISTILL_STEPS} steps at "
        f"batch {TRAIN_BATCH}: {run_s:.1f} s, launches {launches}, expected {expected}")
    check(launches == expected, f"distill launches {launches} != {expected}")
    check(all(launches[k] > 0 for k in ("bsc_attention", "bsc_attention_bwd", "group_norm_silu",
                                        "affine_silu_conv3x3")), f"distill launches {launches}")
    records = [json.loads(line) for line in open(os.path.join(out, "metrics.jsonl"))]
    check([(r["step"], r["N"]) for r in records] == [(0, 512), (DISTILL_STEPS, 256)]
          and all(np.isfinite(r["loss"]) for r in records), f"distill metrics {records}")
    for n, step in ((512, DISTILL_STEPS), (256, 2 * DISTILL_STEPS)):
        check(os.path.isfile(os.path.join(out, f"checkpoints_N{n}", f"{step}.pt")),
              f"distill wrote no checkpoint for N={n}")
    log("progressive distillation losses: " + ", ".join(
        f"step {r['step']} N {r['N']:.0f} {r['loss']:.4e}" for r in records))
    return launches["bsc_attention"], steps / run_s


# Device ms of K1, K2 and K7 before their redesign (PERF.md: the two-pass
# kernels' final chip_smoke.py run, NVIDIA H100 80GB HBM3, 700.00 W), the
# yardstick of the redesigned ones.
MNIST_DIR = os.path.join(ROOT, "configs/image/mnist")
# The MM-DiT family's joint attention (phases 41-45): (B, H, Sq, Sk, D) at
# the guided sampling batch and the training batch (128), as the blocks give
# K5 and K6: SD3's 77 text + 16 image tokens, Flux's (and Chewie's single
# blocks') 128 + 16, SD3.5's second, image-only attention, and AuraFlow's 8
# registers + 128 + 16 at head dim 256 (the wide variant).
MMDIT_FLASH_SITES = {"sd3": (128, 6, 93, 93, 64), "flux": (128, 6, 144, 144, 64),
                     "sd3.5 image": (128, 6, 16, 16, 64), "auraflow": (128, 4, 152, 152, 256)}
# The companions' guided CLI batch (16 samples: forwards of 32), ragged
# neighbours, one key, and 128 tokens: one whole fp32 row tile, beside
# Flux's 144 (a second tile of 16 rows).
MMDIT_FLASH_MORE = [(32, 6, 93, 93, 64), (32, 6, 144, 144, 64), (32, 6, 16, 16, 64),
                    (3, 6, 92, 92, 64), (3, 6, 145, 145, 64), (3, 4, 151, 151, 256),
                    (3, 6, 144, 1, 64), (3, 4, 152, 1, 256), (128, 6, 128, 128, 64)]
# The headlines through the CLIs: (sampling steps at batch DIT_BATCH with
# guidance, training steps at TRAIN_BATCH, samples in the trainer's end grid).
# The steps of all three are cut from the configs' 1000 to keep the run
# inside its time limit (the Euler sampler then integrates the last steps /
# 1000 of the flow, as in JAX): since Sana's and the cascades' phases came,
# Flux's from 1000 (50 s on an H100 80GB HBM3 machine) to 100 and SD3's
# from 100 to 50, and Flux's and SD3's training from 30 steps to 10; once
# the video UNets' phases came, Flux's sampling to 50, SD3's and AuraFlow's
# to 25, and the three's training to 6 steps; once the autoencoders' came,
# to 30, 15 and 15, and 5.
MMDIT_HEADLINES = {"flux.yaml": (30, 5, NUM_SAMPLES),
                   "sd3.yaml": (15, 5, NUM_SAMPLES),
                   "auraflow.yaml": (15, 5, 4)}
MMDIT_COMPANIONS = ("sd3.5.yaml", "flux_dyt.yaml", "chewie.yaml", "diffussm.yaml")


def joint_operands(gen, b: int, h: int, sq: int, sk: int, d: int, dt):
    """K5's and K6's operands as the MM-DiT blocks give them: q, k and v
    contiguous (B, H, S, D), as the [text; image] concat makes them; at head
    dim 256, AuraFlow's, (B, H, S, D) views of (B, S, H, D) storage; the
    cotangent a head view, as the output's reshape sends it back."""
    if d == 256:
        q, k, v = (heads_view(gen, b, s, h, d, dt) for s in (sq, sk, sk))
    else:
        q, k, v = (torch.randn((b, h, s, d), generator=gen, device="cuda").to(dt)
                   for s in (sq, sk, sk))
    return q, k, v, heads_view(gen, b, sq, h, d, dt)


def flash_calls(run):
    """(B, H, Sq, Sk, D) of every K5 call `run()` makes, read from the
    wrapper's arguments."""
    from xdiffusion_tpu_torch.ops import flash_attention as fa

    calls, original = [], fa.flash_attention

    def recording(q, k, v, scale):
        calls.append((*q.shape[:3], k.shape[2], q.shape[3]))
        return original(q, k, v, scale)

    fa.flash_attention = recording
    try:
        run()
    finally:
        fa.flash_attention = original
    return calls


def mmdit_counts(model, training: bool = False):
    """K5 launches per forward of an MM-DiT family network (K6 beside them
    per training step): one per block with attention (SD3.5's dual blocks
    two, Chewie's pooling blocks none), none in DiffuSSM."""
    from xdiffusion_tpu_torch.layers.flux import DoubleStreamBlock

    net = model.score_network()
    if hasattr(net, "_double_blocks"):
        n = len(net._single_blocks) + sum(isinstance(b, DoubleStreamBlock)
                                          for b in net._double_blocks)
    elif hasattr(net, "_mmdit_blocks"):
        n = len(net._mmdit_blocks) + len(net._single_blocks)
    elif type(net).__name__.startswith("SD3"):
        n = sum(1 + b.dual_attention for b in net._blocks)
    else:
        n = 0
    counts = {"flash_attention": n} if n else {}
    if training and n:
        counts["flash_attention_bwd"] = n
    return counts


def phase_mmdit_sites():
    """K5 and K6 at MMDIT_FLASH_SITES and MMDIT_FLASH_MORE against their
    plain versions, fp32 and bf16 (`check_caption_flash_sites` on
    `joint_operands`: phases 7's and 11's tolerances, each twice bit for
    bit, the plan each takes). Then, at each of MMDIT_FLASH_SITES and at 128
    tokens, fp32 (the configs' dtype) device times of K5 and K6 beside the
    plain version, SDPA (its backward alone for K6) and the bound of
    `flash_bounds`, one call each. Returns {"K5"|"K6": {site: record},
    "err": {"K5": e, "K6": e}}."""
    from xdiffusion_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(SEED + 41)
    errs = check_caption_flash_sites(list(MMDIT_FLASH_SITES.values()) + MMDIT_FLASH_MORE, gen,
                                     operands=joint_operands)
    out = {"K5": {}, "K6": {}, "err": errs}
    timed = dict(MMDIT_FLASH_SITES, **{"128 tokens": MMDIT_FLASH_MORE[-1]})
    for site, (b, h, sq, sk, d) in timed.items():
        q, k, v, g = joint_operands(gen, b, h, sq, sk, d, torch.float32)
        scale = d ** -0.5
        o, lse = fa.flash_attention(q, k, v, scale)
        args = (q, k, v, o, lse, g, scale)
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        sdpa_o = F.scaled_dot_product_attention(*leaves, scale=scale)
        flops, exps = 4 * b * h * sq * sk * d, b * h * sq * sk
        plan = fa.flash_plan(b, h, sq, sk, d, torch.float32)
        for kernel, fn, plain, lib, nbytes, kflops in (
                ("K5", lambda: fa.flash_attention(q, k, v, scale),
                 lambda: fa.flash_attention_plain(q, k, v, scale),
                 lambda: F.scaled_dot_product_attention(q, k, v, scale=scale),
                 (2 * q.numel() + k.numel() + v.numel()) * 4 + lse.numel() * 4, flops),
                ("K6", lambda: fa.flash_attention_bwd(*args),
                 lambda: fa.flash_attention_bwd_plain(*args),
                 lambda: torch.autograd.grad(sdpa_o, leaves, g, retain_graph=True),
                 (4 * q.numel() + 4 * k.numel()) * 4 + lse.numel() * 4, 10 * flops // 4)):
            k_ms, p_ms, l_ms = device_ms(fn), device_ms(plain), device_ms(lib)
            bd = flash_bounds(kflops, exps, nbytes, torch.float32)
            log(f"{kernel} at the {site} site B={b} H={h} Sq={sq} Sk={sk} D={d} fp32 "
                f"({plan.variant}, {plan.launches[0].rows} query rows a block), one call: "
                f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, SDPA{' backward' if kernel == 'K6' else ''} "
                f"{l_ms:.4f} ms, bound {bd['bound_ms']:.4f} ms ({bd['binds']}; bytes "
                f"{bd['bytes_ms']:.4f}, 3 TF32 products {bd['tf32x3_ms']:.4f}, fp32 CUDA cores "
                f"{bd['cuda_core_ms']:.4f}), {kflops / k_ms / 1e9:.1f} TFLOP/s")
            out[kernel][site] = {"ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
                                 "bound_ms": bd["bound_ms"],
                                 "bound_by": "bytes" if bd["binds"] == "bytes" else "operations"}
        del q, k, v, g, o, lse, args, leaves, sdpa_o
    a, b_ = out["K5"]["128 tokens"]["ms"], out["K5"]["flux"]["ms"]
    log(f"K5 fp32 at B=128 H=6 D=64: 144 tokens (a 128-row tile and one of 16) {b_:.4f} ms "
        f"against 128 tokens (one tile) {a:.4f} ms: x{b_ / a:.2f} for x{(144 / 128) ** 2:.2f} "
        f"the work")
    return out


def mmdit_context(model, prompts, guided: bool, t: float = 0.5):
    """One forward's context on the card: the prompts' host-side embeddings
    (guided: the empty prompts' after them, as the sampler runs them) and
    the time t."""
    ctx = model.preprocess_context({"text_prompts": prompts})
    ctx = {k: v for k, v in ctx.items() if isinstance(v, torch.Tensor)}
    if guided:
        unc = model.preprocess_context(model.unconditional_context({"text_prompts": prompts}))
        ctx = {k: torch.cat([v, unc[k]]) for k, v in ctx.items()}
    n = 2 * len(prompts) if guided else len(prompts)
    ctx = {k: v.to("cuda") for k, v in ctx.items()}
    ctx["timestep"] = torch.full((n,), t, device="cuda")
    return ctx


def phase_mmdit_sampling(name: str):
    """`name` as shipped (fp32) with seeded random weights through the
    sampling CLI: MMDIT_HEADLINES' steps of the config's Euler sampler at
    batch DIT_BATCH with prompts "0" to "9" in turn and the config's
    guidance 1.0 (one forward on 2 x DIT_BATCH samples a step): launches
    against the code's counts (K5 alone, one call a block with attention),
    every K5 call at its MMDIT_FLASH_SITES shape, finite samples in [0, 1],
    the PNG; samples/s over the sampler's loop; a profile of one guided
    forward (output/chip_smoke/<config>_profile.txt). Returns (K5 launches,
    samples/s, the forward's (wall, busy) ms)."""
    from xdiffusion_tpu_torch import sample as cli
    from xdiffusion_tpu_torch.diffusion.ddpm import GaussianDiffusion_DDPM

    steps = MMDIT_HEADLINES[name][0]
    stem = name[:-5]
    source = os.path.join(MNIST_DIR, name)
    out_dir = os.path.join(OUT_DIR, stem)
    os.makedirs(out_dir, exist_ok=True)
    model = build_model("float32", "cuda", source)
    guidance = model.classifier_free_guidance()
    per_forward = mmdit_counts(model)
    prompts = digit_prompts(DIT_BATCH)
    x = torch.randn((2 * DIT_BATCH, 32, 32, 1), device="cuda")
    ctx = mmdit_context(model, prompts, guided=True)
    with torch.inference_mode():
        calls = flash_calls(lambda: model.predict_score(x, ctx))
    want_calls = [MMDIT_FLASH_SITES[stem]] * per_forward["flash_attention"]
    check(calls == want_calls, f"{name}: K5 calls {calls} != {want_calls}")
    ckpt = os.path.join(out_dir, "random_weights.pt")
    torch.save(model.score_network().state_dict(), ckpt)

    timing, original = {}, GaussianDiffusion_DDPM.sample

    def timed(self, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = original(self, *args, **kwargs)
        torch.cuda.synchronize()
        timing["s"] = time.perf_counter() - t0
        return result

    ks = reset_launches()
    GaussianDiffusion_DDPM.sample = timed
    try:
        samples = cli.main(["--config_path", source, "--checkpoint", ckpt, "--num_samples",
                            str(DIT_BATCH), "--sampling_steps", str(steps), "--guidance",
                            str(guidance), "--text_prompts", ",".join(digit_prompts(10)),
                            "--output_path", out_dir, "--seed", str(SEED)])
    finally:
        GaussianDiffusion_DDPM.sample = original
    launches = {k: v.launches for k, v in ks.items()}
    expected = {k: steps * per_forward.get(k, 0) for k in ks}
    sps = DIT_BATCH / timing["s"]
    log(f"{name} main path (fp32) through the sampling CLI: {steps}-step Euler, batch "
        f"{DIT_BATCH}, guidance {guidance} (forwards of {2 * DIT_BATCH}): sampling "
        f"{timing['s']:.2f} s, {sps:.3f} samples/s, launches {launches}, expected {expected}")
    check(launches == expected, f"{name}: launches {launches} != {expected}")
    check(tuple(samples.shape) == (DIT_BATCH, 32, 32, 1), f"{name}: samples {samples.shape}")
    check(bool(torch.isfinite(samples).all()), f"{name}: samples not finite")
    check(samples.min().item() >= 0.0 and samples.max().item() <= 1.0,
          f"{name}: samples outside [0, 1]")
    check(os.path.getsize(os.path.join(out_dir, "sample-step0.png")) > 0, f"{name}: no PNG")
    log(f"{name} samples: mean {samples.mean().item():.4f} std {samples.std().item():.4f}")
    os.remove(ckpt)

    with torch.inference_mode():
        for _ in range(3):
            model.predict_score(x, ctx)
        ks = reset_launches()
        fwd = profile_text(f"one guided {stem} forward ({2 * DIT_BATCH} samples, fp32)",
                           lambda: model.predict_score(x, ctx).sum().item(),
                           f"{stem}_profile.txt",
                           expect={"K1": 0, "K5": per_forward["flash_attention"]})
    one = {k: v.launches for k, v in ks.items() if v.launches}
    check(one == per_forward, f"one {stem} forward launched {one}, expected {per_forward}")
    return launches["flash_attention"], sps, fwd


def phase_mmdit_training(name: str):
    """`name` (fp32) at batch TRAIN_BATCH: a profile of one training step
    with prompts (output/chip_smoke/<config>_train_profile.txt) and its
    launches, then MMDIT_HEADLINES' steps through `train()` with prompts
    from the digits' labels: every step's loss and grad_norm, steps/s (steps
    WARMUP_STEPS to RESUME_STEP - 1 of a TRAIN_STEPS run, else 2 to the
    last), launches against the code's counts (one K5 and one K6 a step per
    block with attention, and the end grid's GRID_STEPS unguided forwards),
    checkpoint and grid. Returns (K6 launches, steps/s, the step's (wall,
    busy) ms)."""
    import shutil

    from xdiffusion_tpu_torch.datasets.mnist import convert_labels_to_prompts
    from xdiffusion_tpu_torch.optim import default_optimizer
    from xdiffusion_tpu_torch.train_step import create_train_state, make_train_step
    from xdiffusion_tpu_torch.training.image.train import train

    _, n_steps, grid = MMDIT_HEADLINES[name]
    stem = name[:-5]
    source = os.path.join(MNIST_DIR, name)
    model = build_model("float32", "cuda", source)
    per_step, per_forward = mmdit_counts(model, training=True), mmdit_counts(model)
    labels = np.random.default_rng(SEED).integers(0, 10, size=TRAIN_BATCH)
    ctx = model.preprocess_context({"text_prompts": convert_labels_to_prompts(
        labels, rng=np.random.default_rng(SEED))})
    state = create_train_state(model, default_optimizer().build(
        model.score_network().parameters()), seed=SEED)
    step = make_train_step(model)
    batch = {"images": torch.rand((TRAIN_BATCH, 32, 32, 1), device="cuda"),
             **{k: v.to("cuda") for k, v in ctx.items() if isinstance(v, torch.Tensor)}}
    for _ in range(2):
        step(state, batch)
    ks = reset_launches()
    step_prof = profile_text(f"one {stem} training step (batch {TRAIN_BATCH}, fp32)",
                             lambda: step(state, batch)["loss"].item(),
                             f"{stem}_train_profile.txt",
                             expect={"K1": 0, "K5": per_step["flash_attention"]})
    one = {k: v.launches for k, v in ks.items() if v.launches}
    check(one == per_step, f"one {stem} training step launched {one}, expected {per_step}")
    del model, state, step, batch

    root = os.path.join(OUT_DIR, f"{stem}_train")
    shutil.rmtree(root, ignore_errors=True)
    ks = reset_launches()
    t0 = time.perf_counter()
    out_dir = train(source, num_training_steps=n_steps, batch_size=TRAIN_BATCH,
                    save_and_sample_every_n=n_steps, num_samples=grid, seed=SEED,
                    device="cuda", log_every=1, output_path=os.path.join(root, "run"))
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {k: v.launches for k, v in ks.items()}
    grid_steps = GRID_STEPS
    expected = {k: n_steps * per_step.get(k, 0) + grid_steps * per_forward.get(k, 0)
                for k in ks}
    log(f"{stem} training ({n_steps} steps at batch {TRAIN_BATCH} + a {grid_steps}-step grid "
        f"of {grid}, {run_s:.1f} s): launches {launches}, expected {expected}")
    check(launches == expected, f"{stem} training launches {launches} != {expected}")
    metrics = read_metrics(out_dir)
    check(sorted(metrics) == list(range(n_steps)), f"{stem} metrics.jsonl misses steps")
    check(all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in metrics.values()),
          f"{stem} loss or grad_norm not finite")
    log(f"{stem} losses: " + " ".join(f"{metrics[i]['loss']:.4f}" for i in range(n_steps)))
    first, last = ((WARMUP_STEPS, RESUME_STEP - 1) if n_steps == TRAIN_STEPS
                   else (2, n_steps - 1))
    sps = (last - first + 1) / (metrics[last]["time"] - metrics[first - 1]["time"])
    log(f"{stem} training throughput: {sps:.3f} steps/s (steps {first}-{last}, batch "
        f"{TRAIN_BATCH}, fp32, prompts embedded on the host each step)")
    for path in (f"checkpoints/{n_steps}.pt", f"sample-{n_steps}.png"):
        check(os.path.getsize(os.path.join(out_dir, path)) > 0, f"{stem} train wrote no {path}")
    return launches["flash_attention_bwd"], sps, step_prof


def phase_mmdit_card_vs_cpu():
    """flux.yaml, sd3.yaml and auraflow.yaml (fp32, full width, the same
    seeded weights, no guidance drop) card against CPU: one forward at batch
    2 with prompts and injected times (K5 against its plain version), then
    one loss and backward with injected times and noise (K6): the forward
    to 1e-4 of its scale, the loss to 1e-5 relative, the gradient norm to
    1e-4 and every gradient to 1e-3 of its scale (floored at 1e-3 of the
    largest). fp32 on both sides, TF32 off on the card, K5/K6 splitting
    their products into three TF32 ones; sums in other orders through 14
    to 18 blocks."""
    from xdiffusion_tpu_torch.optim import global_norm

    n = 2
    prompts = digit_prompts(n)
    rng = np.random.default_rng(SEED + 43)
    x = torch.from_numpy(rng.standard_normal((n, 32, 32, 1)).astype(np.float32))
    t = torch.from_numpy(rng.uniform(0.05, 0.95, size=n).astype(np.float32))
    images = torch.from_numpy(rng.random((n, 32, 32, 1)).astype(np.float32))
    eps = torch.from_numpy(rng.standard_normal((n, 32, 32, 1)).astype(np.float32))
    for name in MMDIT_HEADLINES:
        config = no_drop_config(os.path.join(MNIST_DIR, name))
        results = {}
        for device in ("cuda", "cpu"):
            model = build_model("float32", device, config)
            ctx = {k: v.to(device) for k, v in model.preprocess_context(
                {"text_prompts": prompts}).items() if isinstance(v, torch.Tensor)}
            ks = reset_launches()
            with torch.inference_mode():
                fwd = model.predict_score(x.to(device), {**ctx, "timestep": t.to(device)}).cpu()
            launched = {k: v.launches for k, v in ks.items() if v.launches}
            loss, _ = model.loss_on_batch(images.to(device), ctx, timesteps=t.to(device),
                                          noise=eps.to(device), deterministic=True)
            loss.backward()
            grads = {k: p.grad.detach().cpu()
                     for k, p in model.score_network().named_parameters()}
            results[device] = (fwd, loss.item(), global_norm(list(grads.values())).item(),
                               grads, launched, mmdit_counts(model))
            del model
        (f_gpu, l_gpu, n_gpu, g_gpu, launched, counts), (f_cpu, l_cpu, n_cpu, g_cpu, _, _) = (
            results["cuda"], results["cpu"])
        check(launched == counts, f"the card's {name} forward launched {launched}")
        err_f = rel_err(f_gpu, f_cpu)
        floor = 1e-3 * max(g.abs().max().item() for g in g_cpu.values())
        worst = max((rel_err(g_gpu[k], g_cpu[k], floor), k) for k in g_cpu)
        log(f"card vs CPU, {name} fp32: forward (batch {n}) max|diff| / max|out| = "
            f"{err_f:.3e} (tol 1e-4); loss {l_gpu:.7f} vs {l_cpu:.7f}, grad_norm {n_gpu:.6f} "
            f"vs {n_cpu:.6f}, worst gradient {worst[1]} at {worst[0]:.3e} (tol 1e-3)")
        check(err_f <= 1e-4, f"{name} forward card vs CPU: {err_f}")
        check(abs(l_gpu - l_cpu) <= 1e-5 * abs(l_cpu), f"{name} loss {l_gpu} vs {l_cpu}")
        check(abs(n_gpu - n_cpu) <= 1e-4 * abs(n_cpu), f"{name} grad_norm {n_gpu} vs {n_cpu}")
        check(worst[0] <= 1e-3, f"{name} gradient {worst[1]}: {worst[0]} > 1e-3")
        del results, g_gpu, g_cpu


def phase_mmdit_companions():
    """Each of MMDIT_COMPANIONS (fp32) with seeded random weights: the
    sampling CLI (TEXT_CLI_STEPS steps at batch TEXT_CLI_SAMPLES with the
    config's guidance; prompts "0" to "9", or DiffuSSM's classes, which its
    network ignores), launches against the code's counts (SD3.5 16 K5 a
    forward, Flux-DyT 18, Chewie its 12 single-stream blocks, DiffuSSM
    none), finite samples in [0, 1]; then TEXT_TRAIN_STEPS steps at batch
    TEXT_TRAIN_BATCH through the trainer's step, each step's launches
    against the code's counts. DiffuSSM's forward is profiled: its S4D
    convolutions run as cuFFT kernels on the card. Returns {config: (K5
    launches in its CLI run, K6 launches in its steps)}."""
    from torch.profiler import ProfilerActivity, profile

    from xdiffusion_tpu_torch import sample as cli
    from xdiffusion_tpu_torch.datasets.mnist import convert_labels_to_prompts
    from xdiffusion_tpu_torch.optim import default_optimizer
    from xdiffusion_tpu_torch.train_step import create_train_state, make_train_step
    from xdiffusion_tpu_torch.training.common import is_text_conditional

    out = {}
    for name in MMDIT_COMPANIONS:
        source = os.path.join(MNIST_DIR, name)
        out_dir = os.path.join(OUT_DIR, "mmdit_configs", name[:-5])
        os.makedirs(out_dir, exist_ok=True)
        model = build_model("float32", "cuda", source)
        texted = is_text_conditional(model)
        classed = bool(model.config().diffusion.score_network.params.get(
            "is_class_conditional", False))
        guidance = model.classifier_free_guidance()
        per_forward, per_step = mmdit_counts(model), mmdit_counts(model, training=True)
        ckpt = os.path.join(out_dir, "random_weights.pt")
        torch.save(model.score_network().state_dict(), ckpt)
        args = ["--config_path", source, "--checkpoint", ckpt, "--num_samples",
                str(TEXT_CLI_SAMPLES), "--sampling_steps", str(TEXT_CLI_STEPS), "--guidance",
                str(guidance), "--output_path", out_dir, "--seed", str(SEED)]
        if texted:
            args += ["--text_prompts", ",".join(digit_prompts(10))]
        ks = reset_launches()
        t0 = time.perf_counter()
        samples = cli.main(args)
        torch.cuda.synchronize()
        launches = {k: v.launches for k, v in ks.items()}
        expected = {k: TEXT_CLI_STEPS * per_forward.get(k, 0) for k in ks}
        log(f"{name} (fp32) through the sampling CLI, {TEXT_CLI_STEPS} steps at batch "
            f"{TEXT_CLI_SAMPLES}, guidance {guidance}: {time.perf_counter() - t0:.2f} s, "
            f"launches {launches}, expected {expected}, samples mean "
            f"{samples.float().mean().item():.4f}")
        check(launches == expected, f"{name}: launches {launches} != {expected}")
        check(tuple(samples.shape) == (TEXT_CLI_SAMPLES, 32, 32, 1), f"{name}: samples shape")
        check(bool(torch.isfinite(samples).all()), f"{name}: samples not finite")
        check(samples.min().item() >= 0.0 and samples.max().item() <= 1.0,
              f"{name}: samples outside [0, 1]")
        check(os.path.getsize(os.path.join(out_dir, "sample-step0.png")) > 0, f"{name}: no PNG")
        os.remove(ckpt)
        k5 = launches["flash_attention"]

        if not per_forward:
            x = torch.randn((TEXT_CLI_SAMPLES, 32, 32, 1), device="cuda")
            ctx = {"timestep": torch.full((TEXT_CLI_SAMPLES,), 500, device="cuda")}
            with torch.inference_mode():
                model.predict_score(x, ctx)
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    model.predict_score(x, ctx)
                    torch.cuda.synchronize()
            fft = [e for e in prof.key_averages()
                   if e.device_type.name == "CUDA" and "fft" in e.key.lower()]
            log(f"{name}: one forward at batch {TEXT_CLI_SAMPLES} ran "
                + ", ".join(f"{e.key[:60]} x{e.count}" for e in fft))
            check(sum(e.count for e in fft) > 0, f"{name}: no FFT kernel ran on the card")

        state = create_train_state(model, default_optimizer().build(
            model.score_network().parameters()), seed=SEED)
        train_step = make_train_step(model)
        losses = []
        k6 = 0
        t0 = time.perf_counter()
        for i in range(TEXT_TRAIN_STEPS):
            rng = np.random.default_rng((SEED, i))
            labels = rng.integers(0, 10, size=TEXT_TRAIN_BATCH)
            batch = {"images": torch.rand((TEXT_TRAIN_BATCH, 32, 32, 1), device="cuda")}
            if texted:
                ctx = model.preprocess_context(
                    {"text_prompts": convert_labels_to_prompts(labels, rng=rng)})
                batch.update({k: v.to("cuda") for k, v in ctx.items()
                              if isinstance(v, torch.Tensor)})
            if classed:
                batch["classes"] = torch.from_numpy(labels).to("cuda")
            ks = reset_launches()
            losses.append(train_step(state, batch)["loss"].item())
            launches = {k: v.launches for k, v in ks.items()}
            expected = {k: per_step.get(k, 0) for k in ks}
            check(launches == expected, f"{name} training step {i}: launches {launches} != "
                                        f"{expected}")
            k6 += launches["flash_attention_bwd"]
        log(f"{name} (fp32), {TEXT_TRAIN_STEPS} training steps at batch {TEXT_TRAIN_BATCH}: "
            f"{time.perf_counter() - t0:.2f} s, losses {[round(v, 4) for v in losses]}, "
            f"launches a step {per_step}")
        check(bool(np.isfinite(losses).all()), f"{name}: training losses {losses}")
        out[name] = (k5, k6)
        del model, state, train_step
    return out


# ---- phases 46-50: Sana (K5/K6 at head dim 576) and the super-resolution
# cascades (K1-K4 at their stages' sites) --------------------------------------

SANA_CONFIG = os.path.join(MNIST_DIR, "sana.yaml")
# Sana's cross-attention: 2 heads of 576 (d 1152), 16 image queries against
# the 300 caption keys, at the guided sampling batch (64 samples, forwards
# of 128) and in training (128); then Sq 1 and 17, Sk 1, 299 and 301, and
# a smaller batch.
SANA_FLASH_SITE = (128, 2, 16, 300, 576)
SANA_FLASH_MORE = [(3, 2, 1, 300, 576), (3, 2, 17, 300, 576), (3, 2, 16, 1, 576),
                   (3, 2, 16, 299, 576), (3, 2, 16, 301, 576), (32, 2, 16, 300, 576)]
SANA_BLOCKS = 12  # K5 calls a forward (K6 a training step): one a block
# Sana's training run: warm-up and timed steps, the resume's step, the run's
# length. Cut from the flagship's 5 / 20 / 25 / 30: the trainer embeds each
# step's 128 prompts on the host (300 x 2304 hash embeddings, about 2.3 s a
# step on an H100 80GB HBM3 machine's host), and the script's time limit
# holds every slice's phases (2 / 3 until the video UNets' phases came).
SANA_WARMUP, SANA_TIMED = 1, 1  # 1 / 2 until phases 72-75 came
SANA_RESUME = SANA_WARMUP + SANA_TIMED
SANA_TRAIN_STEPS = SANA_RESUME + 1
CASCADE_CONFIGS = ("ddpm_cascade_8x8_to_32x32.yaml", "imagen.yaml")
CASCADE_TRAIN_STEPS = 6  # 10 until phases 72-75 came


def sdpa_backends(q, k, v, scale: float) -> str:
    """Which of SDPA's backends take these operands, and the one its default
    dispatch picks."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    took = []
    names = ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION", "MATH")
    for backend in (getattr(SDPBackend, n) for n in names if hasattr(SDPBackend, n)):
        try:
            with sdpa_kernel(backend):
                F.scaled_dot_product_attention(q, k, v, scale=scale)
            took.append(backend.name)
        except RuntimeError:
            pass
    try:
        picked = SDPBackend(torch._fused_sdp_choice(q, k, v, scale=scale)).name
    except (AttributeError, RuntimeError, TypeError, ValueError):
        picked = "not reported by this torch"
    return f"backends that take it: {took}; the default dispatch picks {picked}"


def phase_sana_sites(logs):
    """K5 and K6 at head dim 576 (`flash_plan`'s wide variant, 9 warps of 64
    columns, 16-row streamed tiles): ptxas's registers and spills of its
    kernels; both against their plain versions at SANA_FLASH_SITE and
    SANA_FLASH_MORE in fp32 and bf16, on the operands as Sana's block hands
    them (q a head view of the (B, 16, 1152) query projection, k and v of
    the halves of the (B, 300, 2304) key-value projection:
    `check_caption_flash_sites`, phases 7's and 11's tolerances, each twice
    bit for bit). Then device times of K5 and K6 at the site, fp32 (the
    config's dtype) and bf16, beside the plain version, SDPA (its backward
    alone for K6; which backend takes D 576 logged) and the bound of
    `flash_bounds`, one call each. Returns {"K5"|"K6": record of one fp32
    call, "err": {"K5": e, "K6": e}}."""
    from xdiffusion_tpu_torch.ops import flash_attention as fa

    for name in ("flash_attention", "flash_attention_bwd"):
        ptxas_summary(f"{name} (head dims 256 and 576)", logs.get(name, ""), only="_wide")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 46)
    errs = check_caption_flash_sites([SANA_FLASH_SITE] + SANA_FLASH_MORE, gen)
    b, h, sq, sk, d = SANA_FLASH_SITE
    for dt in (torch.float32, torch.bfloat16):
        for backward in (False, True):
            plan = fa.flash_plan(b, h, sq, sk, d, dt, backward=backward)
            check(plan.variant == "wide" and all(
                ln.threads == 288 and ln.smem <= fa.SMEM_LIMIT for ln in plan.launches),
                f"K5/K6 at Sana's site {dt}: plan {plan}")
    out = {"err": errs}
    scale = d ** -0.5
    flops, exps = 4 * b * h * sq * sk * d, b * h * sq * sk
    for dt in (torch.float32, torch.bfloat16):
        q, k, v, g = caption_operands(gen, b, h, sq, sk, d, dt)
        o, lse = fa.flash_attention(q, k, v, scale)
        args = (q, k, v, o, lse, g, scale)
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        sdpa_o = F.scaled_dot_product_attention(*leaves, scale=scale)
        item = q.element_size()
        if dt == torch.float32:
            log(f"SDPA at Sana's site B={b} H={h} Sq={sq} Sk={sk} D={d} fp32: "
                + sdpa_backends(q, k, v, scale))
        for kernel, fn, plain, lib, nbytes, kflops in (
                ("K5", lambda: fa.flash_attention(q, k, v, scale),
                 lambda: fa.flash_attention_plain(q, k, v, scale),
                 lambda: F.scaled_dot_product_attention(q, k, v, scale=scale),
                 (2 * q.numel() + k.numel() + v.numel()) * item + lse.numel() * 4, flops),
                ("K6", lambda: fa.flash_attention_bwd(*args),
                 lambda: fa.flash_attention_bwd_plain(*args),
                 lambda: torch.autograd.grad(sdpa_o, leaves, g, retain_graph=True),
                 (4 * q.numel() + 4 * k.numel()) * item + lse.numel() * 4, 10 * flops // 4)):
            k_ms, p_ms, l_ms = device_ms(fn), device_ms(plain), device_ms(lib)
            bd = flash_bounds(kflops, exps, nbytes, dt)
            dtn = "fp32" if dt == torch.float32 else "bf16"
            log(f"{kernel} at Sana's cross-attention site B={b} H={h} Sq={sq} Sk={sk} D={d} "
                f"{dtn}, one call: {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
                f"SDPA{' backward' if kernel == 'K6' else ''} {l_ms:.4f} ms, bound "
                f"{bd['bound_ms']:.4f} ms ({bd['binds']}; bytes {bd['bytes_ms']:.4f}), "
                f"{nbytes / k_ms / 1e6:.0f} GB/s; x{SANA_BLOCKS} a "
                f"{'forward' if kernel == 'K5' else 'training step'}: "
                f"{SANA_BLOCKS * k_ms:.4f} ms")
            if dt == torch.float32:
                out[kernel] = {"ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
                               "bound_ms": bd["bound_ms"],
                               "bound_by": "bytes" if bd["binds"] == "bytes" else "operations"}
            else:
                out[kernel]["bf16"] = {"ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
                                       "bound_ms": bd["bound_ms"]}
        del q, k, v, g, o, lse, args, leaves, sdpa_o
    return out


def sana_counts(training: bool = False):
    counts = {"flash_attention": SANA_BLOCKS}
    if training:
        counts["flash_attention_bwd"] = SANA_BLOCKS
    return counts


def phase_sana_sampling():
    """sana.yaml as shipped (fp32, d 1152, 12 blocks) with seeded random
    weights through the sampling CLI: GRID_STEPS ancestral steps at batch
    DIT_BATCH with prompts "0" to "9" in turn and the config's guidance
    (one forward on 2 x DIT_BATCH samples a step): 12 K5 calls a forward,
    each at SANA_FLASH_SITE, and nothing else of the port's kernels; finite
    samples in [0, 1], the PNG; samples/s over the sampler's loop; a profile
    of one guided forward (output/chip_smoke/sana_profile.txt). Returns (K5
    launches, samples/s, the forward's (wall, busy) ms)."""
    from xdiffusion_tpu_torch import sample as cli
    from xdiffusion_tpu_torch.diffusion.ddpm import GaussianDiffusion_DDPM

    out_dir = os.path.join(OUT_DIR, "sana")
    os.makedirs(out_dir, exist_ok=True)
    model = build_model("float32", "cuda", SANA_CONFIG)
    guidance = model.classifier_free_guidance()
    prompts = digit_prompts(DIT_BATCH)
    x = torch.randn((2 * DIT_BATCH, 32, 32, 1), device="cuda")
    ctx = mmdit_context(model, prompts, guided=True, t=500)
    with torch.inference_mode():
        calls = flash_calls(lambda: model.predict_score(x, ctx))
    check(calls == [SANA_FLASH_SITE] * SANA_BLOCKS, f"sana: K5 calls {calls}")
    ckpt = os.path.join(out_dir, "random_weights.pt")
    torch.save(model.score_network().state_dict(), ckpt)

    timing, original = {}, GaussianDiffusion_DDPM.sample

    def timed(self, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = original(self, *args, **kwargs)
        torch.cuda.synchronize()
        timing["s"] = time.perf_counter() - t0
        return result

    ks = reset_launches()
    GaussianDiffusion_DDPM.sample = timed
    try:
        samples = cli.main(["--config_path", SANA_CONFIG, "--checkpoint", ckpt, "--num_samples",
                            str(DIT_BATCH), "--sampling_steps", str(GRID_STEPS), "--guidance",
                            str(guidance), "--text_prompts", ",".join(digit_prompts(10)),
                            "--output_path", out_dir, "--seed", str(SEED)])
    finally:
        GaussianDiffusion_DDPM.sample = original
    launches = {k: v.launches for k, v in ks.items()}
    expected = {k: GRID_STEPS * sana_counts().get(k, 0) for k in ks}
    sps = DIT_BATCH / timing["s"]
    log(f"sana.yaml main path (fp32) through the sampling CLI: {GRID_STEPS}-step ancestral, "
        f"batch {DIT_BATCH}, guidance {guidance} (forwards of {2 * DIT_BATCH}): sampling "
        f"{timing['s']:.2f} s, {sps:.3f} samples/s, launches {launches}, expected {expected}")
    check(launches == expected, f"sana: launches {launches} != {expected}")
    check(tuple(samples.shape) == (DIT_BATCH, 32, 32, 1), f"sana: samples {samples.shape}")
    check(bool(torch.isfinite(samples).all()), "sana: samples not finite")
    check(samples.min().item() >= 0.0 and samples.max().item() <= 1.0,
          "sana: samples outside [0, 1]")
    check(os.path.getsize(os.path.join(out_dir, "sample-step0.png")) > 0, "sana: no PNG")
    log(f"sana samples: mean {samples.mean().item():.4f} std {samples.std().item():.4f}")
    os.remove(ckpt)

    with torch.inference_mode():
        for _ in range(3):
            model.predict_score(x, ctx)
        ks = reset_launches()
        fwd = profile_text(f"one guided sana forward ({2 * DIT_BATCH} samples, fp32)",
                           lambda: model.predict_score(x, ctx).sum().item(), "sana_profile.txt",
                           expect={"K1": 0, "K5": SANA_BLOCKS})
    one = {k: v.launches for k, v in ks.items() if v.launches}
    check(one == sana_counts(), f"one sana forward launched {one}")
    return launches["flash_attention"], sps, fwd


def phase_sana_training():
    """sana.yaml (fp32) at batch TRAIN_BATCH: a profile of one training step
    with prompts (output/chip_smoke/sana_train_profile.txt; 12 K5 and 12 K6),
    then SANA_TRAIN_STEPS steps through `train()` with prompts from the
    digits' labels (the config's guidance drop on): launches against the
    code's counts (and the two grids' GRID_STEPS unguided forwards), every
    step's loss and grad_norm, steps/s over steps SANA_WARMUP to
    SANA_RESUME - 1, checkpoints and grids; then a resume from step
    SANA_RESUME that must repeat that step's loss bit for bit. Returns (K6
    launches, steps/s, the step's (wall, busy) ms)."""
    import shutil

    from xdiffusion_tpu_torch.datasets.mnist import convert_labels_to_prompts
    from xdiffusion_tpu_torch.optim import default_optimizer
    from xdiffusion_tpu_torch.train_step import create_train_state, make_train_step
    from xdiffusion_tpu_torch.training.image.train import train

    model = build_model("float32", "cuda", SANA_CONFIG)
    labels = np.random.default_rng(SEED).integers(0, 10, size=TRAIN_BATCH)
    ctx = model.preprocess_context({"text_prompts": convert_labels_to_prompts(
        labels, rng=np.random.default_rng(SEED))})
    state = create_train_state(model, default_optimizer().build(
        model.score_network().parameters()), seed=SEED)
    step = make_train_step(model)
    batch = {"images": torch.rand((TRAIN_BATCH, 32, 32, 1), device="cuda"),
             **{k: v.to("cuda") for k, v in ctx.items() if isinstance(v, torch.Tensor)}}
    step(state, batch)  # a warm-up (two until phases 72-75 came)
    ks = reset_launches()
    step_prof = profile_text(f"one sana training step (batch {TRAIN_BATCH}, fp32)",
                             lambda: step(state, batch)["loss"].item(),
                             "sana_train_profile.txt", expect={"K1": 0, "K5": SANA_BLOCKS})
    one = {k: v.launches for k, v in ks.items() if v.launches}
    check(one == sana_counts(training=True), f"one sana training step launched {one}")
    del model, state, step, batch

    root = os.path.join(OUT_DIR, "sana_train")
    shutil.rmtree(root, ignore_errors=True)
    common = dict(batch_size=TRAIN_BATCH, save_and_sample_every_n=SANA_RESUME,
                  num_samples=NUM_SAMPLES, seed=SEED, device="cuda", log_every=1)
    ks = reset_launches()
    t0 = time.perf_counter()
    out_dir = train(SANA_CONFIG, num_training_steps=SANA_TRAIN_STEPS,
                    output_path=os.path.join(root, "run"), **common)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {k: v.launches for k, v in ks.items()}
    expected = {k: SANA_TRAIN_STEPS * sana_counts(True).get(k, 0)
                + 2 * GRID_STEPS * sana_counts().get(k, 0) for k in ks}
    log(f"sana training ({SANA_TRAIN_STEPS} steps at batch {TRAIN_BATCH} + 2 x {GRID_STEPS}-"
        f"step grids of {NUM_SAMPLES}, {run_s:.1f} s): launches {launches}, expected "
        f"{expected}")
    check(launches == expected, f"sana training launches {launches} != {expected}")
    metrics = read_metrics(out_dir)
    check(sorted(metrics) == list(range(SANA_TRAIN_STEPS)), "sana metrics.jsonl misses steps")
    check(all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in metrics.values()),
          "sana loss or grad_norm not finite")
    log("sana losses: " + " ".join(f"{metrics[i]['loss']:.4f}"
                                   for i in range(SANA_TRAIN_STEPS)))
    span = metrics[SANA_RESUME - 1]["time"] - metrics[SANA_WARMUP - 1]["time"]
    sps = SANA_TIMED / span
    log(f"sana training throughput: {sps:.3f} steps/s (steps {SANA_WARMUP}-"
        f"{SANA_RESUME - 1}, batch {TRAIN_BATCH}, fp32, prompts embedded on the host each step)")
    for name in (f"checkpoints/{SANA_RESUME}.pt", f"checkpoints/{SANA_TRAIN_STEPS}.pt",
                 f"sample-{SANA_RESUME}.png", f"sample-{SANA_TRAIN_STEPS}.png"):
        check(os.path.getsize(os.path.join(out_dir, name)) > 0, f"sana train wrote no {name}")
    with resumed_run():
        resumed = train(SANA_CONFIG, num_training_steps=SANA_RESUME + 1,
                        output_path=os.path.join(root, "resumed"),
                        resume_from=os.path.join(out_dir, "checkpoints", f"{SANA_RESUME}.pt"),
                        **common)
    want, got = metrics[SANA_RESUME]["loss"], read_metrics(resumed)[SANA_RESUME]["loss"]
    log(f"sana resume from step {SANA_RESUME}: loss {got!r} against the uninterrupted run's "
        f"{want!r}")
    check(got == want, "sana: the resumed step's loss differs")
    return launches["flash_attention_bwd"], sps, step_prof


def phase_sana_card_vs_cpu():
    """sana.yaml (fp32, full width, the same seeded weights, no guidance
    drop) card against CPU: one forward at batch 2 with prompts and
    injected times (K5 against its plain version at head dim 576), then one
    loss and backward with injected times and noise (K6): the forward to
    1e-4 of its scale, the loss to 1e-5 relative, the gradient norm to 1e-4
    and every gradient to 1e-3 of its scale (floored at 1e-3 of the
    largest); TF32 off on the card."""
    from xdiffusion_tpu_torch.optim import global_norm

    n = 2
    prompts = digit_prompts(n)
    rng = np.random.default_rng(SEED + 49)
    x = torch.from_numpy(rng.standard_normal((n, 32, 32, 1)).astype(np.float32))
    t = torch.from_numpy(rng.integers(0, 1000, size=n))
    images = torch.from_numpy(rng.random((n, 32, 32, 1)).astype(np.float32))
    eps = torch.from_numpy(rng.standard_normal((n, 32, 32, 1)).astype(np.float32))
    config = no_drop_config(SANA_CONFIG)
    results = {}
    for device in ("cuda", "cpu"):
        model = build_model("float32", device, config)
        ctx = {k: v.to(device) for k, v in model.preprocess_context(
            {"text_prompts": prompts}).items() if isinstance(v, torch.Tensor)}
        ks = reset_launches()
        with torch.inference_mode():
            fwd = model.predict_score(x.to(device), {**ctx, "timestep": t.to(device)}).cpu()
        launched = {k: v.launches for k, v in ks.items() if v.launches}
        loss, _ = model.loss_on_batch(images.to(device), ctx, timesteps=t.to(device),
                                      noise=eps.to(device), deterministic=True)
        loss.backward()
        grads = {k: p.grad.detach().cpu() for k, p in model.score_network().named_parameters()}
        results[device] = (fwd, loss.item(), global_norm(list(grads.values())).item(), grads,
                           launched)
        del model
    (f_gpu, l_gpu, n_gpu, g_gpu, launched), (f_cpu, l_cpu, n_cpu, g_cpu, _) = (
        results["cuda"], results["cpu"])
    check(launched == sana_counts(), f"the card's sana forward launched {launched}")
    err_f = rel_err(f_gpu, f_cpu)
    floor = 1e-3 * max(g.abs().max().item() for g in g_cpu.values())
    worst = max((rel_err(g_gpu[k], g_cpu[k], floor), k) for k in g_cpu)
    log(f"card vs CPU, sana.yaml fp32: forward (batch {n}) max|diff| / max|out| = {err_f:.3e} "
        f"(tol 1e-4); loss {l_gpu:.7f} vs {l_cpu:.7f}, grad_norm {n_gpu:.6f} vs {n_cpu:.6f}, "
        f"worst gradient {worst[1]} at {worst[0]:.3e} (tol 1e-3)")
    check(err_f <= 1e-4, f"sana forward card vs CPU: {err_f}")
    check(abs(l_gpu - l_cpu) <= 1e-5 * abs(l_cpu), f"sana loss {l_gpu} vs {l_cpu}")
    check(abs(n_gpu - n_cpu) <= 1e-4 * abs(n_cpu), f"sana grad_norm {n_gpu} vs {n_cpu}")
    check(worst[0] <= 1e-3, f"sana gradient {worst[1]}: {worst[0]} > 1e-3")


def build_cascade(name: str, device: str):
    """The cascade as shipped on `device`, every stage's network redrawn from
    SEED (the same weights on the card and on the CPU)."""
    from xdiffusion_tpu_torch.config import load_yaml
    from xdiffusion_tpu_torch.training.image.train import build_model as build
    from xdiffusion_tpu_torch.weights import randomize_

    model = build(load_yaml(os.path.join(MNIST_DIR, name)), device=device)
    randomize_(model.score_network(), SEED)
    return model


def stage_context(stage, b: int, guided: bool, prompts=None):
    """One forward's context for a cascade stage on the card: the timestep,
    a super-resolution stage's conditioning and augmentation timestep, the
    prompts' tokens (guided: the empty prompts' after them)."""
    n = 2 * b if guided else b
    ctx = {"timestep": torch.full((n,), 500, device="cuda")}
    if prompts is not None:
        toks = stage.preprocess_context({"text_prompts": prompts})["text_tokens"]
        if guided:
            toks = torch.cat([toks, torch.zeros_like(toks)])
        ctx["text_tokens"] = toks.to("cuda")
    cfg = stage.config()
    if "super_resolution" in cfg:
        sr = cfg.super_resolution
        ctx[sr.conditioning_key] = torch.rand((n, sr.low_resolution_size, sr.low_resolution_size,
                                               1), device="cuda")
        ctx["augmentation_timestep"] = torch.full((n,), 100, device="cuda")
        ctx["augmentation_noise"] = torch.randn((n, 32, 32, 1), device="cuda")
    return ctx


def stage_forward(stage, b: int, guided: bool = False, prompts=None):
    """A closure running one forward of `stage` at batch b (2b guided)."""
    cfg = stage.config()
    size = cfg.data.image_size
    n = 2 * b if guided else b
    ctx = stage_context(stage, b, guided, prompts)

    def run():
        with torch.inference_mode():
            x = torch.randn((n, size, size, 1), device="cuda")
            c = dict(ctx)
            stage.predict_score(stage.process_input(x, c), c)
    return run


def check_k4_sites(sites, gen):
    """K4 at each distinct (x shape, Co, residual) of `sites` against its
    plain version in fp32 (1e-4 of the largest output: 9C products summed in
    another order), twice bit for bit. Returns the largest error."""
    from xdiffusion_tpu_torch.ops import fused_resblock

    err = 0.0
    for (shape, co, has_res) in counted(sites):
        b, h, w, c = shape
        x = torch.randn(shape, generator=gen, device="cuda")
        a = 1.0 + 0.2 * torch.randn((b, c), generator=gen, device="cuda")
        off = 0.2 * torch.randn((b, c), generator=gen, device="cuda")
        kw = torch.randn((3, 3, c, co), generator=gen, device="cuda") * (9 * c) ** -0.5
        bias = 0.1 * torch.randn((co,), generator=gen, device="cuda")
        res = torch.randn((b, h, w, co), generator=gen, device="cuda") if has_res else None
        want = fused_resblock.affine_silu_conv3x3_plain(x, a, off, kw, bias, res)
        got = fused_resblock.affine_silu_conv3x3(x, a, off, kw, bias, res)
        label = f"K4 x={shape} Co={co} residual={has_res} fp32"
        check_repeats(label, (got,), (fused_resblock.affine_silu_conv3x3(x, a, off, kw, bias,
                                                                          res),))
        err = max(err, compare(label, got, want, 1e-4 * max(1.0, want.abs().max().item())))
    return err


def phase_cascade_sites():
    """Both cascades as shipped (fp32): the sites of one forward of each stage
    at batch BATCH (guided for imagen: forwards of 2 x BATCH) and one
    training forward at TRAIN_BATCH, read by hooks and from K1's arguments;
    K1/K2 at every distinct attention call (`check_bsc_sites`), K3 at every
    distinct GroupNorm site, fp32 and bf16 (`k3_compare`; the Efficient
    UNet's run down to 2x2 maps), K4 at every distinct conv site of the UNet
    stages (`check_k4_sites`), each twice bit for bit; the cascades' resize
    card against CPU. Returns ({config: [per stage (forward counts, training
    counts)]}, {"K1"|"K2"|"K3"|"K4": err})."""
    from xdiffusion_tpu_torch.layers.super_resolution import resize_bilinear as resize

    gen = torch.Generator(device="cuda").manual_seed(SEED + 50)
    errs = {"K1": 0.0, "K2": 0.0, "K3": 0.0, "K4": 0.0}
    counts, bsc_shapes, gn_sites, conv_sites = {}, set(), [], []
    for name in CASCADE_CONFIGS:
        model = build_cascade(name, "cuda")
        text = name == "imagen.yaml"
        counts[name] = []
        for stage in model.models():
            per = {}
            for key, b, guided, training in (("forward", BATCH, text, False),
                                             ("training", TRAIN_BATCH, False, True)):
                prompts = digit_prompts(b) if text else None
                run = stage_forward(stage, b, guided, prompts)
                stage.score_network().train(training)
                sites = main_path_sites(stage, run=run)
                bsc_shapes.update(bsc_calls(run))
                stage.score_network().eval()
                per[key] = per_call_counts(sites, training=training)
                gn_sites += sites["group_norm_silu"]
                conv_sites += sites["affine_silu_conv3x3"]
            log(f"{name} stage {type(stage.score_network()).__module__.rsplit('.', 1)[-1]} "
                f"({stage.config().data.image_size} px): launches a forward {per['forward']}, "
                f"a training step {per['training']}")
            counts[name].append(per)
        del model
    log(f"cascade K1 calls (B, Sq, Sk, C, heads): {sorted(bsc_shapes)}")
    errs.update(check_bsc_sites(sorted(bsc_shapes), gen))
    seen = set()
    for site in counted(gn_sites):
        _, _, _, e = k3_compare("cascade", site, gen, seen)
        errs["K3"] = max(errs["K3"], e[torch.float32])
    check(any(s[0][1] * s[0][2] == 4 for s in counted(gn_sites)),
          "no K3 site at the Efficient UNet's 2x2 maps")
    errs["K4"] = check_k4_sites(conv_sites, gen)
    x = torch.rand((BATCH, 32, 32, 1), generator=gen, device="cuda")
    for size in (8, 16):
        small = resize(x, size)
        diff = max((small.cpu() - resize(x.cpu(), size)).abs().max().item(),
                   (resize(small, 32).cpu() - resize(small.cpu(), 32)).abs().max().item())
        log(f"resize 32 -> {size} -> 32 card vs CPU: max|diff| {diff:.3e} (tol 1e-6)")
        check(diff <= 1e-6, f"resize card vs CPU: {diff}")
    return counts, errs


def phase_cascade_runs(counts):
    """Each cascade (fp32) through the trainer (CASCADE_TRAIN_STEPS steps at
    TRAIN_BATCH, both stages in each step, prompts from the labels for
    imagen; its end grid of NUM_SAMPLES chained through both stages for
    GRID_STEPS steps each) and the sampling CLI (batch BATCH, GRID_STEPS
    steps a stage, imagen with prompts and its guidance): launches against
    the stages' counts, finite losses with both stages', checkpoint and
    grid, samples/s. Returns {config: (launches of the training run,
    launches of the CLI run, steps/s, samples/s)}."""
    import shutil

    from xdiffusion_tpu_torch import sample as cli
    from xdiffusion_tpu_torch.training.image.train import train

    out = {}
    for name in CASCADE_CONFIGS:
        stem = name[:-5]
        source = os.path.join(MNIST_DIR, name)
        text = name == "imagen.yaml"
        root = os.path.join(OUT_DIR, f"{stem}_train")
        shutil.rmtree(root, ignore_errors=True)
        ks = reset_launches()
        t0 = time.perf_counter()
        run_dir = train(source, num_training_steps=CASCADE_TRAIN_STEPS, batch_size=TRAIN_BATCH,
                        save_and_sample_every_n=CASCADE_TRAIN_STEPS, num_samples=NUM_SAMPLES,
                        seed=SEED, device="cuda", log_every=1, output_path=root)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        train_launches = {k: v.launches for k, v in ks.items()}
        expected = {k: sum(CASCADE_TRAIN_STEPS * s["training"].get(k, 0)
                           + GRID_STEPS * s["forward"].get(k, 0) for s in counts[name])
                    for k in ks}
        log(f"{name} training ({CASCADE_TRAIN_STEPS} steps at batch {TRAIN_BATCH}, both stages "
            f"a step, + a {GRID_STEPS}-step chained grid of {NUM_SAMPLES}; {run_s:.1f} s): "
            f"launches {train_launches}, expected {expected}")
        check(train_launches == expected, f"{name} training launches {train_launches}")
        metrics = read_metrics(run_dir)
        check(sorted(metrics) == list(range(CASCADE_TRAIN_STEPS)), f"{name}: metrics miss steps")
        check(all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
                  for r in metrics.values()), f"{name}: loss or grad_norm not finite")
        last = CASCADE_TRAIN_STEPS - 1
        sps = (last - 1) / (metrics[last]["time"] - metrics[1]["time"])
        log(f"{name} losses: " + " ".join(f"{metrics[i]['loss']:.4f}"
                                         for i in range(CASCADE_TRAIN_STEPS))
            + f"; {sps:.3f} steps/s (steps 2-{last})")
        ckpt = os.path.join(run_dir, "checkpoints", f"{CASCADE_TRAIN_STEPS}.pt")
        keys = torch.load(ckpt, map_location="cpu", weights_only=True)["params"].keys()
        check({k.split(".")[0] for k in keys} == {"stage_1", "stage_2"},
              f"{name}: the checkpoint holds {sorted({k.split('.')[0] for k in keys})}")
        check(os.path.getsize(os.path.join(run_dir, f"sample-{CASCADE_TRAIN_STEPS}.png")) > 0,
              f"{name}: no grid")

        out_dir = os.path.join(OUT_DIR, stem)
        args = ["--config_path", source, "--checkpoint", ckpt, "--num_samples", str(BATCH),
                "--sampling_steps", str(GRID_STEPS), "--output_path", out_dir,
                "--seed", str(SEED)]
        if text:
            args += ["--text_prompts", ",".join(digit_prompts(10)), "--guidance", "1.0"]
        ks = reset_launches()
        t0 = time.perf_counter()
        samples = cli.main(args)
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        cli_launches = {k: v.launches for k, v in ks.items()}
        expected = {k: sum(GRID_STEPS * s["forward"].get(k, 0) for s in counts[name])
                    for k in ks}
        log(f"{name} through the sampling CLI ({GRID_STEPS} steps a stage at batch {BATCH}"
            f"{', guided' if text else ''}; {cli_s:.1f} s, {BATCH / cli_s:.3f} samples/s with "
            f"set-up): launches {cli_launches}, expected {expected}; samples mean "
            f"{samples.mean().item():.4f}")
        check(cli_launches == expected, f"{name} CLI launches {cli_launches}")
        check(tuple(samples.shape) == (BATCH, 32, 32, 1) and bool(torch.isfinite(samples).all())
              and samples.min().item() >= 0.0 and samples.max().item() <= 1.0,
              f"{name}: samples {tuple(samples.shape)}")
        check(os.path.getsize(os.path.join(out_dir, f"sample-step{CASCADE_TRAIN_STEPS}.png")) > 0,
              f"{name}: the CLI wrote no PNG")
        out[name] = (train_launches, cli_launches, sps, BATCH / cli_s)
    return out


def phase_cascade_card_vs_cpu():
    """Each cascade (fp32, the same seeded weights) card against CPU: the SR
    stage's loss at batch 2 with injected timesteps, noise, augmentation
    timesteps and augmentation noise (dropout and the guidance drop off),
    its backward's gradient norm; then a 10-step chained sample of both
    stages with every draw injected (initial, per-step and per-step
    augmentation noise; imagen with prompts and guidance). The loss to 1e-5
    relative, the gradient norm to 1e-4, the samples to 1e-3 (in [0, 1])."""
    from xdiffusion_tpu_torch.layers.super_resolution import resize_bilinear
    from xdiffusion_tpu_torch.optim import global_norm

    n, steps = 2, 10
    rng = np.random.default_rng(SEED + 51)
    images = torch.from_numpy(rng.random((n, 32, 32, 1)).astype(np.float32))
    inject = {"timesteps": torch.from_numpy(rng.integers(0, 1000, size=n)),
              "noise": torch.from_numpy(rng.standard_normal((n, 32, 32, 1)).astype(np.float32))}
    aug = {"augmentation_timestep": torch.from_numpy(rng.integers(0, 1000, size=n)),
           "augmentation_noise": torch.from_numpy(
               rng.standard_normal((n, 32, 32, 1)).astype(np.float32))}
    for name in CASCADE_CONFIGS:
        text = name == "imagen.yaml"
        results = {}
        for device in ("cuda", "cpu"):
            model = build_cascade(name, device)
            stage = model.models()[1]
            stage._unconditional_guidance_probability = 0.0
            ctx = model.preprocess_context({"text_prompts": digit_prompts(n)}) if text else {}
            ctx = {k: v.to(device) for k, v in ctx.items() if isinstance(v, torch.Tensor)}
            ctx["low_resolution_images"] = resize_bilinear(images, 8).to(device)
            ctx.update({k: v.to(device) for k, v in aug.items()})
            loss, _ = stage.loss_on_batch(images.to(device), ctx, deterministic=True,
                                          **{k: v.to(device) for k, v in inject.items()})
            loss.backward()
            gnorm = global_norm([p.grad for p in stage.score_network().parameters()]).item()
            stage_noise = []
            for k, layer in enumerate(model.models()):
                size = layer.config().data.image_size
                srng = np.random.default_rng((SEED, k))
                shape = (n, size, size, 1)
                one = {"initial_noise": torch.from_numpy(
                    srng.standard_normal(shape).astype(np.float32)),
                    "context": {"sampling_noise": torch.from_numpy(
                        srng.standard_normal((steps,) + shape).astype(np.float32))}}
                if "super_resolution" in layer.config():
                    rows = 2 * n if text else n
                    one["context"]["sampling_augmentation_noise"] = torch.from_numpy(
                        srng.standard_normal((steps, rows, size, size, 1)).astype(np.float32))
                stage_noise.append(one)
            samples = model.sample(num_samples=n, num_sampling_steps=steps,
                                   context={"text_prompts": digit_prompts(n)} if text else {},
                                   classifier_free_guidance=1.0 if text else None,
                                   stage_noise=stage_noise).cpu()
            results[device] = (loss.item(), gnorm, samples)
            del model, stage
        (l_gpu, g_gpu, s_gpu), (l_cpu, g_cpu, s_cpu) = results["cuda"], results["cpu"]
        diff = (s_gpu - s_cpu).abs().max().item()
        log(f"card vs CPU, {name} fp32: SR-stage loss {l_gpu:.7f} vs {l_cpu:.7f}, grad_norm "
            f"{g_gpu:.6f} vs {g_cpu:.6f}; a {steps}-step chained sample max|diff| {diff:.3e} "
            f"(tol 1e-3)")
        check(abs(l_gpu - l_cpu) <= 1e-5 * abs(l_cpu), f"{name} loss {l_gpu} vs {l_cpu}")
        check(abs(g_gpu - g_cpu) <= 1e-4 * abs(g_cpu), f"{name} grad_norm {g_gpu} vs {g_cpu}")
        check(diff <= 1e-3, f"{name} chained sample card vs CPU: {diff}")



# ---- phases 51-55: the video UNets ------------------------------------------------

VIDEO_DIR = os.path.join(ROOT, "configs/video/moving_mnist")
VDM_CONFIG = os.path.join(VIDEO_DIR, "video_diffusion_models.yaml")
VIDEO_COMPANIONS = ("imagen_video_8x16x16.yaml", "make_a_video.yaml", "video_ldm.yaml",
                    "animate_diff.yaml")
# The video CLIs' default batch; video_diffusion_models.yaml's training run
# (a resume from VIDEO_RESUME repeats its last steps) and the ancestral
# steps of its sampling-CLI run, of the config's 1024; the companions'
# training steps and CLI steps; the trainer's frame strips' steps.
VIDEO_BATCH = 8
VIDEO_TRAIN_STEPS, VIDEO_RESUME = 6, 3  # 10, 5 until phases 72-75 came
VIDEO_SAMPLING_STEPS = 10  # 15 until phases 72-75 came
VIDEO_COMPANION_STEPS, VIDEO_CLI_STEPS, VIDEO_STRIP_STEPS = 3, 3, 3  # 3, 5, 5 until phases 72-75 came
# K1 (B, Sq, Sk, C, heads) at batch 8: video_diffusion_models.yaml's
# spatial attention at 16x16, 8x8 and its middle 4x4 over B*F = 128 maps;
# make_a_video.yaml's 16x16 cross-attention (77 caption keys before the 256
# image keys); imagen_video_8x16x16.yaml's 4x4 cross-attention at B*F = 64.
VIDEO_K1_SITES = [(128, 256, 256, 256, 4), (128, 64, 64, 256, 4), (128, 16, 16, 256, 4),
                  (128, 256, 333, 256, 4), (64, 16, 93, 256, 4)]
# K5/K6 (B, H, Sq, Sk, D): animate_diff.yaml's motion attention at its 32x32
# stages, B*H*W sequences of 16 frames at batch 8 (B*H = 16,384), and under
# guidance at batch 8 (B*H = 32,768); ragged: 9 frames, 3 sequences.
MOTION_SITE = (8192, 2, 16, 16, 64)
MOTION_MORE = [(16384, 2, 16, 16, 64), (3, 2, 9, 9, 64)]


def build_video(path: str, device: str):
    """The video config as shipped on `device`, its network redrawn from SEED
    (the same weights on the card and on the CPU)."""
    from xdiffusion_tpu_torch.config import load_yaml
    from xdiffusion_tpu_torch.training.image.train import build_model as build
    from xdiffusion_tpu_torch.weights import randomize_

    model = build(load_yaml(path), device=device)
    randomize_(model.score_network(), SEED)
    return model


def video_context(model, b: int, device: str = "cuda"):
    """The prompts' tensors of a text-conditional video config (else {})."""
    from xdiffusion_tpu_torch.training.common import is_text_conditional

    if not is_text_conditional(model):
        return {}
    ctx = model.preprocess_context({"text_prompts": digit_prompts(b)})
    return {k: v.to(device) for k, v in ctx.items() if isinstance(v, torch.Tensor)}


def video_step(model, b: int, seed: int = SEED):
    """A closure: one training loss and backward at batch b (dropout on,
    drawn from a generator), as the trainer's step runs it."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    shape = model.sampling_shape(b)
    images = torch.rand(shape, generator=gen, device="cuda")
    ctx = video_context(model, b)

    def run():
        loss, _ = model.loss_on_batch(images, ctx, generator=gen)
        loss.backward()
    return run


def video_counts(model, run, training: bool = False):
    """Launches per forward (or, `training`, per training step) that the
    network's structure implies, read by hooks during `run()`: K1 at every
    `SpatialCrossAttention`, K3 at every plain-form GroupNorm with per-frame
    statistics, K4 at every fused convolution (conv2 leaves it while
    dropping), K5 at every `MotionSelfAttention`; in training K2 and K6
    beside each K1 and K5 whose output needs a gradient (all of them unless
    parameters are frozen). Also the K3 sites (x's shape, groups, silu,
    eps)."""
    from xdiffusion_tpu_torch.layers.attention import SpatialCrossAttention
    from xdiffusion_tpu_torch.layers.resnet import FastGroupNorm, FusedAffineConv
    from xdiffusion_tpu_torch.score_networks.animate_diff import MotionSelfAttention

    counts = dict.fromkeys(("bsc_attention", "group_norm_silu", "affine_silu_conv3x3",
                            "flash_attention"), 0)
    backward = {"bsc_attention": 0, "flash_attention": 0}
    gn_sites = []

    def on_norm(mod, args, kwargs, out):
        if (mod.stat_frames == 1 and not kwargs.get("return_coefficients")
                and kwargs.get("t_scale") is None):
            counts["group_norm_silu"] += 1
            gn_sites.append((tuple(args[0].shape), mod.num_groups, mod.silu, mod.epsilon))

    def counter(key):
        def fn(mod, args, kwargs, out):
            counts[key] += 1
            if key in backward and out.requires_grad:
                backward[key] += 1
        return fn

    hooks = []
    for m in model.score_network().modules():
        fn = {SpatialCrossAttention: counter("bsc_attention"), FastGroupNorm: on_norm,
              FusedAffineConv: counter("affine_silu_conv3x3"),
              MotionSelfAttention: counter("flash_attention")}.get(type(m))
        if fn is not None:
            hooks.append(m.register_forward_hook(fn, with_kwargs=True))
    try:
        run()
    finally:
        for h in hooks:
            h.remove()
    if training:
        counts["bsc_attention_bwd"] = backward["bsc_attention"]
        counts["flash_attention_bwd"] = backward["flash_attention"]
    return {k: v for k, v in counts.items() if v}, gn_sites


def video_structure(model, b: int = 2):
    """(per-forward counts, per-training-step counts, K3 sites of both) of a
    video config: one sampling step at batch b (with prompts for a
    text-conditional config), one training step."""
    from xdiffusion_tpu_torch.training.common import is_text_conditional

    ctx = {"text_prompts": digit_prompts(b)} if is_text_conditional(model) else {}
    fwd, fwd_sites = video_counts(
        model, lambda: model.sample(num_samples=b, num_sampling_steps=1, context=ctx))
    model.score_network().train()
    step, step_sites = video_counts(model, video_step(model, b), training=True)
    model.score_network().zero_grad(set_to_none=True)
    model.score_network().eval()
    return fwd, step, fwd_sites + step_sites


def add_counts(total, counts, times: int = 1):
    for k, v in counts.items():
        total[k] = total.get(k, 0) + times * v
    return total


def motion_operands(gen, b: int, h: int, sq: int, sk: int, d: int, dt):
    """K5's and K6's operands as MotionSelfAttention gives them: head views
    of (B*H*W, F, heads, D) projections; and a cotangent."""
    return tuple(heads_view(gen, b, n, h, d, dt) for n in (sq, sk, sk, sq))


def phase_video_sites():
    """K1/K2 at VIDEO_K1_SITES (`check_bsc_sites`), K5/K6 at MOTION_SITE and
    MOTION_MORE on `motion_operands` (`check_caption_flash_sites`), each in
    fp32 and bf16 with the earlier phases' tolerances, K2, K5 and K6 twice
    bit for bit; K4 at a shared-frame site: a video_diffusion_models.yaml
    32x32 block's conv2 at batch 8 (x (128, 32, 32, 128), frames that
    differ, norm2's coefficients over each example's 16 frames repeated per
    frame with a per-frame scale-shift, the residual) against its plain
    version in fp32 (1e-4 of the scale), twice bit for bit. Then fp32 device
    times (the configs' dtype), one call each, beside the plain version,
    the library call (SDPA and its backward, F.conv2d) and the bound: K1
    and K2 at the 16x16 self-attention site and Make-A-Video's cross site,
    K4 at the shared-frame site (bound: fp32 on the CUDA cores, where K4's
    fp32 kernel computes), K5 and K6 at MOTION_SITE. Returns {"K1"|...:
    {site: record}, "err": {kernel: fp32/bf16 error}}."""
    from xdiffusion_tpu_torch.layers.resnet import FastGroupNorm
    from xdiffusion_tpu_torch.ops import flash_attention as fa
    from xdiffusion_tpu_torch.ops import fused_resblock

    gen = torch.Generator(device="cuda").manual_seed(SEED + 51)
    errs = check_bsc_sites(VIDEO_K1_SITES, gen)
    errs.update(check_caption_flash_sites([MOTION_SITE] + MOTION_MORE, gen, motion_operands))
    for b, h, sq, sk, d in [MOTION_SITE] + MOTION_MORE:
        plan = fa.flash_plan(b, h, sq, sk, d, torch.float32)
        log(f"K5 at B={b} H={h} S={sq}: grid {plan.launches[0].grid} (B*H {b * h})")
    b, f, hw, c = VIDEO_BATCH, 16, 32, 128
    x = torch.randn((b * f, hw, hw, c), generator=gen, device="cuda") * 2 + 0.5
    norm = FastGroupNorm(c, 32, silu=True, stat_frames=f).cuda()
    with torch.no_grad():
        norm.scale.normal_(1.0, 0.1, generator=gen)
        norm.bias.normal_(0.0, 0.1, generator=gen)
    t_scale = (0.3 * torch.randn((b, 1, 1, c), generator=gen, device="cuda")).repeat_interleave(
        f, dim=0)
    t_shift = torch.randn((b, 1, 1, c), generator=gen, device="cuda").repeat_interleave(f, dim=0)
    with torch.no_grad():
        a, off = norm(x, t_scale=t_scale, t_shift=t_shift, return_coefficients=True)
    check(torch.equal(a[0], a[f - 1]) and not torch.equal(x[0], x[f - 1]),
          "K4 shared-frame site: coefficients differ over frames, or the frames agree")
    kw = torch.randn((3, 3, c, c), generator=gen, device="cuda") * (9 * c) ** -0.5
    bias = 0.1 * torch.randn((c,), generator=gen, device="cuda")
    res = torch.randn(x.shape, generator=gen, device="cuda")
    want = fused_resblock.affine_silu_conv3x3_plain(x, a, off, kw, bias, res)
    got = fused_resblock.affine_silu_conv3x3(x, a, off, kw, bias, res)
    check_repeats("K4 shared-frame", (got,),
                  (fused_resblock.affine_silu_conv3x3(x, a, off, kw, bias, res),))
    errs["K4"] = compare(f"K4 shared-frame x={tuple(x.shape)} Co={c} residual fp32 "
                         f"({fused_resblock.conv_plan(b * f, hw, hw, c, c, torch.float32).variant};"
                         f" repeat bit-identical)", got, want,
                         1e-4 * max(1.0, want.abs().max().item()))

    out = {"err": errs}
    y = F.silu(x * a[:, None, None, :] + off[:, None, None, :]).permute(0, 3, 1, 2)
    wn = kw.permute(3, 2, 0, 1)
    nbytes = (x.numel() + kw.numel() + 2 * res.numel()) * 4 + (2 * a.numel() + c) * 4
    ops = 2 * x.numel() * 9 * c
    cases = [("K4", "shared_frame_conv2",
              lambda: fused_resblock.affine_silu_conv3x3(x, a, off, kw, bias, res),
              lambda: fused_resblock.affine_silu_conv3x3_plain(x, a, off, kw, bias, res),
              lambda: F.conv2d(y, wn, bias, padding=1),
              {"bytes_ms": nbytes / PEAK_BYTES * 1e3, "ops_ms": ops / PEAK_FP32 * 1e3})]
    for label, (b1, s1, k1, c1, heads) in (("self_16x16", VIDEO_K1_SITES[0]),
                                          ("make_a_video_cross", VIDEO_K1_SITES[3])):
        d1 = c1 // heads
        q = torch.randn((b1, s1, 3 * c1), generator=gen, device="cuda")[..., :c1]
        k, v = torch.randn((b1, k1, 2 * c1), generator=gen, device="cuda").chunk(2, -1)
        g = torch.randn((b1, s1, c1), generator=gen, device="cuda")
        qh, kh, vh = (t.reshape(b1, -1, heads, d1).transpose(1, 2).contiguous().requires_grad_()
                      for t in (q, k, v))
        gh = g.reshape(b1, s1, heads, d1).transpose(1, 2).contiguous()
        sd = F.scaled_dot_product_attention(qh, kh, vh)
        flops, exps = 4 * b1 * s1 * k1 * c1, b1 * heads * s1 * k1
        io = (2 * b1 * s1 * c1 + 2 * b1 * k1 * c1) * 4
        sc = d1 ** -0.5
        cases += [
            ("K1", label, lambda q=q, k=k, v=v, h=heads, sc=sc: fa.short_attention_bsc(
                q, k, v, h, sc),
             lambda q=q, k=k, v=v, h=heads, sc=sc: fa.short_attention_bsc_plain(q, k, v, h, sc),
             lambda qh=qh, kh=kh, vh=vh: F.scaled_dot_product_attention(qh, kh, vh),
             flash_bounds(flops, exps, io, torch.float32)),
            ("K2", label, lambda q=q, k=k, v=v, g=g, h=heads, sc=sc: fa.short_attention_bsc_bwd(
                q, k, v, g, h, sc),
             lambda q=q, k=k, v=v, g=g, h=heads, sc=sc: fa.short_attention_bsc_bwd_plain(
                 q, k, v, g, h, sc),
             lambda sd=sd, qh=qh, kh=kh, vh=vh, gh=gh: torch.autograd.grad(
                 sd, (qh, kh, vh), gh, retain_graph=True),
             flash_bounds(10 * flops // 4, exps, 2 * io + b1 * s1 * c1 * 4, torch.float32))]
    b5, h5, s5, _, d5 = MOTION_SITE
    q, k, v, g = motion_operands(gen, b5, h5, s5, s5, d5, torch.float32)
    o, lse = fa.flash_attention(q, k, v, d5 ** -0.5)
    args = (q, k, v, o, lse, g, d5 ** -0.5)
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    sd5 = F.scaled_dot_product_attention(*leaves)
    flops, exps = 4 * b5 * h5 * s5 * s5 * d5, b5 * h5 * s5 * s5
    cases += [
        ("K5", "motion_32x32", lambda: fa.flash_attention(q, k, v, d5 ** -0.5),
         lambda: fa.flash_attention_plain(q, k, v, d5 ** -0.5),
         lambda: F.scaled_dot_product_attention(q, k, v),
         flash_bounds(flops, exps, 4 * q.numel() * 4 + lse.numel() * 4, torch.float32)),
        ("K6", "motion_32x32", lambda: fa.flash_attention_bwd(*args),
         lambda: fa.flash_attention_bwd_plain(*args),
         lambda: torch.autograd.grad(sd5, leaves, g, retain_graph=True),
         flash_bounds(10 * flops // 4, exps, 8 * q.numel() * 4 + lse.numel() * 4,
                      torch.float32))]
    for kernel, label, fn, plain, lib, bd in cases:
        k_ms, p_ms, l_ms = device_ms(fn), device_ms(plain), device_ms(lib)
        bound = max(bd["bytes_ms"], bd["ops_ms"])
        bound_by = "bytes" if bd["bytes_ms"] >= bd["ops_ms"] else "operations"
        log(f"{kernel} at the video site {label} fp32, one call: {k_ms:.4f} ms, plain "
            f"{p_ms:.4f} ms, library {l_ms:.4f} ms, bound {bound:.4f} ms ({bound_by}; bytes "
            f"{bd['bytes_ms']:.4f}, operations {bd['ops_ms']:.4f}), "
            f"{100 * bound / k_ms:.1f}% of the bound")
        out.setdefault(kernel, {})[label] = {"ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
                                             "bound_ms": bound, "bound_by": bound_by}
    return out


def sample_timer():
    """Wraps `GaussianDiffusion_DDPM.sample` so that each call's wall time
    (synchronized) lands in the returned list; returns (list, restore)."""
    from xdiffusion_tpu_torch.diffusion.ddpm import GaussianDiffusion_DDPM

    original, times = GaussianDiffusion_DDPM.sample, []

    def timed(self, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = original(self, *args, **kwargs)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        return out

    GaussianDiffusion_DDPM.sample = timed

    def restore():
        GaussianDiffusion_DDPM.sample = original
    return times, restore


def video_cli_sample(path: str, checkpoint: str, steps: int, out_dir: str):
    """The video sampling CLI at batch VIDEO_BATCH: (samples, launches,
    samples/s of its `sample()` call)."""
    from xdiffusion_tpu_torch import sample_video

    times, restore = sample_timer()
    ks = reset_launches()
    try:
        samples = sample_video.main(["--config_path", path, "--checkpoint", checkpoint,
                                     "--num_samples", str(VIDEO_BATCH), "--sampling_steps",
                                     str(steps), "--output_path", out_dir, "--device", "cuda"])
    finally:
        restore()
    launched = {k: v.launches for k, v in ks.items() if v.launches}
    check(tuple(samples.shape)[0] == VIDEO_BATCH and bool(torch.isfinite(samples).all()),
          f"{path}: CLI samples {tuple(samples.shape)} not finite")
    check(any(n.endswith(".gif") for n in os.listdir(out_dir)), f"{out_dir}: no GIF")
    return samples, launched, VIDEO_BATCH / times[-1]


def video_train(path: str, steps: int, save_every: int, root: str, resume_from=None, **kw):
    """The video `train()` at batch VIDEO_BATCH (frame strips of
    VIDEO_STRIP_STEPS steps at each save; `kw`, more of its arguments):
    (run dir, launches, metrics)."""
    import shutil

    from xdiffusion_tpu_torch.training.video.train import train

    shutil.rmtree(root, ignore_errors=True)
    ks = reset_launches()
    run_dir = train(path, num_training_steps=steps, batch_size=VIDEO_BATCH,
                    save_and_sample_every_n=save_every, num_samples=4,
                    sampling_steps=VIDEO_STRIP_STEPS, seed=SEED, device="cuda", log_every=1,
                    output_path=root, resume_from=resume_from, **kw)
    torch.cuda.synchronize()
    launched = {k: v.launches for k, v in ks.items() if v.launches}
    metrics = read_metrics(run_dir)
    check(all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in metrics.values()),
          f"{path}: loss or grad_norm not finite")
    return run_dir, launched, metrics


def phase_vdm():
    """video_diffusion_models.yaml as shipped (fp32) through the video
    trainer and the video sampling CLI: its structure's launches a forward
    and a training step (read by hooks); a profiled training step at batch
    VIDEO_BATCH (busy share, K1, K2 and K4 device time); `train()` for
    VIDEO_TRAIN_STEPS steps at batch VIDEO_BATCH on the synthetic
    Moving-MNIST, frame strips and checkpoints every VIDEO_RESUME steps,
    launches against the structure's counts, steps/s; a resume from step
    VIDEO_RESUME whose first step repeats its loss bit for bit; then the
    CLI from the last checkpoint, VIDEO_SAMPLING_STEPS of the config's 1024
    ancestral steps at batch VIDEO_BATCH (launches per forward against the
    structure's; samples/s). Returns (a record for the kernels line, the K3
    sites of its forward and step)."""
    model = build_video(VDM_CONFIG, "cuda")
    fwd, step, gn_sites = video_structure(model)
    log(f"video_diffusion_models.yaml launches a forward {fwd}, a training step {step}")
    model.score_network().train()
    run = video_step(model, VIDEO_BATCH)
    run()  # warm-up
    model.score_network().zero_grad(set_to_none=True)
    wall, busy = profile_text(f"video_diffusion_models.yaml training step (fp32, batch "
                              f"{VIDEO_BATCH} x 16 frames)", run, "vdm_train_profile.txt")
    del model, run
    root = os.path.join(OUT_DIR, "video_diffusion_models_train")
    run_dir, launched, metrics = video_train(VDM_CONFIG, VIDEO_TRAIN_STEPS, VIDEO_RESUME, root)
    saves = VIDEO_TRAIN_STEPS // VIDEO_RESUME
    expected = add_counts(add_counts({}, step, VIDEO_TRAIN_STEPS), fwd,
                          saves * VIDEO_STRIP_STEPS)
    log(f"video_diffusion_models.yaml training ({VIDEO_TRAIN_STEPS} steps at batch "
        f"{VIDEO_BATCH}, {saves} strips of {VIDEO_STRIP_STEPS} steps): launches {launched}, "
        f"expected {expected}")
    check(launched == expected, f"video_diffusion_models training launches {launched}")
    check(sorted(metrics) == list(range(VIDEO_TRAIN_STEPS)), "video_diffusion_models: steps")
    last = VIDEO_TRAIN_STEPS - 1
    sps = (last - VIDEO_RESUME) / (metrics[last]["time"] - metrics[VIDEO_RESUME]["time"])
    log("video_diffusion_models.yaml losses: " + " ".join(
        f"{metrics[i]['loss']:.4f}" for i in range(VIDEO_TRAIN_STEPS))
        + f"; {sps:.3f} steps/s (steps {VIDEO_RESUME + 1}-{last})")
    ckpt = os.path.join(run_dir, "checkpoints", f"{VIDEO_RESUME}.pt")
    with resumed_run():
        _, _, resumed = video_train(VDM_CONFIG, VIDEO_TRAIN_STEPS, VIDEO_RESUME,
                                    os.path.join(OUT_DIR, "video_diffusion_models_resume"), ckpt)
    # The first resumed step repeats bit for bit; later ones differ by the
    # rounding of cuDNN's convolution backward, whose algorithms may sum in
    # another order from call to call.
    same = resumed[VIDEO_RESUME]["loss"] == metrics[VIDEO_RESUME]["loss"]
    later = max(abs(resumed[i]["loss"] - metrics[i]["loss"])
                for i in range(VIDEO_RESUME, VIDEO_TRAIN_STEPS))
    log(f"resume from step {VIDEO_RESUME}: its loss repeats bit for bit: {same}; the largest "
        f"loss difference over steps {VIDEO_RESUME}-{last}: {later:.3e}")
    check(same and sorted(resumed) == list(range(VIDEO_RESUME, VIDEO_TRAIN_STEPS)),
          "video_diffusion_models: the resume does not repeat the run")
    samples, cli_launched, samples_ps = video_cli_sample(
        VDM_CONFIG, os.path.join(run_dir, "checkpoints", f"{VIDEO_TRAIN_STEPS}.pt"),
        VIDEO_SAMPLING_STEPS, os.path.join(OUT_DIR, "video_diffusion_models_samples"))
    cli_expected = add_counts({}, fwd, VIDEO_SAMPLING_STEPS)
    log(f"video_diffusion_models.yaml sampling CLI ({VIDEO_SAMPLING_STEPS} of the config's "
        f"1024 ancestral steps, cut for the run's time limit, batch {VIDEO_BATCH}): "
        f"{samples_ps:.3f} samples/s, launches {cli_launched} ({fwd} a forward), expected "
        f"{cli_expected}")
    check(cli_launched == cli_expected, f"video_diffusion_models CLI launches {cli_launched}")
    check(tuple(samples.shape) == (VIDEO_BATCH, 16, 32, 32, 1), f"samples {samples.shape}")
    return {"training": launched, "sampling_cli": cli_launched, "steps_per_s": sps,
            "samples_per_s": samples_ps, "step_ms": (wall, busy), "forward": fwd,
            "run_dir": run_dir}, gn_sites


def phase_video_companions():
    """The other four video configs as shipped (fp32): each one's structure's
    launches a forward and a training step, `train()` for
    VIDEO_COMPANION_STEPS steps at batch VIDEO_BATCH (with its end strip of
    VIDEO_STRIP_STEPS steps) and the sampling CLI from its checkpoint
    (VIDEO_CLI_STEPS steps at batch VIDEO_BATCH), launches against the
    counts; each kernel the config's path takes (K1 and K2 everywhere, K3,
    K4, K5 and K6 for AnimateDiff) launched. Returns ({config: record},
    the K3 sites of their forwards and steps)."""
    out, gn_sites = {}, []
    for name in VIDEO_COMPANIONS:
        path = os.path.join(VIDEO_DIR, name)
        model = build_video(path, "cuda")
        fwd, step, sites = video_structure(model)
        gn_sites += sites
        del model
        stem = name[:-5]
        run_dir, launched, metrics = video_train(
            path, VIDEO_COMPANION_STEPS, VIDEO_COMPANION_STEPS,
            os.path.join(OUT_DIR, f"{stem}_train"))
        expected = add_counts(add_counts({}, step, VIDEO_COMPANION_STEPS), fwd,
                              VIDEO_STRIP_STEPS)
        last = VIDEO_COMPANION_STEPS - 1
        sps = last / (metrics[last]["time"] - metrics[0]["time"])
        _, cli_launched, samples_ps = video_cli_sample(
            path, os.path.join(run_dir, "checkpoints", f"{VIDEO_COMPANION_STEPS}.pt"),
            VIDEO_CLI_STEPS, os.path.join(OUT_DIR, f"{stem}_samples"))
        cli_expected = add_counts({}, fwd, VIDEO_CLI_STEPS)
        log(f"{name}: launches a forward {fwd}, a training step {step}; training "
            f"({VIDEO_COMPANION_STEPS} steps at batch {VIDEO_BATCH}, {sps:.3f} steps/s) "
            f"launches {launched}, expected {expected}; sampling CLI ({VIDEO_CLI_STEPS} steps, "
            f"batch {VIDEO_BATCH}, {samples_ps:.3f} samples/s) launches {cli_launched}, "
            f"expected {cli_expected}")
        check(launched == expected, f"{name} training launches {launched}")
        check(cli_launched == cli_expected, f"{name} CLI launches {cli_launched}")
        needed = {"bsc_attention", "bsc_attention_bwd", "group_norm_silu", "affine_silu_conv3x3"}
        if name == "animate_diff.yaml":
            needed |= {"flash_attention", "flash_attention_bwd"}
        ran = set(launched) | set(cli_launched)
        check(needed <= ran, f"{name}: {sorted(needed - ran)} never launched")
        out[name] = {"training": launched, "sampling_cli": cli_launched, "steps_per_s": sps,
                     "samples_per_s": samples_ps, "forward": fwd}
    return out, gn_sites


def phase_video_guidance():
    """video_diffusion_models.yaml (fp32, seeded weights) sampled with
    reconstruction guidance and the splice: 3 ancestral steps at batch 4
    with conditioning frames x_a (16 frames) on the config's 4 overlap
    frames, and frames 12-15 observed (video_mask False, x0 given). The
    gradient of each step's overlap error is non-zero past the overlap (and
    zero on it), K2 launched in the sampler once per attention call a step,
    the observed frames equal x0 exactly entering every step after the
    first and in the samples, and the samples' first 4 frames are x_a's
    last 4."""
    from xdiffusion_tpu_torch.samplers import ancestral
    from xdiffusion_tpu_torch.utils import unnormalize_to_zero_to_one

    n, steps, k = 4, 3, 4
    model = build_video(VDM_CONFIG, "cuda")
    sampler = model._reverse_process_sampler
    check(sampler.reconstruction_guidance and sampler._num_frame_overlap == k,
          "video_diffusion_models: no reconstruction guidance on 4 frames")
    fwd, _ = video_counts(model, lambda: model.sample(num_samples=n, num_sampling_steps=1))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 54)
    shape = model.sampling_shape(n)
    x_a = torch.rand(shape, generator=gen, device="cuda") * 2 - 1
    x0 = torch.rand(shape, generator=gen, device="cuda") * 2 - 1
    mask = torch.ones((n, 16), dtype=torch.bool, device="cuda")
    mask[:, 12:] = False
    grads, entering = [], []
    autograd_grad, p_sample = torch.autograd.grad, ancestral.AncestralSampler.p_sample

    def grad_spy(outputs, inputs, *args, **kwargs):
        out = autograd_grad(outputs, inputs, *args, **kwargs)
        if isinstance(inputs, torch.Tensor) and tuple(inputs.shape) == shape:
            grads.append(out[0].detach().clone())
        return out

    def step_spy(self, x, *args, **kwargs):
        entering.append(x.detach().clone())
        return p_sample(self, x, *args, **kwargs)

    ancestral.torch.autograd.grad, ancestral.AncestralSampler.p_sample = grad_spy, step_spy
    ks = reset_launches()
    try:
        t0 = time.perf_counter()
        out = model.sample(num_samples=n, num_sampling_steps=steps, generator=gen,
                           context={"x_a": x_a, "video_mask": mask, "x0": x0})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        ancestral.torch.autograd.grad, ancestral.AncestralSampler.p_sample = (autograd_grad,
                                                                                 p_sample)
    launched = {key: v.launches for key, v in ks.items() if v.launches}
    expected = add_counts({"bsc_attention_bwd": steps * fwd["bsc_attention"]}, fwd, steps)
    sizes = [(g[:, :k].abs().max().item(), g[:, k:].abs().max().item()) for g in grads]
    log(f"reconstruction-guided sampling ({steps} steps, batch {n}, {wall:.2f} s): launches "
        f"{launched}, expected {expected}; max|grad| on the overlap / past it per step "
        + ", ".join(f"{a:.1e} / {b:.3e}" for a, b in sizes))
    check(launched == expected, f"guided sampling launches {launched}")
    check(len(grads) == steps and all(a == 0.0 and b > 0.0 for a, b in sizes),
          "reconstruction guidance: the gradient is zero past the overlap or not on it")
    pinned = all(torch.equal(x[:, 12:], x0[:, 12:]) for x in entering[1:])
    check(len(entering) == steps and pinned, "the splice did not pin frames 12-15 to x0")
    check(torch.equal(out[:, 12:], unnormalize_to_zero_to_one(x0[:, 12:])),
          "the samples' observed frames are not x0")
    check(torch.equal(out[:, :k], unnormalize_to_zero_to_one(x_a[:, -k:])),
          "the samples' overlap frames are not x_a's last")
    log("the splice pinned frames 12-15 to x0 entering every step and in the samples; the "
        "overlap frames are x_a's last 4")
    return launched


def video_cut_config(name: str) -> str:
    """The config at reduced depth for phase 55: two levels of the UNet
    ([1, 2]), one residual block a level, widths as shipped (num_features
    128, heads of 64, 16 frames), dropout and the guidance drop off; written
    under OUT_DIR."""
    import yaml

    with open(os.path.join(VIDEO_DIR, name)) as f:
        cfg = yaml.safe_load(f)
    sn = cfg["diffusion"]["score_network"]["params"]
    net = sn.get("spatial_score_network", sn)
    net.update(channel_multipliers=net["channel_multipliers"][:2], num_resnet_blocks=1,
               dropout=0.0)
    cfg["diffusion"]["classifier_free_guidance"]["unconditional_guidance_probability"] = 0.0
    path = os.path.join(OUT_DIR, "cut_" + name)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def phase_video_card_vs_cpu():
    """video_diffusion_models.yaml and animate_diff.yaml at reduced depth
    (`video_cut_config`), fp32, the same seeded weights, card against CPU at
    batch 1 (16 frames; the CPU's share of the run's time limit): the loss with injected times and noise (dropout off) and its
    gradient norm, then a 5-step ancestral trajectory with injected initial
    and per-step noise (AnimateDiff with prompts). The loss to 1e-5
    relative, the gradient norm to 1e-4, the samples to 1e-3 (in [0, 1], as
    the cascades' phase 50: x_hat = alpha z - sigma v at the first steps'
    logSNR near -20 magnifies fp32 sums in other orders);
    fp32 on both sides, TF32 off on the card (K5/K6 split their products
    into three TF32 ones)."""
    from xdiffusion_tpu_torch.optim import global_norm

    n, steps = 1, 5
    rng = np.random.default_rng(SEED + 55)
    shape = (n, 16, 32, 32, 1)
    images = torch.from_numpy(rng.random(shape).astype(np.float32))
    eps = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    t = torch.from_numpy(np.float32([0.7]))
    init = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    noise = torch.from_numpy(rng.standard_normal((steps,) + shape).astype(np.float32))
    for name in ("video_diffusion_models.yaml", "animate_diff.yaml"):
        path = video_cut_config(name)
        results = {}
        for device in ("cuda", "cpu"):
            model = build_video(path, device)
            ctx = video_context(model, n, device)
            loss, _ = model.loss_on_batch(images.to(device), ctx, timesteps=t.to(device),
                                          noise=eps.to(device), deterministic=True)
            loss.backward()
            gnorm = global_norm([p.grad for p in model.score_network().parameters()
                                 if p.grad is not None]).item()
            sctx = {"sampling_noise": noise}
            if ctx:
                sctx["text_prompts"] = digit_prompts(n)
            samples = model.sample(num_samples=n, num_sampling_steps=steps,
                                   initial_noise=init, context=sctx).cpu()
            results[device] = (loss.item(), gnorm, samples)
            del model
        (l_gpu, g_gpu, s_gpu), (l_cpu, g_cpu, s_cpu) = results["cuda"], results["cpu"]
        diff = (s_gpu - s_cpu).abs().max().item()
        log(f"card vs CPU, {name} at reduced depth (channel_multipliers [1, 2], one residual "
            f"block a level; widths as shipped) fp32: loss {l_gpu:.7f} vs {l_cpu:.7f}, "
            f"grad_norm {g_gpu:.6f} vs {g_cpu:.6f}; a {steps}-step trajectory max|diff| "
            f"{diff:.3e} (tol 1e-3)")
        check(abs(l_gpu - l_cpu) <= 1e-5 * abs(l_cpu), f"{name} loss {l_gpu} vs {l_cpu}")
        check(abs(g_gpu - g_cpu) <= 1e-4 * abs(g_cpu), f"{name} grad_norm {g_gpu} vs {g_cpu}")
        check(diff <= 1e-3, f"{name} trajectory card vs CPU: {diff}")



def check_video_k3(sites):
    """K3 at each distinct GroupNorm site of the video configs' forwards and
    training steps (the spatial and temporal attention norms, on (B*H*W, F,
    C) views down to 16 rows, pseudo-3D's per-frame norm1, the image UNets'
    final norm) against its plain version in fp32 and bf16, twice bit for
    bit (`k3_compare`). Returns the largest fp32 error."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 53)
    seen, err = set(), 0.0
    for site in counted(sites):
        _, _, _, e = k3_compare("video", site, gen, seen)
        err = max(err, e[torch.float32])
    check(any(s[0][1:-1] == (16,) for s in counted(sites)),
          "no K3 site on a temporal attention's (B*H*W, 16, C) view")
    log(f"K3 at {len(counted(sites))} video sites, plans {sorted(seen)}")
    return err


# ---- phases 56-61: FDM, long videos, the Imagen-Video cascade, the warm start ------

FDM_CONFIG = os.path.join(VIDEO_DIR, "flexible_diffusion_modeling.yaml")
IMAGEN_VIDEO_CONFIG = os.path.join(VIDEO_DIR, "imagen_video.yaml")
SCHEME_CONFIG = os.path.join(ROOT, "configs/video/sampling_schemes/autoregressive.yaml")
# FDM at batch VIDEO_BATCH: the trainer's steps (a resume from FDM_RESUME
# repeats its loss) and the sampling CLI's steps of the config's 1000; the
# long-video runs (the scheme's 13 windows, the extensions to 32 frames) at
# LONG_BATCH with LONG_STEPS a window; the Imagen-Video chain's steps a stage
# and batch; the warm start's image steps and temporal-only video steps; the
# Moving-MNIST-256 steps. Cut for the script's time limit: every check and
# launch count stays.
FDM_TRAIN_STEPS, FDM_RESUME, FDM_CLI_STEPS = 4, 2, 5
LONG_BATCH, LONG_STEPS = 2, 2
CHAIN_STEPS, CHAIN_BATCH = 3, 4
WARM_IMAGE_STEPS, WARM_VIDEO_STEPS, MM256_STEPS = 2, 3, 2
FDM_SITES = {"group_norm_silu": 23, "affine_silu_conv3x3": 44}


def fdm_context(b: int, f: int = 16, seed: int = SEED):
    """An FDM batch's context on the card: FDM's random latent and observed
    subsets of 16 frames, their frame indices, the timestep 500."""
    from xdiffusion_tpu_torch.training_utils import sample_fdm_training_batch

    videos = np.zeros((b, f, 1, 1, 1), np.float32)
    _, fi, observed, latent = sample_fdm_training_batch(videos, f, "random",
                                                        np.random.default_rng(seed))
    return {"timestep": torch.full((b,), 500, device="cuda"),
            "frame_indices": torch.from_numpy(fi).cuda(),
            "observed_mask": torch.from_numpy(observed).cuda(),
            "video_mask": torch.from_numpy(latent.astype(bool)).cuda()}


def fdm_forward(model, b: int):
    """A closure: one FDM forward at batch b (16 frames of 32x32, x0 given)."""
    ctx = fdm_context(b)
    x = torch.randn((b, 16, 32, 32, 1), device="cuda")
    ctx["x0"] = torch.rand_like(x) * 2 - 1

    def run():
        with torch.inference_mode():
            model.predict_score(x, dict(ctx))
    return run


def fdm_step(model, b: int):
    """A closure: one FDM training loss and backward at batch b with an FDM
    batch's keys, as the trainer's step runs it."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    images = torch.rand((b, 16, 32, 32, 1), generator=gen, device="cuda")
    ctx = fdm_context(b)
    ctx.pop("timestep")

    def run():
        loss, _ = model.loss_on_batch(images, dict(ctx), generator=gen)
        loss.backward()
    return run


def time_k3_k4_sites(label, gn_sites, conv_sites, gen):
    """fp32 device ms (K3 with L2 warm and cold) of K3 at each distinct
    GroupNorm site and K4 at each distinct conv site, beside the plain
    version, the library call (F.group_norm [+ F.silu]; F.conv2d of the
    activated input) and the bound; logged per site. Returns {"K3"|"K4":
    the sums over the sites, each site as often as the forward calls it}."""
    from xdiffusion_tpu_torch.ops import fused_resblock, group_norm

    out = {"K3": new_record(), "K4": new_record()}
    out["K3"]["cold_ms"] = 0.0
    for (shape, ng, silu, eps), n in counted(gn_sites).items():
        c = shape[-1]
        x = torch.randn(shape, generator=gen, device="cuda") * 2 + 0.5
        scale = 1.0 + 0.1 * torch.randn((c,), generator=gen, device="cuda")
        bias = 0.1 * torch.randn((c,), generator=gen, device="cuda")
        kernel = lambda: group_norm.group_norm_silu(x, scale, bias, ng, eps, silu)  # noqa: E731
        plain = lambda: group_norm.group_norm_silu_plain(x, scale, bias, ng, eps, silu)  # noqa: E731
        plan = group_norm.gn_plan(shape[0], math.prod(shape[1:-1]), c, ng, torch.float32)
        bd = {"bytes_ms": (2 * x.numel() + 2 * c) * 4 / PEAK_BYTES * 1e3,
              "ops_ms": 10 * x.numel() / PEAK_FP32 * 1e3}
        xn = x.permute(0, x.ndim - 1, *range(1, x.ndim - 1))  # channels first, no copy
        lib = ((lambda: F.silu(F.group_norm(xn, ng, scale, bias, eps), inplace=True)) if silu
               else (lambda: F.group_norm(xn, ng, scale, bias, eps)))
        row = {"ms": device_ms(kernel), "cold_ms": cold_ms(kernel), "plain_ms": device_ms(plain),
               "library_ms": device_ms(lib), "wrapper_ms": time_ms(kernel), **bd}
        row["bound_ms"] = max(bd.values())
        log(f"K3 at the {label} site x={shape} silu={silu} x{n} fp32: {row['ms']:.4f} ms warm, "
            f"{row['cold_ms']:.4f} cold, plain {row['plain_ms']:.4f}, library "
            f"{row['library_ms']:.4f}, bound {row['bound_ms']:.4f} "
            f"({plan.variant}, k {plan.k}, {plan.threads} threads)")
        for key in ("ms", "cold_ms", "plain_ms", "library_ms", "wrapper_ms", "bytes_ms",
                    "ops_ms", "bound_ms"):
            out["K3"][key] += n * row[key]
    for (shape, co, has_res), n in counted(conv_sites).items():
        b, h, w, c = shape
        x = torch.randn(shape, generator=gen, device="cuda")
        a = 1.0 + 0.2 * torch.randn((b, c), generator=gen, device="cuda")
        off = 0.2 * torch.randn((b, c), generator=gen, device="cuda")
        kw = torch.randn((3, 3, c, co), generator=gen, device="cuda") * (9 * c) ** -0.5
        bias = 0.1 * torch.randn((co,), generator=gen, device="cuda")
        res = torch.randn((b, h, w, co), generator=gen, device="cuda") if has_res else None
        y = F.silu(x * a[:, None, None, :] + off[:, None, None, :]).permute(0, 3, 1, 2)
        wn = kw.permute(3, 2, 0, 1)
        kernel = lambda: fused_resblock.affine_silu_conv3x3(x, a, off, kw, bias, res)  # noqa: E731
        plain = lambda: fused_resblock.affine_silu_conv3x3_plain(x, a, off, kw, bias, res)  # noqa: E731
        outs = b * h * w * co * (2 if has_res else 1)
        bd = {"bytes_ms": (x.numel() + kw.numel() + outs + 2 * a.numel() + co) * 4
              / PEAK_BYTES * 1e3, "ops_ms": 2 * x.numel() * 9 * co / PEAK_FP32 * 1e3}
        row = {"ms": device_ms(kernel), "plain_ms": device_ms(plain),
               "library_ms": device_ms(lambda: F.conv2d(y, wn, bias, padding=1)), **bd}
        row["bound_ms"] = max(bd.values())
        log(f"K4 at the {label} site x={shape} Co={co} residual={has_res} x{n} fp32: "
            f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f}, library {row['library_ms']:.4f}, "
            f"bound {row['bound_ms']:.4f} "
            f"({fused_resblock.conv_plan(b, h, w, c, co, torch.float32).variant})")
        for key in ("ms", "plain_ms", "library_ms", "bytes_ms", "ops_ms", "bound_ms"):
            out["K4"][key] += n * row[key]
    for rec in out.values():
        rec["bound_by"] = "bytes" if rec["bytes_ms"] >= rec["ops_ms"] else "operations"
    return out


def phase_fdm_sites():
    """flexible_diffusion_modeling.yaml as shipped (fp32) at batch
    VIDEO_BATCH: its structure's launches a forward and a training step
    (hooks: K3 at the 22 RPE-attention norms on (B*H*W, 16, 256) and (B*16,
    H*W, 256) views and the final norm, K4 at both convs of its 22 residual
    blocks, which never drop, as in JAX); K3 at every site against its plain
    version in fp32 and bf16 and K4 at every conv site in fp32, twice bit
    for bit; fp32 device ms of both at every site beside the plain version,
    the library call and the bound (`time_k3_k4_sites`); a profile of one
    forward and one training step. Returns a record for the kernels line."""
    model = build_video(FDM_CONFIG, "cuda")
    fwd_run = fdm_forward(model, VIDEO_BATCH)
    sites = main_path_sites(model, run=fwd_run)
    gn_sites, conv_sites = sites["group_norm_silu"], sites["affine_silu_conv3x3"]
    fwd, _ = video_counts(model, fwd_run)
    model.score_network().train()
    step_run = fdm_step(model, VIDEO_BATCH)
    step, _ = video_counts(model, step_run, training=True)
    model.score_network().zero_grad(set_to_none=True)
    log(f"flexible_diffusion_modeling.yaml launches a forward {fwd}, a training step {step}; "
        f"K3 sites {counted(gn_sites)}; K4 sites {counted(conv_sites)}")
    check(fwd == FDM_SITES and step == FDM_SITES, f"FDM launches {fwd}, {step}")
    check(len(gn_sites) == 23 and any(s[0] == (VIDEO_BATCH * 256, 16, 256) for s in gn_sites),
          "FDM: no K3 site at 16 rows of the 16x16 level's temporal attention")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 56)
    seen, k3_err = set(), 0.0
    for site in counted(gn_sites):
        _, _, _, e = k3_compare("fdm", site, gen, seen)
        k3_err = max(k3_err, e[torch.float32])
    k4_err = check_k4_sites(conv_sites, gen)
    times = time_k3_k4_sites("FDM", gn_sites, conv_sites, gen)
    attention = fdm_spatial_attention(gen)
    model.score_network().eval()
    fwd_run()  # warm-up
    fwd_ms = profile_text(f"FDM forward (fp32, batch {VIDEO_BATCH} x 16 frames)", fwd_run,
                          "fdm_profile.txt")
    model.score_network().train()
    step_run()
    model.score_network().zero_grad(set_to_none=True)
    step_ms = profile_text(f"FDM training step (fp32, batch {VIDEO_BATCH} x 16 frames)",
                           step_run, "fdm_train_profile.txt")
    del model
    return {"forward": fwd, "step": step, "times": times, "err": {"K3": k3_err, "K4": k4_err},
            "forward_ms": fwd_ms, "step_ms": step_ms, "plans": sorted(seen),
            "spatial_attention": attention}


def fdm_spatial_attention(gen):
    """FDM's spatial attention core (no relative positions, no mask: the
    JAX package's and the port's plain einsums, `RPEAttention`) at its three
    sites at batch 8 (B*16 frames = 128 maps of 16x16, 8x8 and the middle's
    4x4, 256 channels, 4 heads; 5, 5 and 1 calls a forward), fp32 device ms
    beside K1 on the same q, k, v (`short_attention_bsc`, which computes the
    same function: a candidate, not on the path) and SDPA; K1 held against
    the einsums (1e-4). Returns {site: (einsum ms, K1 ms, SDPA ms)}."""
    from xdiffusion_tpu_torch.ops import flash_attention as fa

    out = {}
    for hw, calls in ((256, 5), (64, 5), (16, 1)):
        b, c, heads = VIDEO_BATCH * 16, 256, 4
        d = c // heads
        q, k, v = (torch.randn((b, hw, c), generator=gen, device="cuda") for _ in range(3))

        def einsums():
            qh, kh, vh = (t.reshape(b, hw, heads, d).transpose(1, 2) for t in (q, k, v))
            attn = torch.softmax(torch.einsum("bhtf,bhsf->bhts", qh * d ** -0.5, kh), dim=-1)
            return torch.einsum("bhts,bhsf->bhtf", attn, vh).transpose(1, 2).reshape(b, hw, c)

        qh, kh, vh = (t.reshape(b, hw, heads, d).transpose(1, 2).contiguous() for t in (q, k, v))
        compare(f"K1 at FDM's spatial attention ({b}, {hw}, {c}, {heads} heads) fp32 against "
                f"the einsums", fa.short_attention_bsc(q, k, v, heads, d ** -0.5), einsums(), 1e-4)
        row = (device_ms(einsums), device_ms(lambda: fa.short_attention_bsc(q, k, v, heads,
                                                                            d ** -0.5)),
               device_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh)))
        log(f"FDM spatial attention at {hw} tokens x{calls} a forward (fp32, one call): einsums "
            f"{row[0]:.4f} ms, K1 {row[1]:.4f}, SDPA {row[2]:.4f}")
        out[f"{hw}_tokens"] = dict(zip(("einsum_ms", "k1_ms", "sdpa_ms"), row), calls=calls)
    return out


def phase_fdm_runs(fwd, step):
    """FDM through the entry points (fp32, seeded weights where a
    checkpoint is not the trainer's): `train()` for FDM_TRAIN_STEPS steps at
    batch VIDEO_BATCH with FDM batches (strips and GIFs every FDM_RESUME
    steps), launches against the structure's counts, a resume from
    FDM_RESUME whose first step repeats its loss bit for bit; the sampling
    CLI (FDM_CLI_STEPS steps at batch VIDEO_BATCH); `--sampling_scheme_path
    autoregressive.yaml` (160 frames, 13 windows of 16, LONG_STEPS a window
    at batch LONG_BATCH); the extend CLI to 32 frames, hard on FDM (and its
    guided form refused: FDM's schedule is discrete, as JAX asserts) and
    guided on video_diffusion_models.yaml (K2 in the sampler); launches
    against the counts of every run. Returns a record."""
    from xdiffusion_tpu_torch import extend_video, sample_video

    root = os.path.join(OUT_DIR, "fdm_train")
    run_dir, launched, metrics = video_train(FDM_CONFIG, FDM_TRAIN_STEPS, FDM_RESUME, root)
    saves = FDM_TRAIN_STEPS // FDM_RESUME
    expected = add_counts(add_counts({}, step, FDM_TRAIN_STEPS), fwd, saves * VIDEO_STRIP_STEPS)
    last = FDM_TRAIN_STEPS - 1
    sps = (last - 1) / (metrics[last]["time"] - metrics[1]["time"])
    log(f"FDM training ({FDM_TRAIN_STEPS} steps at batch {VIDEO_BATCH} with FDM batches, {saves} "
        f"strips of {VIDEO_STRIP_STEPS} steps): launches {launched}, expected {expected}; losses "
        + " ".join(f"{metrics[i]['loss']:.4f}" for i in range(FDM_TRAIN_STEPS))
        + f"; {sps:.3f} steps/s (steps 2-{last})")
    check(launched == expected, f"FDM training launches {launched}")
    check(os.path.exists(os.path.join(run_dir, f"sample-{FDM_TRAIN_STEPS}.gif")), "FDM: no GIF")
    with resumed_run():
        _, _, resumed = video_train(FDM_CONFIG, FDM_TRAIN_STEPS, FDM_RESUME,
                                    os.path.join(OUT_DIR, "fdm_resume"),
                                    os.path.join(run_dir, "checkpoints", f"{FDM_RESUME}.pt"))
    same = resumed[FDM_RESUME]["loss"] == metrics[FDM_RESUME]["loss"]
    log(f"FDM resume from step {FDM_RESUME}: its loss repeats bit for bit: {same}")
    check(same, "FDM: the resume does not repeat the run")
    ckpt = os.path.join(run_dir, "checkpoints", f"{FDM_TRAIN_STEPS}.pt")
    samples, cli, samples_ps = video_cli_sample(FDM_CONFIG, ckpt, FDM_CLI_STEPS,
                                                os.path.join(OUT_DIR, "fdm_samples"))
    cli_expected = add_counts({}, fwd, FDM_CLI_STEPS)
    log(f"FDM sampling CLI ({FDM_CLI_STEPS} of 1000 steps, batch {VIDEO_BATCH}): "
        f"{samples_ps:.3f} samples/s, launches {cli}, expected {cli_expected}")
    check(cli == cli_expected and tuple(samples.shape) == (VIDEO_BATCH, 16, 32, 32, 1),
          f"FDM CLI launches {cli}, samples {tuple(samples.shape)}")

    common = ["--checkpoint", ckpt, "--num_samples", str(LONG_BATCH), "--sampling_steps",
              str(LONG_STEPS), "--device", "cuda"]
    runs = {}

    def timed(name, fn, forwards):
        ks = reset_launches()
        t0 = time.perf_counter()
        video = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {k: v.launches for k, v in ks.items() if v.launches}
        want = add_counts({}, fwd, forwards)
        log(f"{name}: {tuple(video.shape)} in {wall:.2f} s, launches {got}, expected {want}")
        check(got == want and bool(torch.isfinite(video).all()), f"{name}: launches {got}")
        runs[name] = {"launches": got, "s": wall}
        return video

    out = os.path.join(OUT_DIR, "fdm_long")
    video = timed("scheme autoregressive.yaml (160 frames, 13 windows)", lambda: sample_video.main(
        ["--config_path", FDM_CONFIG, "--sampling_scheme_path", SCHEME_CONFIG, "--output_path",
         out] + common), 13 * LONG_STEPS)
    check(tuple(video.shape) == (LONG_BATCH, 160, 32, 32, 1)
          and os.path.exists(os.path.join(out, f"long-video-step{FDM_TRAIN_STEPS}.gif")),
          "the scheme's video or GIF")
    extend = ["--total_frames", "32", "--num_frame_overlap", "4"]
    video = timed("extend hard to 32 frames", lambda: extend_video.main(
        ["--config_path", FDM_CONFIG, "--output_path", out] + extend + common), 3 * LONG_STEPS)
    check(tuple(video.shape) == (LONG_BATCH, 32, 32, 32, 1)
          and os.path.exists(os.path.join(out, "extended-32f.gif")), "the extension's GIF")
    try:
        extend_video.main(["--config_path", FDM_CONFIG, "--output_path", out,
                           "--reconstruction_guidance"] + extend + common)
        check(False, "guided extension of FDM's discrete schedule was not refused")
    except ValueError as e:
        log(f"guided extension of FDM refused as in JAX: {e}")
    vdm = build_video(VDM_CONFIG, "cuda")
    vdm_ckpt = os.path.join(OUT_DIR, "vdm_weights.pt")
    torch.save(vdm.score_network().state_dict(), vdm_ckpt)
    vdm_fwd, _ = video_counts(vdm, lambda: vdm.sample(num_samples=LONG_BATCH,
                                                     num_sampling_steps=1))
    del vdm
    ks = reset_launches()
    video = extend_video.main(["--config_path", VDM_CONFIG, "--checkpoint", vdm_ckpt,
                               "--num_samples", str(LONG_BATCH), "--sampling_steps",
                               str(LONG_STEPS), "--device", "cuda", "--output_path", out,
                               "--reconstruction_guidance"] + extend)
    got = {k: v.launches for k, v in ks.items() if v.launches}
    want = add_counts({"bsc_attention_bwd": 2 * LONG_STEPS * vdm_fwd["bsc_attention"]}, vdm_fwd,
                      3 * LONG_STEPS)
    log(f"extend guided (video_diffusion_models.yaml) to 32 frames: launches {got}, expected {want}")
    check(got == want and tuple(video.shape) == (LONG_BATCH, 32, 32, 32, 1),
          f"guided extension launches {got}")
    runs["extend guided (video_diffusion_models.yaml)"] = {"launches": got}
    return {"training": launched, "sampling_cli": cli, "steps_per_s": sps,
            "samples_per_s": samples_ps, "long": runs}


def fdm_cut_config() -> str:
    """flexible_diffusion_modeling.yaml at reduced depth for the card-vs-CPU
    check: two levels ([1, 2]), one residual block a level, attention at
    16x16, widths as shipped (128 channels, 4 heads, 16 frames of 32x32);
    written under OUT_DIR."""
    import yaml

    with open(FDM_CONFIG) as f:
        cfg = yaml.safe_load(f)
    cfg["diffusion"]["score_network"]["params"].update(channel_mult=[1, 2], num_res_blocks=1,
                                                       attention_resolutions=[16])
    path = os.path.join(OUT_DIR, "cut_flexible_diffusion_modeling.yaml")
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def phase_fdm_card_vs_cpu():
    """FDM at reduced depth (`fdm_cut_config`), fp32, the same seeded
    weights, card against CPU at batch 1: the loss of an FDM batch (latent
    and observed subsets, their frame indices) with injected time and noise
    and its gradient norm, then a 5-step ancestral trajectory with injected
    initial and per-step noise and frames 0-3 observed through the splice.
    The loss to 1e-5 relative, the gradient norm to 1e-4, the samples to
    1e-3 (in [0, 1]); TF32 off on the card."""
    from xdiffusion_tpu_torch.optim import global_norm

    n, steps = 1, 5
    rng = np.random.default_rng(SEED + 58)
    shape = (n, 16, 32, 32, 1)
    images = torch.from_numpy(rng.random(shape).astype(np.float32))
    eps = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    t = torch.tensor([700])
    init = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    noise = torch.from_numpy(rng.standard_normal((steps,) + shape).astype(np.float32))
    x0 = torch.from_numpy(rng.uniform(-1, 1, shape).astype(np.float32))
    mask = torch.ones((n, 16), dtype=torch.bool)
    mask[:, :4] = False
    batch = {k: v.cpu() for k, v in fdm_context(n, seed=SEED + 58).items() if k != "timestep"}
    path = fdm_cut_config()
    results = {}
    for device in ("cuda", "cpu"):
        model = build_video(path, device)
        loss, _ = model.loss_on_batch(images.to(device), {k: v.to(device) for k, v in batch.items()},
                                      timesteps=t.to(device), noise=eps.to(device),
                                      deterministic=True)
        loss.backward()
        gnorm = global_norm([p.grad for p in model.score_network().parameters()
                             if p.grad is not None]).item()
        samples = model.sample(num_samples=n, num_sampling_steps=steps, initial_noise=init,
                               context={"sampling_noise": noise, "video_mask": mask,
                                        "x0": x0}).cpu()
        results[device] = (loss.item(), gnorm, samples)
        del model
    (l_gpu, g_gpu, s_gpu), (l_cpu, g_cpu, s_cpu) = results["cuda"], results["cpu"]
    diff = (s_gpu - s_cpu).abs().max().item()
    log(f"card vs CPU, FDM at reduced depth (channel_mult [1, 2], one residual block a level, "
        f"widths as shipped) fp32: loss {l_gpu:.7f} vs {l_cpu:.7f}, grad_norm {g_gpu:.6f} vs "
        f"{g_cpu:.6f}; a {steps}-step trajectory max|diff| {diff:.3e} (tol 1e-3)")
    check(abs(l_gpu - l_cpu) <= 1e-5 * abs(l_cpu), f"FDM loss {l_gpu} vs {l_cpu}")
    check(abs(g_gpu - g_cpu) <= 1e-4 * abs(g_cpu), f"FDM grad_norm {g_gpu} vs {g_cpu}")
    check(diff <= 1e-3, f"FDM trajectory card vs CPU: {diff}")
    from xdiffusion_tpu_torch.utils import unnormalize_to_zero_to_one

    check(torch.equal(s_gpu[:, :4], unnormalize_to_zero_to_one(x0[:, :4])),
          "FDM: the splice's frames are not x0")


def imagen_video_stage_context(stage, b: int, prompts):
    """One forward's context for an Imagen-Video stage on the card: the
    time 0.5 and its logSNR, the prompts' tokens, an SR stage's conditioning
    (its low-resolution video) and augmentation time 0.1 and noise."""
    cfg = stage.config()
    t = torch.full((b,), 0.5, device="cuda")
    ctx = {"timestep": t, "logsnr_t": stage.noise_scheduler().logsnr(t),
           "text_tokens": stage.preprocess_context({"text_prompts": prompts})["text_tokens"]
           .to("cuda")}
    if "super_resolution" in cfg:
        pre = cfg.diffusion.input_preprocessing.params
        frames = cfg.diffusion.sampling.output_frames
        size = cfg.data.image_size
        low = ((b, pre.low_resolution_size, size, size, 1) if pre.get("is_temporal")
               else (b, frames, pre.low_resolution_size, pre.low_resolution_size, 1))
        ctx[cfg.super_resolution.conditioning_key] = torch.rand(low, device="cuda")
        ctx["augmentation_timestep"] = torch.full((b,), 0.1, device="cuda")
        ctx["augmentation_noise"] = torch.randn((b, frames, size, size, 1), device="cuda")
    return ctx


def phase_imagen_video():
    """imagen_video.yaml as shipped (fp32, seeded weights): the temporal SR
    stage's sites in one forward at batch VIDEO_BATCH (hooks and K1's
    arguments; K1/K2 at every attention call with `check_bsc_sites`, K3 at
    every GroupNorm site with `k3_compare`, K4 at every conv site, each twice
    bit for bit; fp32 device ms of K3/K4 there); the three stages' launches a
    forward at CHAIN_BATCH; the chain sampled (base 8 frames of 16x16,
    temporal SR to 16 frames, spatial SR to 32x32; CHAIN_STEPS a stage, the
    SR stages at their fixed augmentation level) with launches against those
    counts; the 5-D cascade loss refused as in JAX. Returns a record."""
    from xdiffusion_tpu_torch.config import load_yaml
    from xdiffusion_tpu_torch.training.image.train import build_model as build
    from xdiffusion_tpu_torch.weights import randomize_

    model = build(load_yaml(IMAGEN_VIDEO_CONFIG), device="cuda")
    randomize_(model.score_network(), SEED)
    tsr = model.models()[1]
    prompts = digit_prompts(VIDEO_BATCH)
    ctx = imagen_video_stage_context(tsr, VIDEO_BATCH, prompts)
    x = torch.randn((VIDEO_BATCH, 16, 16, 16, 1), device="cuda")

    def run():
        with torch.inference_mode():
            c = dict(ctx)
            tsr.predict_score(tsr.process_input(x, c), c)

    counts, gn_sites = video_counts(tsr, run)
    conv_sites = main_path_sites(tsr, run=run)["affine_silu_conv3x3"]
    k1_calls = sorted(set(bsc_calls(run)))
    log(f"imagen_video_tsr_8x16.yaml (temporal SR) launches a forward at batch {VIDEO_BATCH}: "
        f"{counts}; K1 calls {k1_calls}; K3 sites {counted(gn_sites)}")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 59)
    errs = check_bsc_sites(k1_calls, gen)
    seen = set()
    errs["K3"] = max(k3_compare("tsr", site, gen, seen)[3][torch.float32]
                     for site in counted(gn_sites))
    errs["K4"] = check_k4_sites(conv_sites, gen)
    times = time_k3_k4_sites("TSR", gn_sites, conv_sites, gen)
    stage_fwd = []
    for i, stage in enumerate(model.models()):
        sctx = {"text_prompts": digit_prompts(CHAIN_BATCH)}
        if i:
            c = imagen_video_stage_context(stage, CHAIN_BATCH, digit_prompts(CHAIN_BATCH))
            key = stage.config().super_resolution.conditioning_key
            sctx[key] = c[key]
        stage_fwd.append(video_counts(stage, lambda s=stage, c=sctx: s.sample(
            num_samples=CHAIN_BATCH, num_sampling_steps=1, context=dict(c)))[0])
    expected = {}
    for c in stage_fwd:
        add_counts(expected, c, CHAIN_STEPS)
    ks = reset_launches()
    t0 = time.perf_counter()
    samples = model.sample(num_samples=CHAIN_BATCH, num_sampling_steps=CHAIN_STEPS,
                           context={"text_prompts": digit_prompts(CHAIN_BATCH)})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = {k: v.launches for k, v in ks.items() if v.launches}
    log(f"imagen_video.yaml chained sample ({CHAIN_STEPS} steps a stage, batch {CHAIN_BATCH}): "
        f"{tuple(samples.shape)} in {wall:.2f} s; stage launches a forward {stage_fwd}; "
        f"launches {launched}, expected {expected}")
    check(launched == expected, f"imagen_video chain launches {launched}")
    check(tuple(samples.shape) == (CHAIN_BATCH, 16, 32, 32, 1)
          and bool(((samples >= 0) & (samples <= 1)).all()), "imagen_video chain samples")
    try:
        model.loss_on_batch(torch.rand((2, 16, 32, 32, 1), device="cuda"), {},
                            generator=torch.Generator(device="cuda"))
        check(False, "imagen_video.yaml: the 5-D loss was not refused")
    except ValueError as e:
        log(f"imagen_video.yaml 5-D loss refused as in JAX: {e}")
    del model
    return {"tsr_forward": counts, "chain": launched, "times": times, "err": errs,
            "chain_s": wall}


def warm_image_config() -> str:
    """The image config of video_ldm.yaml's spatial network (animate_diff's
    is the same): its process without frames, the spatial block without the
    per-frame batch heads; written under OUT_DIR."""
    import yaml

    with open(os.path.join(VIDEO_DIR, "video_ldm.yaml")) as f:
        cfg = yaml.safe_load(f)
    spatial = cfg["diffusion"]["score_network"]["params"]["spatial_score_network"]
    cond = spatial["conditioning"]
    cond["context_transformer_head"] = [h for h in cond["context_transformer_head"]
                                        if not h["target"].endswith("SpatialBatchForVideo")]
    cfg["diffusion"]["score_network"] = {"target": "xdiffusion_tpu.score_networks.unet.Unet",
                                         "params": spatial}
    cfg["diffusion"]["sampling"].pop("output_frames")
    cfg["data"].pop("input_number_of_frames", None)
    path = os.path.join(OUT_DIR, "video_ldm_spatial_image.yaml")
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def phase_warm_start():
    """The image-to-video warm start: video_ldm.yaml's spatial network as an
    image config (`warm_image_config`) trained WARM_IMAGE_STEPS steps at
    batch VIDEO_BATCH on image/moving_mnist through the image `train()`;
    its checkpoint into video_ldm.yaml and animate_diff.yaml (fp32, as
    shipped) through the video `train()` with train_temporal_modules_only,
    WARM_VIDEO_STEPS steps at batch VIDEO_BATCH (its end strip of
    VIDEO_STRIP_STEPS steps): every parameter the image checkpoint filled
    bit-equal to it afterwards, the temporal ones (each named by a temporal
    marker) moved from their initial values, which the network built from
    the trainer's seed gives; launches against the counts of the warm
    structure (`video_structure` with the backbone frozen: K2 only where a
    gradient flows back through K1), K1-K4 (and AnimateDiff's K5/K6)
    launched. Returns {config: launches}."""
    import shutil

    from xdiffusion_tpu_torch import checkpoints
    from xdiffusion_tpu_torch.config import load_yaml
    from xdiffusion_tpu_torch.training.image.train import build_model as build
    from xdiffusion_tpu_torch.training.image.train import train as image_train

    root = os.path.join(OUT_DIR, "warm_image")
    shutil.rmtree(root, ignore_errors=True)
    image_dir = image_train(warm_image_config(), num_training_steps=WARM_IMAGE_STEPS,
                            batch_size=VIDEO_BATCH, dataset_name="image/moving_mnist",
                            save_and_sample_every_n=WARM_IMAGE_STEPS, num_samples=4,
                            seed=SEED, device="cuda", output_path=root)
    image = torch.load(os.path.join(image_dir, "checkpoints", f"{WARM_IMAGE_STEPS}.pt"),
                       map_location="cpu", weights_only=True)["params"]
    out = {}
    for name in ("video_ldm.yaml", "animate_diff.yaml"):
        torch.manual_seed(SEED)  # as the trainer builds its network
        model = build(load_yaml(os.path.join(VIDEO_DIR, name)), device="cuda")
        net = model.score_network()
        _, kept = checkpoints.restore_params_partial(image_dir, net)
        initial = {k: p.detach().cpu().clone() for k, p in net.named_parameters() if k in kept}
        for k, p in net.named_parameters():
            p.requires_grad_(k in kept)
        fwd, step, _ = video_structure(model)
        del model, net
        expected = add_counts(add_counts({}, step, WARM_VIDEO_STEPS), fwd, VIDEO_STRIP_STEPS)
        run_dir, launched, _ = video_train(
            os.path.join(VIDEO_DIR, name), WARM_VIDEO_STEPS, WARM_VIDEO_STEPS,
            os.path.join(OUT_DIR, "warm_" + name[:-5]),
            load_model_weights_from_checkpoint=image_dir, train_temporal_modules_only=True)
        trained = torch.load(os.path.join(run_dir, "checkpoints", f"{WARM_VIDEO_STEPS}.pt"),
                             map_location="cpu", weights_only=True)["params"]
        filled = [k for k in trained if k in image and image[k].shape == trained[k].shape]
        temporal = [k for k in trained if k not in filled]
        frozen = all(torch.equal(trained[k], image[k]) for k in filled)
        marked = all(any(m in k.lower() for m in checkpoints.TEMPORAL_KEY_MARKERS)
                     for k in temporal)
        moved = [k for k in temporal if not torch.equal(trained[k], initial[k])]
        needed = {"bsc_attention", "group_norm_silu", "affine_silu_conv3x3"}
        if name == "animate_diff.yaml":
            needed |= {"flash_attention", "flash_attention_bwd"}
        log(f"warm start {name}: {len(filled)} parameters from the image checkpoint, "
            f"{len(temporal)} temporal trained, {len(moved)} of them moved from init; after "
            f"{WARM_VIDEO_STEPS} temporal-only steps the filled ones bit-equal: {frozen}; "
            f"launches a forward {fwd}, a temporal-only step {step}; run launches {launched}, "
            f"expected {expected}")
        check(frozen and marked and temporal and filled, f"{name}: warm start")
        check(sorted(temporal) == sorted(kept) and moved,
              f"{name}: temporal parameters {len(temporal)} of {len(kept)}, {len(moved)} moved")
        check(launched == expected, f"{name}: warm-start launches {launched}")
        check(needed <= set(launched), f"{name}: {sorted(needed - set(launched))} never launched")
        out[name] = launched
    return out


def phase_moving_mnist_256(fwd, step):
    """video/moving_mnist_256 (its synthesizer: 100 videos of 30 frames at
    256x256, two digits each, resized once to 32) through the video
    `train()` on flexible_diffusion_modeling.yaml, MM256_STEPS steps at
    batch VIDEO_BATCH (its end strip of VIDEO_STRIP_STEPS steps): finite
    losses, launches against FDM's counts a forward `fwd` and a step
    `step`. Returns its launches."""
    run_dir, launched, metrics = video_train(
        FDM_CONFIG, MM256_STEPS, MM256_STEPS, os.path.join(OUT_DIR, "moving_mnist_256"),
        dataset_name="video/moving_mnist_256")
    expected = add_counts(add_counts({}, step, MM256_STEPS), fwd, VIDEO_STRIP_STEPS)
    log(f"video/moving_mnist_256 through the FDM trainer ({MM256_STEPS} steps at batch "
        f"{VIDEO_BATCH}): losses {[round(metrics[i]['loss'], 4) for i in sorted(metrics)]}, "
        f"launches {launched}, expected {expected}")
    check(sorted(metrics) == list(range(MM256_STEPS)), "moving_mnist_256: steps")
    check(launched == expected, f"moving_mnist_256 launches {launched}")
    return launched


# ---- phases 62-65: autoencoders and latent diffusion ---------------------------
#
# The VAE configs (trained through the port's autoencoder CLIs, their
# disc_start lowered to 0 in a copy so that the discriminator phase and the
# adaptive weight run), urbansound8k_4x16x32.yaml (run forward here; it
# trains on UrbanSound8k in phase 70) and ltx_video.yaml (the LTX transformer over
# the LTX VAE's latents). The video VAEs train on 20-frame clips, the real
# Moving-MNIST's length, made by the port's synthesizer and written as the
# real archive (`vae_video_data`): the synthetic stand-in's 16 frames make
# the Hunyuan and OpenSora decoders return 15 and 13, and their loss fails
# on the shapes, as JAX's does.
AUDIO_DIR = os.path.join(ROOT, "configs/audio/urbansound8k")
KL_CONFIG = os.path.join(AUDIO_DIR, "vae.yaml")
KL_WIDE_CONFIG = os.path.join(AUDIO_DIR, "autoencoder/urbansound8k_4x16x32.yaml")
VAE_VIDEO_CONFIGS = {"ltx": os.path.join(VIDEO_DIR, "ltx_video/autoencoder.yaml"),
                     "hunyuan": os.path.join(VIDEO_DIR, "hunyuan_video/autoencoder.yaml"),
                     "open_sora": os.path.join(VIDEO_DIR, "open_sora/vae_hunyuan.yaml")}
LTX_LATENT_CONFIG = os.path.join(VIDEO_DIR, "ltx_video/ltx_video.yaml")
# The CLIs' batches (video 4, image 64); each VAE run's steps (checkpoints
# at VAE_RESUME and the end; a resume from VAE_RESUME repeats its loss);
# the latent LTX run's (batch 8, the video trainer's default) and its strips'
# sampling steps.
VAE_VIDEO_BATCH, VAE_IMAGE_BATCH, VAE_STEPS, VAE_RESUME = 4, 64, 3, 2
LATENT_BATCH, LATENT_STEPS, LATENT_RESUME, LATENT_STRIP_STEPS = 8, 4, 3, 5
# K1/K2 (B, Sq, Sk, C, heads): one head of 256 over the KL VAEs' mid-block
# tokens at the image CLI's batch (vae.yaml's 8x8, urbansound8k_4x16x32's
# 16x32), and ragged. K5/K6 (B, H, Sq, Sk, D): ltx_video.yaml's 3x4x4 latent
# grid at batch 8, self-attention and cross-attention to 128 T5 tokens.
VAE_K1_SITES = [(64, 64, 64, 256, 1), (64, 512, 512, 256, 1)]
VAE_K1_RAGGED = [(3, 65, 65, 256, 1), (2, 511, 511, 256, 1)]
LATENT_FLASH_SITES = {"self": (8, 6, 48, 48, 64), "cross": (8, 6, 48, 128, 64)}


def structure_counts(run):
    """Launches that the structure implies, read by a global forward hook
    while `run()` runs: K1 at every SpatialCrossAttention and VAEAttnBlock,
    K2 beside each one whose output needs a gradient; K3 at every
    plain-form FastGroupNorm call (per-frame statistics, no scale-shift, no
    coefficients for K4); K4 at every fused convolution (a dropping conv2
    leaves it); K5 at every Sora STAttention and unmasked
    CaptionCrossAttention, every HunyuanVideo double- and single-stream
    block and each layer of an unmasked token refiner, K6 beside each one
    whose output needs a gradient. Also the K3 sites (x's shape, groups,
    silu, eps) and the value `run()` returns."""
    from torch.nn.modules.module import register_module_forward_hook

    from xdiffusion_tpu_torch.autoencoders.layers import VAEAttnBlock
    from xdiffusion_tpu_torch.layers.attention import SpatialCrossAttention
    from xdiffusion_tpu_torch.layers.flux import DoubleStreamBlock, SingleStreamBlock
    from xdiffusion_tpu_torch.layers.resnet import FastGroupNorm, FusedAffineConv
    from xdiffusion_tpu_torch.score_networks.hunyuan_video import SingleTokenRefiner
    from xdiffusion_tpu_torch.score_networks.sora import CaptionCrossAttention, STAttention

    counts, sites = {}, []

    def add(name, n, out=None):
        counts[name] = counts.get(name, 0) + n
        first = out[0] if isinstance(out, tuple) else out
        if out is not None and first.requires_grad:
            counts[name + "_bwd"] = counts.get(name + "_bwd", 0) + n

    def hook(mod, args, kwargs, out):
        unmasked = len(args) < 3 or args[2] is None
        if isinstance(mod, FastGroupNorm):
            if (mod.stat_frames == 1 and not kwargs.get("return_coefficients")
                    and kwargs.get("t_scale") is None):
                add("group_norm_silu", 1)
                sites.append((tuple(args[0].shape), mod.num_groups, mod.silu, mod.epsilon))
        elif isinstance(mod, FusedAffineConv):
            add("affine_silu_conv3x3", 1)
        elif isinstance(mod, (SpatialCrossAttention, VAEAttnBlock)):
            add("bsc_attention", 1, out)
        elif (isinstance(mod, (STAttention, DoubleStreamBlock, SingleStreamBlock))
              or (isinstance(mod, CaptionCrossAttention) and unmasked)):
            add("flash_attention", 1, out)
        elif isinstance(mod, SingleTokenRefiner) and unmasked:
            add("flash_attention", mod.depth, out)

    handle = register_module_forward_hook(hook, with_kwargs=True)
    try:
        result = run()
    finally:
        handle.remove()
    return counts, sites, result


def launched_by(run):
    """(kernel launches of `run()` by name, structure counts, K3 sites,
    run's value); the launches checked against the counts."""
    ks = reset_launches()
    counts, sites, result = structure_counts(run)
    torch.cuda.synchronize()
    launched = {k: v.launches for k, v in ks.items() if v.launches}
    check(launched == counts, f"launches {launched} against the structure's {counts}")
    return launched, sites, result


def bsc_site_times(b: int, s: int, c: int, gen, heads: int = 1, label: str = "a KL VAE mid block"):
    """fp32 device ms of K1 and K2 at `heads` heads over c channels and s
    tokens, one call, beside the plain version, SDPA (its backward alone for
    K2) and the bound (`flash_bounds`)."""
    from xdiffusion_tpu_torch.ops import flash_attention as fa

    d, scale = c // heads, (c // heads) ** -0.5
    q, k, v = torch.randn((b, s, 3 * c), generator=gen, device="cuda").chunk(3, -1)
    g = torch.randn((b, s, c), generator=gen, device="cuda")
    heads_last = [t.reshape(b, s, heads, d).transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v)]
    sdpa_o = F.scaled_dot_product_attention(*heads_last)
    gh = g.reshape(b, s, heads, d).transpose(1, 2).contiguous()
    out = {}
    for kernel, fn, plain, lib, nbytes, ops in (
            ("K1", lambda: fa.short_attention_bsc(q, k, v, heads, scale),
             lambda: fa.short_attention_bsc_plain(q, k, v, heads, scale),
             lambda: F.scaled_dot_product_attention(*heads_last), 4 * b * s * c * 4,
             4 * b * s * s * c),
            ("K2", lambda: fa.short_attention_bsc_bwd(q, k, v, g, heads, scale),
             lambda: fa.short_attention_bsc_bwd_plain(q, k, v, g, heads, scale),
             lambda: torch.autograd.grad(sdpa_o, heads_last, gh, retain_graph=True),
             7 * b * s * c * 4, 10 * b * s * s * c)):
        k_ms, p_ms, l_ms, w_ms = device_ms(fn), device_ms(plain), device_ms(lib), time_ms(fn)
        bd = flash_bounds(ops, b * heads * s * s, nbytes, torch.float32)
        log(f"{kernel} at {label} B={b} S={s} C={c} {heads} head(s) fp32, one call: "
            f"{k_ms:.4f} ms (wrapper {w_ms:.4f} ms host time), plain {p_ms:.4f} ms, "
            f"SDPA{' backward' if kernel == 'K2' else ''} {l_ms:.4f} ms, bound "
            f"{bd['bound_ms']:.4f} ms ({bd['binds']})")
        out[kernel] = {"ms": k_ms, "wrapper_ms": w_ms, "plain_ms": p_ms, "library_ms": l_ms,
                       "bound_ms": bd["bound_ms"],
                       "bound_by": "bytes" if bd["binds"] == "bytes" else "operations"}
    return out


def build_vae_cuda(path: str):
    from xdiffusion_tpu_torch.config import load_yaml
    from xdiffusion_tpu_torch.training.image.autoencoder import build_vae

    return build_vae(load_yaml(path), "cuda")


def phase_vae_sites():
    """K1/K2 at one head of 256 (the wide variant) at VAE_K1_SITES and
    VAE_K1_RAGGED, fp32 and bf16, twice bit for bit (`check_bsc_sites`), and
    their fp32 times at the two KL sites; urbansound8k_4x16x32.yaml at full
    width encoding and decoding a batch of 64 log-mels of 64x128 (2 K1 at
    512 keys, its K3 launches against its structure); K3 at every distinct
    GroupNorm site of vae.yaml's forward at batch 64 and of the Hunyuan and
    OpenSora VAEs' at batch 4 x 17 frames (5-D maps of 32-128 channels, 1-4
    a group, one (B, F*H*W, C) problem) in fp32, twice bit for bit, their
    times (warm, cold) beside F.group_norm(+F.silu), the plain version and
    the bound; K5/K6 at LATENT_FLASH_SITES fp32 and bf16, twice bit for bit,
    fp32 times beside the plain version, SDPA and the bound. Returns the
    records for the kernels line."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 62)
    errs = check_bsc_sites(VAE_K1_SITES + VAE_K1_RAGGED, gen)
    out = {"K1": {}, "K2": {}, "K3": {}, "K5": {}, "K6": {}}
    for b, s, _, c, _ in VAE_K1_SITES:
        for kernel, rec in bsc_site_times(b, s, c, gen).items():
            out[kernel][f"{s}_tokens"] = rec

    wide = build_vae_cuda(KL_WIDE_CONFIG)
    x = torch.rand((VAE_IMAGE_BATCH, 64, 128, 1), generator=gen, device="cuda")
    with torch.no_grad():
        launched, wide_sites, recon = launched_by(
            lambda: wide.decode_from_latents(wide.encode_to_latents(x, generator=gen)))
    check(tuple(recon.shape) == tuple(x.shape) and bool(torch.isfinite(recon).all()),
          "urbansound8k_4x16x32: reconstruction")
    check(launched.get("bsc_attention") == 2, f"urbansound8k_4x16x32 K1 launches {launched}")
    log(f"urbansound8k_4x16x32.yaml (full width) encode + decode of {VAE_IMAGE_BATCH} x 64x128: "
        f"launches {launched}, latents (4, 16, 32)")
    del wide

    gn_sites = {}
    for label, path, shape in (("kl", KL_CONFIG, (VAE_IMAGE_BATCH, 32, 32, 1)),
                               ("hunyuan", VAE_VIDEO_CONFIGS["hunyuan"],
                                (VAE_VIDEO_BATCH, 17, 32, 32, 1)),
                               ("open_sora", VAE_VIDEO_CONFIGS["open_sora"],
                                (VAE_VIDEO_BATCH, 17, 32, 32, 1))):
        vae = build_vae_cuda(path)
        xs = torch.rand(shape, generator=gen, device="cuda")
        with torch.no_grad():
            _, sites, _ = launched_by(lambda: vae(xs, generator=gen))
        gn_sites[label] = sites
        del vae
    k3_err, seen = 0.0, set()
    for label, sites in gn_sites.items():
        log(f"K3 sites of the {label} VAE's forward: {counted(sites)}")
        for site in counted(sites):
            _, _, _, e = k3_compare(label, site, gen, seen, dtypes=(torch.float32,))
            k3_err = max(k3_err, e[torch.float32])
        out["K3"][label] = time_k3_k4_sites(f"{label} VAE", sites, [], gen)["K3"]
        del out["K3"][label]["err"]  # the checks' error is the kernels line's `max_abs_err`
    check(any(s[0][-1] // s[1] == 1 and len(s[0]) == 5 for s in gn_sites["hunyuan"]),
          "no K3 site at one channel a group on a 5-D map")

    flash_errs = check_caption_flash_sites(list(LATENT_FLASH_SITES.values()), gen)
    for kernel, recs in flash_site_times("latent LTX's", LATENT_FLASH_SITES, gen).items():
        out[kernel].update(recs)
    out["err"] = {"K1": errs["K1"], "K2": errs["K2"], "K3": k3_err, "K5": flash_errs["K5"],
                  "K6": flash_errs["K6"]}
    return out


def flash_site_times(label: str, sites: dict, gen, operands=None):
    """fp32 device ms of K5 and K6 at each {name: (B, H, Sq, Sk, D)} of
    `sites` (on `operands`, by default `caption_operands`), one call, beside
    the plain version, SDPA (its backward alone for K6) and the bound
    (`flash_bounds`). Returns {"K5"|"K6": {name: record}}."""
    from xdiffusion_tpu_torch.ops import flash_attention as fa

    out = {"K5": {}, "K6": {}}
    for site, (b, h, sq, sk, d) in sites.items():
        q, k, v, g = (operands or caption_operands)(gen, b, h, sq, sk, d, torch.float32)
        scale = d ** -0.5
        o, lse = fa.flash_attention(q, k, v, scale)
        args = (q, k, v, o, lse, g, scale)
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        sdpa_o = F.scaled_dot_product_attention(*leaves, scale=scale)
        flops = 4 * b * h * sq * sk * d
        for kernel, fn, plain, lib, nbytes, kflops in (
                ("K5", lambda: fa.flash_attention(q, k, v, scale),
                 lambda: fa.flash_attention_plain(q, k, v, scale),
                 lambda: F.scaled_dot_product_attention(q, k, v, scale=scale),
                 (2 * q.numel() + k.numel() + v.numel()) * 4 + lse.numel() * 4, flops),
                ("K6", lambda: fa.flash_attention_bwd(*args),
                 lambda: fa.flash_attention_bwd_plain(*args),
                 lambda: torch.autograd.grad(sdpa_o, leaves, g, retain_graph=True),
                 (4 * q.numel() + 4 * k.numel()) * 4 + lse.numel() * 4, 10 * flops // 4)):
            k_ms, p_ms, l_ms, w_ms = device_ms(fn), device_ms(plain), device_ms(lib), time_ms(fn)
            bd = flash_bounds(kflops, b * h * sq * sk, nbytes, torch.float32)
            log(f"{kernel} at {label} {site} site B={b} H={h} Sq={sq} Sk={sk} D={d} fp32, "
                f"one call: {k_ms:.4f} ms (wrapper {w_ms:.4f} ms host time), plain {p_ms:.4f} "
                f"ms, SDPA{' backward' if kernel == 'K6' else ''} {l_ms:.4f} ms, bound "
                f"{bd['bound_ms']:.4f} ms ({bd['binds']})")
            out[kernel][site] = {"ms": k_ms, "wrapper_ms": w_ms, "plain_ms": p_ms,
                                 "library_ms": l_ms, "bound_ms": bd["bound_ms"],
                                 "bound_by": "bytes" if bd["binds"] == "bytes" else "operations"}
    return out


class cudnn_deterministic:
    """While active, cuDNN runs only deterministic algorithms."""

    def __enter__(self):
        self.saved = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True

    def __exit__(self, *exc):
        torch.backends.cudnn.deterministic = self.saved


def vae_video_data():
    """20-frame Moving-MNIST clips at 32x32 (400 to train, 40 to validate)
    from the port's synthesizer, written under OUT_DIR as the real archive
    (moving_mnist/moving_mnist_<split>.npz); returns the data directory."""
    from xdiffusion_tpu_torch.datasets.moving_mnist import synthesize_moving_mnist

    root = os.path.join(OUT_DIR, "vae_data")
    os.makedirs(os.path.join(root, "moving_mnist"), exist_ok=True)
    for split, n, seed in (("train", 400, 0), ("val", 40, 1)):
        videos, labels = synthesize_moving_mnist(n, num_frames=20, image_size=32, seed=seed)
        np.savez(os.path.join(root, "moving_mnist", f"moving_mnist_{split}.npz"),
                 videos=videos, labels=labels)
    return root


class video_data:
    """While active, the video trainers, the autoencoder trainer and the
    reconstruct CLI load video/moving_mnist from `root`'s archives, past
    `cached_datasets` (which holds the 16-frame stand-in)."""

    def __init__(self, root: str):
        self.root = root

    def __enter__(self):
        import xdiffusion_tpu_torch.datasets as datasets
        from xdiffusion_tpu_torch.datasets import utils
        from xdiffusion_tpu_torch.training.video import autoencoder, train

        self.saved_env = os.environ.get("XDIFFUSION_DATA_DIR")
        os.environ["XDIFFUSION_DATA_DIR"] = self.root
        self.modules = (datasets, autoencoder, train)
        self.saved = [m.load_dataset for m in self.modules]
        for m in self.modules:
            m.load_dataset = utils.load_dataset
        return self

    def __exit__(self, *exc):
        for m, fn in zip(self.modules, self.saved):
            m.load_dataset = fn
        if self.saved_env is None:
            os.environ.pop("XDIFFUSION_DATA_DIR", None)
        else:
            os.environ["XDIFFUSION_DATA_DIR"] = self.saved_env


def disc_on_config(path: str) -> str:
    """A copy of a VAE config under OUT_DIR with disc_start 0."""
    import yaml

    with open(path) as f:
        cfg = yaml.safe_load(f)
    cfg["autoencoder"]["params"]["loss_config"]["params"]["disc_start"] = 0
    out = os.path.join(OUT_DIR, "vae_configs", os.path.basename(os.path.dirname(path)) + "_"
                       + os.path.basename(path))
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        yaml.safe_dump(cfg, f)
    return out


def vae_step_times(path: str, batch: int, shape, label: str, profiled: bool):
    """One VAE-GAN step of the config (full width, its loss as `path` has
    it) at `shape`: steps/s over 2 timed steps after one warm-up, and, if
    `profiled`, a profile of one step. Returns (steps/s, (wall ms, busy ms)
    or None)."""
    from xdiffusion_tpu_torch.training.image.autoencoder import (
        create_vae_train_state,
        make_vae_train_step,
    )

    vae = build_vae_cuda(path)
    state = create_vae_train_state(vae, seed=SEED)
    step = make_vae_train_step(vae)
    x = torch.rand(shape, generator=torch.Generator(device="cuda").manual_seed(SEED),
                   device="cuda")
    step(state, {"images": x})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2):
        metrics = step(state, {"images": x})
    check(math.isfinite(metrics["loss_ae"].item()), f"{label}: loss not finite")
    sps = 2 / (time.perf_counter() - t0)
    prof = profile_text(f"a {label} VAE-GAN step (fp32, batch {batch})",
                        lambda: step(state, {"images": x}), f"vae_{label}_step_profile.txt"
                        ) if profiled else None
    del vae, state
    return sps, prof


def phase_vae_runs(data_root: str):
    """The four trainable VAE configs at full width through the port's CLIs,
    disc_start 0 (`disc_on_config`): VAE_STEPS steps (checkpoints and
    reconstructions at VAE_RESUME and the end) at the CLI's batch (the three
    video VAEs 4 clips of 17 frames at 32x32 from `vae_video_data`, vae.yaml
    64 MNIST digits at 32x32), a resume from VAE_RESUME whose logged loss
    repeats bit for bit, the reconstruct CLI on the run (finite, its MSE),
    every run's launches against the structure (`structure_counts`); then each
    config's steps/s, and a profiled step of the LTX and KL VAEs
    (`vae_step_times`). Returns
    ({config: {"training", "resume", "reconstruct": launches}},
    {config: (steps/s, profile)}, {config: its run directory})."""
    from xdiffusion_tpu_torch import reconstruct, train_autoencoder, train_video_autoencoder

    runs, speed, run_dirs = {}, {}, {}
    jobs = [(name, path, train_video_autoencoder, VAE_VIDEO_BATCH, "video/moving_mnist",
             (VAE_VIDEO_BATCH, 17, 32, 32, 1)) for name, path in VAE_VIDEO_CONFIGS.items()]
    jobs.append(("kl", KL_CONFIG, train_autoencoder, VAE_IMAGE_BATCH, "image/mnist",
                 (VAE_IMAGE_BATCH, 32, 32, 1)))
    for name, path, cli, batch, dataset, shape in jobs:
        cfg = disc_on_config(path)
        root = os.path.join(OUT_DIR, "vae_runs", name)
        common = ["--config_path", cfg, "--batch_size", str(batch), "--device", "cuda",
                  "--dataset_name", dataset, "--save_and_sample_every_n", str(VAE_RESUME),
                  "--num_training_steps", str(VAE_STEPS)]
        # The logged autoencoder loss holds the adaptive weight, from the
        # gradients of the decoder's last convolution: cuDNN's default
        # convolution backward sums in a varying order (a resume missed by
        # 2e-7 once), so these runs take its deterministic algorithms.
        with video_data(data_root), cudnn_deterministic():
            t0 = time.perf_counter()
            trained, _, run_dir = launched_by(lambda: cli.main(common + ["--output_path", root]))
            wall = time.perf_counter() - t0
            with resumed_run():
                resumed, _, resumed_dir = launched_by(lambda: cli.main(common + [
                    "--output_path", root + "_resumed",
                    "--resume_from", os.path.join(run_dir, "checkpoints", f"{VAE_RESUME}.pt")]))
            recon, _, (x, y, mse) = launched_by(lambda: reconstruct.main([
                "--config_path", cfg, "--autoencoder_checkpoint", run_dir, "--dataset_name",
                dataset, "--num_samples", "4", "--device", "cuda", "--output_path",
                os.path.join(root, "reconstructions")]))
        metrics, again = read_metrics(run_dir), read_metrics(resumed_dir)
        key = "loss_ae" if name == "kl" else "total_loss"
        check(all(math.isfinite(m[key]) for m in metrics.values()), f"{name}: loss not finite")
        check(again[VAE_RESUME][key] == metrics[VAE_RESUME][key],
              f"{name}: resumed loss {again[VAE_RESUME][key]} != {metrics[VAE_RESUME][key]}")
        check(x.shape == y.shape and math.isfinite(mse), f"{name}: reconstruction")
        log(f"{os.path.basename(path)} ({name}, full width, disc_start 0) through the "
            f"autoencoder CLI: {VAE_STEPS} steps at batch {batch} in {wall:.1f} s with set-up, "
            f"losses {[round(metrics[i][key], 5) for i in sorted(metrics)]}, a resume from "
            f"step {VAE_RESUME} repeats {again[VAE_RESUME][key]!r}; reconstruct CLI MSE "
            f"{mse:.5f}; launches {trained} (resume {resumed}, reconstruct {recon})")
        runs[name] = {"training": trained, "resume": resumed, "reconstruct": recon}
        # The LTX VAE (3-D convolutions) and the KL VAE (K1/K2/K3) profiled.
        speed[name] = vae_step_times(cfg, batch, shape, name, profiled=name in ("ltx", "kl"))
        log(f"{name} VAE-GAN step at batch {batch}: {speed[name][0]:.3f} steps/s")
        run_dirs[name] = run_dir
    return runs, speed, run_dirs


def phase_latent_ltx(data_root: str, vae_run: str):
    """ltx_video.yaml as shipped (12 layers, 6 heads of 64, 32 latent
    channels; fp32) through the video training CLI with
    --load_vae_weights_from_checkpoint on the LTX VAE run of phase 63:
    LATENT_STEPS steps at batch 8 on 17-frame clips (the 3x4x4 latent grid:
    24 K5 a forward, 24 K6 a step, every call at LATENT_FLASH_SITES' shapes),
    decoded strips of LATENT_STRIP_STEPS steps; a resume from LATENT_RESUME
    that recomputes the same latent scale and repeats its loss bit for bit;
    launches against the structure's counts; steps/s and a profiled step;
    decoded samples through `sample()` (samples/s) and the video sampling
    CLI refusing the config, which loads no VAE (JAX's fails on the unset
    scale). Returns its launches and rates."""
    import contextlib
    import io

    from xdiffusion_tpu_torch import sample_video, train_video
    from xdiffusion_tpu_torch.config import load_yaml
    from xdiffusion_tpu_torch.training.image.autoencoder import load_vae_params
    from xdiffusion_tpu_torch.training.image.train import build_model

    root = os.path.join(OUT_DIR, "latent_ltx")
    common = ["--config_path", LTX_LATENT_CONFIG, "--batch_size", str(LATENT_BATCH),
              "--device", "cuda", "--save_and_sample_every_n", str(LATENT_RESUME),
              "--sampling_steps", str(LATENT_STRIP_STEPS), "--num_samples", "4",
              "--load_vae_weights_from_checkpoint", vae_run,
              "--num_training_steps", str(LATENT_STEPS)]
    out = {}
    with video_data(data_root):
        for label, extra in (("training", ["--output_path", root]),
                             ("resume", ["--output_path", root + "_resumed", "--resume_from",
                                         os.path.join(root, "video_moving_mnist", "ltx_video",
                                                      "checkpoints", f"{LATENT_RESUME}.pt")])):
            ks = reset_launches()
            text = io.StringIO()
            with contextlib.redirect_stdout(Tee(sys.stdout, text)), (
                    resumed_run() if label == "resume" else contextlib.nullcontext()):
                calls = flash_calls(lambda: out.setdefault(label, train_video.main(common + extra)))
            torch.cuda.synchronize()
            out[label + "_launches"] = {k: v.launches for k, v in ks.items() if v.launches}
            out[label + "_scale"] = [line for line in text.getvalue().splitlines()
                                     if line.startswith("latent scale factor")]
            out[label + "_calls"] = calls
    metrics, again = read_metrics(out["training"]), read_metrics(out["resume"])
    steps = {"training": LATENT_STEPS, "resume": LATENT_STEPS - LATENT_RESUME}
    for label, n in steps.items():
        launched, calls = out[label + "_launches"], out[label + "_calls"]
        strips = 2 if label == "training" else 1
        want = {"flash_attention": 24 * (n + strips * LATENT_STRIP_STEPS),
                "flash_attention_bwd": 24 * n}
        check(launched == want, f"latent LTX {label} launches {launched} against {want}")
        shapes = set(calls)
        check(shapes <= {LATENT_FLASH_SITES["self"], LATENT_FLASH_SITES["cross"],
                         (4, 6, 48, 48, 64), (4, 6, 48, 128, 64)},
              f"latent LTX K5 shapes {shapes}")
    check(out["training_scale"] == out["resume_scale"] and len(out["training_scale"]) == 1,
          f"latent scale {out['training_scale']} against {out['resume_scale']}")
    check(again[LATENT_RESUME]["loss"] == metrics[LATENT_RESUME]["loss"],
          f"latent LTX resume {again[LATENT_RESUME]['loss']} != {metrics[LATENT_RESUME]['loss']}")

    model = build_model(load_yaml(LTX_LATENT_CONFIG), device="cuda")
    model.set_latent_encoder_params(load_vae_params(vae_run, "cuda"))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 64)
    clips = torch.rand((LATENT_BATCH, 17, 32, 32, 1), generator=gen, device="cuda")
    model.compute_latent_scale(clips, generator=gen)
    ctx = video_context(model, LATENT_BATCH)
    net = model.score_network().train()

    def step():
        loss, _ = model.loss_on_batch(clips, ctx, generator=gen)
        loss.backward()
        net.zero_grad(set_to_none=True)

    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    sps = 3 / (time.perf_counter() - t0)
    prof = profile_text(f"a latent LTX training step (fp32, batch {LATENT_BATCH}, VAE encode "
                        f"included)", step, "latent_ltx_train_profile.txt",
                        expect={"K1": 0, "K5": 24})
    net.eval()
    ctx4 = {"text_prompts": digit_prompts(4)}
    model.sample(num_samples=4, num_sampling_steps=2, context=ctx4)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    samples = model.sample(num_samples=4, num_sampling_steps=LATENT_STRIP_STEPS, context=ctx4)
    torch.cuda.synchronize()
    samples_ps = 4 / (time.perf_counter() - t0)
    check(tuple(samples.shape) == (4, 17, 32, 32, 1) and bool(torch.isfinite(samples).all()),
          f"latent LTX samples {tuple(samples.shape)}")
    del model
    try:
        sample_video.main(["--config_path", LTX_LATENT_CONFIG, "--checkpoint",
                           os.path.join(out["training"], "checkpoints", f"{LATENT_STEPS}.pt"),
                           "--num_samples", "1", "--sampling_steps", "1", "--device", "cuda",
                           "--output_path", os.path.join(root, "cli")])
        refused = False
    except ValueError as e:
        refused = "latent scale" in str(e)
    check(refused, "the video sampling CLI took a latent config without its VAE")
    log(f"ltx_video.yaml (full width, fp32) through the video training CLI from the LTX VAE "
        f"run: {LATENT_STEPS} steps at batch {LATENT_BATCH}, losses "
        f"{[round(metrics[i]['loss'], 5) for i in sorted(metrics)]}, {out['training_scale'][0]} "
        f"on both runs, the resume repeats {again[LATENT_RESUME]['loss']!r}; launches "
        f"{out['training_launches']} (resume {out['resume_launches']}); a step {sps:.3f} "
        f"steps/s; {LATENT_STRIP_STEPS}-step decoded sampling {samples_ps:.3f} samples/s at "
        f"batch 4; the sampling CLI refuses the config (it loads no VAE, as in JAX)")
    return {"launches": {k: out[k + "_launches"] for k in steps}, "steps_per_s": sps,
            "samples_per_s": samples_ps, "step_ms": prof}


def vae_cut_config(path: str, **edits) -> dict:
    """A VAE config's autoencoder block with `edits` on its params."""
    import yaml

    with open(path) as f:
        block = yaml.safe_load(f)["autoencoder"]
    block["params"].update(edits)
    return block


def phase_vae_card_vs_cpu():
    """Card against CPU at reduced depth, fp32 on both sides (TF32 off), the
    same seeded weights (`randomize_`) and injected draws: one VAE-GAN step
    (`make_vae_train_step` at the trainers' learning rate) of each family
    (vae.yaml with one residual block a level at batch 2, the LTX and
    Hunyuan VAEs with one block a level at batch 1 x 9 frames of 16x16;
    widths as shipped): its
    losses within 1e-5, the autoencoder phase's gradient norm within 1e-4,
    the discriminator phase's within 1e-3; then
    ltx_video.yaml's latent loss with injected times, noise and posterior
    draw (the transformer at 2 layers, the VAE at one block a level) within
    1e-5 and a 5-step decoded trajectory within 1e-3 (samples in [0, 1])."""
    import yaml

    from xdiffusion_tpu_torch.config import DotConfig, instantiate_from_config
    from xdiffusion_tpu_torch.diffusion.ddpm import GaussianDiffusion_DDPM
    from xdiffusion_tpu_torch.optim import global_norm
    from xdiffusion_tpu_torch.training.image.autoencoder import (
        create_vae_train_state,
        make_vae_train_step,
    )
    from xdiffusion_tpu_torch.weights import randomize_

    rng = np.random.default_rng(SEED + 65)
    ltx_blocks = [["res_x", 1], ["compress_all", 1]] * 2
    families = {
        "kl": (vae_cut_config(KL_CONFIG, encoder_decoder_config=dict(
            vae_cut_config(KL_CONFIG)["params"]["encoder_decoder_config"], num_res_blocks=1)),
            (2, 32, 32, 1), (2, 8, 8, 4)),
        "ltx": (vae_cut_config(VAE_VIDEO_CONFIGS["ltx"], encoder_blocks=ltx_blocks,
                               decoder_blocks=ltx_blocks, input_number_of_frames=9),
                (1, 9, 16, 16, 1), (1, 3, 4, 4, 32)),
        "hunyuan": (vae_cut_config(VAE_VIDEO_CONFIGS["hunyuan"], layers_per_block=1,
                                   sample_size=16, sample_tsize=9),
                    (1, 9, 16, 16, 1), (1, 5, 4, 4, 4)),
    }
    for name, (block, shape, zshape) in families.items():
        block["params"]["loss_config"]["params"]["disc_start"] = 0
        x = torch.from_numpy(rng.random(shape).astype(np.float32))
        noise = {k: torch.from_numpy(rng.standard_normal(zshape).astype(np.float32))
                 for k in ("noise_ae", "noise_disc")}
        results = {}
        for device in ("cuda", "cpu"):
            vae = instantiate_from_config(block, use_config_struct=True, device=device)
            randomize_(vae, SEED)
            # At the trainers' 4.5e-6: the discriminator phase reads the
            # updated autoencoder, whose Adam step moves each weight by about
            # lr with the sign of its gradient; at 1e-3 those whose gradients
            # are rounding noise (biases before a one-channel-a-group
            # GroupNorm) moved the disc loss by 4e-5 between card and CPU.
            state = create_vae_train_state(vae)
            m = make_vae_train_step(vae)(state, dict(
                images=x.to(device), **{k: v.to(device) for k, v in noise.items()}))
            norms = [global_norm([p.grad for p in getattr(vae, g).parameters()
                                  if p.grad is not None]).item() for g in ("ae", "disc")]
            results[device] = ([m[k].item() for k in ("loss_ae", "loss_disc")], norms)
            del vae, state
        (l_gpu, g_gpu), (l_cpu, g_cpu) = results["cuda"], results["cpu"]
        log(f"card vs CPU, a {name} VAE-GAN step at reduced depth (fp32): losses (ae, disc) "
            f"{l_gpu} vs {l_cpu}, gradient norms (ae, disc) {g_gpu} vs {g_cpu}")
        for a, b in zip(l_gpu, l_cpu):
            check(abs(a - b) <= 1e-5 * abs(b), f"{name} VAE-GAN loss {a} vs {b}")
        # The discriminator's gradients are its convolutions' weight
        # gradients, sums over every position of the batch in other orders on
        # the card and the CPU: their norms differed by 2e-5 to 9.5e-5 (my
        # chip run); the autoencoder's by 3e-6 to 2.6e-5.
        for a, b, tol in zip(g_gpu, g_cpu, (1e-4, 1e-3)):
            check(abs(a - b) <= tol * abs(b), f"{name} VAE-GAN gradient norm {a} vs {b}")

    with open(LTX_LATENT_CONFIG) as f:
        cfg = yaml.safe_load(f)
    cfg["diffusion"]["score_network"]["params"]["num_layers"] = 2
    cut = [["res_x", 1], ["compress_all", 1]] * 3 + [["res_x", 1]]  # as shipped, 1 a level
    cfg["diffusion"]["latent_encoder"]["params"].update(encoder_blocks=cut, decoder_blocks=cut)
    cfg["diffusion"]["classifier_free_guidance"]["unconditional_guidance_probability"] = 0.0
    n, steps = 1, 5
    clips = torch.from_numpy(rng.random((n, 17, 32, 32, 1)).astype(np.float32))
    z = (n, 3, 4, 4, 32)
    draws = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
             for k, s in (("latent", z), ("eps", z), ("init", z), ("noise", (steps,) + z))}
    t = torch.from_numpy(np.float32([0.6]))
    results = {}
    for device in ("cuda", "cpu"):
        model = GaussianDiffusion_DDPM(DotConfig(cfg), device=device)
        randomize_(model.score_network(), SEED)
        randomize_(model.latent_encoder(), SEED + 1)
        model.set_latent_scale(0.9)
        ctx = video_context(model, n, device)
        loss, _ = model.loss_on_batch(clips.to(device), ctx, timesteps=t.to(device),
                                      noise=draws["eps"].to(device), deterministic=True,
                                      latent_noise=draws["latent"].to(device))
        samples = model.sample(num_samples=n, num_sampling_steps=steps,
                               initial_noise=draws["init"],
                               context={"text_prompts": digit_prompts(n),
                                        "sampling_noise": draws["noise"]}).cpu()
        results[device] = (loss.item(), samples)
        del model
    (l_gpu, s_gpu), (l_cpu, s_cpu) = results["cuda"], results["cpu"]
    diff = (s_gpu - s_cpu).abs().max().item()
    log(f"card vs CPU, ltx_video.yaml at reduced depth (2 layers; the VAE one block a level; "
        f"widths as shipped) fp32: latent loss {l_gpu:.7f} vs {l_cpu:.7f}; a {steps}-step "
        f"decoded trajectory max|diff| {diff:.3e} (tol 1e-3)")
    check(abs(l_gpu - l_cpu) <= 1e-5 * abs(l_cpu), f"latent loss {l_gpu} vs {l_cpu}")
    check(tuple(s_gpu.shape) == (n, 17, 32, 32, 1) and diff <= 1e-3,
          f"latent trajectory card vs CPU: {diff}")


# ---- phases 66-71: Sora, HunyuanVideo and the audio path --------------------------

SORA_CONFIG = os.path.join(VIDEO_DIR, "sora.yaml")
HUNYUAN_CONFIG = os.path.join(VIDEO_DIR, "hunyuan_video/hunyuan_video.yaml")
HUNYUAN_VAE_CONFIG = VAE_VIDEO_CONFIGS["hunyuan"]
CLAP_CONFIG = os.path.join(AUDIO_DIR, "ddpm_32x32_v_continuous_clap.yaml")
# K5/K6 (B, H, Sq, Sk, D) at the video trainer's batch 8: Sora's attention
# within each of 16 frames of 8x8 tokens, across the 16 frames at each of
# the 64 locations, and from the 1,024 video tokens to 120 T5 tokens;
# HunyuanVideo's joint attention over 256 text + 144 video tokens (a 9x4x4
# latent grid) and its token refiner's over the 256 text tokens.
SORA_FLASH_SITES = {"spatial": (128, 6, 64, 64, 64), "temporal": (512, 6, 16, 16, 64),
                    "caption": (8, 6, 1024, 120, 64)}
HUNYUAN_FLASH_SITES = {"joint": (8, 6, 400, 400, 64), "refiner": (8, 6, 256, 256, 64)}
# K5 calls a forward the structure implies: Sora's 12 block pairs, each
# block a self-attention and a caption attention; HunyuanVideo's 6 double
# and 12 single blocks and its refiner's 2 layers.
SORA_K5, HUNYUAN_K5 = 48, 20
# The video trainer's steps at VIDEO_BATCH (checkpoints at ST_RESUME and the
# end; a resume from ST_RESUME repeats its loss), its strips' and the video
# sampling CLI's steps; the audio trainer's steps at BATCH (its grids walk
# GRID_STEPS), sample_audio's samples and steps, the audio VAEs' steps.
ST_STEPS, ST_RESUME, ST_STRIP_STEPS, ST_CLI_STEPS = 3, 2, 3, 5
AUDIO_STEPS, AUDIO_RESUME, AUDIO_SAMPLES, AUDIO_SAMPLE_STEPS, AUDIO_VAE_STEPS = 3, 2, 10, 10, 2


def phase_transformer_sites():
    """K5/K6 at SORA_FLASH_SITES and HUNYUAN_FLASH_SITES, fp32 and bf16,
    twice bit for bit (`check_caption_flash_sites`; the caption and refiner
    calls on head views of their projections, the others on contiguous (B,
    H, S, D), as the rotary embedding and the [text; video] concat leave
    them), and each site's fp32 times beside the plain version, SDPA and the
    bound (`flash_site_times`). Returns {"K5"|"K6": {site: record}, "err":
    {"K5", "K6"}}."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 66)
    out = {"K5": {}, "K6": {}, "err": {"K5": 0.0, "K6": 0.0}}
    for prefix, label, sites in (("sora", "Sora's", SORA_FLASH_SITES),
                                 ("hunyuan", "HunyuanVideo's", HUNYUAN_FLASH_SITES)):
        for name, shape in sites.items():
            ops = caption_operands if name in ("caption", "refiner") else joint_operands
            errs = check_caption_flash_sites([shape], gen, operands=ops)
            for kernel in ("K5", "K6"):
                out["err"][kernel] = max(out["err"][kernel], errs[kernel])
            for kernel, recs in flash_site_times(label, {name: shape}, gen, ops).items():
                out[kernel][f"{prefix}_{name}"] = dict(recs[name], shape=list(shape))
    return out


def clap_context(model, b: int, t=None):
    """The CLAP embeddings of b class-name prompts on the card, and a
    time's logSNR when `t` is given."""
    from xdiffusion_tpu_torch.datasets.urbansound8k import CLASS_NAMES

    prompts = [CLASS_NAMES[i % 10] for i in range(b)]
    ctx = {k: v.to("cuda") for k, v in model.preprocess_context(
        {"text_prompts": prompts}).items() if isinstance(v, torch.Tensor)}
    if t is not None:
        ctx["timestep"] = torch.full((b,), t, device="cuda")
        ctx["logsnr_t"] = model.noise_scheduler().logsnr(ctx["timestep"])
    return ctx


def image_step(model, images, ctx, seed: int = SEED):
    """A closure: one training loss and backward (dropout on, from a
    generator) on `images` with `ctx`, as the trainers' step runs it."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    net = model.score_network()

    def run():
        loss, _ = model.loss_on_batch(images, ctx, generator=gen)
        loss.backward()
        net.zero_grad(set_to_none=True)
    return run


def phase_audio_sites():
    """ddpm_32x32_v_continuous_clap.yaml as shipped (fp32, seeded weights):
    the sites of one sampling forward and one training step at BATCH with
    the class names' CLAP embeddings (hooks, `main_path_sites`; the CLAP
    vector joins the timestep embedding and reaches no attention: its
    attention is self-attention, 4 heads of 64, at 16x16 and 4x4); K1/K2 at
    every attention call (`check_bsc_sites`), K3 at every GroupNorm site
    (`k3_compare`) and K4 at every conv site (`check_k4_sites`), each twice
    bit for bit; fp32 times of K1/K2 at the 16x16 site (one call) and of
    K3/K4 per forward (`time_k3_k4_sites`) beside the plain version, the
    library call and the bound; a profiled training step. Returns {"K1"..
    "K4": record, "err": {...}, "step_ms": (wall, busy)}."""
    model = build_model("float32", "cuda", CLAP_CONFIG)
    net = model.score_network()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 67)
    fwd_run = lambda: model.sample(num_samples=BATCH, num_sampling_steps=1,  # noqa: E731
                                   context={"text_prompts": digit_prompts(BATCH)})
    fwd = main_path_sites(model, run=fwd_run)
    images = torch.rand((BATCH, 32, 32, 1), generator=gen, device="cuda")
    step = image_step(model, images, clap_context(model, BATCH))
    net.train()
    train = main_path_sites(model, run=step)
    net.eval()
    shapes = sorted(set(bsc_calls(fwd_run)))
    log(f"audio UNet: K1 calls (B, Sq, Sk, C, heads) {shapes}; launches a forward "
        f"{per_call_counts(fwd)}, a training step {per_call_counts(train, training=True)}")
    check(shapes == [(BATCH, 16, 16, 256, 4), (BATCH, 256, 256, 256, 4)],
          f"audio K1 sites {shapes}")
    errs = check_bsc_sites(shapes, gen)
    seen = set()
    errs["K3"] = 0.0
    for site in counted(fwd["group_norm_silu"] + train["group_norm_silu"]):
        _, _, _, e = k3_compare("audio", site, gen, seen)
        errs["K3"] = max(errs["K3"], e[torch.float32])
    errs["K4"] = check_k4_sites(fwd["affine_silu_conv3x3"] + train["affine_silu_conv3x3"], gen)
    out = bsc_site_times(BATCH, 256, 256, gen, heads=4, label="the audio UNet's 16x16 site")
    out.update(time_k3_k4_sites("audio UNet", fwd["group_norm_silu"],
                                fwd["affine_silu_conv3x3"], gen))
    net.train()
    step()
    out["step_ms"] = profile_text(f"an audio training step (fp32, batch {BATCH})", step,
                                  "audio_train_profile.txt")
    out["steps_per_s"] = steps_per_s(step)
    net.eval()
    out["err"] = errs
    return out


def st_run(cli, args, label: str):
    """`cli.main(args)` under `launched_by`, its stdout kept: (launches, the
    value, the latent-scale lines it printed)."""
    import contextlib
    import io

    text = io.StringIO()
    with contextlib.redirect_stdout(Tee(sys.stdout, text)):
        launched, _, value = launched_by(lambda: cli.main(args))
    log(f"{label}: launches {launched}")
    scale = [ln for ln in text.getvalue().splitlines() if ln.startswith("latent scale factor")]
    return launched, value, scale


def st_structure(model, sample_ctx, step, k5: int, label: str):
    """K5/K6 launches of one sampling forward (1-step sampling) and one
    training step, against k5 each, and the K5 shapes they run."""
    calls = set()
    with torch.no_grad():
        fwd, _, _ = structure_counts(lambda: calls.update(flash_calls(
            lambda: model.sample(num_samples=VIDEO_BATCH, num_sampling_steps=1,
                                 context=sample_ctx))))
    model.score_network().train()
    train, _, _ = structure_counts(lambda: calls.update(flash_calls(step)))
    model.score_network().eval()
    log(f"{label}: launches a sampling forward {fwd}, a training step {train}; K5 calls "
        f"{sorted(calls)}")
    check(fwd.get("flash_attention") == k5 and "flash_attention_bwd" not in fwd,
          f"{label}: K5 a forward {fwd}")
    check(train.get("flash_attention") == k5 and train.get("flash_attention_bwd") == k5,
          f"{label}: K5/K6 a step {train}")
    return calls


def st_train_runs(cli_args, root: str, label: str):
    """The video training CLI: ST_STEPS steps, then a resume from ST_RESUME
    whose logged loss (and latent scale) repeat. Returns ({"training",
    "resume": launches}, the run dir)."""
    import contextlib

    from xdiffusion_tpu_torch import train_video

    runs, out, scales = {}, {}, {}
    for kind in ("training", "resume"):
        extra = ["--output_path", root + ("_resumed" if kind == "resume" else "")]
        if kind == "resume":
            extra += ["--resume_from", os.path.join(out["training"], "checkpoints",
                                                    f"{ST_RESUME}.pt")]
        with resumed_run() if kind == "resume" else contextlib.nullcontext():
            runs[kind], out[kind], scales[kind] = st_run(train_video, cli_args + extra,
                                                         f"{label} {kind}")
    metrics, again = read_metrics(out["training"]), read_metrics(out["resume"])
    check(scales["training"] == scales["resume"],
          f"{label}: latent scale {scales['resume']} against {scales['training']}")
    check(all(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])
              for m in metrics.values()), f"{label}: loss not finite")
    check(again[ST_RESUME]["loss"] == metrics[ST_RESUME]["loss"],
          f"{label}: resumed loss {again[ST_RESUME]['loss']} != {metrics[ST_RESUME]['loss']}")
    log(f"{label}: losses {[round(metrics[i]['loss'], 5) for i in sorted(metrics)]}, the resume "
        f"from step {ST_RESUME} repeats {again[ST_RESUME]['loss']!r}"
        + (f", {scales['training'][0]} on both runs" if scales["training"] else ""))
    return runs, out["training"]


def steps_per_s(step, n: int = 3) -> float:
    """Steps/s of n calls of `step` after it has run once."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    torch.cuda.synchronize()
    return n / (time.perf_counter() - t0)


def timed_samples(model, n: int, steps: int, ctx) -> float:
    """samples/s of `steps`-step sampling of n, after a warm-up step."""
    model.sample(num_samples=n, num_sampling_steps=1, context=ctx)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = model.sample(num_samples=n, num_sampling_steps=steps, context=ctx)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out).all()), "samples not finite")
    return n / (time.perf_counter() - t0)


def phase_sora():
    """sora.yaml as shipped (fp32; 12 block pairs of 6 heads of 64, 58.4M
    parameters) at VIDEO_BATCH: one sampling forward and one training step
    with seeded weights and an OpenSora frame mask hold SORA_K5 K5 (and K6)
    launches at SORA_FLASH_SITES' shapes; a profiled training step; the
    video training CLI (its mask_ratios through OpenSoraMaskGenerator,
    prompts from the labels, strips of ST_STRIP_STEPS steps) and a resume;
    the video sampling CLI on its checkpoint (ST_CLI_STEPS steps, 4
    samples); every run's launches against the structure (`launched_by`);
    steps/s and samples/s. Returns its launches and rates."""
    from xdiffusion_tpu_torch import sample_video
    from xdiffusion_tpu_torch.masking import OpenSoraMaskGenerator

    model = build_video(SORA_CONFIG, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 68)
    ctx = video_context(model, VIDEO_BATCH)
    ratios = model.config().training.mask_ratios.to_dict()
    ctx["video_mask"] = torch.from_numpy(OpenSoraMaskGenerator(mask_ratios=ratios).get_masks(
        (VIDEO_BATCH, 16), rng=np.random.default_rng(SEED))).to("cuda")
    videos = torch.rand((VIDEO_BATCH, 16, 32, 32, 1), generator=gen, device="cuda")
    step = image_step(model, videos, ctx)
    calls = st_structure(model, {"text_prompts": digit_prompts(VIDEO_BATCH)}, step, SORA_K5,
                         "sora.yaml")
    check(calls <= set(SORA_FLASH_SITES.values()), f"Sora K5 shapes {calls}")
    model.score_network().train()
    step()
    step_ms = profile_text(f"a Sora training step (fp32, batch {VIDEO_BATCH})", step,
                           "sora_train_profile.txt", expect={"K1": 0, "K5": SORA_K5})
    sps = steps_per_s(step)
    model.score_network().eval()
    samples_ps = timed_samples(model, VIDEO_BATCH, ST_CLI_STEPS,
                               {"text_prompts": digit_prompts(VIDEO_BATCH)})
    del model

    root = os.path.join(OUT_DIR, "sora")
    args = ["--config_path", SORA_CONFIG, "--batch_size", str(VIDEO_BATCH), "--device", "cuda",
            "--save_and_sample_every_n", str(ST_RESUME), "--sampling_steps",
            str(ST_STRIP_STEPS), "--num_samples", "4", "--num_training_steps", str(ST_STEPS)]
    runs, run = st_train_runs(args, root, "sora.yaml through the video training CLI")
    runs["sampling_cli"], samples, _ = st_run(sample_video, [
        "--config_path", SORA_CONFIG, "--checkpoint",
        os.path.join(run, "checkpoints", f"{ST_STEPS}.pt"), "--num_samples", "4",
        "--sampling_steps", str(ST_CLI_STEPS), "--device", "cuda", "--output_path",
        os.path.join(root, "cli")], "sora.yaml through the video sampling CLI")
    check(tuple(samples.shape) == (4, 16, 32, 32, 1) and bool(torch.isfinite(samples).all()),
          f"Sora samples {tuple(samples.shape)}")
    log(f"sora.yaml (full width, fp32): training {sps:.3f} steps/s at batch {VIDEO_BATCH} "
        f"(the trainer's step; a step {step_ms[0]:.3f} ms wall, {step_ms[1]:.3f} ms device); "
        f"{ST_CLI_STEPS}-step sampling "
        f"{samples_ps:.3f} samples/s at batch {VIDEO_BATCH}")
    return {"launches": runs, "steps_per_s": sps, "samples_per_s": samples_ps,
            "step_ms": step_ms}


def phase_hunyuan(data_root: str, vae_run: str):
    """hunyuan_video.yaml as shipped (fp32; 6 double and 12 single blocks of
    6 heads of 64, 64.6M parameters) over the Hunyuan VAE of phase 63's run
    (its config's VAE block is that run's; 17 frames of 32x32 -> 9 x 8 x 8
    x 4): one decoded sampling forward and one training step with seeded
    weights hold HUNYUAN_K5 K5 (and K6) launches at HUNYUAN_FLASH_SITES'
    shapes, the VAE's K3 against its structure; a profiled training step
    (the VAE's encode included); the video training CLI with
    --load_vae_weights_from_checkpoint and a resume that recomputes the
    latent scale and repeats its loss; every run's launches against the
    structure; the video sampling CLI refusing the latent config (it loads
    no VAE, as JAX's fails); steps/s and decoded samples/s. Returns its
    launches and rates."""
    from xdiffusion_tpu_torch import sample_video
    from xdiffusion_tpu_torch.training.image.autoencoder import load_vae_params

    model = build_video(HUNYUAN_CONFIG, "cuda")
    model.set_latent_encoder_params(load_vae_params(vae_run, "cuda"))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 69)
    clips = torch.rand((VIDEO_BATCH, 17, 32, 32, 1), generator=gen, device="cuda")
    model.compute_latent_scale(clips, generator=gen)
    step = image_step(model, clips, video_context(model, VIDEO_BATCH))
    calls = st_structure(model, {"text_prompts": digit_prompts(VIDEO_BATCH)}, step, HUNYUAN_K5,
                         "hunyuan_video.yaml")
    check(calls <= set(HUNYUAN_FLASH_SITES.values()), f"Hunyuan K5 shapes {calls}")
    model.score_network().train()
    step()
    step_ms = profile_text(f"a HunyuanVideo training step (fp32, batch {VIDEO_BATCH}, the VAE "
                           f"encode included)", step, "hunyuan_train_profile.txt",
                           expect={"K1": 0, "K5": HUNYUAN_K5})
    sps = steps_per_s(step)
    model.score_network().eval()
    samples_ps = timed_samples(model, VIDEO_BATCH, ST_STRIP_STEPS,
                               {"text_prompts": digit_prompts(VIDEO_BATCH)})
    del model

    root = os.path.join(OUT_DIR, "hunyuan_video")
    args = ["--config_path", HUNYUAN_CONFIG, "--batch_size", str(VIDEO_BATCH), "--device",
            "cuda", "--save_and_sample_every_n", str(ST_RESUME), "--sampling_steps",
            str(ST_STRIP_STEPS), "--num_samples", "4", "--num_training_steps", str(ST_STEPS),
            "--load_vae_weights_from_checkpoint", vae_run]
    with video_data(data_root):
        runs, run = st_train_runs(args, root, "hunyuan_video.yaml through the video training CLI")
    try:
        sample_video.main(["--config_path", HUNYUAN_CONFIG, "--checkpoint",
                           os.path.join(run, "checkpoints", f"{ST_STEPS}.pt"), "--num_samples",
                           "1", "--sampling_steps", "1", "--device", "cuda", "--output_path",
                           os.path.join(root, "cli")])
        refused = False
    except ValueError as e:
        refused = "latent scale" in str(e)
    check(refused, "the video sampling CLI took hunyuan_video.yaml without its VAE")
    log(f"hunyuan_video.yaml (full width, fp32) over the Hunyuan VAE run: training {sps:.3f} "
        f"steps/s at batch {VIDEO_BATCH} (the trainer's step with the VAE encode; a step "
        f"{step_ms[0]:.3f} ms wall, {step_ms[1]:.3f} ms device); {ST_STRIP_STEPS}-step "
        f"decoded sampling "
        f"{samples_ps:.3f} samples/s at batch {VIDEO_BATCH}; the sampling CLI refuses the "
        f"config (it loads no VAE, as in JAX)")
    return {"launches": runs, "steps_per_s": sps, "samples_per_s": samples_ps,
            "step_ms": step_ms}


def phase_audio():
    """The audio path through its CLIs on the synthetic UrbanSound8k: the
    CLAP config (fp32, full width) through the audio training CLI at BATCH,
    the class names as prompts (AUDIO_STEPS steps, grids of GRID_STEPS, a
    resume from AUDIO_RESUME that repeats its loss), then `sample_audio` on
    its checkpoint (AUDIO_SAMPLES samples, AUDIO_SAMPLE_STEPS steps,
    Griffin-Lim on the card, WAVs and its JSON line); the two audio VAE
    configs (disc_start 0) through the audio autoencoder CLI, AUDIO_VAE_STEPS
    VAE-GAN steps at BATCH on 32x32 and 64x128 log-mels; every run's
    launches against the structure. Returns its launches and rates."""
    import wave

    from xdiffusion_tpu_torch import sample_audio, train_audio, train_audio_autoencoder

    root = os.path.join(OUT_DIR, "audio")
    args = ["--config_path", CLAP_CONFIG, "--batch_size", str(BATCH), "--device", "cuda",
            "--save_and_sample_every_n", str(AUDIO_RESUME), "--num_samples", "16",
            "--num_training_steps", str(AUDIO_STEPS)]
    runs = {}
    runs["training"], run, _ = st_run(train_audio, args + ["--output_path", root],
                                      "the CLAP config through the audio training CLI")
    with resumed_run():
        runs["resume"], resumed, _ = st_run(train_audio, args + [
            "--output_path", root + "_resumed", "--resume_from",
            os.path.join(run, "checkpoints", f"{AUDIO_RESUME}.pt")], "its resume")
    metrics, again = read_metrics(run), read_metrics(resumed)
    check(all(math.isfinite(m["loss"]) for m in metrics.values()), "audio: loss not finite")
    check(again[AUDIO_RESUME]["loss"] == metrics[AUDIO_RESUME]["loss"],
          f"audio: resumed loss {again[AUDIO_RESUME]['loss']} != {metrics[AUDIO_RESUME]['loss']}")
    wavs = os.path.join(root, "wavs")
    runs["sample_audio"], result, _ = st_run(sample_audio, [
        "--config_path", CLAP_CONFIG, "--checkpoint", os.path.join(run, "checkpoints",
                                                                   f"{AUDIO_STEPS}.pt"),
        "--num_samples", str(AUDIO_SAMPLES), "--sampling_steps", str(AUDIO_SAMPLE_STEPS),
        "--device", "cuda", "--output_path", wavs], "sample_audio")
    names = sorted(n for n in os.listdir(wavs) if n.endswith(".wav"))
    check(len(names) == AUDIO_SAMPLES and os.path.getsize(os.path.join(wavs, "mel_grid.png")),
          f"sample_audio wrote {names}")
    with wave.open(os.path.join(wavs, names[0])) as w:
        check((w.getsampwidth(), w.getframerate(), w.getnframes()) == (2, 22050, 32 * 256),
              "sample_audio: WAV format")
    log(f"audio: losses {[round(metrics[i]['loss'], 5) for i in sorted(metrics)]}, the resume "
        f"repeats {again[AUDIO_RESUME]['loss']!r}; sample_audio {result}")
    for name, path in (("vae", KL_CONFIG), ("vae_64x128", KL_WIDE_CONFIG)):
        runs[name], vae_run, _ = st_run(train_audio_autoencoder, [
            "--config_path", disc_on_config(path), "--batch_size", str(BATCH), "--device",
            "cuda", "--num_training_steps", str(AUDIO_VAE_STEPS), "--output_path",
            os.path.join(root, name)], f"{os.path.basename(path)} through the audio "
                                       f"autoencoder CLI")
        losses = [m["loss_ae"] for m in read_metrics(vae_run).values()]
        check(all(math.isfinite(x) for x in losses), f"{name}: losses {losses}")
    return {"launches": runs, "samples_per_s": result["samples_per_sec"]}


def phase_transformers_card_vs_cpu():
    """Card against CPU at reduced depth, fp32 on both sides (TF32 off), the
    same seeded weights (`randomize_`) and injected draws, batch 1: sora.yaml
    at 2 block pairs (an OpenSora frame mask conditioning the first frame),
    hunyuan_video.yaml at one double and one single block over its VAE at
    one block a level (17 frames of 32x32, the posterior draw injected),
    the CLAP config at one residual block a level (widths as shipped): the
    loss at an injected time and noise (dropout off) within 1e-5, its
    gradient norm within 1e-4, and a 5-step trajectory (Hunyuan's decoded)
    within 1e-3 on samples in [0, 1]."""
    import yaml

    from xdiffusion_tpu_torch.config import DotConfig
    from xdiffusion_tpu_torch.datasets.urbansound8k import CLASS_NAMES
    from xdiffusion_tpu_torch.optim import global_norm
    from xdiffusion_tpu_torch.training.image.train import build_model as build
    from xdiffusion_tpu_torch.weights import randomize_

    rng = np.random.default_rng(SEED + 71)
    steps = 5

    def cut(path, **edits):
        with open(path) as f:
            cfg = yaml.safe_load(f)
        cfg["diffusion"]["score_network"]["params"].update(edits)
        cfg["diffusion"]["classifier_free_guidance"]["unconditional_guidance_probability"] = 0.0
        return cfg

    hunyuan = cut(HUNYUAN_CONFIG, mm_double_blocks_depth=1, mm_single_blocks_depth=1)
    hunyuan["diffusion"]["latent_encoder"]["params"]["layers_per_block"] = 1
    cases = {
        "sora.yaml": (cut(SORA_CONFIG, depth=2), (1, 16, 32, 32, 1), (1, 16, 32, 32, 1),
                      digit_prompts(1)),
        "hunyuan_video.yaml": (hunyuan, (1, 17, 32, 32, 1), (1, 9, 8, 8, 4), digit_prompts(1)),
        os.path.basename(CLAP_CONFIG): (cut(CLAP_CONFIG, num_resnet_blocks=1), (1, 32, 32, 1),
                                        (1, 32, 32, 1), [CLASS_NAMES[3]]),
    }
    for name, (cfg, shape, zshape, prompts) in cases.items():
        draws = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                 for k, s in (("eps", zshape), ("latent", zshape), ("init", zshape),
                              ("noise", (steps,) + zshape))}
        images = torch.from_numpy(rng.random(shape).astype(np.float32))
        t = torch.from_numpy(np.float32([0.6]))
        results = {}
        for device in ("cuda", "cpu"):
            model = build(DotConfig(cfg), device=device)
            randomize_(model.score_network(), SEED)
            extra = {}
            if model.latent_encoder() is not None:
                randomize_(model.latent_encoder(), SEED + 1)
                model.set_latent_scale(0.9)
                extra["latent_noise"] = draws["latent"].to(device)
            ctx = {k: v.to(device) for k, v in model.preprocess_context(
                {"text_prompts": prompts}).items() if isinstance(v, torch.Tensor)}
            if name == "sora.yaml":
                ctx["video_mask"] = torch.tensor([[False] + [True] * 15], device=device)
            loss, _ = model.loss_on_batch(images.to(device), ctx, timesteps=t.to(device),
                                          noise=draws["eps"].to(device), deterministic=True,
                                          **extra)
            loss.backward()
            gnorm = global_norm([p.grad for p in model.score_network().parameters()
                                 if p.grad is not None]).item()
            samples = model.sample(num_samples=1, num_sampling_steps=steps,
                                   initial_noise=draws["init"],
                                   context={"text_prompts": prompts,
                                            "sampling_noise": draws["noise"]}).cpu()
            results[device] = (loss.item(), gnorm, samples)
            del model
        (l_gpu, g_gpu, s_gpu), (l_cpu, g_cpu, s_cpu) = results["cuda"], results["cpu"]
        diff = (s_gpu - s_cpu).abs().max().item()
        log(f"card vs CPU, {name} at reduced depth (widths as shipped) fp32: loss {l_gpu:.7f} "
            f"vs {l_cpu:.7f}, grad_norm {g_gpu:.6f} vs {g_cpu:.6f}; a {steps}-step trajectory "
            f"{tuple(s_gpu.shape)} max|diff| {diff:.3e} (tol 1e-3)")
        check(abs(l_gpu - l_cpu) <= 1e-5 * abs(l_cpu), f"{name} loss {l_gpu} vs {l_cpu}")
        check(abs(g_gpu - g_cpu) <= 1e-4 * abs(g_cpu), f"{name} grad_norm {g_gpu} vs {g_cpu}")
        check(tuple(s_gpu.shape) == shape and diff <= 1e-3,
              f"{name} trajectory card vs CPU: {diff}")


# ---- the trainer extras: LoRA, gradient accumulation, importance sampling,
# observability (phases 72-75) -------------------------------------------

# LoRA: rank, steps of the train() run and its save interval (its resume
# starts at the first save), DDIM steps of the sampling CLI with
# --lora_weights. Gradient accumulation: k and the mini-steps of the run,
# whose resume starts after mini-step 3. Importance sampling: the steps of
# the run (a resume from step 2) and the warmed history's seed. The
# profiler's window starts at PROFILE_START.
LORA_RANK, LORA_STEPS, LORA_SAVE, LORA_SAMPLING_STEPS = 4, 4, 2, 3
ACCUM_K, ACCUM_STEPS = 2, 4
IMPORTANCE_STEPS, IMPORTANCE_SAVE = 4, 2
PROFILE_START = 1
IMPORTANCE_OVERRIDE = {"target": "xdiffusion_tpu.importance_sampling.ImportanceSampler",
                       "params": {"num_timesteps": 1000, "history_per_term": 10,
                                  "uniform_prob": 0.001}}


def expected_launches(per_step, per_forward, steps: int, forwards: int):
    """{kernel: launches} of `steps` bf16 flagship training steps and
    `forwards` sampling forwards, every kernel of the build named."""
    from xdiffusion_tpu_torch.ops._build import kernels

    return {name: steps * per_step.get(name, 0) + forwards * per_forward.get(name, 0)
            for name in kernels()}


def run_counted(fn):
    """({kernel: launches} of `fn()`, its value)."""
    ks = reset_launches()
    value = fn()
    torch.cuda.synchronize()
    return {name: k.launches for name, k in ks.items()}, value


class captured_models:
    """While active, the image trainer's `build_model` keeps every process
    it builds in `.models`, after `edit(model)` when given."""

    def __init__(self, edit=None):
        self.edit, self.models = edit, []

    def __enter__(self):
        from xdiffusion_tpu_torch.training.image import train as trainer

        self.saved = build = trainer.build_model

        def recording(config, device=None):
            model = build(config, device=device)
            if self.edit is not None:
                self.edit(model)
            self.models.append(model)
            return model

        trainer.build_model = recording
        return self

    def __exit__(self, *exc):
        from xdiffusion_tpu_torch.training.image import train as trainer

        trainer.build_model = self.saved


class summary_on:
    """While active, the trainers print their start-up model summary (the
    run keeps it off: its forward would add launches to every run's count)."""

    def __enter__(self):
        os.environ["XDIFFUSION_MODEL_SUMMARY"] = "1"

    def __exit__(self, *exc):
        os.environ["XDIFFUSION_MODEL_SUMMARY"] = "0"


def check_run(label: str, out_dir: str, launches, expected, steps):
    """The run's launches against `expected`, and a finite loss and
    grad_norm at each of `steps` in its metrics.jsonl; returns the metrics."""
    log(f"{label}: launches {launches}, expected {expected}")
    check(launches == expected, f"{label}: launches {launches} != {expected}")
    metrics = read_metrics(out_dir)
    for step in steps:
        check(step in metrics, f"{label}: no metrics at step {step}")
        r = metrics[step]
        log(f"  step {step}: loss {r['loss']:.6f} grad_norm {r['grad_norm']:.4f}")
        check(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]),
              f"{label}: step {step}'s loss or grad_norm is not finite")
    return metrics


def check_resumed(label: str, metrics, resumed_dir: str, step: int) -> None:
    want, got = metrics[step]["loss"], read_metrics(resumed_dir)[step]["loss"]
    log(f"{label}: resumed step {step}'s loss {got!r} against {want!r}")
    check(abs(got - want) <= 1e-6 * abs(want), f"{label}: the resumed step's loss differs")


def fp32_batch(n: int, seed: int = SEED):
    """A seeded fp32 flagship batch: images, timesteps and noise (CPU)."""
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.random((n, 32, 32, 1)).astype(np.float32)),
            torch.from_numpy(rng.integers(0, 1000, size=n)),
            torch.from_numpy(rng.standard_normal((n, 32, 32, 1)).astype(np.float32)))


def seeded_lora(net, seed: int = SEED):
    """A LoRA of `net` with seeded factors, down N(0, 1) / r and up N(0,
    0.01^2), drawn on the host so that the card and the CPU hold the same."""
    from xdiffusion_tpu_torch import lora as lora_lib

    lora = lora_lib.inject_trainable_lora(net, r=LORA_RANK)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for d, u in zip(lora.down, lora.up):
            d.copy_(torch.from_numpy(rng.standard_normal(tuple(d.shape)).astype(np.float32)
                                     / LORA_RANK))
            u.copy_(torch.from_numpy(0.01 * rng.standard_normal(tuple(u.shape)).astype(
                np.float32)))
    return lora


def phase_lora(sites, base: str):
    """72. LoRA fine-tuning of the flagship (bf16, batch TRAIN_BATCH) over
    the base checkpoint `base` (phase 5's): LORA_STEPS steps through
    `train()` with `use_lora_training` (each step's K1-K4 launches a
    flagship step's; every base parameter bit for bit unchanged; finite
    losses; lora_weights.pkl), a resume through the `train_lora` CLI that
    repeats the loss at its step, the sampling CLI with --lora_weights
    (LORA_SAMPLING_STEPS DDIM steps at batch BATCH, its launches) equal bit
    for bit to sampling the merged network, and card against CPU in fp32 at
    batch 4: one LoRA loss, the factors' gradients (the base gets none) and
    the merged network's forward. Returns the runs' launches."""
    import shutil

    from xdiffusion_tpu_torch import checkpoints, lora as lora_lib
    from xdiffusion_tpu_torch import sample as sample_cli
    from xdiffusion_tpu_torch import train_lora
    from xdiffusion_tpu_torch.config import instantiate_from_config, load_yaml
    from xdiffusion_tpu_torch.diffusion.ddpm import GaussianDiffusion_DDPM
    from xdiffusion_tpu_torch.training.image.train import train
    from xdiffusion_tpu_torch.weights import load_checkpoint

    per_step, per_forward = flagship_counts(sites)
    root = os.path.join(OUT_DIR, "lora")
    shutil.rmtree(root, ignore_errors=True)
    config = flagship_config_file("bfloat16", root)
    runs = {}
    with captured_models() as cap:
        launches, out_dir = run_counted(lambda: train(
            config, num_training_steps=LORA_STEPS, batch_size=TRAIN_BATCH,
            output_path=os.path.join(root, "run"), save_and_sample_every_n=LORA_SAVE,
            num_samples=NUM_SAMPLES, seed=SEED, device="cuda", log_every=1,
            use_lora_training=True, lora_rank=LORA_RANK,
            load_model_weights_from_checkpoint=base))
    runs["lora training"] = launches
    metrics = check_run("LoRA training run", out_dir, launches, expected_launches(
        per_step, per_forward, LORA_STEPS, 2 * GRID_STEPS), range(LORA_STEPS))
    lora_file = os.path.join(out_dir, "lora_weights.pkl")
    check(os.path.isfile(lora_file), "the LoRA run wrote no lora_weights.pkl")
    net = cap.models[0].score_network()
    lora_lib.detach(net)  # the parameters are the frozen bases again
    want = checkpoints.read_payload(base, "cuda")["params"]
    changed = [k for k, v in net.state_dict().items() if not torch.equal(v, want[k])]
    log(f"LoRA run: {len(want)} base tensors, {len(changed)} changed")
    check(not changed, f"the LoRA run changed base parameters {changed[:5]}")

    with resumed_run():
        launches, resumed = run_counted(lambda: train_lora.main([
            "--config_path", config, "--load_model_weights_from_checkpoint", base,
            "--resume_from", os.path.join(out_dir, "checkpoints", f"{LORA_SAVE}.pt"),
            "--num_training_steps", str(LORA_SAVE + 1), "--batch_size", str(TRAIN_BATCH),
            "--num_samples", str(NUM_SAMPLES), "--save_and_sample_every_n", str(LORA_SAVE),
            "--output_path", os.path.join(root, "resumed"), "--seed", str(SEED),
            "--device", "cuda"]))
    runs["lora resume (train_lora CLI)"] = launches
    expected = expected_launches(per_step, per_forward, 1, GRID_STEPS)
    check(launches == expected, f"LoRA resume: launches {launches} != {expected}")
    check_resumed("LoRA", metrics, resumed, LORA_SAVE)

    launches, got = run_counted(lambda: sample_cli.main([
        "--config_path", config, "--checkpoint", base, "--lora_weights", lora_file,
        "--num_samples", str(BATCH), "--sampler_config_path", DDIM_CONFIG,
        "--sampling_steps", str(LORA_SAMPLING_STEPS), "--seed", str(SEED),
        "--output_path", os.path.join(root, "samples"), "--device", "cuda"]))
    runs["sampling CLI --lora_weights"] = launches
    expected = expected_launches({}, per_forward, 0, LORA_SAMPLING_STEPS)
    check(launches == expected, f"LoRA sampling CLI: launches {launches} != {expected}")
    model = GaussianDiffusion_DDPM(load_yaml(config), device="cuda")
    load_checkpoint(model.score_network(), base)
    lora_lib.merge_lora(model.score_network(),
                        lora_lib.load_lora_weights(lora_file, model.score_network()))
    sampler = instantiate_from_config(load_yaml(DDIM_CONFIG).sampling.to_dict())
    want = model.sample(num_samples=BATCH, num_sampling_steps=LORA_SAMPLING_STEPS,
                        sampler=sampler,
                        generator=torch.Generator(device="cuda").manual_seed(SEED))
    log(f"sampling CLI with --lora_weights against the merged network: max|diff| "
        f"{(got.float() - want.float()).abs().max().item():.3e}")
    check(torch.equal(got, want), "the LoRA sampling CLI differs from the merged network")

    # Card against CPU, fp32, batch 2, dropout off.
    images, t, noise = fp32_batch(2)
    results = {}
    for device in ("cuda", "cpu"):
        model = build_model("float32", device)
        net = model.score_network()
        lora = seeded_lora(net)
        lora_lib.attach(net, lora)
        loss, _ = model.loss_on_batch(images.to(device), {}, timesteps=t.to(device),
                                      noise=noise.to(device), deterministic=True)
        loss.backward()
        check(all(p.grad is None for p in net.parameters()), "a base parameter got a gradient")
        grads = {name: p.grad.detach().cpu() for name, p in lora.named_parameters()}
        lora_lib.detach(net)
        lora_lib.merge_lora(net, lora)
        with torch.inference_mode():
            out = model.predict_score(images.to(device), {"timestep": t.to(device)})
        results[device] = (loss.item(), grads, out.float().cpu())
    (l_gpu, g_gpu, o_gpu), (l_cpu, g_cpu, o_cpu) = results["cuda"], results["cpu"]
    floor = 1e-3 * max(g.abs().max().item() for g in g_cpu.values())
    worst = max((rel_err(g_gpu[k], g_cpu[k], floor), k) for k in g_cpu)
    err = (o_gpu - o_cpu).abs().max().item()
    log(f"card vs CPU LoRA, fp32 batch 2: loss {l_gpu:.7f} vs {l_cpu:.7f}, worst factor "
        f"gradient {worst[1]} at {worst[0]:.3e} ({len(g_cpu)} factors), merged forward "
        f"max|diff| {err:.3e}")
    check(abs(l_gpu - l_cpu) <= 1e-4 * abs(l_cpu), f"LoRA loss {l_gpu} vs {l_cpu}")
    check(worst[0] <= 1e-3, f"LoRA factor gradient {worst[1]}: {worst[0]} > 1e-3")
    check(err <= 2e-3, f"merged LoRA forward: {err} > 2e-3")
    return runs


def phase_accumulation(sites):
    """73. Gradient accumulation (optax.MultiSteps) on the flagship (bf16,
    batch TRAIN_BATCH): k = ACCUM_K over 4 mini-steps of the train step with
    EMA, the parameters changing only after mini-steps 2 and 4 (the EMA
    after each), each mini-step's launches a flagship step's;
    `train(gradient_accumulation_steps=ACCUM_K)` for ACCUM_STEPS mini-steps
    and a resume after mini-step 3 that repeats mini-step 4's loss; card
    against CPU (fp32, batch 2, dropout off): the mini-batches' gradient
    norms and their running mean, and on the card the accumulated update
    equal bit for bit to one step on that mean. Returns the runs' launches."""
    import shutil

    from xdiffusion_tpu_torch import checkpoints
    from xdiffusion_tpu_torch.optim import MultiSteps, default_optimizer, global_norm
    from xdiffusion_tpu_torch.train_step import create_train_state, make_train_step
    from xdiffusion_tpu_torch.training.image.train import train

    per_step, per_forward = flagship_counts(sites)
    model = build_model("bfloat16", "cuda")
    net = model.score_network()
    opt = MultiSteps(default_optimizer().build(net.parameters()), ACCUM_K)
    state = create_train_state(model, opt, ema=True, seed=SEED)
    step = make_train_step(model, ema_decay=0.999)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    step_launches = {}
    for i in range(1, 5):
        before = [p.detach().clone() for p in net.parameters()]
        ema_before = [p.clone() for p in state.ema.parameters()]
        images = torch.rand((TRAIN_BATCH, 32, 32, 1), device="cuda", generator=gen)
        launches, metrics = run_counted(lambda: step(state, {"images": images}))
        moved = sum(not torch.equal(a, p) for a, p in zip(before, net.parameters()))
        ema_moved = sum(not torch.equal(a, p) for a, p in zip(ema_before, state.ema.parameters()))
        log(f"accumulation mini-step {i}: {moved} of {len(before)} parameters moved, EMA "
            f"{ema_moved}; loss {metrics['loss'].item():.6f}; launches {launches}")
        check(launches == expected_launches(per_step, per_forward, 1, 0),
              f"accumulation mini-step {i}: launches {launches}")
        step_launches = {k: step_launches.get(k, 0) + v for k, v in launches.items()}
        check((moved > 0) == (i % ACCUM_K == 0),
              f"accumulation mini-step {i}: {moved} parameters moved")
        # From mini-step 2 on the EMA differs from the parameters, and moves
        # at every mini-step (at 1 it averages two equal copies).
        check(i == 1 or ema_moved > 0, f"accumulation mini-step {i}: the EMA did not move")
    del model, net, state, opt

    runs = {"accumulation train step (4 mini-steps)": step_launches}
    root = os.path.join(OUT_DIR, "accumulation")
    shutil.rmtree(root, ignore_errors=True)
    config = flagship_config_file("bfloat16", root)
    common = dict(batch_size=TRAIN_BATCH, num_samples=NUM_SAMPLES, seed=SEED, device="cuda",
                  log_every=1, gradient_accumulation_steps=ACCUM_K,
                  save_and_sample_every_n=ACCUM_STEPS - 1)
    launches, out_dir = run_counted(lambda: train(
        config, num_training_steps=ACCUM_STEPS, output_path=os.path.join(root, "run"),
        **common))
    runs["accumulation training"] = launches
    metrics = check_run("accumulation run", out_dir, launches, expected_launches(
        per_step, per_forward, ACCUM_STEPS, 2 * GRID_STEPS), range(ACCUM_STEPS))
    saved = checkpoints.read_payload(out_dir, "cuda", step=ACCUM_STEPS - 1)["optimizer"]
    acc_norm = global_norm(saved["acc"]).item()
    log(f"accumulation checkpoint after mini-step {ACCUM_STEPS - 1}: mini_step "
        f"{saved['mini_step']}, accumulated gradient norm {acc_norm:.4f}, "
        f"{saved['inner']['count']} update(s)")
    check(saved["mini_step"] == 1 and acc_norm > 0 and saved["inner"]["count"] == 1,
          "the checkpoint does not carry the accumulator")
    with resumed_run():
        launches, resumed = run_counted(lambda: train(
            config, num_training_steps=ACCUM_STEPS, output_path=os.path.join(root, "resumed"),
            resume_from=os.path.join(out_dir, "checkpoints", f"{ACCUM_STEPS - 1}.pt"), **common))
    runs["accumulation resume"] = launches
    check(launches == expected_launches(per_step, per_forward, 1, GRID_STEPS),
          f"accumulation resume: launches {launches}")
    check_resumed("accumulation", metrics, resumed, ACCUM_STEPS - 1)

    # Card against CPU, fp32, batch 2, dropout off: two mini-batches.
    batches = [fp32_batch(2, SEED + i) for i in range(ACCUM_K)]
    results = {}
    for device in ("cuda", "cpu"):
        model = build_model("float32", device)
        net = model.score_network()
        params = list(net.parameters())
        opt = MultiSteps(default_optimizer().build(params), ACCUM_K)
        norms = []
        for i, (images, t, noise) in enumerate(batches):
            opt.zero_grad()
            loss, _ = model.loss_on_batch(images.to(device), {}, timesteps=t.to(device),
                                          noise=noise.to(device), deterministic=True)
            loss.backward()
            if i == ACCUM_K - 1:
                # The running mean the final mini-step folds in, and one
                # plain step on it from the same parameters.
                mean = [a + (p.grad - a) / (i + 1) for a, p in zip(opt.acc, params)]
                ref = [p.detach().clone().requires_grad_() for p in params]
                ref_opt = default_optimizer().build(ref)
                for r, m in zip(ref, mean):
                    r.grad = m.clone()
                ref_opt.step()
            norms.append(opt.step().item())
        check(opt.mini_step == 0 and opt.count == 1, "MultiSteps took no update")
        if device == "cuda":
            same = all(torch.equal(p, r) for p, r in zip(params, ref))
            log(f"card: the accumulated update against one step on the mean gradient: "
                f"{'bit for bit' if same else 'differs'}")
            check(same, "the accumulated update differs from one step on the mean")
        results[device] = (norms, {n: m.cpu() for n, m in zip(
            (n for n, _ in net.named_parameters()), mean)})
    (n_gpu, m_gpu), (n_cpu, m_cpu) = results["cuda"], results["cpu"]
    floor = 1e-3 * max(g.abs().max().item() for g in m_cpu.values())
    worst = max((rel_err(m_gpu[k], m_cpu[k], floor), k) for k in m_cpu)
    log(f"card vs CPU accumulation, fp32 batch 2: mini-batch grad norms {n_gpu} vs {n_cpu}, "
        f"mean gradient norm {global_norm(list(m_gpu.values())).item():.6f} vs "
        f"{global_norm(list(m_cpu.values())).item():.6f}, worst {worst[1]} at {worst[0]:.3e}")
    for a, b in zip(n_gpu, n_cpu):
        check(abs(a - b) <= 1e-4 * abs(b), f"mini-batch grad norm {a} vs {b}")
    check(worst[0] <= 1e-3, f"mean gradient {worst[1]}: {worst[0]} > 1e-3")
    return runs


class warmed_importance:
    """While active, `ImportanceSampler.init_device_state` returns a full
    history (every count at history_per_term) of seeded losses in [0.01,
    0.11): a cold history fills only after some 10,000 batch entries."""

    def __init__(self, seed: int = SEED):
        self.seed = seed

    def __enter__(self):
        from xdiffusion_tpu_torch.importance_sampling import ImportanceSampler

        self.saved = init = ImportanceSampler.init_device_state
        seed = self.seed

        def warmed(sampler, device=None):
            state = init(sampler, device)
            rng = np.random.default_rng(seed)
            history = 0.01 + 0.1 * rng.random(tuple(state["loss_history"].shape))
            state["loss_history"].copy_(torch.from_numpy(history.astype(np.float32)))
            state["loss_counts"].fill_(sampler.history_per_term)
            return state

        ImportanceSampler.init_device_state = warmed
        return self

    def __exit__(self, *exc):
        from xdiffusion_tpu_torch.importance_sampling import ImportanceSampler

        ImportanceSampler.init_device_state = self.saved


def phase_importance(sites):
    """74. Loss-aware importance sampling: on the same 20 (t, loss) batches
    of 128 (a third of them drawn from 8 timesteps: duplicates), the card's
    `device_update` equal to the CPU's bit for bit and to the float64 host
    path's history, `device_weights` within 1e-6 (relative) of the CPU's and
    1e-5 of the host's; draws in range with weights 1 / (T p); then the
    flagship (bf16, batch TRAIN_BATCH) with the `ImportanceSampler` override
    through `train()` from a warmed history, IMPORTANCE_STEPS steps (each a
    flagship step's launches), the checkpoint carrying the updated state and
    a resume from step IMPORTANCE_SAVE that repeats its loss. Returns the
    runs' launches."""
    import shutil

    import yaml

    from xdiffusion_tpu_torch import checkpoints
    from xdiffusion_tpu_torch.importance_sampling import ImportanceSampler
    from xdiffusion_tpu_torch.training.image.train import train

    params = IMPORTANCE_OVERRIDE["params"]
    sampler = ImportanceSampler(**params)
    with warmed_importance():
        states = {d: sampler.init_device_state(d) for d in ("cuda", "cpu")}
    host = ImportanceSampler(**params)
    host._loss_history = states["cpu"]["loss_history"].double().numpy().copy()
    host._loss_counts[:] = sampler.history_per_term
    rng = np.random.default_rng(SEED + 3)
    worst_cpu = worst_host = 0.0
    for _ in range(20):
        ts = rng.integers(0, sampler.num_timesteps, size=TRAIN_BATCH)
        dup = rng.random(TRAIN_BATCH) < 1 / 3
        ts[dup] = rng.integers(0, 8, size=int(dup.sum()))
        losses = (0.2 * rng.random(TRAIN_BATCH)).astype(np.float32)
        for d in states:
            states[d] = sampler.device_update(states[d], torch.from_numpy(ts).to(d),
                                              torch.from_numpy(losses).to(d))
        host.update_with_all_losses(ts, losses)
        card = {k: v.cpu() for k, v in states["cuda"].items()}
        check(all(torch.equal(card[k], states["cpu"][k]) for k in card),
              "device_update: the card's state differs from the CPU's")
        check(np.array_equal(card["loss_history"].double().numpy(), host._loss_history)
              and np.array_equal(card["loss_counts"].numpy(), host._loss_counts),
              "device_update: the card's state differs from the host path's")
        w_card = sampler.device_weights(states["cuda"]).cpu().double()
        w_cpu = sampler.device_weights(states["cpu"]).double()
        w_host = torch.from_numpy(host.weights())
        worst_cpu = max(worst_cpu, ((w_card - w_cpu).abs() / w_cpu).max().item())
        worst_host = max(worst_host, ((w_card - w_host).abs() / w_host).max().item())
    t, w = sampler.device_sample(torch.Generator(device="cuda").manual_seed(SEED), TRAIN_BATCH,
                                 states["cuda"])
    p = sampler.device_weights(states["cuda"])
    log(f"importance sampling: device_update equal bit for bit (card, CPU, host float64) over "
        f"20 batches; device_weights relative error against the CPU {worst_cpu:.3e}, against "
        f"the float64 host path {worst_host:.3e}; a draw of {TRAIN_BATCH}: t in "
        f"[{t.min().item()}, {t.max().item()}], weights in [{w.min().item():.4f}, "
        f"{w.max().item():.4f}]")
    check(worst_cpu <= 1e-6, f"device_weights against the CPU: {worst_cpu} > 1e-6")
    check(worst_host <= 1e-5, f"device_weights against the host: {worst_host} > 1e-5")
    check(int(t.min()) >= 0 and int(t.max()) < sampler.num_timesteps, "a draw out of range")
    check(torch.equal(w, (1.0 / (sampler.num_timesteps * p[t])).float()), "draw weights")

    per_step, per_forward = flagship_counts(sites)
    root = os.path.join(OUT_DIR, "importance")
    shutil.rmtree(root, ignore_errors=True)
    config = flagship_config_file("bfloat16", root)
    with open(config) as f:
        cfg = yaml.safe_load(f)
    cfg["diffusion"]["noise_scheduler"]["params"]["importance_sampler"] = IMPORTANCE_OVERRIDE
    with open(config, "w") as f:
        yaml.safe_dump(cfg, f)
    common = dict(batch_size=TRAIN_BATCH, num_samples=NUM_SAMPLES, seed=SEED, device="cuda",
                  log_every=1, save_and_sample_every_n=IMPORTANCE_SAVE)
    runs = {}
    with warmed_importance():
        warm = sampler.init_device_state("cuda")
        launches, out_dir = run_counted(lambda: train(
            config, num_training_steps=IMPORTANCE_STEPS, output_path=os.path.join(root, "run"),
            **common))
        runs["importance training"] = launches
        metrics = check_run("importance run", out_dir, launches, expected_launches(
            per_step, per_forward, IMPORTANCE_STEPS, 2 * GRID_STEPS), range(IMPORTANCE_STEPS))
        saved = checkpoints.read_payload(out_dir, "cuda")["importance"]
        rows = (saved["loss_history"] != warm["loss_history"]).any(dim=1).sum().item()
        log(f"importance run: the checkpoint's history differs from the warmed one in {rows} "
            f"rows (at most {IMPORTANCE_STEPS * TRAIN_BATCH} entries); counts "
            f"{int(saved['loss_counts'].min())}-{int(saved['loss_counts'].max())}")
        check(0 < rows <= IMPORTANCE_STEPS * TRAIN_BATCH, "the checkpoint's history did not move")
        check(bool((saved["loss_counts"] == sampler.history_per_term).all()), "counts")
        with resumed_run():
            launches, resumed = run_counted(lambda: train(
                config, num_training_steps=IMPORTANCE_SAVE + 1,
                output_path=os.path.join(root, "resumed"),
                resume_from=os.path.join(out_dir, "checkpoints", f"{IMPORTANCE_SAVE}.pt"),
                **common))
    runs["importance resume"] = launches
    check(launches == expected_launches(per_step, per_forward, 1, GRID_STEPS),
          f"importance resume: launches {launches}")
    check_resumed("importance", metrics, resumed, IMPORTANCE_SAVE)
    return runs


def read_events(directory: str):
    """The records of the TensorBoard event file in `directory`, each
    checked against its masked crc32c: [(step, [(tag, kind, value)])],
    kind "scalar" (value: the float) or "image" (value: (h, w, c, png))."""
    import struct

    from xdiffusion_tpu_torch.tensorboard import _masked_crc

    def fields(buf):
        i = 0
        while i < len(buf):
            key, i = varint(buf, i)
            num, wire = key >> 3, key & 7
            if wire == 0:
                value, i = varint(buf, i)
            elif wire == 1:
                value, i = buf[i:i + 8], i + 8
            elif wire == 5:
                value, i = buf[i:i + 4], i + 4
            else:
                n, i = varint(buf, i)
                value, i = buf[i:i + n], i + n
            yield num, value

    def varint(buf, i):
        out = shift = 0
        while True:
            b = buf[i]
            i += 1
            out |= (b & 0x7F) << shift
            shift += 7
            if not b & 0x80:
                return out, i

    (name,) = [n for n in os.listdir(directory) if n.startswith("events.out.tfevents.")]
    with open(os.path.join(directory, name), "rb") as f:
        data = f.read()
    out, i = [], 0
    while i < len(data):
        header = data[i:i + 8]
        (n,) = struct.unpack("<Q", header)
        check(struct.unpack("<I", data[i + 8:i + 12])[0] == _masked_crc(header), "event crc")
        payload = data[i + 12:i + 12 + n]
        check(struct.unpack("<I", data[i + 12 + n:i + 16 + n])[0] == _masked_crc(payload),
              "event crc")
        i += 16 + n
        ev = dict(fields(payload))
        values = []
        for num, summary_value in fields(ev.get(5, b"")):
            sv = dict(fields(summary_value))
            tag = sv[1].decode()
            if 2 in sv:
                values.append((tag, "scalar", struct.unpack("<f", sv[2])[0]))
            elif 4 in sv:
                img = dict(fields(sv[4]))
                values.append((tag, "image", (img[1], img[2], img[3], img[4])))
        out.append((ev.get(2, 0), values))
    return out


def png_rows(png: bytes) -> bytes:
    """The filtered scanlines (inflated IDAT) of a PNG."""
    import struct
    import zlib

    i, idat = 8, b""
    while i < len(png):
        (n,) = struct.unpack(">I", png[i:i + 4])
        if png[i + 4:i + 8] == b"IDAT":
            idat += png[i + 8:i + 8 + n]
        i += 12 + n
    return zlib.decompress(idat)


def phase_observability(sites):
    """75. The trainer's observability on the flagship (bf16, batch
    TRAIN_BATCH): a `train()` run with the model summary on (printed at
    start-up, its total parameters the network's) and `profile_start_step`
    PROFILE_START, whose trace holds the K1-K4 kernels of its 3 steps and
    none outside them, and whose TensorBoard events hold every logged
    scalar and the sample grid (its pixels the PNG grid's); `debug_nans` on
    a clean run (the same losses) and with a weight poisoned by a NaN
    (FloatingPointError naming a module; anomaly mode restored); the
    summary's and the TensorBoard writer's start-up wall times; the native
    batch assembler built by g++ and equal bit for bit to numpy, both
    timed. Returns the runs' launches."""
    import contextlib
    import io
    import shutil

    from xdiffusion_tpu_torch import native
    from xdiffusion_tpu_torch.config import load_yaml
    from xdiffusion_tpu_torch.datasets import load_dataset
    from xdiffusion_tpu_torch.summary import model_summary
    from xdiffusion_tpu_torch.tensorboard import TensorBoardWriter, _filtered_rows
    from xdiffusion_tpu_torch.training.image.train import train

    per_step, per_forward = flagship_counts(sites)
    root = os.path.join(OUT_DIR, "observability")
    shutil.rmtree(root, ignore_errors=True)
    config = flagship_config_file("bfloat16", root)
    steps = PROFILE_START + 3
    common = dict(batch_size=TRAIN_BATCH, num_samples=NUM_SAMPLES, seed=SEED, device="cuda",
                  log_every=1)
    runs = {}
    text = io.StringIO()
    # The clean debug_nans run repeats this run's losses, a step after an
    # update among them: both take cuDNN's deterministic algorithms.
    deterministic = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    t0 = time.perf_counter()
    # resumed_run: no checkpoint file, as no later run reads these runs'.
    with summary_on(), resumed_run(), contextlib.redirect_stdout(Tee(sys.stdout, text)):
        launches, out_dir = run_counted(lambda: train(
            config, num_training_steps=steps, output_path=os.path.join(root, "profiled"),
            save_and_sample_every_n=steps, profile_start_step=PROFILE_START, **common))
    runs["profiled training (summary on)"] = launches
    # The summary's forward at batch 2 launches one forward's kernels.
    metrics = check_run("profiled run", out_dir, launches, expected_launches(
        per_step, per_forward, steps, GRID_STEPS + 1), range(steps))
    n_params = sum(p.numel() for p in build_model("bfloat16", "cuda").score_network().parameters())
    check(f"Total Parameters: {n_params:,}" in text.getvalue(), "no model summary at start-up")
    check("profiler trace written to" in text.getvalue(), "the profiler wrote no trace")
    traces = [n for n in os.listdir(os.path.join(out_dir, "profile")) if n.endswith(".json")]
    check(len(traces) == 1, f"profile traces {traces}")
    with open(os.path.join(out_dir, "profile", traces[0])) as f:
        events = json.load(f)["traceEvents"]
    names = [e["name"] for e in events if e.get("cat") == "kernel"]
    traced = {"K1": sum(map(is_k1, names)), "K2": sum(map(is_k2, names)),
              "K3": sum("gn_kernel" in n for n in names), "K4": sum(map(is_k4, names))}
    window = {"K1": 3 * per_step["bsc_attention"], "K2": 3 * per_step["bsc_attention_bwd"],
              "K3": 3 * per_step["group_norm_silu"], "K4": 3 * per_step["affine_silu_conv3x3"]}
    log(f"profiler trace {traces[0]}: {len(names)} kernels, K1-K4 {traced} against 3 steps' "
        f"wrapper calls {window}")
    for k in ("K1", "K3"):  # one kernel a call
        check(traced[k] == window[k], f"trace: {k} {traced[k]} != {window[k]}")
    for k in ("K2", "K4"):  # a call may add a split-sum kernel
        check(traced[k] >= window[k], f"trace: {k} {traced[k]} < {window[k]}")

    records = read_events(os.path.join(out_dir, "tensorboard"))
    scalars = {(step, tag): v for step, vals in records for tag, kind, v in vals
               if kind == "scalar"}
    images = [(step, v) for step, vals in records for tag, kind, v in vals
              if kind == "image" and tag == "samples"]
    for step in range(steps):
        for key in ("loss", "mse_loss", "vb_loss", "grad_norm"):
            check(scalars.get((step, key)) == np.float32(metrics[step][key]),
                  f"TensorBoard scalar {key} at step {step}")
    check(len(images) == 1 and images[0][0] == steps, f"TensorBoard sample grids {images}")
    h, w, c, png = images[0][1]
    with open(os.path.join(out_dir, f"sample-{steps}.png"), "rb") as f:
        grid = png_rows(f.read())  # filter 0 on every row
    pixels = np.frombuffer(grid, np.uint8).reshape(h, w * c + 1)[:, 1:].reshape(h, w, c)
    check(png_rows(png) == _filtered_rows(pixels), "the TensorBoard grid's pixels")
    log(f"TensorBoard events: {len(records)} records, {len(scalars)} scalars, the {h}x{w} "
        f"sample grid at step {steps} equal to sample-{steps}.png; the profiled run and its "
        f"checks {time.perf_counter() - t0:.1f} s")

    # debug_nans on a clean run: the same losses.
    t0 = time.perf_counter()
    with resumed_run():
        launches, clean = run_counted(lambda: train(
            config, num_training_steps=2, output_path=os.path.join(root, "debug_nans"),
            save_and_sample_every_n=2, debug_nans=True, **common))
    runs["debug_nans training"] = launches
    check(launches == expected_launches(per_step, per_forward, 2, GRID_STEPS),
          f"debug_nans run: launches {launches}")
    got = read_metrics(clean)
    for step in range(2):
        a, b = got[step]["loss"], metrics[step]["loss"]
        log(f"debug_nans run, step {step}: loss {a!r} against {b!r}")
        check(abs(a - b) <= 1e-6 * abs(b), f"debug_nans changed step {step}'s loss")
    check(not torch.is_anomaly_enabled(), "debug_nans left anomaly mode on")
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = deterministic

    def poison(model):
        for name, p in model.score_network().named_parameters():
            if name.endswith("conv1.kernel"):
                with torch.no_grad():
                    p.view(-1)[0] = float("nan")
                return

    with captured_models(edit=poison):
        try:
            train(config, num_training_steps=1, output_path=os.path.join(root, "poisoned"),
                  save_and_sample_every_n=1, debug_nans=True, **common)
            raised = None
        except FloatingPointError as e:
            raised = str(e)
    log(f"debug_nans with a NaN in a conv1 kernel: FloatingPointError {raised!r}")
    check(raised is not None and "conv1" in raised, "no FloatingPointError at the poisoned conv")
    check(not torch.is_anomaly_enabled(), "debug_nans left anomaly mode on")
    log(f"the debug_nans runs: {time.perf_counter() - t0:.1f} s")

    # Start-up costs, wall time on the card's host.
    model = build_model("bfloat16", "cuda")
    model_summary(model)  # the first call pays for lazy initialisation
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model_summary(model)
    summary_s = time.perf_counter() - t0
    grid = np.random.default_rng(SEED).random((128, 128, 1)).astype(np.float32)
    t0 = time.perf_counter()
    writer = TensorBoardWriter(os.path.join(root, "tb_cost"))
    for key in ("loss", "mse_loss", "vb_loss", "grad_norm"):
        writer.add_scalar(key, 1.0, 0)
    writer.add_image("samples", grid, 0)  # NUM_SAMPLES = 16 grids of 32x32
    writer.close()
    tb_s = time.perf_counter() - t0
    log(f"start-up costs: the model summary {1e3 * summary_s:.1f} ms (a batch-2 forward), "
        f"a TensorBoard writer with 4 scalars and a 128x128 grid {1e3 * tb_s:.1f} ms")

    # The native batch assembler.
    check(native.load() is not None, "the native batch assembler did not build")
    dataset, _ = load_dataset("image/mnist", config=load_yaml(config), split="train")
    arena = np.ascontiguousarray(dataset.images)
    labels = np.ascontiguousarray(dataset.labels)
    idx = np.random.default_rng(SEED).permutation(len(arena))[:TRAIN_BATCH]
    got = native.gather_normalize(arena, idx)
    want = arena[idx].astype(np.float32) * np.float32(1.0 / 255.0)
    check(got.tobytes() == want.tobytes(), "native gather_normalize differs from numpy")
    check(np.array_equal(native.gather_i32(labels, idx), labels[idx].astype(np.int32)),
          "native gather_i32 differs from numpy")
    native_ms = time_host_ms(lambda: native.gather_normalize(arena, idx))
    numpy_ms = time_host_ms(lambda: arena[idx].astype(np.float32) * np.float32(1.0 / 255.0))
    log(f"native batch assembler ({arena.shape[1:]} uint8, batch {TRAIN_BATCH}): "
        f"{native_ms:.4f} ms against numpy's {numpy_ms:.4f} ms, bit for bit")
    return runs, {"summary_ms": 1e3 * summary_s, "tensorboard_ms": 1e3 * tb_s,
                  "native_ms": native_ms, "numpy_ms": numpy_ms}


def time_host_ms(fn, iters: int = 20) -> float:
    fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e3


def device_busy(step):
    """(wall ms, device-busy ms) of one call of `step`: the card's activity
    in a `torch.profiler` session (PROFILED), the host clock to a
    synchronize."""
    from torch.profiler import profile

    torch.cuda.synchronize()
    with profile(activities=PROFILED) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type.name == "CUDA") / 1e3
    return wall_ms, busy


def extras_step_times():
    """bf16 flagship steps at TRAIN_BATCH in one process: steps/s over 2
    steps after a warm-up (for accumulation at k = 2, 2 mini-steps: one
    update), and the wall and device-busy time of one more (`device_busy`;
    the accumulation mini-step profiled applies the update), for the plain
    step, the LoRA step, an accumulation mini-step and an
    importance-sampling step."""
    from xdiffusion_tpu_torch import lora as lora_lib
    from xdiffusion_tpu_torch.importance_sampling import ImportanceSampler
    from xdiffusion_tpu_torch.optim import MultiSteps, default_optimizer
    from xdiffusion_tpu_torch.train_step import create_train_state, make_train_step

    model = build_model("bfloat16", "cuda")
    net = model.score_network()
    batch = {"images": torch.rand((TRAIN_BATCH, 32, 32, 1), device="cuda",
                                  generator=torch.Generator(device="cuda").manual_seed(SEED))}
    sampler = ImportanceSampler(**IMPORTANCE_OVERRIDE["params"])
    out = {}
    for kind in ("flagship", "lora", "accumulation", "importance"):
        t0 = time.perf_counter()
        lora = None
        if kind == "lora":
            lora = lora_lib.inject_trainable_lora(net, r=LORA_RANK)
            lora_lib.attach(net, lora)
        opt = default_optimizer().build((lora or net).parameters())
        if kind == "accumulation":
            opt = MultiSteps(opt, 2)
        importance = sampler if kind == "importance" else None
        with warmed_importance():
            state = create_train_state(model, opt, seed=SEED, lora=lora,
                                       importance_sampler=importance)
        step = make_train_step(model, param_transform=lora, importance_sampler=importance)
        step(state, batch)
        sps = steps_per_s(lambda: step(state, batch), 2)
        # For accumulation the 4th mini-step, which applies the update.
        wall, busy = device_busy(lambda: step(state, batch))
        out[kind] = {"steps_per_s": sps, "wall_ms": wall, "device_ms": busy}
        log(f"{kind} step (bf16, batch {TRAIN_BATCH}): {sps:.3f} steps/s, a profiled step "
            f"{wall:.3f} ms wall, {busy:.3f} ms device ({100 * busy / wall:.1f}% busy); "
            f"{time.perf_counter() - t0:.1f} s")
        if lora is not None:
            lora_lib.detach(net)
            net.requires_grad_(True)
    return out


# ---- phases 76-78: checkpoint interchange and evaluation --------------------------

# measure_fid on phase 5's checkpoint (the CLI's own 50 DDIM steps; 2,048
# samples by default, 512 here for the run's time limit) and measure_video_fid
# on phase 52's; the perceptual trainer's CLI steps.
FID_SAMPLES, FID_STEPS, FID_BATCH = 512, 50, 256
VIDEO_FID_VIDEOS = 8
PERCEPTUAL_CLI_STEPS = 3
PERCEPTUAL_ASSET = os.path.join(ROOT, "xdiffusion_tpu_torch", "autoencoders", "assets",
                                "perceptual_filters.npz")


def written_bytes(root: str) -> int:
    """The bytes of every file under `root`."""
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(root) for f in fs)


def file_digest(path: str) -> str:
    import hashlib

    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


class captured_extractor:
    """While active, eval.fid's `train_feature_extractor` keeps the last
    classifier it trained in `.model` (the FID CLIs train theirs)."""

    def __enter__(self):
        from xdiffusion_tpu_torch.eval import fid

        self.saved = train = fid.train_feature_extractor

        def recording(*args, **kwargs):
            self.model, loss = train(*args, **kwargs)
            return self.model, loss

        fid.train_feature_extractor = recording
        return self

    def __exit__(self, *exc):
        from xdiffusion_tpu_torch.eval import fid

        fid.train_feature_extractor = self.saved


def phase_interchange(sites, flagship_run: str, pixart_samples: np.ndarray, smi: str):
    """76. Checkpoint interchange and FID: phase 5's final flagship
    checkpoint (bf16) through the exporter into the reference layout, as a
    `.pt` of the reference trainer's {"model_state_dict": ...} and as a
    `.safetensors` (the port's writer); the import CLI on each (its wall
    time), every parameter and the EMA of each import bit for bit phase 5's;
    measure_fid on the `.safetensors` import (FID_SAMPLES samples, FID_STEPS
    DDIM steps, batch FID_BATCH, the synthetic digits): its JSON line, a
    finite FID above a finite floor, samples/s of its sampling, K1/K3/K4
    launches against FID_STEPS forwards a batch. Then phase 29's FID on the
    extractor the CLI trained (the one training of the LeNet extractor in
    this run): the real-against-real floor, noise's FID above it, the PixArt
    headline's samples. The bytes written are logged and removed.
    Returns (the record for the kernels line, the floor, the PixArt
    samples' FID)."""
    import shutil

    from xdiffusion_tpu_torch import import_torch_checkpoint, measure_fid
    from xdiffusion_tpu_torch.config import load_yaml
    from xdiffusion_tpu_torch.importers.export_torch import export_unet_params
    from xdiffusion_tpu_torch.importers.safetensors_io import save_safetensors
    from xdiffusion_tpu_torch.training.image.train import build_model as build_process

    root = os.path.join(OUT_DIR, "interchange")
    shutil.rmtree(root, ignore_errors=True)
    config = flagship_config_file("bfloat16", root)
    trained = torch.load(os.path.join(flagship_run, "checkpoints", f"{TRAIN_STEPS}.pt"),
                         map_location="cpu", weights_only=True)["params"]
    net = build_process(load_yaml(config), device="cpu").score_network()
    net.load_state_dict(trained)
    layer = load_yaml(config).diffusion.score_network.params.conditioning
    layer = layer.context_transformer_layer.params
    t0 = time.perf_counter()
    sd = export_unet_params(net, heads=layer.heads, dim_head=layer.dim_head)
    files = {"pt": os.path.join(root, "reference.pt"),
             "safetensors": os.path.join(root, "reference.safetensors")}
    torch.save({"model_state_dict": {k: torch.from_numpy(v) for k, v in sd.items()}},
               files["pt"])
    save_safetensors(files["safetensors"], sd)
    export_s = time.perf_counter() - t0
    del net
    log(f"exported phase 5's {len(trained)} parameters into {len(sd)} reference tensors "
        f"({os.path.getsize(files['pt']) / 1e6:.1f} MB .pt, "
        f"{os.path.getsize(files['safetensors']) / 1e6:.1f} MB .safetensors) in "
        f"{export_s:.2f} s")
    import_s = {}
    for kind, file in files.items():
        out = os.path.join(root, "imported_" + kind)
        t0 = time.perf_counter()
        launched, info = run_counted(lambda: import_torch_checkpoint.main([
            "--config_path", config, "--torch_checkpoint", file, "--output", out,
            "--step", str(TRAIN_STEPS), "--device", "cuda"]))
        import_s[kind] = time.perf_counter() - t0
        check(not any(launched.values()), f"the import launched kernels: {launched}")
        check(info["imported_torch_tensors"] == len(sd) and info["step"] == TRAIN_STEPS,
              f"import CLI line {info}")
        payload = torch.load(os.path.join(out, f"{TRAIN_STEPS}.pt"), map_location="cpu",
                             weights_only=True)
        for group in ("params", "ema"):
            got = payload[group]
            check(sorted(got) == sorted(trained)
                  and all(torch.equal(got[k], trained[k]) for k in trained),
                  f"the {kind} import's {group} differ from phase 5's")
        log(f"import CLI ({kind}): {json.dumps(info)}; {import_s[kind]:.2f} s wall "
            f"[{smi}]; parameters and EMA bit for bit phase 5's")

    imported = os.path.join(root, "imported_safetensors")
    per_forward = flagship_counts(sites)[1]
    times, restore = sample_timer()
    try:
        with captured_extractor() as extractor:
            launched, info = run_counted(lambda: measure_fid.main([
                "--config_path", config, "--checkpoint", imported, "--num_samples",
                str(FID_SAMPLES), "--sampling_steps", str(FID_STEPS), "--sample_batch",
                str(FID_BATCH), "--allow-synthetic", "--device", "cuda"]))
    finally:
        restore()
    batches = -(-FID_SAMPLES // FID_BATCH)
    expected = expected_launches({}, per_forward, 0, batches * FID_STEPS)
    samples_ps = FID_SAMPLES / sum(times)
    log(f"measure_fid ({FID_SAMPLES} samples, {FID_STEPS} DDIM steps, batch {FID_BATCH}, "
        f"bf16): {json.dumps(info)}; sampling {samples_ps:.2f} samples/s [{smi}]; launches "
        f"{launched}, expected {expected}")
    check(launched == expected, f"measure_fid launches {launched} != {expected}")
    check(info["checkpoint_step"] == TRAIN_STEPS and info["num_samples"] == FID_SAMPLES,
          f"measure_fid line {info}")
    check(np.isfinite(info["fid"]) and np.isfinite(info["fid_floor_real_vs_real"])
          and info["fid_floor_real_vs_real"] < info["fid"],
          f"measure_fid: floor {info['fid_floor_real_vs_real']} not below FID {info['fid']}")
    floor, sample_fid = phase_fid(pixart_samples, extractor.model)
    nbytes = written_bytes(root)
    log(f"phase 76 wrote {nbytes / 1e9:.3f} GB under {root}; removed")
    shutil.rmtree(root, ignore_errors=True)
    return {"measure_fid": {k: launched[k] for k in per_forward},
            "measure_fid_line": info, "samples_per_s": samples_ps,
            "import_s": import_s, "bytes": nbytes}, floor, sample_fid


def phase_video_fid(vdm, smi: str):
    """77. measure_video_fid on phase 52's last video_diffusion_models.yaml
    checkpoint: VIDEO_FID_VIDEOS videos in one batch, VIDEO_SAMPLING_STEPS of
    the config's sampler, the synthetic Moving-MNIST; its JSON line (finite
    frame FID and floor, vids_per_sec), launches against the structure's a
    forward. Returns its launches and line."""
    from xdiffusion_tpu_torch import measure_video_fid

    checkpoint = os.path.join(vdm["run_dir"], "checkpoints", f"{VIDEO_TRAIN_STEPS}.pt")
    launched, info = run_counted(lambda: measure_video_fid.main([
        "--config_path", VDM_CONFIG, "--checkpoint", checkpoint, "--num_videos",
        str(VIDEO_FID_VIDEOS), "--sample_batch", str(VIDEO_FID_VIDEOS), "--sampling_steps",
        str(VIDEO_SAMPLING_STEPS), "--allow-synthetic", "--device", "cuda"]))
    launched = {k: v for k, v in launched.items() if v}
    expected = add_counts({}, vdm["forward"], VIDEO_SAMPLING_STEPS)
    log(f"measure_video_fid ({VIDEO_FID_VIDEOS} videos, {VIDEO_SAMPLING_STEPS} steps, fp32): "
        f"{json.dumps(info)} [{smi}]; launches {launched}, expected {expected}")
    check(launched == expected, f"measure_video_fid launches {launched} != {expected}")
    check(np.isfinite(info["frame_fid"]) and np.isfinite(info["fid_floor_real_vs_real"])
          and info["vids_per_sec"] > 0 and info["checkpoint_step"] == VIDEO_TRAIN_STEPS,
          f"measure_video_fid line {info}")
    return {"measure_video_fid": launched, "measure_video_fid_line": info}


def phase_perceptual(smi: str):
    """78. The perceptual filter bank's trainer: one step on the card
    against the CPU from the same start and batch (the loss to 1e-5
    relative; Adam's first step moves each weight by lr times the sign of
    its gradient, so a filter differs by at most 2 lr where a gradient's
    sign differs, on a share of them logged), then the CLI on the card for
    PERCEPTUAL_CLI_STEPS steps into output/chip_smoke/ (its JSON line, the
    bank it writes), and the shipped asset's sha256 unchanged."""
    import shutil

    from xdiffusion_tpu_torch import train_perceptual_features
    from xdiffusion_tpu_torch.autoencoders.perceptual import train_perceptual_filters
    from xdiffusion_tpu_torch.datasets.synthetic import generate_digits

    digest = file_digest(PERCEPTUAL_ASSET)
    images, labels = generate_digits(512, seed=SEED, image_size=32)
    images = images.astype(np.float32) / 255.0
    card, card_loss = train_perceptual_filters(images, labels, steps=1, device="cuda")
    cpu, cpu_loss = train_perceptual_filters(images, labels, steps=1, device="cpu")
    diffs = np.concatenate([np.abs(a - b).ravel() for (a, _), (b, _) in zip(card, cpu)]
                           + [np.abs(a - b).ravel() for (_, a), (_, b) in zip(card, cpu)])
    moved = float((diffs > 1e-6).mean())
    log(f"perceptual trainer, one step card vs CPU: loss {card_loss:.6f} against "
        f"{cpu_loss:.6f}; filters' largest difference {diffs.max():.3e} (2 lr = 2e-3), "
        f"{100 * moved:.3f}% of them beyond 1e-6")
    check(abs(card_loss - cpu_loss) <= 1e-5 * abs(cpu_loss), "perceptual loss card vs CPU")
    check(diffs.max() <= 2e-3 + 1e-6 and moved <= 0.01, "perceptual filters card vs CPU")
    out = os.path.join(OUT_DIR, "perceptual", "perceptual_filters.npz")
    t0 = time.perf_counter()
    info = train_perceptual_features.main(["--num_images", "2048", "--steps",
                                           str(PERCEPTUAL_CLI_STEPS), "--output", out,
                                           "--device", "cuda"])
    wall = time.perf_counter() - t0
    with np.load(out) as bank:
        shapes = [bank[f"w{i}"].shape for i in range(5)]
        finite = all(np.isfinite(bank[k]).all() for k in bank.files)
    log(f"train_perceptual_features ({PERCEPTUAL_CLI_STEPS} steps): {json.dumps(info)}; "
        f"{wall:.2f} s wall [{smi}]; bank {shapes}")
    check(finite and np.isfinite(info["final_train_loss"]) and shapes[0] == (3, 3, 3, 16),
          "the perceptual CLI's bank")
    shutil.rmtree(os.path.dirname(out), ignore_errors=True)
    check(file_digest(PERCEPTUAL_ASSET) == digest, "the shipped perceptual asset changed")
    log(f"shipped perceptual_filters.npz sha256 {digest[:16]}... unchanged")
    return info


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


def cached_datasets() -> None:
    """Makes the trainers' `load_dataset` (image and video) build each
    (dataset, split, image size) once in this run and hand the same one to
    every later `train()`: the synthetic stand-ins are generated and
    resized on the host in each call (some 5 s for MNIST at 32 pixels),
    and the run calls the trainers about 25 times. The datasets are the
    same, and no step or grid is timed across the load."""
    import functools

    from xdiffusion_tpu_torch import datasets
    from xdiffusion_tpu_torch.training.image import autoencoder as vae_trainer
    from xdiffusion_tpu_torch.training.image import train as image_trainer
    from xdiffusion_tpu_torch.training.video import train as video_trainer

    load = image_trainer.load_dataset
    built = {}

    @functools.wraps(load)
    def cached(dataset_name, config=None, split="train"):
        size = config.data.image_size if config is not None and "data" in config else None
        key = (dataset_name, split, str(size))  # a [frames, n_mels] size is a list
        if key not in built:
            built[key] = load(dataset_name, config=config, split=split)
        return built[key]

    image_trainer.load_dataset = video_trainer.load_dataset = vae_trainer.load_dataset = cached
    # The CLIs that load a dataset themselves (measure_fid, measure_video_fid)
    # import it from the package when they run.
    datasets.load_dataset = cached


def memoized_redraws(max_bytes: int = 4 << 30) -> None:
    """Makes `weights.randomize_` keep the values it draws for a network (a
    module of the same parameter names and shapes) and seed, at most
    `max_bytes` of the latest, and copy them into the next such network: the
    numpy draws (some 9 s for AuraFlow's 311M parameters on a fast host)
    repeat for a config's sampling and training phases and for both halves of
    a card-against-CPU check. The values are the same as drawn anew."""
    import functools

    from xdiffusion_tpu_torch import weights

    draw = weights.randomize_
    kept = {}

    @functools.wraps(draw)
    def randomize_(module, seed):
        named = sorted(module.named_parameters())
        key = (seed, tuple((n, tuple(p.shape)) for n, p in named))
        if key not in kept:
            draw(module, seed)
            kept[key] = [p.detach().to("cpu", copy=True) for _, p in named]
            while sum(t.numel() * 4 for v in kept.values() for t in v) > max_bytes:
                kept.pop(next(iter(kept)))
            return
        kept[key] = kept.pop(key)  # the latest last
        with torch.no_grad():
            for (_, p), v in zip(named, kept[key]):
                p.copy_(v)

    weights.randomize_ = randomize_


def short_grids() -> None:
    """Cuts the sampling steps of the image trainer's grids
    (`training.image.train.sample_and_save`, which `train()` and the
    training CLI call at each save) to GRID_STEPS for the rest of the run.
    A process whose sampler fixes its own steps (EDM's Heun) ignores the
    count, as its `sample` does."""
    import functools

    from xdiffusion_tpu_torch.training.image import train as trainer

    grid = trainer.sample_and_save

    @functools.wraps(grid)
    def short(model, *args, **kwargs):
        model.sample = functools.partial(model.sample, num_sampling_steps=GRID_STEPS)
        try:
            return grid(model, *args, **kwargs)
        finally:
            del model.sample  # the class's method again

    trainer.sample_and_save = short


def log_phase_times() -> None:
    """Wraps every phase_* function of this module so that each logs its
    wall time: every slice's phases share the run's time limit."""
    import functools

    def timed(name, fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                log(f"[{name} took {time.perf_counter() - t0:.1f} s]")
        return wrapper

    for name, fn in list(globals().items()):
        if name.startswith("phase_") and callable(fn):
            globals()[name] = timed(name, fn)


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
    # The trainers' start-up summary runs a forward whose launches every
    # run's count would carry: phase 75 turns it on for its own run.
    os.environ["XDIFFUSION_MODEL_SUMMARY"] = "0"
    t_run = time.perf_counter()
    log_phase_times()
    short_grids()
    cached_datasets()
    memoized_redraws()
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
    train_launches, train_sps, flagship_run = phase_training(sites)
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

    text_sites = phase_text_sites()
    for name, _, rec in records:
        kernel = {"bsc_attention": "K1", "bsc_attention_bwd": "K2"}.get(name)
        if kernel:
            rec["err"] = max(rec["err"], text_sites[kernel]["err"])
    text_launches, text_sps, text_fwd = phase_text_sampling()
    phase_text_card_vs_cpu()
    text_train_launches, text_train_sps, text_step = phase_text_training()
    phase_text_companions()

    t_pixart = time.perf_counter()
    pixart_sites = phase_pixart_sites()
    for name, _, rec in records:
        kernel = {"bsc_attention": "K1", "bsc_attention_bwd": "K2", "flash_attention": "K5",
                  "flash_attention_bwd": "K6"}.get(name)
        if kernel:
            rec["err"] = max(rec["err"], pixart_sites[kernel]["err"])
    pixart_launches, pixart_sps, pixart_fwd, pixart_samples = phase_pixart_sampling()
    phase_pixart_card_vs_cpu()
    pixart_train_launches, pixart_train_sps, pixart_step = phase_pixart_training()
    wide_launches = phase_pixart_companions()
    log(f"phases 24-29 took {time.perf_counter() - t_pixart:.1f} s")

    t_edm = time.perf_counter()
    edm_sites = phase_edm_sites(logs)
    for name, _, rec in records:
        kernel = {"bsc_attention": "K1", "bsc_attention_bwd": "K2"}.get(name)
        if kernel:
            rec["err"] = max(rec["err"], edm_sites[kernel]["err"])
    edm_launches, edm_sps, edm_fwd = phase_edm_sampling()
    phase_edm_card_vs_cpu()
    edm_train_launches, edm_train_sps, edm_step, edm_run = phase_edm_training()
    companion_launches = phase_edm_companions()
    log(f"phases 30-34 took {time.perf_counter() - t_edm:.1f} s")

    t_wide = time.perf_counter()
    wide_sites = phase_wide_sites(logs)
    for name, _, rec in records:
        kernel = {"bsc_attention": "K1", "bsc_attention_bwd": "K2", "flash_attention": "K5",
                  "flash_attention_bwd": "K6"}.get(name)
        if kernel:
            rec["err"] = max(rec["err"], wide_sites[kernel]["err"])
    wf_launches, wf_sps, wf_fwd = phase_wide_sampling()
    phase_wide_card_vs_cpu()
    wf_train_launches, wf_train_sps, wf_step = phase_wide_training()
    phase_consistency_card_vs_cpu()
    consistency = phase_consistency(edm_run)
    distill_k1, distill_sps = phase_progressive_distillation()
    log(f"phases 35-40 took {time.perf_counter() - t_wide:.1f} s")

    t_mmdit = time.perf_counter()
    mmdit_sites = phase_mmdit_sites()
    for name, _, rec in records:
        kernel = {"flash_attention": "K5", "flash_attention_bwd": "K6"}.get(name)
        if kernel:
            rec["err"] = max(rec["err"], mmdit_sites["err"][kernel])
    mmdit = {}
    for name in MMDIT_HEADLINES:
        mmdit[name] = phase_mmdit_sampling(name) + phase_mmdit_training(name)
    phase_mmdit_card_vs_cpu()
    mmdit_companions = phase_mmdit_companions()
    log(f"phases 41-45 took {time.perf_counter() - t_mmdit:.1f} s")

    t_sana = time.perf_counter()
    sana_sites = phase_sana_sites(logs)
    cascade_counts, cascade_errs = phase_cascade_sites()
    for name, _, rec in records:
        kernel = {"flash_attention": "K5", "flash_attention_bwd": "K6"}.get(name)
        if kernel:
            rec["err"] = max(rec["err"], sana_sites["err"][kernel])
        kernel = {"bsc_attention": "K1", "bsc_attention_bwd": "K2"}.get(name)
        if kernel:
            rec["err"] = max(rec["err"], cascade_errs[kernel])
    sana_k5, sana_sps, sana_fwd = phase_sana_sampling()
    sana_k6, sana_train_sps, sana_step = phase_sana_training()
    phase_sana_card_vs_cpu()
    cascade_runs = phase_cascade_runs(cascade_counts)
    phase_cascade_card_vs_cpu()
    log(f"phases 46-50 took {time.perf_counter() - t_sana:.1f} s")

    t_video = time.perf_counter()
    video_sites = phase_video_sites()
    for name, _, rec in records:
        kernel = {"bsc_attention": "K1", "bsc_attention_bwd": "K2", "affine_silu_conv3x3": "K4",
                  "flash_attention": "K5", "flash_attention_bwd": "K6"}.get(name)
        if kernel:
            rec["err"] = max(rec["err"], video_sites["err"][kernel])
    vdm, vdm_gn_sites = phase_vdm()
    video_runs, companion_gn_sites = phase_video_companions()
    video_runs = {"video_diffusion_models.yaml": vdm, **video_runs}
    video_k3_err = check_video_k3(vdm_gn_sites + companion_gn_sites)
    guided_launches = phase_video_guidance()
    phase_video_card_vs_cpu()
    log(f"phases 51-55 took {time.perf_counter() - t_video:.1f} s")

    t_long = time.perf_counter()
    fdm = phase_fdm_sites()
    fdm_runs = phase_fdm_runs(fdm["forward"], fdm["step"])
    phase_fdm_card_vs_cpu()
    imagen_video = phase_imagen_video()
    warm = phase_warm_start()
    mm256 = phase_moving_mnist_256(fdm["forward"], fdm["step"])
    for name, _, rec in records:
        kernel = {"bsc_attention": "K1", "bsc_attention_bwd": "K2", "group_norm_silu": "K3",
                  "affine_silu_conv3x3": "K4"}.get(name)
        if kernel:
            rec["err"] = max(rec["err"], imagen_video["err"][kernel],
                             fdm["err"].get(kernel, 0.0))
    log(f"phases 56-61 took {time.perf_counter() - t_long:.1f} s")

    t_vae = time.perf_counter()
    vae_sites = phase_vae_sites()
    for name, _, rec in records:
        kernel = {"bsc_attention": "K1", "bsc_attention_bwd": "K2", "group_norm_silu": "K3",
                  "flash_attention": "K5", "flash_attention_bwd": "K6"}.get(name)
        if kernel:
            rec["err"] = max(rec["err"], vae_sites["err"][kernel])
    vae_data_root = vae_video_data()
    vae_runs, vae_speed, vae_run_dirs = phase_vae_runs(vae_data_root)
    latent = phase_latent_ltx(vae_data_root, vae_run_dirs["ltx"])
    phase_vae_card_vs_cpu()
    log(f"phases 62-65 took {time.perf_counter() - t_vae:.1f} s")

    t_st = time.perf_counter()
    st_sites = phase_transformer_sites()
    audio_sites = phase_audio_sites()
    for name, _, rec in records:
        kernel = {"flash_attention": "K5", "flash_attention_bwd": "K6"}.get(name)
        if kernel:
            rec["err"] = max(rec["err"], st_sites["err"][kernel])
        kernel = {"bsc_attention": "K1", "bsc_attention_bwd": "K2", "group_norm_silu": "K3",
                  "affine_silu_conv3x3": "K4"}.get(name)
        if kernel:
            rec["err"] = max(rec["err"], audio_sites["err"][kernel])
    long_tx = {"sora": phase_sora(),
               "hunyuan_video": phase_hunyuan(vae_data_root, vae_run_dirs["hunyuan"])}
    audio = phase_audio()
    phase_transformers_card_vs_cpu()
    log(f"phases 66-71 took {time.perf_counter() - t_st:.1f} s")

    t_extras = time.perf_counter()
    extras = {"lora": phase_lora(sites, os.path.join(flagship_run, "checkpoints",
                                                     f"{TRAIN_STEPS}.pt")),
              "accumulation": phase_accumulation(sites),
              "importance": phase_importance(sites)}
    extras["observability"], startup = phase_observability(sites)
    step_times = extras_step_times()
    log(f"phases 72-75 took {time.perf_counter() - t_extras:.1f} s")

    t_eval = time.perf_counter()
    evaluation, fid_floor, fid_samples = phase_interchange(sites, flagship_run, pixart_samples,
                                                           smi)
    evaluation.update(phase_video_fid(vdm, smi))
    evaluation["perceptual_cli"] = phase_perceptual(smi)
    log(f"phases 76-78 took {time.perf_counter() - t_eval:.1f} s")
    log(f"phases 1-78 took {time.perf_counter() - t_run:.1f} s")
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
    # K1 and K2 at the headline's cross-attention sites (bf16, per guided
    # sampling forward at batch 128), and their launches on its paths.
    by_name = {k["name"]: k for k in kernels}
    for name, kernel, launched in (
            ("bsc_attention", "K1", text_launches["bsc_attention"]),
            ("bsc_attention_bwd", "K2", text_train_launches["bsc_attention_bwd"])):
        by_name[name]["cross_attention"] = {"ms": text_sites[kernel]["ms"],
                                "library_ms": text_sites[kernel]["sdpa_ms"],
                                "bound_ms": text_sites[kernel]["bound_ms"],
                                "launches": launched}
    # K5 and K6 at PixArt's cross-attention site (fp32, per guided sampling
    # forward at batch 128 and per training step at batch 128: 12 calls),
    # and their launches on its paths; K1 and K2 at the deep WideFormer's
    # self-attention site (fp32, batch 32: 20 calls), and their launches in
    # its CLI run and training steps.
    for name, kernel, launched, key in (
            ("flash_attention", "K5", pixart_launches["flash_attention"],
             "pixart_cross_attention"),
            ("flash_attention_bwd", "K6", pixart_train_launches["flash_attention_bwd"],
             "pixart_cross_attention"),
            ("bsc_attention", "K1", wide_launches["bsc_attention"], "wideformer_deep"),
            ("bsc_attention_bwd", "K2", wide_launches["bsc_attention_bwd"], "wideformer_deep")):
        rec = pixart_sites[kernel]
        by_name[name][key] = {k: rec[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
        by_name[name][key]["launches"] = launched
    # K1 and K2 at head dim 256 (the wide variant): fp32 at the SongUNet's
    # sites, per sampling forward at batch 64 (K1) and per training step at
    # batch 128 (K2); launches in edm.yaml's 18-step Heun run (K1) and its
    # training run (K2), and in the companions' CLI runs and steps.
    for name, kernel, launched, companions in (
            ("bsc_attention", "K1", edm_launches["bsc_attention"],
             companion_launches["bsc_attention"]),
            ("bsc_attention_bwd", "K2", edm_train_launches["bsc_attention_bwd"],
             companion_launches["bsc_attention_bwd"])):
        rec = edm_sites[kernel]
        by_name[name]["edm_head_dim_256"] = {k: rec[k] for k in (
            "ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "cuda_core_ms")}
        by_name[name]["edm_head_dim_256"].update(launches=launched,
                                                 companion_launches=companions)
    # K5 and K6 at head dim 256 (the wide variant) and K1 and K2 at the same
    # config's self-attention: fp32 at wideformer_pixart.yaml's sites (B 128),
    # per guided sampling forward (K1, K5) and per training step (K2, K6),
    # two calls each; launches in its sampling run and its training run.
    for name, kernel, launched in (
            ("flash_attention", "K5", wf_launches["flash_attention"]),
            ("flash_attention_bwd", "K6", wf_train_launches["flash_attention_bwd"]),
            ("bsc_attention", "K1", wf_launches["bsc_attention"]),
            ("bsc_attention_bwd", "K2", wf_train_launches["bsc_attention_bwd"])):
        rec = wide_sites[kernel]
        key = "wideformer_head_dim_256" if kernel in ("K5", "K6") else "wideformer_self_attention"
        by_name[name][key] = {k: rec[k] for k in (
            "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}
        by_name[name][key]["launches"] = launched
    # K5 and K6 at the MM-DiT family's joint-attention sites (fp32, one call
    # at B 128; the forward's and training step's calls: SD3 12, SD3.5's
    # image-only 4, Flux 18, AuraFlow 14), and their launches on the
    # headlines' sampling-CLI and training runs and the companions' CLI runs
    # and steps.
    for name, kernel, idx in (("flash_attention", "K5", 0), ("flash_attention_bwd", "K6", 3)):
        by_name[name]["mmdit_joint_attention"] = {
            "sites": {site: dict(mmdit_sites[kernel][site], shape=list(shape))
                      for site, shape in MMDIT_FLASH_SITES.items()},
            "launches": {cfg: runs[idx] for cfg, runs in mmdit.items()},
            "companion_launches": {cfg: pair[idx // 3]
                                   for cfg, pair in mmdit_companions.items()}}
    # K5 and K6 at Sana's cross-attention site (head dim 576, B 128): one
    # fp32 call (12 a guided forward or a training step) beside the plain
    # version, SDPA and the bound, bf16 beside it; launches in sana.yaml's
    # sampling-CLI run and its training run.
    for name, kernel, launched in (("flash_attention", "K5", sana_k5),
                                   ("flash_attention_bwd", "K6", sana_k6)):
        by_name[name]["sana_cross_attention"] = dict(
            sana_sites[kernel], shape=list(SANA_FLASH_SITE), calls_per_forward=SANA_BLOCKS,
            launches=launched)
    # K1-K4 launches in the cascades' training and sampling-CLI runs, and
    # the largest fp32 error at their stages' sites.
    for name, kernel in (("bsc_attention", "K1"), ("bsc_attention_bwd", "K2"),
                         ("group_norm_silu", "K3"), ("affine_silu_conv3x3", "K4")):
        by_name[name]["cascades"] = {
            "launches": {cfg: {"training": r[0][name], "sampling_cli": r[1][name]}
                         for cfg, r in cascade_runs.items()},
            "max_abs_err_fp32_at_stage_sites": cascade_errs[kernel]}
    # K1-K6 at the video UNets' sites (fp32, one call each: K1/K2 at
    # video_diffusion_models.yaml's 16x16 self-attention and Make-A-Video's
    # cross-attention, K4 at a shared-frame conv2, K5/K6 at AnimateDiff's
    # 32x32 motion attention), and their launches in each video config's
    # training and sampling-CLI runs and in the reconstruction-guided
    # sampling; these launches also count in each kernel's `launches`.
    for name, kernel in (("bsc_attention", "K1"), ("bsc_attention_bwd", "K2"),
                         ("group_norm_silu", "K3"), ("affine_silu_conv3x3", "K4"),
                         ("flash_attention", "K5"), ("flash_attention_bwd", "K6")):
        runs = {cfg: {"training": r["training"].get(name, 0),
                      "sampling_cli": r["sampling_cli"].get(name, 0)}
                for cfg, r in video_runs.items()}
        entry = {"launches": runs, "guided_sampling_launches": guided_launches.get(name, 0)}
        if kernel in video_sites:
            entry["sites"] = video_sites[kernel]
        if kernel == "K3":
            entry["max_abs_err_fp32_at_video_sites"] = video_k3_err
        by_name[name]["video_unets"] = entry
        by_name[name]["launches"] += (sum(r["training"] + r["sampling_cli"] for r in runs.values())
                                      + entry["guided_sampling_launches"])
    # K3 and K4 at FDM's sites (fp32, batch 8: per forward, 23 K3 and 44
    # K4 calls, each site as often as the forward calls it; K3 with L2 warm
    # and cold) and at the temporal SR stage's; their launches, and K1/K2's,
    # in FDM's trainer, CLI, scheme and extension runs, the Imagen-Video
    # chain, the warm start and Moving-MNIST-256; these launches also count
    # in each kernel's `launches`.
    long_runs = {"fdm_training": fdm_runs["training"], "fdm_sampling_cli": fdm_runs["sampling_cli"],
                 **{k: r["launches"] for k, r in fdm_runs["long"].items()},
                 "imagen_video_chain": imagen_video["chain"],
                 **{f"warm_start {k}": v for k, v in warm.items()},
                 "moving_mnist_256": mm256}
    for name, kernel in (("bsc_attention", "K1"), ("bsc_attention_bwd", "K2"),
                         ("group_norm_silu", "K3"), ("affine_silu_conv3x3", "K4"),
                         ("flash_attention", "K5"), ("flash_attention_bwd", "K6")):
        entry = {"launches": {k: v.get(name, 0) for k, v in long_runs.items()}}
        if kernel in ("K3", "K4"):
            entry["fdm"] = dict(fdm["times"][kernel], calls_per_forward=fdm["forward"][name],
                                max_abs_err_fp32=fdm["err"][kernel])
            entry["imagen_video_tsr"] = dict(imagen_video["times"][kernel],
                                             calls_per_forward=imagen_video["tsr_forward"][name])
        if kernel in ("K1", "K2", "K3", "K4"):
            entry["max_abs_err_fp32_at_tsr_sites"] = imagen_video["err"][kernel]
        if kernel == "K1":  # a candidate for FDM's einsum attention; not on its path
            entry["fdm_spatial_attention_candidate"] = fdm["spatial_attention"]
        by_name[name]["long_video"] = entry
        by_name[name]["launches"] += sum(entry["launches"].values())
    # K1/K2 at the KL VAEs' one-head-of-256 mid-block sites, K3 at the KL
    # and 5-D Hunyuan/OpenSora GroupNorm sites, K5/K6 at latent LTX's grid
    # (fp32, one call, or each site as often as a forward calls it for K3),
    # and their launches in phases 63-64's runs (the VAEs' training,
    # resume and reconstruct CLI runs; latent LTX's training and resume),
    # which also count in `launches`.
    vae_launches = {f"{cfg} {kind}": counts for cfg, run in vae_runs.items()
                    for kind, counts in run.items()}
    vae_launches.update({f"ltx_video {kind}": counts
                         for kind, counts in latent["launches"].items()})
    for name, kernel in (("bsc_attention", "K1"), ("bsc_attention_bwd", "K2"),
                         ("group_norm_silu", "K3"), ("flash_attention", "K5"),
                         ("flash_attention_bwd", "K6")):
        entry = {"sites": vae_sites[kernel], "max_abs_err": vae_sites["err"][kernel],
                 "launches": {k: v.get(name, 0) for k, v in vae_launches.items()}}
        by_name[name]["autoencoders"] = entry
        by_name[name]["launches"] += sum(entry["launches"].values())
    # K5 and K6 at Sora's and HunyuanVideo's sites (fp32, one call at batch
    # 8; calls_per_forward: Sora 48, Hunyuan 20), and their launches, and
    # K3's in Hunyuan's VAE, in phases 68-69's runs (the training CLI, its
    # resume, Sora's sampling CLI), which also count in `launches`.
    for name, kernel in (("group_norm_silu", "K3"), ("flash_attention", "K5"),
                         ("flash_attention_bwd", "K6")):
        entry = {"launches": {f"{cfg} {kind}": counts.get(name, 0) for cfg, r in long_tx.items()
                              for kind, counts in r["launches"].items()}}
        if kernel in st_sites:
            entry.update(sites=st_sites[kernel], max_abs_err=st_sites["err"][kernel],
                         calls_per_forward={"sora": SORA_K5, "hunyuan_video": HUNYUAN_K5})
        by_name[name]["long_video_transformers"] = entry
        by_name[name]["launches"] += sum(entry["launches"].values())
    # K1-K4 at the audio UNet's sites (fp32: K1/K2 one call at the 16x16
    # site, batch 64; K3/K4 summed over a forward's sites), and their
    # launches in phase 70's runs (the audio training CLI, its resume,
    # sample_audio, the audio VAEs' CLI runs), which also count in `launches`.
    for name, kernel in (("bsc_attention", "K1"), ("bsc_attention_bwd", "K2"),
                         ("group_norm_silu", "K3"), ("affine_silu_conv3x3", "K4")):
        site = {k: v for k, v in audio_sites[kernel].items() if k != "err"}
        entry = {"site": site, "max_abs_err": audio_sites["err"][kernel],
                 "launches": {kind: counts.get(name, 0)
                              for kind, counts in audio["launches"].items()}}
        by_name[name]["audio"] = entry
        by_name[name]["launches"] += sum(entry["launches"].values())
    # K1-K4's launches in phases 72-75's runs (LoRA training, its resume
    # through the train_lora CLI and the sampling CLI with --lora_weights;
    # gradient accumulation's mini-steps, run and resume; importance
    # sampling's run and resume; the profiled and debug_nans runs), which
    # also count in `launches`.
    for name in ("bsc_attention", "bsc_attention_bwd", "group_norm_silu", "affine_silu_conv3x3"):
        entry = {"launches": {f"{group}: {label}": counts.get(name, 0)
                              for group, group_runs in extras.items()
                              for label, counts in group_runs.items()}}
        by_name[name]["trainer_extras"] = entry
        by_name[name]["launches"] += sum(entry["launches"].values())
    # K1, K3 and K4's launches in phases 76-77's evaluation CLIs (measure_fid
    # on the imported flagship checkpoint, measure_video_fid on phase 52's),
    # which also count in `launches`.
    for name in ("bsc_attention", "group_norm_silu", "affine_silu_conv3x3"):
        entry = {"launches": {cli: evaluation[cli].get(name, 0)
                              for cli in ("measure_fid", "measure_video_fid")}}
        by_name[name]["evaluation"] = entry
        by_name[name]["launches"] += sum(entry["launches"].values())
    # K1's launches on the consistency and progressive-distillation paths.
    by_name["bsc_attention"]["consistency_distillation_launches"] = consistency["launches"]
    by_name["bsc_attention"]["progressive_distillation_launches"] = distill_k1
    k3 = next(k for k in kernels if k["name"] == "group_norm_silu")
    k3["cold_ms"] = k3_record[2]["cold_ms"]
    k3["backward_ms"] = k3_backward_ms
    k3["edm_max_abs_err_fp32"] = edm_sites["K3"]["err"]
    log(f"K3 per flagship bf16 forward: {k3['ms']:.4f} ms warm, {k3['cold_ms']:.4f} cold against "
        f"a bound of {k3['bound_ms']:.4f} ({100 * k3['bound_ms'] / k3['cold_ms']:.1f}% reached "
        f"cold); {K3_BEFORE_FORWARD_MS} before the redesign; its plain-autograd backward "
        f"{k3_backward_ms:.4f} ms a training step")
    log(f"kernel times (device time; wrapper_ms: the wrapper's host time) are bf16 sums "
        f"over each kernel's sites, per sampling forward at "
        f"batch {BATCH} (K2: per training step at batch {TRAIN_BATCH}; K5: fp32, per LTX "
        f"forward at batch {LTX_BATCH}; K6: fp32, per LTX training step at batch "
        f"{LTX_TRAIN_BATCH}); launches are per 50-step DDIM run (K2: per training run; K5: "
        f"per {MAIN_STEPS}-step LTX run; K6: per {TRAIN_STEPS}-step LTX training run); sampling "
        f"{sps:.2f} samples/s, training {train_sps:.3f} steps/s, LTX {ltx_sps:.4f} "
        f"samples/s, LTX training {ltx_train_sps:.3f} steps/s, long video "
        f"{long_s['fp32']:.4f} s/forward fp32, {long_s['bf16']:.4f} bf16, long training "
        f"step {long_train['fp32'][0]:.1f} ms fp32 (K6 {long_train['fp32'][1]:.1f}), "
        f"{long_train['bf16'][0]:.1f} ms bf16 (K6 {long_train['bf16'][1]:.1f}); K7: fp32, one "
        f"call at the DiT site (128, 6, 16, 64), no path launches it; DiT sampling "
        f"{dit_sps:.3f} samples/s ({dit_k1} K1 launches in {MAIN_STEPS} guided steps), DiT training "
        f"{dit_train_sps:.3f} steps/s ({dit_k2} K2 launches in {TRAIN_STEPS} steps); headline "
        f"{os.path.basename(TEXT_CONFIG)} (bf16) sampling {text_sps:.2f} samples/s (50-step "
        f"guided DDIM, batch {BATCH}; a guided forward {text_fwd[0]:.3f} ms wall, "
        f"{text_fwd[1]:.3f} ms device, {100 * text_fwd[1] / text_fwd[0]:.1f}% busy), training "
        f"{text_train_sps:.3f} steps/s (batch {TRAIN_BATCH}; a step {text_step[0]:.3f} ms wall, "
        f"{text_step[1]:.3f} ms device, {100 * text_step[1] / text_step[0]:.1f}% busy); PixArt "
        f"{os.path.basename(PIXART_CONFIG)} (fp32) sampling {pixart_sps:.3f} samples/s ({MAIN_STEPS} "
        f"guided ancestral steps, batch {DIT_BATCH}, {pixart_launches['flash_attention']} K5 "
        f"launches; a guided forward {pixart_fwd[0]:.3f} ms wall, {pixart_fwd[1]:.3f} ms "
        f"device, {100 * pixart_fwd[1] / pixart_fwd[0]:.1f}% busy), training "
        f"{pixart_train_sps:.3f} steps/s (batch {TRAIN_BATCH}, "
        f"{pixart_train_launches['flash_attention_bwd']} K6 launches in {TRAIN_STEPS} steps; a "
        f"step {pixart_step[0]:.3f} ms wall, {pixart_step[1]:.3f} ms device, "
        f"{100 * pixart_step[1] / pixart_step[0]:.1f}% busy); FID real floor {fid_floor:.4f}, "
        f"PixArt samples {fid_samples:.4f}; EDM {os.path.basename(EDM_CONFIG)} (fp32) sampling "
        f"{edm_sps:.3f} samples/s ({EDM_HEUN_STEPS}-step Heun, batch {BATCH}, "
        f"{edm_launches['bsc_attention']} K1 launches at head dim 256; a forward "
        f"{edm_fwd[0]:.3f} ms wall, {edm_fwd[1]:.3f} ms device, "
        f"{100 * edm_fwd[1] / edm_fwd[0]:.1f}% busy), training {edm_train_sps:.3f} steps/s "
        f"(batch {TRAIN_BATCH}; a step {edm_step[0]:.3f} ms wall, {edm_step[1]:.3f} ms device, "
        f"{100 * edm_step[1] / edm_step[0]:.1f}% busy); WideFormer "
        f"{os.path.basename(WIDEFORMER)} (fp32, head dim 256) sampling {wf_sps:.3f} samples/s "
        f"({WIDE_SAMPLING_STEPS} guided ancestral steps, batch {DIT_BATCH}, "
        f"{wf_launches['flash_attention']} K5 launches; a guided forward {wf_fwd[0]:.3f} ms "
        f"wall, {wf_fwd[1]:.3f} ms device, {100 * wf_fwd[1] / wf_fwd[0]:.1f}% busy), "
        f"training {wf_train_sps:.3f} steps/s (batch {TRAIN_BATCH}; a step {wf_step[0]:.3f} "
        f"ms wall, {wf_step[1]:.3f} ms device, {100 * wf_step[1] / wf_step[0]:.1f}% "
        f"busy); consistency (fp32) one-step sampling {consistency['onestep_sps']:.1f} "
        f"samples/s at batch {CONSISTENCY_BATCH}, distillation {consistency['distillation_sps']:.3f} "
        f"and training {consistency['training_sps']:.3f} steps/s through distill_consistency at "
        f"batch {CONSISTENCY_BATCH} (its set-up included); progressive distillation "
        f"{distill_sps:.3f} steps/s at batch {TRAIN_BATCH} (set-up included); MM-DiT (fp32) "
        + "; ".join(
            f"{cfg} sampling {r[1]:.3f} samples/s ({MMDIT_HEADLINES[cfg][0]} guided Euler steps, "
            f"batch {DIT_BATCH}, {r[0]} K5 launches; a guided forward {r[2][0]:.3f} ms wall, "
            f"{r[2][1]:.3f} ms device, {100 * r[2][1] / r[2][0]:.1f}% busy), training "
            f"{r[4]:.3f} steps/s (batch {TRAIN_BATCH}, {r[3]} K6 launches; a step "
            f"{r[5][0]:.3f} ms wall, {r[5][1]:.3f} ms device, "
            f"{100 * r[5][1] / r[5][0]:.1f}% busy)" for cfg, r in mmdit.items())
        + f"; Sana sana.yaml (fp32, head dim 576) sampling {sana_sps:.3f} samples/s "
        f"({GRID_STEPS} guided ancestral steps, batch {DIT_BATCH}, {sana_k5} K5 launches; a "
        f"guided forward {sana_fwd[0]:.3f} ms wall, {sana_fwd[1]:.3f} ms device, "
        f"{100 * sana_fwd[1] / sana_fwd[0]:.1f}% busy), training {sana_train_sps:.3f} steps/s "
        f"(batch {TRAIN_BATCH}, {sana_k6} K6 launches; a step {sana_step[0]:.3f} ms wall, "
        f"{sana_step[1]:.3f} ms device, {100 * sana_step[1] / sana_step[0]:.1f}% busy); "
        "cascades (fp32) " + "; ".join(
            f"{cfg} training {r[2]:.3f} steps/s (batch {TRAIN_BATCH}, both stages), sampling "
            f"CLI {r[3]:.3f} samples/s ({GRID_STEPS} steps a stage, batch {BATCH})"
            for cfg, r in cascade_runs.items())
        + "; video UNets (fp32, batch " + f"{VIDEO_BATCH}) " + "; ".join(
            f"{cfg} training {r['steps_per_s']:.3f} steps/s, sampling CLI "
            f"{r['samples_per_s']:.3f} samples/s" for cfg, r in video_runs.items())
        + f" (a video_diffusion_models.yaml training step {vdm['step_ms'][0]:.3f} ms wall, "
        f"{vdm['step_ms'][1]:.3f} ms device, {100 * vdm['step_ms'][1] / vdm['step_ms'][0]:.1f}% "
        f"busy); the launches of the video paths count in each kernel's `launches`"
        + f"; FDM (fp32, batch {VIDEO_BATCH}) a forward {fdm['forward_ms'][0]:.3f} ms wall, "
        f"{fdm['forward_ms'][1]:.3f} ms device, a training step {fdm['step_ms'][0]:.3f} ms wall, "
        f"{fdm['step_ms'][1]:.3f} ms device, training {fdm_runs['steps_per_s']:.3f} steps/s, "
        f"sampling CLI {fdm_runs['samples_per_s']:.3f} samples/s; the Imagen-Video chain "
        f"{imagen_video['chain_s']:.2f} s ({CHAIN_STEPS} steps a stage, batch {CHAIN_BATCH})"
        + "; VAE-GAN steps (fp32, full width) " + "; ".join(
            f"{cfg} {r[0]:.3f} steps/s" + (f" (a step {r[1][0]:.3f} ms wall, {r[1][1]:.3f} ms "
                                           f"device)" if r[1] else "")
            for cfg, r in vae_speed.items())
        + f"; latent ltx_video.yaml (fp32, batch {LATENT_BATCH}) training {latent['steps_per_s']:.3f} "
        f"steps/s (a step {latent['step_ms'][0]:.3f} ms wall, {latent['step_ms'][1]:.3f} ms "
        f"device), {LATENT_STRIP_STEPS}-step decoded sampling {latent['samples_per_s']:.3f} "
        f"samples/s at batch 4"
        + "; " + "; ".join(
            f"{cfg} (fp32, batch {VIDEO_BATCH}) training {r['steps_per_s']:.3f} steps/s (a step "
            f"{r['step_ms'][0]:.3f} ms wall, {r['step_ms'][1]:.3f} ms device, "
            f"{100 * r['step_ms'][1] / r['step_ms'][0]:.1f}% busy), sampling "
            f"{r['samples_per_s']:.3f} samples/s" for cfg, r in long_tx.items())
        + f"; the CLAP audio config (fp32, batch {BATCH}) training "
        f"{audio_sites['steps_per_s']:.3f} steps/s (a step {audio_sites['step_ms'][0]:.3f} ms "
        f"wall, {audio_sites['step_ms'][1]:.3f} ms device, "
        f"{100 * audio_sites['step_ms'][1] / audio_sites['step_ms'][0]:.1f}% busy), sample_audio "
        f"{audio['samples_per_s']:.3f} samples/s ({AUDIO_SAMPLE_STEPS} steps, batch "
        f"{AUDIO_SAMPLES})"
        + "; trainer extras (bf16 flagship, batch " + f"{TRAIN_BATCH}) " + "; ".join(
            f"{kind} step {r['steps_per_s']:.3f} steps/s ({r['wall_ms']:.3f} ms wall, "
            f"{r['device_ms']:.3f} ms device, {100 * r['device_ms'] / r['wall_ms']:.1f}% busy)"
            for kind, r in step_times.items())
        + f", start-up: model summary {startup['summary_ms']:.1f} ms, TensorBoard writer "
        f"{startup['tensorboard_ms']:.1f} ms, native batch assembly {startup['native_ms']:.4f} "
        f"ms against numpy's {startup['numpy_ms']:.4f}"
        + f" on {smi}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
