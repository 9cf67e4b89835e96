"""Gaussian diffusion process (DDPM): sampling and the training loss.

Counterpart of `GaussianDiffusion_DDPM` in xdiffusion_tpu/diffusion/ddpm.py:
construction from a config, `predict_score`, `preprocess_context` (prompt
strings to tensors on the host), `sampling_shape`, `sample` and
`loss_on_batch`, for image (B, H, W, C) and video (B, F, H, W, C) samples,
in pixel space or, with a `latent_encoder` (a frozen VAE: autoencoders/),
in its latent space (the loss encodes the batch and scales it by the latent
scale; `sample` divides by it, decodes and maps [-1, 1] to [0, 1]),
on discrete, continuous-time (logSNR: the context carries `logsnr_t`) and
rectified-flow schedules; a super-resolution stage (a `super_resolution`
block and layers/super_resolution.py's input preprocessor) reads its
low-resolution conditioning from the context.
The score network is an `nn.Module` that holds its parameters; randomness
comes from an explicit `torch.Generator`.

Mixture-of-experts networks (layers/moe.py): the training objective adds
`moe_aux_loss_weight` times the mean of the blocks' load-balance losses.
`predict_score`, the deterministic forward that the samplers call, runs an
MoE network in chunks of FORWARD_CHUNK samples when the batch is larger and
divides evenly, as the JAX package's `predict_score` does (ops/batch_chunk.py
there). For a dense network the chunks change nothing but the layout, so the
port runs it whole; for an MoE network they change the result, because each
expert's capacity is reckoned over the tokens of one call. Guided sampling
at batch 64 runs a 128-sample forward, which the JAX package routes as two
chunks of 64. `loss_on_batch` runs the network whole whenever the JAX
package's loss does: in training mode, and for the MoE aux-loss forward
(its `with_intermediates` path), whatever the grad mode.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple, Union

import torch

from xdiffusion_tpu_torch.config import DotConfig, instantiate_from_config, type_from_config
from xdiffusion_tpu_torch.diffusion import PredictionType, prediction_type_from_config
from xdiffusion_tpu_torch.diffusion.sampling import build_sample_loop
from xdiffusion_tpu_torch.importance_sampling import UniformSampler
from xdiffusion_tpu_torch.layers.embedding import place_encoders
from xdiffusion_tpu_torch.layers.moe import MoEMlp
from xdiffusion_tpu_torch.scheduler import elementwise_loss
from xdiffusion_tpu_torch.utils import (
    discretized_gaussian_log_likelihood,
    mean_flat,
    normal_kl,
    normalize_to_neg_one_to_one,
    prob_mask_like,
    resolve_device,
    unnormalize_to_zero_to_one,
)


# The arrays a "text_prompts" guidance signal resolves to.
_TEXT_REALIZATIONS = ("text_tokens", "text_embeddings", "t5_text_embeddings",
                      "clip_text_embeddings", "clap_embeddings")

# Samples per chunk of an MoE network's sampling forward: the JAX
# package's default XDIFFUSION_FORWARD_CHUNK.
FORWARD_CHUNK = 64


def _chunked(apply, x: torch.Tensor, context: Dict):
    """apply(x, context) over batch chunks of FORWARD_CHUNK samples: each
    context tensor whose leading axis is the batch is split with x, the rest
    passes whole. One call when the batch is at most FORWARD_CHUNK or does
    not divide."""
    b = x.shape[0]
    if b <= FORWARD_CHUNK or b % FORWARD_CHUNK:
        return apply(x, context)
    moving = {k for k, v in context.items()
              if isinstance(v, torch.Tensor) and v.ndim >= 1 and v.shape[0] == b}
    outs = []
    for i in range(0, b, FORWARD_CHUNK):
        part = {k: (v[i:i + FORWARD_CHUNK] if k in moving else v) for k, v in context.items()}
        outs.append(apply(x[i:i + FORWARD_CHUNK], part))
    return torch.cat(outs, dim=0)


class GaussianDiffusion_DDPM:
    """Config-driven diffusion process over a score network.

    Runs on `device`: CUDA when none is given (raising if there is no CUDA
    device), the CPU only when asked for."""

    def __init__(self, config: DotConfig,
                 device: Optional[Union[str, torch.device]] = None):
        self.device = resolve_device(device)
        self._config = config
        diff = config.diffusion
        self._prediction_type = prediction_type_from_config(diff.parameterization)

        sn_cfg = diff.score_network
        sn_cls = type_from_config(sn_cfg.to_dict())
        self._score_network = sn_cls(config=DotConfig(sn_cfg.params.to_dict()))
        self._score_network.to(self.device).eval()
        self._is_learned_sigma = bool(sn_cfg.params.is_learned_sigma)
        self._has_experts = int(sn_cfg.params.get("num_experts", 0) or 0) > 1
        self._moe_aux_weight = (float(sn_cfg.params.get("moe_aux_loss_weight", 0.01))
                                if self._has_experts else 0.0)

        self._noise_scheduler = instantiate_from_config(
            diff.noise_scheduler.to_dict()).to(self.device)
        is_cfg = diff.noise_scheduler.params.get("importance_sampler")
        if is_cfg is not None and "target" in is_cfg:
            self._importance_sampler = instantiate_from_config(is_cfg.to_dict())
        else:
            self._importance_sampler = UniformSampler(self._noise_scheduler.steps())

        self._context_preprocessors = [
            instantiate_from_config(c) for c in diff.get("context_preprocessing", [])
        ]
        # Frozen text towers load on the process's device.
        place_encoders(self._context_preprocessors, self.device)
        self._host_prompt_projection = None
        projs = sn_cfg.params.get("conditioning", {}).get("projections", {})
        if "text_prompts" in projs:
            candidate = instantiate_from_config(projs["text_prompts"].to_dict())
            if getattr(candidate, "host_side", False):
                self._host_prompt_projection = candidate
        ip_cfg = diff.get("input_preprocessing")
        self._input_preprocessor = (
            instantiate_from_config(ip_cfg.to_dict()) if ip_cfg is not None else None)

        cfg_block = diff.get("classifier_free_guidance")
        self._classifier_free_guidance = (
            float(cfg_block.classifier_free_guidance) if cfg_block is not None else 0.0)
        self._unconditional_context_adapter = (
            instantiate_from_config(cfg_block.unconditional_context.to_dict())
            if cfg_block is not None else None)
        self._unconditional_guidance_probability = (
            float(cfg_block.unconditional_guidance_probability)
            if cfg_block is not None else 0.0)
        self._cfg_signals = list(cfg_block.signals) if cfg_block is not None else []

        sampling = diff.get("sampling")
        if sampling is not None and "target" in sampling:
            self._reverse_process_sampler = instantiate_from_config(sampling.to_dict())
        else:
            from xdiffusion_tpu_torch.samplers.ancestral import AncestralSampler

            self._reverse_process_sampler = AncestralSampler()

        # Optional SDE shell (rectified flow).
        sde_cfg = diff.get("sde")
        self._sde = (instantiate_from_config(sde_cfg.to_dict())
                     if sde_cfg is not None else None)

        # Latent diffusion: a frozen VAE on the process's device. The
        # trainers load its weights (set_latent_encoder_params) and fix the
        # latent scale (compute_latent_scale) before the first loss.
        le_cfg = diff.get("latent_encoder")
        self._latent_encoder = None
        if le_cfg is not None:
            self._latent_encoder = instantiate_from_config(
                le_cfg.to_dict(), use_config_struct=True, device=self.device)
            self._latent_encoder.requires_grad_(False).eval()
        self._latent_scale_factor: Optional[float] = None

    # -- protocol accessors ------------------------------------------------

    def config(self) -> DotConfig:
        return self._config

    def score_network(self) -> torch.nn.Module:
        return self._score_network

    def noise_scheduler(self):
        return self._noise_scheduler

    def importance_sampler(self):
        return self._importance_sampler

    def example_batch(self, batch_size: int = 2) -> Tuple[torch.Tensor, Dict]:
        """Zero (x, context) of the config's input signature, as the JAX
        package's `example_batch` builds them for its model summary: the
        timestep (and logSNR of a continuous schedule), classes, text tokens,
        a super-resolution stage's low-resolution input and augmentation
        timestep, and what the context preprocessors make of empty prompts."""
        diff = self._config.diffusion
        sn = diff.score_network.params
        s = sn.input_spatial_size
        spatial = [s[0], s[1]] if isinstance(s, list) else [s, s]
        dev = self.device
        frames = [sn.input_number_of_frames] if "input_number_of_frames" in sn else []
        x = torch.zeros([batch_size] + frames + spatial + [sn.input_channels], device=dev)
        continuous = self._noise_scheduler.continuous()
        time_dtype = torch.float32 if continuous else torch.long
        context: Dict = {"timestep": torch.zeros((batch_size,), dtype=time_dtype, device=dev)}
        if continuous:
            context["logsnr_t"] = torch.zeros((batch_size,), device=dev)
        if sn.get("is_class_conditional", False):
            context["classes"] = torch.zeros((batch_size,), dtype=torch.long, device=dev)
        signals = list(sn.conditioning.signals) if "conditioning" in sn else []
        if "text_tokens" in signals:
            text_len = 128
            for c in diff.get("context_preprocessing", []) or []:
                params = c.get("params", {}) or {}
                if "text_context_size" in params:
                    text_len = int(params["text_context_size"])
            context["text_tokens"] = torch.zeros((batch_size, text_len), dtype=torch.long,
                                                 device=dev)
        if "super_resolution" in self._config:
            sr = self._config.super_resolution
            prep = diff.get("input_preprocessing", {})
            temporal = bool((prep.get("params", {}) if prep else {}).get("is_temporal", False))
            low = sr.low_resolution_size
            if frames and temporal:
                lr_shape = [batch_size, low] + spatial + [sn.output_channels]
            else:
                lr_shape = [batch_size] + frames + [low, low, sn.output_channels]
            context[sr.conditioning_key] = torch.zeros(lr_shape, device=dev)
            context["augmentation_timestep"] = torch.zeros((batch_size,), dtype=time_dtype,
                                                           device=dev)
        if self._context_preprocessors:
            probe = self.preprocess_context({"text_prompts": [""] * batch_size})
            for key, value in probe.items():
                if key not in context and isinstance(value, torch.Tensor):
                    context[key] = value.to(dev)
        return x, context

    def prediction_type(self) -> PredictionType:
        return self._prediction_type

    def is_learned_sigma(self) -> bool:
        return self._is_learned_sigma

    def sde(self):
        return self._sde

    def classifier_free_guidance(self) -> float:
        return self._classifier_free_guidance

    def dynamic_thresholding_config(self):
        return self._config.diffusion.get("dynamic_thresholding")

    # -- latent diffusion ------------------------------------------------------

    def latent_encoder(self):
        return self._latent_encoder

    def set_latent_encoder_params(self, state_dict: Dict[str, torch.Tensor]) -> None:
        """Loads a VAE's parameters: its `ae.*` entries (a VAE-GAN
        checkpoint's `params` also holds the discriminator's `disc.*`, which a
        frozen latent encoder has no use for), strictly."""
        ae = {k[len("ae."):]: v for k, v in state_dict.items() if k.startswith("ae.")}
        self._latent_encoder.ae.load_state_dict(ae)

    def compute_latent_scale(self, images: torch.Tensor,
                             noise: Optional[torch.Tensor] = None,
                             generator: Optional[torch.Generator] = None) -> float:
        """scale = 1 / std of the latents of a representative batch (the
        posterior's draw `noise`, else drawn from `generator`)."""
        assert self._latent_encoder is not None
        z = self._latent_encoder.encode_to_latents(images, noise=noise, generator=generator)
        self._latent_scale_factor = float(1.0 / z.float().std(correction=0))
        return self._latent_scale_factor

    def set_latent_scale(self, scale: float) -> None:
        self._latent_scale_factor = float(scale)

    def _clean_input(self, images: torch.Tensor, noise: Optional[torch.Tensor],
                     generator: Optional[torch.Generator]) -> torch.Tensor:
        """z_0: the batch in [-1, 1], or a latent process's scaled latents
        of it (the posterior's draw `noise`, else from `generator`)."""
        if self._latent_encoder is None:
            return normalize_to_neg_one_to_one(images)
        if self._latent_scale_factor is None:
            raise ValueError("call compute_latent_scale() or set_latent_scale() before training")
        if noise is None and generator is None:
            raise ValueError("loss_on_batch: pass a generator for its random draws")
        z = self._latent_encoder.encode_to_latents(images, noise=noise, generator=generator)
        return z * self._latent_scale_factor

    # -- forward -------------------------------------------------------------

    def process_input(self, x: torch.Tensor, context: Dict) -> torch.Tensor:
        if self._input_preprocessor is None:
            return x
        return self._input_preprocessor(x=x, context=context,
                                        noise_scheduler=self._noise_scheduler)

    def predict_score(self, x: torch.Tensor, context: Dict,
                      network: Optional[torch.nn.Module] = None) -> torch.Tensor:
        """The deterministic prediction of the score network (or of
        `network`, one of the same architecture: a distillation teacher); an
        MoE network's runs in FORWARD_CHUNK-sample chunks (see the module
        docstring)."""
        network = network if network is not None else self._score_network
        if self._has_experts:
            return _chunked(network, x, context)
        return network(x, context)

    def preprocess_context(self, context: Dict) -> Dict:
        """Host-side: prompt strings -> tensors, by the config's context
        preprocessors and then by a host-side `text_prompts` projection of
        the score network (T5TextPromptsToTokens), if it has one."""
        for preprocessor in self._context_preprocessors:
            context = preprocessor(context)
        if "text_prompts" in context and self._host_prompt_projection is not None:
            context = dict(context)
            context["text_tokens"] = self._host_prompt_projection(context.pop("text_prompts"))
        return context

    def unconditional_context(self, context: Dict) -> Optional[Dict]:
        if self._unconditional_context_adapter is None:
            return None
        out = self._unconditional_context_adapter(context)
        return out if isinstance(out, dict) else None

    # -- training loss -------------------------------------------------------

    def loss_on_batch(self, images: torch.Tensor, context: Dict,
                      timesteps: Optional[torch.Tensor] = None,
                      loss_weights: Optional[torch.Tensor] = None,
                      noise: Optional[torch.Tensor] = None,
                      deterministic: bool = False,
                      generator: Optional[torch.Generator] = None,
                      latent_noise: Optional[torch.Tensor] = None,
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Training objective on an image (B, H, W, C) or video (B, F, H, W, C)
        batch in [0, 1], differentiable in the score network's parameters.
        Returns (loss, metrics). A context `video_mask` (B, F) keeps the
        frames it marks False at their clean values. A latent process
        diffuses the frozen VAE's latents of the batch times the latent
        scale.

        `generator` (on the process's device) draws, in this order, a latent
        process's posterior noise unless `latent_noise` is given (the JAX
        package draws it from the fifth of its key's five-way split), the
        timesteps unless `timesteps` is given, the noise unless `noise` is
        given, the classifier-free-guidance drop mask, a super-resolution
        stage's conditioning augmentation (its timesteps unless the context
        holds `augmentation_timestep`, then its noise unless it holds
        `augmentation_noise`: layers/super_resolution.py), and the dropout
        masks.
        `deterministic=True` puts the network in eval mode (no dropout);
        otherwise it trains, and drops with `generator`. For a mixture-of-
        experts network the objective adds the weighted load-balance loss,
        reported as metrics["moe_aux_loss"]."""
        b = images.shape[0]
        context = dict(context)

        def need_generator():
            if generator is None:
                raise ValueError("loss_on_batch: pass a generator for its random draws")
            return generator

        z_0 = self._clean_input(images, latent_noise, generator)
        if timesteps is not None:
            t = timesteps
            weights = (loss_weights if loss_weights is not None
                       else torch.ones((b,), dtype=torch.float32, device=images.device))
        else:
            t, weights = self._noise_scheduler.sample_random_times(b, need_generator())
        if self._noise_scheduler.continuous():
            context["logsnr_t"] = self._noise_scheduler.logsnr(t)
        context["timestep"] = t

        epsilon = (noise if noise is not None else
                   torch.randn(z_0.shape, generator=need_generator(), dtype=z_0.dtype,
                               device=z_0.device))
        x_t = self._noise_scheduler.q_sample(x_start=z_0, t=t, noise=epsilon)
        if "video_mask" in context:
            # Masked video diffusion: conditioning frames (mask False) keep
            # their clean values, and networks that splice observed frames
            # at their input read them from context["x0"].
            mask = context["video_mask"][:, :x_t.shape[1], None, None, None].bool()
            x_t = torch.where(mask, x_t, z_0)
            context["x0"] = z_0

        # Training-time CFG: drop conditioning signals to their unconditional
        # values with the configured probability.
        if (self._unconditional_guidance_probability > 0.0
                and self._unconditional_context_adapter is not None):
            uncond = self.unconditional_context(context)
            p = self._unconditional_guidance_probability
            # A probability of 1 drops every example without a draw.
            mask = prob_mask_like((b,), p, need_generator() if p < 1.0 else generator,
                                  images.device)
            for key in self._cfg_signals:
                # A signal named by its prompts drops whichever array the
                # prompts resolved to, as the JAX loss does.
                keys = (key,)
                if key == "text_prompts":
                    keys = tuple(k for k in _TEXT_REALIZATIONS if k in context) or keys
                for k in keys:
                    if k not in context or k not in uncond:
                        continue
                    cond_sig, uncond_sig = context[k], uncond[k]
                    if not hasattr(cond_sig, "ndim"):
                        continue  # an unresolved host signal: a list of prompts
                    cond_sig = torch.as_tensor(cond_sig, device=images.device)
                    uncond_sig = torch.as_tensor(uncond_sig, device=images.device)
                    m = mask.reshape((b,) + (1,) * (cond_sig.ndim - 1))
                    # Token ids stay integers, embeddings keep their dtype.
                    context[k] = torch.where(m, uncond_sig.to(cond_sig.dtype), cond_sig)

        network = self._score_network
        network.train(not deterministic)
        if generator is not None:
            context["preprocessor_generator"] = generator
        x_in = self.process_input(x_t, context)
        if not deterministic:
            context["dropout_generator"] = need_generator()
        if deterministic and self._moe_aux_weight == 0.0:
            model_prediction = self.predict_score(x_in, context)
        else:
            # The JAX package's training forward and its MoE aux-loss forward
            # run whole: the aux loss is the whole batch's, never a chunk's.
            model_prediction = network(x_in, context)
        if self._is_learned_sigma:
            model_prediction, learned_variance = model_prediction

        if self._prediction_type == PredictionType.EPSILON:
            target = epsilon
        elif self._prediction_type == PredictionType.V:
            target = self._noise_scheduler.predict_v_from_x_and_epsilon(
                x=z_0, epsilon=epsilon, t=t)
        elif self._prediction_type == PredictionType.RECTIFIED_FLOW:
            target = z_0 - epsilon
        else:
            raise NotImplementedError(f"Prediction type {self._prediction_type} not implemented.")

        loss_type = getattr(self._noise_scheduler, "loss_type", "l2")
        mse_loss = mean_flat(elementwise_loss(loss_type, model_prediction, target))
        vb_loss = torch.zeros_like(mse_loss)
        if self._is_learned_sigma:
            # The hybrid objective: the variational bound sees the prediction
            # detached, so it trains only the variance half, scaled by 1e-3.
            vb_loss = self._vb_bits_per_dim(model_prediction.detach(), learned_variance,
                                            x_0=z_0, x_t=x_t, context=context) * 1e-3
        objective = ((mse_loss + vb_loss) * weights).mean()
        metrics = {
            "loss": objective,
            "mse_loss": mse_loss.mean(),
            "vb_loss": vb_loss.mean(),
            "timesteps": t,
            "loss_per_example": (mse_loss + vb_loss).detach(),
        }
        if self._moe_aux_weight > 0.0:
            aux = [m.aux_loss for m in network.modules() if isinstance(m, MoEMlp)]
            moe_aux = sum(aux) / len(aux)  # the mean over blocks
            objective = objective + self._moe_aux_weight * moe_aux
            metrics["moe_aux_loss"] = moe_aux
            metrics["loss"] = objective
        return objective, metrics

    def distillation_loss_on_batch(self, images: torch.Tensor, context: Dict, N: int,
                                   teacher: torch.nn.Module,
                                   teacher_process: Optional["GaussianDiffusion_DDPM"] = None,
                                   timesteps: Optional[torch.Tensor] = None,
                                   noise: Optional[torch.Tensor] = None,
                                   generator: Optional[torch.Generator] = None,
                                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Progressive distillation (Salimans & Ho 2022): the score network
        learns to match two DDIM steps of `teacher` (a frozen network of the
        same architecture, run by `teacher_process`, by default this
        process) with one. v-parameterised continuous schedulers only.

        `generator` draws t = i / N with i uniform in [0, N), then the noise,
        unless `timesteps` (fp32 t) and `noise` are given. The teacher runs
        under no_grad. As in the JAX package, the second teacher step's x
        prediction reads z_t and the context at t, not z_mid."""
        teacher_process = teacher_process or self
        sched = self._noise_scheduler
        assert sched.continuous(), "distillation requires a continuous scheduler"
        b = images.shape[0]
        context = dict(context)

        def need_generator():
            if generator is None:
                raise ValueError("distillation_loss_on_batch: pass a generator for its draws")
            return generator

        x_0 = normalize_to_neg_one_to_one(images)
        if timesteps is not None:
            t = torch.as_tensor(timesteps, dtype=torch.float32, device=images.device)
        else:
            t = torch.randint(0, N, (b,), generator=need_generator(),
                              device=images.device).float() / N
        logsnr = sched.logsnr(t)
        context["logsnr_t"] = logsnr
        context["timestep"] = t
        epsilon = (torch.as_tensor(noise, dtype=x_0.dtype, device=x_0.device)
                   if noise is not None else
                   torch.randn(x_0.shape, generator=need_generator(), device=x_0.device))
        z_t = sched.q_sample(x_start=x_0, t=t, noise=epsilon)

        def expand(v):
            return v.reshape((-1,) + (1,) * (z_t.ndim - 1))

        def softplus(x):
            return torch.logaddexp(x, torch.zeros_like(x))

        with torch.no_grad():
            # Teacher DDIM step 1: t -> t - 0.5 / N.
            teacher_v = teacher_process.predict_score(z_t, context, network=teacher)
            x_pred = sched.predict_x_from_v(z=z_t, v=teacher_v, context=context)
            eps_pred = sched.predict_epsilon_from_x(z=z_t, x=x_pred, context=context)
            u_mid = t - 0.5 / N
            logsnr_mid = sched.logsnr(u_mid)
            a_mid = expand(torch.sqrt(torch.sigmoid(logsnr_mid)))
            stdv_mid = expand(torch.sqrt(torch.sigmoid(-logsnr_mid)))
            z_mid = a_mid * x_pred + stdv_mid * eps_pred

            # Teacher DDIM step 2: t - 0.5 / N -> t - 1 / N.
            ctx_mid = dict(context)
            ctx_mid["logsnr_t"] = logsnr_mid
            ctx_mid["timestep"] = u_mid
            teacher_v2 = teacher_process.predict_score(z_mid, ctx_mid, network=teacher)
            x_pred = sched.predict_x_from_v(z=z_t, v=teacher_v2, context=context)
            eps_pred = sched.predict_epsilon_from_x(z=z_t, x=x_pred, context=context)
            u_s = t - 1.0 / N
            logsnr_s = sched.logsnr(u_s)
            a_s = expand(torch.sqrt(torch.sigmoid(logsnr_s)))
            stdv_s = expand(torch.sqrt(torch.sigmoid(-logsnr_s)))
            z_teacher = a_s * x_pred + stdv_s * eps_pred

            # The x target z_teacher implies (not x_pred), x_pred at t = 0.
            a_t = expand(torch.sqrt(torch.sigmoid(logsnr)))
            stdv_frac = expand(torch.exp(0.5 * (softplus(logsnr) - softplus(logsnr_s))))
            x_target = (z_teacher - stdv_frac * z_t) / (a_s - stdv_frac * a_t)
            x_target = torch.where(expand(t == 0), x_pred, x_target)
            eps_target = sched.predict_epsilon_from_x(z=z_t, x=x_target, context=context)

        # The student's one step; SNR weighting makes it an epsilon MSE.
        model_v = self.predict_score(z_t, context)
        model_x = sched.predict_x_from_v(z=z_t, v=model_v, context=context)
        model_eps = sched.predict_epsilon_from_x(z=z_t, x=model_x, context=context)
        loss_per = mean_flat((model_eps - eps_target) ** 2)
        loss = loss_per.mean()
        return loss, {"loss": loss, "mse_loss": loss, "vb_loss": torch.zeros_like(loss),
                      "timesteps": t, "loss_per_example": loss_per.detach()}

    def _vb_bits_per_dim(self, model_prediction: torch.Tensor, learned_variance: torch.Tensor,
                         x_0: torch.Tensor, x_t: torch.Tensor, context: Dict) -> torch.Tensor:
        """The variational-bound term of a learned-sigma network in bits per
        dimension, (B,): the KL of the true posterior from the model's at
        t > 0, the discretised decoder's NLL at t == 0. The network's
        variance half is the model's log-variance."""
        sched = self._noise_scheduler
        true_mean, _, true_log_var = sched.q_posterior(x_start=x_0, x_t=x_t, context=context)
        if self._prediction_type == PredictionType.EPSILON:
            x_hat = sched.predict_x_from_epsilon(z=x_t, epsilon=model_prediction, context=context)
        else:
            x_hat = sched.predict_x_from_v(z=x_t, v=model_prediction, context=context)
        model_mean, _, _ = sched.q_posterior(x_start=x_hat, x_t=x_t, context=context)
        ln2 = math.log(2.0)
        kl = mean_flat(normal_kl(true_mean, true_log_var, model_mean, learned_variance)) / ln2
        decoder_nll = -discretized_gaussian_log_likelihood(
            x_0, means=model_mean, log_scales=0.5 * learned_variance)
        decoder_nll = mean_flat(decoder_nll) / ln2
        t = context["timestep"]
        # Integer steps (int32 in the JAX package, int64 here) test t == 0,
        # continuous times t < 1e-8.
        is_t0 = (t < 1e-8) if t.is_floating_point() else (t == 0)
        return torch.where(is_t0, decoder_nll, kl)

    # -- sampling ------------------------------------------------------------

    def sampling_shape(self, num_samples: int) -> Tuple[int, ...]:
        sampling = self._config.diffusion.sampling
        s = sampling.output_spatial_size
        spatial = [s[0], s[1]] if isinstance(s, list) else [s, s]
        if "output_frames" in sampling:
            return (num_samples, sampling.output_frames, spatial[0], spatial[1],
                    sampling.output_channels)
        return (num_samples, spatial[0], spatial[1], sampling.output_channels)

    def sample(self, num_samples: int = 16, context: Optional[Dict] = None,
               classifier_free_guidance: Optional[float] = None,
               num_sampling_steps: Optional[int] = None, sampler=None,
               initial_noise: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(num_samples, H, W, C) or, for a video config, (num_samples, F, H,
        W, C) samples in [0, 1] on the process's device.

        `generator` (on that device) draws the initial and per-step noise,
        and a super-resolution stage's per-step conditioning augmentation
        noise; `initial_noise`, `context["sampling_noise"]` and
        `context["sampling_augmentation_noise"]` replace them. A stage with
        `super_resolution.sampling_augmentation_level` augments its
        conditioning to that fixed level at every step. Tensors that the
        context preprocessors make on the host (text embeddings) move to the
        device once, before the loop. The loop runs in inference mode, or
        without gradients where the sampler differentiates the network (the
        reconstruction-guided ancestral sampler: samplers/ancestral.py)."""
        sampler = sampler if sampler is not None else self._reverse_process_sampler
        needs_autograd = getattr(sampler, "needs_autograd", lambda ctx: False)(context)
        with torch.no_grad() if needs_autograd else torch.inference_mode():
            return self._sample(num_samples, context, classifier_free_guidance,
                                num_sampling_steps, sampler, initial_noise, generator)

    def _sample(self, num_samples, context, classifier_free_guidance, num_sampling_steps,
                sampler, initial_noise, generator) -> torch.Tensor:
        context = dict(context or {})
        sr = self._config.get("super_resolution")
        if sr is not None and "sampling_augmentation_level" in sr:
            context["augmentation_level"] = sr.sampling_augmentation_level
        steps = (num_sampling_steps if num_sampling_steps is not None
                 else self._noise_scheduler.steps())
        unconditional_context = None
        if classifier_free_guidance is not None:
            unconditional_context = self.unconditional_context(context)
            if unconditional_context is not None:
                unconditional_context = self.preprocess_context(unconditional_context)
        context = self.preprocess_context(context)

        def sanitize(ctx):
            if ctx is None:
                return None
            return {k: v.to(self.device) if isinstance(v, torch.Tensor) else v
                    for k, v in ctx.items()
                    if not isinstance(v, (str, list, tuple)) or k == "shape"}

        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        latent = self._latent_encoder is not None
        if latent and self._latent_scale_factor is None:
            # The JAX package divides by its unset scale (None) and fails there.
            raise ValueError("sample: a latent process needs its VAE's weights and latent "
                             "scale (set_latent_encoder_params, compute_latent_scale)")
        sample_fn = build_sample_loop(
            process=self, shape=self.sampling_shape(num_samples),
            num_sampling_steps=steps,
            sampler=sampler, classifier_free_guidance=classifier_free_guidance,
            unnormalize=not latent,
        )
        x = sample_fn(generator, sanitize(context), sanitize(unconditional_context),
                      initial_noise)
        if not latent:
            return x
        decoded = self._latent_encoder.decode_from_latents(x / self._latent_scale_factor)
        return unnormalize_to_zero_to_one(decoded)
