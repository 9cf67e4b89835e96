"""Training-time timestep samplers: uniform, and loss-aware importance
sampling (Improved DDPM, Sec. 3.3).

Counterpart of xdiffusion_tpu/importance_sampling.py:

- `ScheduleSampler.sample` / `update_with_all_losses` are the host path, on
  float64 numpy state, with a numpy generator;
- `ImportanceSampler`'s device path keeps its state on the model's device
  in the train state ({"loss_history": (T, h) fp32, "loss_counts": (T,)
  int32}): `device_weights`, `device_sample` (torch.multinomial from the
  train state's generator; JAX's `jax.random.choice` draws differ) and
  `device_update`, which applies a batch's (t, loss) pairs as the host loop
  does one after another, duplicates included, in one vectorised pass that
  only moves values.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch


class ScheduleSampler:
    """A distribution over the diffusion steps for training."""

    def weights(self) -> np.ndarray:
        """Unnormalised positive sampling weight per diffusion step."""
        raise NotImplementedError

    def update_with_all_losses(self, ts, losses) -> None:
        """Feeds back per-timestep losses (a no-op unless loss-aware)."""

    @property
    def device_side(self) -> bool:
        """True if the train step draws the timesteps itself."""
        return False

    def sample(self, batch_size: int, rng: Optional[np.random.Generator] = None):
        """Host-side importance sampling: (timesteps int32, weights float32)."""
        rng = rng or np.random.default_rng()
        w = self.weights()
        p = w / np.sum(w)
        indices = rng.choice(len(p), size=(batch_size,), p=p)
        weights = 1.0 / (len(p) * p[indices])
        return indices.astype(np.int32), weights.astype(np.float32)


class UniformSampler(ScheduleSampler):
    """Uniform timesteps with unit weights; the process draws them itself."""

    def __init__(self, num_timesteps: int):
        self._num_timesteps = int(num_timesteps)

    def weights(self) -> np.ndarray:
        return np.ones([self._num_timesteps])

    @property
    def device_side(self) -> bool:
        return True


class ImportanceSampler(ScheduleSampler):
    """Samples t with probability proportional to the root mean square of
    its last `history_per_term` losses, mixed with `uniform_prob` of the
    uniform distribution; uniform until every timestep has a full history."""

    def __init__(self, num_timesteps: int, history_per_term: int = 10,
                 uniform_prob: float = 0.001):
        self.num_timesteps = int(num_timesteps)
        self.history_per_term = int(history_per_term)
        self.uniform_prob = float(uniform_prob)
        self._loss_history = np.zeros([self.num_timesteps, self.history_per_term],
                                      dtype=np.float64)
        self._loss_counts = np.zeros([self.num_timesteps], dtype=np.int64)

    def weights(self) -> np.ndarray:
        if not self._warmed_up():
            return np.ones([self.num_timesteps], dtype=np.float64)
        weights = np.sqrt(np.mean(self._loss_history ** 2, axis=-1))
        weights /= np.sum(weights)
        weights *= 1.0 - self.uniform_prob
        weights += self.uniform_prob / len(weights)
        return weights

    def update_with_all_losses(self, ts, losses) -> None:
        for t, loss in zip(np.asarray(ts), np.asarray(losses)):
            if self._loss_counts[t] == self.history_per_term:
                self._loss_history[t, :-1] = self._loss_history[t, 1:]
                self._loss_history[t, -1] = loss
            else:
                self._loss_history[t, self._loss_counts[t]] = loss
                self._loss_counts[t] += 1

    def _warmed_up(self) -> bool:
        return bool((self._loss_counts == self.history_per_term).all())

    # -- device path (inside the train step) --------------------------------

    @property
    def device_side(self) -> bool:
        return True

    def init_device_state(self, device=None) -> Dict[str, torch.Tensor]:
        """The loss-history state the train state carries."""
        return {"loss_history": torch.zeros((self.num_timesteps, self.history_per_term),
                                            dtype=torch.float32, device=device),
                "loss_counts": torch.zeros((self.num_timesteps,), dtype=torch.int32,
                                           device=device)}

    def device_weights(self, state: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The normalised sampling distribution (fp32); uniform until warmed up."""
        n = self.num_timesteps
        history = state["loss_history"]
        warmed = torch.all(state["loss_counts"] == self.history_per_term)
        w = torch.sqrt(torch.mean(history ** 2, dim=-1))
        w = w / torch.clamp(torch.sum(w), min=1e-12)
        w = w * (1.0 - self.uniform_prob) + self.uniform_prob / n
        return torch.where(warmed, w, torch.full((n,), 1.0 / n, device=history.device))

    def device_sample(self, generator: torch.Generator, batch_size: int,
                      state: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        """(timesteps int64, importance weights fp32) drawn from `generator`."""
        p = self.device_weights(state)
        t = torch.multinomial(p, batch_size, replacement=True, generator=generator)
        weights = 1.0 / (self.num_timesteps * p[t])
        return t, weights.float()

    def device_update(self, state: Dict[str, torch.Tensor], ts: torch.Tensor,
                      losses: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The state after the host loop's update with the pairs (ts[i],
        losses[i]) in order. For a timestep of prior count c that the batch
        holds k times, the new row is the last min(h, c + k) of its c kept
        losses followed by its k new ones, and its count min(h, c + k): the
        losses are moved, not computed with. Returns a new state."""
        h = self.history_per_term
        history, counts = state["loss_history"], state["loss_counts"]
        ts = ts.long()
        losses = losses.detach().to(history.dtype)
        rows, inverse, k = torch.unique(ts, return_inverse=True, return_counts=True)
        c = counts[rows].long()
        off = torch.clamp(c + k - h, min=0)  # the oldest losses pushed out
        j = torch.arange(h, device=ts.device)
        src = j[None, :] + off[:, None]
        old = history[rows]
        kept = torch.gather(old, 1, torch.clamp(src, max=h - 1))
        new = torch.where(src < c[:, None], kept, old)
        # Each pair's place in its timestep's new row: after the kept losses
        # and the pairs before it of the same timestep.
        same = ts[:, None] == ts[None, :]
        earlier = torch.tril(same, diagonal=-1).sum(dim=1)
        pos = c[inverse] + earlier - off[inverse]
        live = pos >= 0
        new[inverse[live], pos[live]] = losses[live]
        history = history.clone()
        history[rows] = new
        counts = counts.clone()
        counts[rows] = torch.clamp(c + k, max=h).to(counts.dtype)
        return {"loss_history": history, "loss_counts": counts}
