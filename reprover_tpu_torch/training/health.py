"""Training-health instrumentation: divergence detection + embedding rank.

A copy of :mod:`reprover_tpu.training.health` (numpy only; importing it from
the JAX package runs ``reprover_tpu/training/__init__.py``, which imports
JAX and optax).

Born from a measured failure, not speculation: the round-4 flagship
pretrain diverged at its warmup peak (train loss bottomed 1.23 at step
~350, climbed to 2.11 by step 950 — `benchmarks/results/
r4_pretrain_byt5.err`), then "recovered" to a 1.25-1.29 plateau while the
encoder's pooled representation had silently collapsed to effective rank
1.22 (`benchmarks/probe_embed_diversity.py`). Every later chunk resumed
the poisoned lineage and every fine-tune from its export parked at the
degenerate all-zeros MSE floor. The reference has no equivalent guard
(Lightning would have logged the same numbers and kept going); this is
the failure-detection subsystem (SURVEY.md §5) applied to training runs.

Two tools:

- :class:`DivergenceGuard` — windowed EMA of the train loss vs its
  running minimum; sustained regression past ``factor`` × min for
  ``patience`` consecutive log windows raises :class:`DivergenceError`
  (so a scripted run exits non-zero *before* exporting poisoned weights,
  instead of burning the rest of its budget).
- :func:`embedding_eff_rank` — the entropy effective rank of a pooled-
  embedding probe batch; logged at validation time it makes representation
  collapse visible live (a healthy byt5 init probes ~18, the poisoned
  export ~1.2).
"""

from __future__ import annotations

import logging
import math
from typing import Optional

import numpy as np

logger = logging.getLogger(__name__)


class DivergenceError(RuntimeError):
    """Raised by :class:`DivergenceGuard` when training has diverged."""


class DivergenceGuard:
    """Detect sustained loss blow-ups (warmup-peak divergence signature).

    Call :meth:`update` once per logged loss value (one log window). The
    guard keeps an EMA of the loss and its running minimum; once at least
    ``min_updates`` windows have passed, ``patience`` *consecutive*
    windows with ``ema > factor * running_min`` trigger
    :class:`DivergenceError`.

    The running minimum is taken over a median-of-3 of the RAW windowed
    losses (single-window spikes can't drag it down; unlike an EMA-min it
    still reaches the true bottom when the climb follows quickly), while
    the compared value is a fast EMA (decay 0.6). ``factor`` 1.5 /
    ``patience`` 5 flags the measured round-4 curve within ~10 log
    windows of the blow-up, while leaving noisy-but-flat losses alone.
    """

    def __init__(
        self,
        factor: float = 1.5,
        patience: int = 5,
        min_updates: int = 4,
        ema_decay: float = 0.6,
    ) -> None:
        if not (factor > 1.0 and patience >= 1):
            raise ValueError(f"need factor > 1 and patience >= 1, got {factor}, {patience}")
        self.factor = factor
        self.patience = patience
        self.min_updates = min_updates
        self.ema_decay = ema_decay
        self._ema: Optional[float] = None
        self._recent: list = []  # last 3 raw losses (median-of-3 min source)
        self._min: float = math.inf
        self._min_step: int = 0
        self._bad_streak: int = 0
        self._updates: int = 0

    def update(self, step: int, loss: float) -> None:
        if not math.isfinite(loss):
            # NaN/inf loss is divergence with no grace period.
            raise DivergenceError(
                f"non-finite train loss {loss!r} at step {step}"
            )
        self._updates += 1
        self._ema = (
            loss
            if self._ema is None
            else self.ema_decay * self._ema + (1 - self.ema_decay) * loss
        )
        self._recent.append(loss)
        if len(self._recent) > 3:
            self._recent.pop(0)
        if len(self._recent) == 3:
            med = sorted(self._recent)[1]
            if med < self._min:
                self._min = med
                self._min_step = step
        if self._updates <= self.min_updates:
            return
        if self._ema > self.factor * self._min:
            self._bad_streak += 1
            if self._bad_streak == 1 or self._bad_streak == self.patience - 1:
                logger.warning(
                    "loss EMA %.4f exceeds %.2fx its running min %.4f "
                    "(step %d); divergence streak %d/%d",
                    self._ema, self.factor, self._min, self._min_step,
                    self._bad_streak, self.patience,
                )
            if self._bad_streak >= self.patience:
                raise DivergenceError(
                    f"training diverged: loss EMA {self._ema:.4f} has stayed "
                    f"above {self.factor:.2f}x its running minimum "
                    f"{self._min:.4f} (reached at step {self._min_step}) for "
                    f"{self.patience} consecutive log windows (now at step "
                    f"{step}). Lower the peak lr or extend warmup; resuming "
                    f"a post-divergence checkpoint bakes the damage in."
                )
        else:
            self._bad_streak = 0


def embedding_anisotropy(embeddings: np.ndarray) -> dict:
    """Off-diagonal cosine statistics of an [N, D] embedding probe batch.

    The round-5 flagship post-mortem's measured discriminator for whether
    an init can feed the reference's MSE retrieval recipe
    (ReProver's `retrieval/model.py:217-228` label-matrix loss):
    MSE-trainable inits probe ``cos_offdiag_mean`` ≈ 0.91 with std ≈ 0.027
    (random byt5/d256 — both fine-tune to R@1 80 on the hard benchmark),
    while every span-corruption checkpoint probes ≈ 0.999 with std below
    0.001 and parks at the all-zeros MSE floor (BASELINE.md round 5:
    "Why span-corruption pretraining CANNOT feed the MSE recipe"). The
    std is the load-bearing number: it IS the similarity spread the MSE
    gradient works with. Logged every validation alongside
    :func:`embedding_eff_rank`; unlike a zero-shot retrieval probe it
    needs no (context, premise) supervision, so the pretrain CLI can
    compute it from its corpus-only val batch.
    """
    e = np.asarray(embeddings, np.float64)
    if e.ndim != 2 or e.shape[0] < 2:
        return {"cos_offdiag_mean": float("nan"), "cos_offdiag_std": float("nan")}
    norms = np.linalg.norm(e, axis=1, keepdims=True)
    e = e / np.maximum(norms, 1e-12)
    g = e @ e.T
    off = g[~np.eye(g.shape[0], dtype=bool)]
    return {
        "cos_offdiag_mean": float(off.mean()),
        "cos_offdiag_std": float(off.std()),
    }


def embedding_eff_rank(embeddings: np.ndarray) -> float:
    """Entropy effective rank of an [N, D] embedding probe batch.

    exp(H(p)) over the normalized squared singular values of the centered
    cloud: ~1 for a collapsed (rank-1/anisotropic) representation, up to
    min(N, D) for an isotropic one. Cheap enough to run on a single val
    batch every validation.
    """
    e = np.asarray(embeddings, np.float64)
    if e.ndim != 2 or e.shape[0] < 2:
        return float("nan")
    c = e - e.mean(axis=0, keepdims=True)
    s = np.linalg.svd(c, compute_uv=False)
    total = float(np.sum(s**2))
    if total <= 0.0:
        return 1.0
    p = (s**2) / total
    return float(np.exp(-np.sum(p * np.log(np.maximum(p, 1e-12)))))
