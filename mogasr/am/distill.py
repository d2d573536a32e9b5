"""Teacher-student knowledge distillation for CTC acoustic models.

Distills a large offline encoder (e.g. the Conformer CTC model) into a
small streaming-capable student (e.g. the stateful LSTM) by matching
frame-level output distributions: Hinton-style soft targets at temperature
tau, mixed with the ordinary hard-label CTC loss (``alpha`` interpolation).
This is the standard production recipe for shipping a low-latency streaming
model that inherits most of an offline model's accuracy.

Requirements (checked): teacher and student share one unit inventory
(units + blank) and one frame rate — every mogasr encoder emits
per-input-frame logits (``ConformerAm`` repeat-upsamples its 4x-subsampled
trunk back to frame rate), so frame-level matching needs no alignment step.

Device shape: ONE jitted train step runs the teacher forward (under
``stop_gradient``), the student forward, the masked KL + CTC losses, and
the optimizer update. Teacher posteriors are produced and consumed inside
the same XLA program — they never leave HBM and nothing is recomputed on
the host. SpecAugment (when enabled) perturbs ONLY the student's input;
the teacher scores the clean features, which is what makes the soft
targets worth distilling from.

No reference implementation exists for this capability (the /root/reference
mount is empty — SURVEY.md §0); the algorithm follows Hinton et al. 2015
("Distilling the Knowledge in a Neural Network") applied per frame, as in
standard CTC distillation practice.
"""

from __future__ import annotations

from typing import Any, Optional

import jax
import jax.numpy as jnp
import optax

from mogasr.am.ctc import (
    CtcTrainState,
    ctc_loss,
    masked_mean_objective,
)
from mogasr.config import TrainConfig


def distill_kl(
    student_logits: jax.Array,   # [B, T, V]
    teacher_logits: jax.Array,   # [B, T, V]
    n_frames: jax.Array,         # [B]
    temperature: float = 1.0,
) -> jax.Array:
    """Masked mean frame-level KL(teacher_tau || student_tau) * tau^2.

    The tau^2 factor keeps soft-target gradient magnitudes comparable
    across temperatures (Hinton 2015 §2). Padded frames are excluded from
    the mean (CLAUDE.md padding-invariance convention), so the value is
    independent of the batch's pad length.
    """
    tau = float(temperature)
    logp_t = jax.nn.log_softmax(teacher_logits / tau, axis=-1)
    logp_s = jax.nn.log_softmax(student_logits / tau, axis=-1)
    kl = jnp.sum(jnp.exp(logp_t) * (logp_t - logp_s), axis=-1)  # [B, T]
    t_max = student_logits.shape[1]
    mask = jnp.arange(t_max)[None, :] < n_frames[:, None]
    n_valid = jnp.maximum(jnp.sum(mask), 1)
    return jnp.sum(jnp.where(mask, kl, 0.0)) / n_valid * (tau * tau)


def distill_objective(
    student_model,
    teacher_model,
    teacher_params,
    params,
    feats,            # student input (possibly augmented)
    feats_clean,      # teacher input (always clean)
    n_frames,
    labels,
    n_labels,
    alpha: float = 0.5,
    temperature: float = 2.0,
    blank_id: Optional[int] = None,
):
    """alpha * soft KL + (1 - alpha) * hard CTC; returns (loss, aux dict).

    alpha=1 is pure posterior matching (no labels needed beyond shapes);
    alpha=0 degenerates to plain CTC training.
    """
    teacher_logits = jax.lax.stop_gradient(
        teacher_model.apply(teacher_params, feats_clean, n_frames)
    )
    student_logits = student_model.apply(params, feats, n_frames)
    kl = distill_kl(student_logits, teacher_logits, n_frames, temperature)
    nll = ctc_loss(student_logits, n_frames, labels, n_labels, blank_id)
    hard, mean_nll = masked_mean_objective(nll, n_frames, n_labels)
    loss = alpha * kl + (1.0 - alpha) * hard
    return loss, {"kl": kl, "ctc": hard, "utt_nll": mean_nll}


def make_distill_train_step(
    student_model,
    teacher_model,
    teacher_params,
    cfg: TrainConfig,
    alpha: float = 0.5,
    temperature: float = 2.0,
    blank_id: Optional[int] = None,
    spec_augment: bool = False,
):
    """Jitted (state, feats, n_frames, labels, n_labels) -> (state, metrics).

    Same optimizer recipe and state container as the plain CTC loop
    (``CtcTrainState`` + ``make_optimizer``), so checkpoints and the CLI
    restore path are identical to a from-scratch CTC student.
    """
    from mogasr.am.train_nn import make_optimizer

    opt = make_optimizer(cfg)
    if spec_augment:
        from mogasr.am.neural import spec_augment as _sa

    @jax.jit
    def train_step(state, feats, n_frames, labels, n_labels):
        if spec_augment:
            key = jax.random.fold_in(jax.random.key(cfg.seed), state.step)
            feats_in = _sa(feats, n_frames, key)
        else:
            feats_in = feats

        def loss_fn(params):
            return distill_objective(
                student_model, teacher_model, teacher_params, params,
                feats_in, feats, n_frames, labels, n_labels,
                alpha=alpha, temperature=temperature, blank_id=blank_id,
            )

        (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            state.params
        )
        updates, opt_state = opt.update(grads, state.opt_state, state.params)
        params = optax.apply_updates(state.params, updates)
        return CtcTrainState(params, opt_state, state.step + 1), {
            "loss": loss,
            "kl": aux["kl"],
            "ctc": aux["ctc"],
            "utt_nll": aux["utt_nll"],
        }

    return train_step


def distill_kl_oracle_np(
    student_logits, teacher_logits, n_frames, temperature=1.0
):
    """NumPy oracle for distill_kl (tests)."""
    import numpy as np

    tau = float(temperature)
    s = np.asarray(student_logits, np.float64) / tau
    t = np.asarray(teacher_logits, np.float64) / tau
    def logsm(x):
        m = x.max(axis=-1, keepdims=True)
        z = x - m
        return z - np.log(np.exp(z).sum(axis=-1, keepdims=True))
    lp_t, lp_s = logsm(t), logsm(s)
    kl = (np.exp(lp_t) * (lp_t - lp_s)).sum(axis=-1)
    total, n = 0.0, 0
    for b, nf in enumerate(np.asarray(n_frames)):
        total += kl[b, : int(nf)].sum()
        n += int(nf)
    return total / max(n, 1) * tau * tau
