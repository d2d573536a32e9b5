"""Data-parallel (sharded) pipeline steps: eval, EM, NN training.

SURVEY.md §3.5: the eval/EM entry points are the only ones that cross chips.
Implementation is idiomatic jit-over-NamedSharding: inputs carry a
``('data',)``-sharded leading dim, parameters are replicated, and XLA inserts
the all-reduces where outputs must be replicated (EM stats via the
segment-sum -> replicated-output contraction; NN grads via the mean loss).
The one ``shard_map`` is inside the GMM scorer (``score_frames`` with the
mesh), because its GPU kernel has no partitioning rule of its own.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

from mogasr.am import em
from mogasr.am.gmm import GmmSet
from mogasr.am.gmm_pallas import score_frames
from mogasr.config import FrontendConfig, TrainConfig
from mogasr.decoder import viterbi as vit
from mogasr.dist.mesh import data_sharding, replicated


def make_sharded_em_step(mesh: Mesh):
    """(gmm, feats[N,D], labels[N]) -> GmmStats, with N sharded over chips.

    The [S,K] stat outputs are replicated, so XLA emits a psum for the
    cross-chip reduction — the EM allreduce of SURVEY.md §3.3.
    """
    dsh = data_sharding(mesh)
    rep = replicated(mesh)

    @functools.partial(
        jax.jit,
        in_shardings=(rep, dsh, dsh),
        out_shardings=rep,
    )
    def em_step(gmm: GmmSet, feats: jax.Array, labels: jax.Array) -> em.GmmStats:
        return em.accumulate_stats(gmm, feats, labels)

    return em_step


def make_sharded_align_step(mesh: Mesh, acoustic_scale: float = 1.0):
    """Batched score+align step with utterances sharded over chips.

    (gmm, feats[B,T,D], n_frames[B], graphs{...[B,J]}) -> ViterbiResult.
    Each chip aligns its utterance shard; no cross-chip traffic beyond the
    (replicated) params broadcast.
    """
    dsh = data_sharding(mesh)
    rep = replicated(mesh)

    @functools.partial(
        jax.jit,
        in_shardings=(rep, dsh, dsh, dsh),
        out_shardings=dsh,
    )
    def align_step(gmm, feats, n_frames, graphs):
        ll = score_frames(feats, gmm, mesh=mesh)
        return vit.viterbi(ll, graphs, n_frames, acoustic_scale=acoustic_scale)

    return align_step


def make_sharded_soft_em_step(mesh: Mesh, acoustic_scale: float = 1.0):
    """Full Baum-Welch (soft-EM) E-step with utterances sharded over chips.

    (gmm, feats[B,T,D], n_frames[B], graphs{...[B,J]}) -> GmmStats.
    Each chip runs scoring + forward-backward on its utterance shard and
    accumulates soft stats; the replicated [S,K] stat outputs make XLA emit
    the psum — the soft counterpart of make_sharded_em_step.
    """
    from mogasr.decoder import forward_backward as fbd

    dsh = data_sharding(mesh)
    rep = replicated(mesh)

    @functools.partial(
        jax.jit,
        in_shardings=(rep, dsh, dsh, dsh),
        out_shardings=rep,
    )
    def soft_em_step(gmm: GmmSet, feats, n_frames, graphs) -> em.GmmStats:
        B, T, D = feats.shape
        n_pdfs = gmm.means.shape[0]
        ll = score_frames(feats, gmm, mesh=mesh)
        res = fbd.forward_backward(ll, graphs, n_frames,
                                  acoustic_scale=acoustic_scale)
        post = fbd.state_posteriors_to_pdf(
            res.log_gamma, graphs["emit_id"], n_pdfs)
        s = em.accumulate_stats_soft(
            gmm, feats.reshape(B * T, D), post.reshape(-1, n_pdfs))
        # padding utterances (n_frames == 0) carry -inf forward loglik
        return s._replace(
            loglik=jnp.sum(jnp.where(n_frames > 0, res.loglik, 0.0)))

    return soft_em_step


def make_sharded_decode_step(mesh: Mesh, acoustic_scale: float = 1.0):
    """Sharded free-decode/eval step (SURVEY.md §3.5's cross-chip entry).

    (gmm, feats[B,T,D], n_frames[B], graphs) -> (ViterbiResult [sharded],
    totals {frames, score} [replicated]).  Paths/scores stay on their chips
    (hosts gather their own shards); the replicated totals are the psum-ed
    frame counts the eval sweep turns into utt/s/chip + RTF.
    """
    dsh = data_sharding(mesh)
    rep = replicated(mesh)

    @functools.partial(
        jax.jit,
        in_shardings=(rep, dsh, dsh, dsh),
        out_shardings=(dsh, rep),
    )
    def decode_step(gmm, feats, n_frames, graphs):
        ll = score_frames(feats, gmm, mesh=mesh)
        res = vit.viterbi(ll, graphs, n_frames, acoustic_scale=acoustic_scale)
        totals = {
            "frames": jnp.sum(n_frames),
            "score": jnp.sum(jnp.where(n_frames > 0, res.score, 0.0)),
        }
        return res, totals

    return decode_step


def make_sharded_stats_step(mesh: Mesh, accumulate_fn):
    """Generic sharded sufficient-statistics step for any accumulator with
    the (gmm, feats[N, D], labels[N]) -> stats-pytree signature — covers
    fMLLR (am.fmllr.accumulate_fmllr_stats), MLLR
    (am.mllr.accumulate_mllr_stats), and hard-EM stats alike. Frames are
    sharded over chips; the replicated stat outputs make XLA insert the
    psum (the adaptation counterpart of the EM allreduce)."""
    dsh = data_sharding(mesh)
    rep = replicated(mesh)

    @functools.partial(
        jax.jit,
        in_shardings=(rep, dsh, dsh),
        out_shardings=rep,
    )
    def stats_step(gmm, feats, labels):
        return accumulate_fn(gmm, feats, labels)

    return stats_step


def make_sharded_ctc_train_step(model, cfg: TrainConfig, mesh: Mesh):
    """CTC train step, batch sharded / params replicated (alignment-free
    counterpart of make_sharded_train_step; same derived grad psum)."""
    import optax

    from mogasr.am.ctc import CtcTrainState, ctc_objective
    from mogasr.am.train_nn import make_optimizer

    opt = make_optimizer(cfg)
    dsh = data_sharding(mesh)
    rep = replicated(mesh)

    @functools.partial(
        jax.jit,
        in_shardings=(rep, dsh, dsh, dsh, dsh),
        out_shardings=(rep, rep),
    )
    def train_step(state, feats, n_frames, labels, n_labels):
        def loss_fn(params):
            loss, _ = ctc_objective(model, params, feats, n_frames, labels, n_labels)
            return loss

        loss, grads = jax.value_and_grad(loss_fn)(state.params)
        updates, opt_state = opt.update(grads, state.opt_state, state.params)
        params = optax.apply_updates(state.params, updates)
        return CtcTrainState(params, opt_state, state.step + 1), {"loss": loss}

    return train_step


def make_sharded_distill_train_step(
    student_model, teacher_model, teacher_params, cfg: TrainConfig,
    mesh: Mesh, alpha: float = 0.5, temperature: float = 2.0,
):
    """Knowledge-distillation step (mogasr.am.distill), batch sharded /
    params replicated: each chip runs the teacher forward on its utterance
    shard (posteriors stay chip-local in HBM); the masked KL/CTC means and
    the grad psum are the XLA-derived global reductions, so the step is
    exactly the local objective."""
    import optax

    from mogasr.am.ctc import CtcTrainState
    from mogasr.am.distill import distill_objective
    from mogasr.am.train_nn import make_optimizer

    opt = make_optimizer(cfg)
    dsh = data_sharding(mesh)
    rep = replicated(mesh)

    @functools.partial(
        jax.jit,
        in_shardings=(rep, dsh, dsh, dsh, dsh),
        out_shardings=(rep, rep),
    )
    def train_step(state, feats, n_frames, labels, n_labels):
        def loss_fn(params):
            loss, aux = distill_objective(
                student_model, teacher_model, teacher_params, params,
                feats, feats, n_frames, labels, n_labels,
                alpha=alpha, temperature=temperature,
            )
            return loss, aux

        (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            state.params
        )
        updates, opt_state = opt.update(grads, state.opt_state, state.params)
        params = optax.apply_updates(state.params, updates)
        return CtcTrainState(params, opt_state, state.step + 1), {
            "loss": loss, "kl": aux["kl"], "ctc": aux["ctc"],
        }

    return train_step


def make_sharded_mpc_step(model, cfg: TrainConfig, mesh: Mesh,
                          n_masks: int = 4, mask_width: int = 12):
    """Self-supervised MPC pretraining step, batch sharded / params
    replicated. The span masks derive from the REPLICATED step counter
    (fold_in), so every chip draws the same global [B, T] mask and the
    sharded computation is bitwise the local objective up to the grad-psum
    reduction order."""
    import optax

    from mogasr.am.pretrain import MpcTrainState, mpc_objective, span_time_mask
    from mogasr.am.train_nn import make_optimizer

    opt = make_optimizer(cfg)
    dsh = data_sharding(mesh)
    rep = replicated(mesh)

    @functools.partial(
        jax.jit,
        in_shardings=(rep, dsh, dsh),
        out_shardings=(rep, rep),
    )
    def train_step(state, feats, n_frames):
        key = jax.random.fold_in(jax.random.key(cfg.seed), state.step)
        mask = span_time_mask(key, n_frames, feats.shape[1],
                              n_masks, mask_width)

        def loss_fn(params):
            loss, n = mpc_objective(model, params, feats, n_frames, mask)
            return loss, n

        (loss, n), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            state.params
        )
        updates, opt_state = opt.update(grads, state.opt_state, state.params)
        params = optax.apply_updates(state.params, updates)
        return MpcTrainState(params, opt_state, state.step + 1), {
            "loss": loss, "masked_frames": n,
        }

    return train_step


def make_sharded_rnnt_train_step(model, cfg: TrainConfig, mesh: Mesh):
    """RNN-T train step, batch sharded / params replicated."""
    import optax

    from mogasr.am.rnnt import RnntTrainState, rnnt_objective
    from mogasr.am.train_nn import make_optimizer

    opt = make_optimizer(cfg)
    dsh = data_sharding(mesh)
    rep = replicated(mesh)

    @functools.partial(
        jax.jit,
        in_shardings=(rep, dsh, dsh, dsh, dsh),
        out_shardings=(rep, rep),
    )
    def train_step(state, feats, n_frames, labels, n_labels):
        def loss_fn(params):
            loss, _ = rnnt_objective(model, params, feats, n_frames, labels, n_labels)
            return loss

        loss, grads = jax.value_and_grad(loss_fn)(state.params)
        updates, opt_state = opt.update(grads, state.opt_state, state.params)
        params = optax.apply_updates(state.params, updates)
        return RnntTrainState(params, opt_state, state.step + 1), {"loss": loss}

    return train_step


def make_sharded_rnnt_pruned_train_step(
    model, cfg: TrainConfig, mesh: Mesh, band: int
):
    """Pruned-transducer train step (mogasr.am.rnnt_pruned), batch sharded /
    params replicated.  Everything per-utterance — the simple pass, the
    occupancy bounds, the banded joint — shards cleanly on the batch axis;
    only the grad psum crosses devices, exactly like the dense RNN-T step."""
    import optax

    from mogasr.am.rnnt import RnntTrainState
    from mogasr.am.rnnt_pruned import rnnt_pruned_objective
    from mogasr.am.train_nn import make_optimizer

    opt = make_optimizer(cfg)
    dsh = data_sharding(mesh)
    rep = replicated(mesh)

    @functools.partial(
        jax.jit,
        in_shardings=(rep, dsh, dsh, dsh, dsh),
        out_shardings=(rep, rep),
    )
    def train_step(state, feats, n_frames, labels, n_labels):
        def loss_fn(params):
            loss, _ = rnnt_pruned_objective(
                model, params, feats, n_frames, labels, n_labels, band
            )
            return loss

        loss, grads = jax.value_and_grad(loss_fn)(state.params)
        updates, opt_state = opt.update(grads, state.opt_state, state.params)
        params = optax.apply_updates(state.params, updates)
        return RnntTrainState(params, opt_state, state.step + 1), {"loss": loss}

    return train_step


def make_sharded_nn_mmi_step(
    model, cfg: TrainConfig, mesh: Mesh, log_priors,
    acoustic_scale: float = 0.1,
):
    """Sequence-discriminative (MMI) hybrid-NN step (am/nn_seq), batch
    sharded / params replicated: the per-utterance alignment-chain (num)
    and word-loop (den) graphs are [B, J] arrays, so they shard on the
    batch axis like the features; only the grad psum crosses devices."""
    import jax.numpy as jnp
    import optax

    from mogasr.am.nn_seq import nn_mmi_objective
    from mogasr.am.train_nn import TrainState, make_optimizer

    opt = make_optimizer(cfg)
    dsh = data_sharding(mesh)
    rep = replicated(mesh)
    priors = jax.device_put(jnp.asarray(log_priors), rep)

    @functools.partial(
        jax.jit,
        in_shardings=(rep, dsh, dsh, dsh, dsh),
        out_shardings=(rep, rep),
    )
    def train_step(state, feats, n_frames, num_graphs, den_graphs):
        def loss_fn(params):
            return nn_mmi_objective(
                model, params, priors, feats, n_frames,
                num_graphs, den_graphs, acoustic_scale,
            )

        (loss, mmi), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            state.params
        )
        updates, opt_state = opt.update(grads, state.opt_state, state.params)
        params = optax.apply_updates(state.params, updates)
        return TrainState(params, opt_state, state.step + 1), {
            "loss": loss, "mmi_per_frame": mmi,
        }

    return train_step


def make_sharded_aed_train_step(model, cfg: TrainConfig, mesh: Mesh):
    """AED (Conformer + Transformer decoder) train step, batch sharded /
    params replicated — same derived grad psum as the CTC/RNN-T steps."""
    import optax

    from mogasr.am.aed import AedTrainState, aed_objective
    from mogasr.am.train_nn import make_optimizer

    opt = make_optimizer(cfg)
    dsh = data_sharding(mesh)
    rep = replicated(mesh)

    @functools.partial(
        jax.jit,
        in_shardings=(rep, dsh, dsh, dsh, dsh),
        out_shardings=(rep, rep),
    )
    def train_step(state, feats, n_frames, labels, n_labels):
        def loss_fn(params):
            loss, _ = aed_objective(model, params, feats, n_frames, labels, n_labels)
            return loss

        loss, grads = jax.value_and_grad(loss_fn)(state.params)
        updates, opt_state = opt.update(grads, state.opt_state, state.params)
        params = optax.apply_updates(state.params, updates)
        return AedTrainState(params, opt_state, state.step + 1), {"loss": loss}

    return train_step


def make_sharded_aed_mwer_step(model, cfg: TrainConfig, mesh: Mesh,
                               ce_weight: float = 0.1):
    """DP-sharded MWER fine-tuning step: batch rows (and their N-best
    lists/risks) sharded over 'data', params replicated; the expected-risk
    objective averages over VALID rows globally, so the derived grad psum
    matches the local step exactly (equality-tested in test_dist.py).
    N-best generation stays on the host driver (pipeline.finetune_aed_mwer
    pattern) — only the gradient step is sharded."""
    import optax

    from mogasr.am.aed import AedTrainState, aed_mwer_objective
    from mogasr.am.train_nn import make_optimizer

    opt = make_optimizer(cfg)
    dsh = data_sharding(mesh)
    rep = replicated(mesh)

    @functools.partial(
        jax.jit,
        in_shardings=(rep, dsh, dsh, dsh, dsh, dsh, dsh, dsh, dsh),
        out_shardings=(rep, rep),
    )
    def mwer_step(state, feats, n_frames, hyps, n_hyp_tokens, hyp_mask,
                  risks, labels, n_labels):
        def loss_fn(params):
            loss, metrics = aed_mwer_objective(
                model, params, feats, n_frames, hyps, n_hyp_tokens,
                hyp_mask, risks, labels, n_labels, ce_weight=ce_weight,
            )
            return loss, metrics

        (_, metrics), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            state.params
        )
        updates, opt_state = opt.update(grads, state.opt_state, state.params)
        params = optax.apply_updates(state.params, updates)
        return AedTrainState(params, opt_state, state.step + 1), metrics

    return mwer_step


def make_sharded_train_step(model, cfg: TrainConfig, mesh: Mesh, spec_augment: bool = False):
    """NN train step with the batch sharded and params/opt-state replicated.

    The mean CE loss contracts over the sharded batch dim -> XLA inserts the
    gradient all-reduce across devices.
    """
    from mogasr.am.train_nn import TrainState, make_optimizer
    from mogasr.am.neural import frame_ce_loss

    opt = make_optimizer(cfg)
    dsh = data_sharding(mesh)
    rep = replicated(mesh)
    if spec_augment:
        from mogasr.am.neural import spec_augment as _sa

    @functools.partial(
        jax.jit,
        in_shardings=(rep, dsh, dsh, dsh),
        out_shardings=(rep, rep),
    )
    def train_step(state, feats, n_frames, labels):
        if spec_augment:
            key = jax.random.fold_in(jax.random.key(cfg.seed), state.step)
            feats_in = _sa(feats, n_frames, key)
        else:
            feats_in = feats

        def loss_fn(params):
            logits = model.apply(params, feats_in, n_frames)
            return frame_ce_loss(logits, labels)

        (loss, acc), grads = jax.value_and_grad(loss_fn, has_aux=True)(state.params)
        updates, opt_state = opt.update(grads, state.opt_state, state.params)
        params = jax.tree.map(lambda p, u: p + u, state.params, updates)
        return TrainState(params, opt_state, state.step + 1), {
            "loss": loss,
            "frame_acc": acc,
        }

    return train_step
