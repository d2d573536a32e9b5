"""Self-supervised encoder pretraining: masked predictive coding (MPC).

Pretrains any mogasr acoustic encoder on UNLABELED audio by masking random
time spans of the input features and training the network to reconstruct
the original features at the masked positions (L2) — the masked-prediction
objective of Jiang et al. 2019 ("Improving Transformer-based ASR with
unsupervised pre-training"), the conv/attention-era descendant of APC.
The pretrained trunk then initializes supervised CE/CTC fine-tuning,
the standard low-label production recipe.

Design notes:
- The pretraining model IS the ordinary ``build_model(arch, feat_dim,...)``
  classifier with the output head sized to the feature dimension, so every
  trunk parameter keeps the exact path it has in the supervised model of
  the same architecture. Transfer is therefore a pure tree merge
  (``transfer_pretrained``): copy leaves whose (path, shape) match — the
  reconstruction head is skipped automatically by its shape.
- Span masks are sampled inside the jitted step from a step-folded PRNG key
  (same convention as SpecAugment); masked frames are zeroed. The loss is
  the mean squared error over (masked AND valid) positions only — padding
  can neither be masked nor scored (CLAUDE.md padding-invariance rule).

No reference implementation exists for this capability (the /root/reference
mount is empty — SURVEY.md §0).
"""

from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import jax
import jax.numpy as jnp
import optax

from mogasr.config import TrainConfig


def span_time_mask(
    key: jax.Array,
    n_frames: jax.Array,   # [B]
    t_max: int,
    n_masks: int = 4,
    width: int = 12,
) -> jax.Array:
    """Bool [B, T]: union of n_masks random spans per row, clipped to the
    valid prefix. Span widths are uniform in [1, width]; starts are uniform
    over the valid range so masks never touch padding."""
    B = n_frames.shape[0]
    ks = jax.random.split(key, 2)
    w = jax.random.randint(ks[0], (B, n_masks), 1, width + 1)
    # start in [0, max(n_frames - w, 1))
    hi = jnp.maximum(n_frames[:, None] - w, 1)
    start = (jax.random.uniform(ks[1], (B, n_masks)) * hi).astype(jnp.int32)
    t = jnp.arange(t_max)[None, None, :]
    spans = (t >= start[..., None]) & (t < (start + w)[..., None])
    mask = jnp.any(spans, axis=1)
    return mask & (jnp.arange(t_max)[None, :] < n_frames[:, None])


def mpc_objective(
    model, params, feats, n_frames, mask,
) -> Tuple[jax.Array, jax.Array]:
    """(masked-position MSE, masked-frame count). Input frames under the
    mask are zeroed; the network predicts the ORIGINAL features there."""
    masked_in = jnp.where(mask[..., None], 0.0, feats)
    pred = model.apply(params, masked_in, n_frames)
    se = jnp.sum((pred - feats) ** 2, axis=-1)      # [B, T]
    n = jnp.maximum(jnp.sum(mask), 1)
    return jnp.sum(jnp.where(mask, se, 0.0)) / (n * feats.shape[-1]), n


class MpcTrainState(NamedTuple):
    params: Any
    opt_state: Any
    step: jax.Array


def init_mpc_state(model, cfg: TrainConfig, feat_dim: int, key) -> MpcTrainState:
    from mogasr.am.train_nn import make_optimizer

    dummy = jnp.zeros((2, 8, feat_dim), jnp.float32)
    params = model.init(key, dummy, jnp.asarray([8, 8]))
    opt = make_optimizer(cfg)
    return MpcTrainState(params, opt.init(params), jnp.zeros((), jnp.int32))


def make_mpc_train_step(
    model, cfg: TrainConfig, n_masks: int = 4, mask_width: int = 12,
):
    """Jitted (state, feats, n_frames) -> (state, metrics) — no labels."""
    from mogasr.am.train_nn import make_optimizer

    opt = make_optimizer(cfg)

    @jax.jit
    def train_step(state, feats, n_frames):
        key = jax.random.fold_in(jax.random.key(cfg.seed), state.step)
        mask = span_time_mask(
            key, n_frames, feats.shape[1], n_masks, mask_width
        )

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


def pretrain_mpc(
    batches,
    tcfg: TrainConfig,
    arch: str = "conformer",
    steps=None,
    n_masks: int = 4,
    mask_width: int = 12,
    logger=None,
):
    """Unsupervised MPC pretraining over feature batches (transcripts are
    never read). Returns (model, params) with the reconstruction head; feed
    ``params`` to ``transfer_pretrained`` to initialize a supervised model."""
    from mogasr.am.neural import build_model

    feat_dim = int(batches[0].feats.shape[-1])
    model = build_model(arch, feat_dim, tcfg)
    state = init_mpc_state(model, tcfg, feat_dim, jax.random.key(tcfg.seed))
    step_fn = make_mpc_train_step(model, tcfg, n_masks, mask_width)

    total = steps if steps is not None else tcfg.num_nn_steps
    i, m = 0, {"loss": jnp.asarray(0.0)}
    while i < total:
        for fb in batches:
            state, m = step_fn(state, fb.feats, fb.n_frames)
            i += 1
            if logger is not None and i % 50 == 0:
                logger.log({"stage": "pretrain_mpc", "step": i,
                            "loss": float(m["loss"])})
            if i >= total:
                break
    return model, state.params


def transfer_pretrained(pretrained_params, target_params):
    """Merge: copy every pretrained leaf whose tree path AND shape match
    into the target tree (the differently-shaped task head keeps its fresh
    init). Returns (merged_params, n_copied, n_total_target_leaves)."""
    src = dict(jax.tree_util.tree_flatten_with_path(pretrained_params)[0])
    dst_leaves, treedef = jax.tree_util.tree_flatten_with_path(target_params)
    merged, copied = [], 0
    for path, leaf in dst_leaves:
        cand = src.get(path)
        if cand is not None and jnp.shape(cand) == jnp.shape(leaf):
            merged.append(cand)
            copied += 1
        else:
            merged.append(leaf)
    return jax.tree_util.tree_unflatten(treedef, merged), copied, len(dst_leaves)
