"""Neural acoustic models: MLP and LSTM frame classifiers (hybrid NN-HMM).

BASELINE.json configs[3]: "Neural acoustic-model variant forward pass
(MLP/LSTM frame classifier) with on-device frame-sync decode". Flax linen
modules lowered to XLA; the LSTM's time recursion is ``nn.RNN`` (lax.scan
inside — the second sequential hot loop, SURVEY.md §3.4).

Hybrid decoding uses scaled likelihoods: log p(x|s) ~ log p(s|x) - log p(s),
with state priors estimated from the alignment label counts.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np

from mogasr.config import TrainConfig


def splice_frames(feats: jax.Array, n_frames: jax.Array, context: int) -> jax.Array:
    """[B, T, D] -> [B, T, (2*context+1)*D] with per-utterance edge clamping."""
    if context == 0:
        return feats
    B, T, D = feats.shape
    t = jnp.arange(T, dtype=jnp.int32)[None, :]
    last = jnp.maximum(n_frames - 1, 0)[:, None]
    cols = []
    for off in range(-context, context + 1):
        idx = jnp.clip(t + off, 0, None)
        idx = jnp.minimum(idx, last)
        cols.append(jnp.take_along_axis(feats, idx[:, :, None], axis=1))
    return jnp.concatenate(cols, axis=-1)


class MlpAm(nn.Module):
    """Feed-forward frame classifier over spliced context windows."""

    n_pdfs: int
    hidden: int = 512
    layers: int = 3
    context: int = 4

    @nn.compact
    def __call__(self, feats: jax.Array, n_frames: jax.Array) -> jax.Array:
        x = splice_frames(feats, n_frames, self.context)
        for _ in range(self.layers):
            x = nn.Dense(self.hidden)(x)
            x = nn.LayerNorm()(x)
            x = nn.relu(x)
        return nn.Dense(self.n_pdfs)(x)  # [B, T, n_pdfs] logits


class LstmAm(nn.Module):
    """Unidirectional stacked-LSTM frame classifier."""

    n_pdfs: int
    hidden: int = 512
    layers: int = 2

    @nn.compact
    def __call__(self, feats: jax.Array, n_frames: jax.Array) -> jax.Array:
        x = feats
        for _ in range(self.layers):
            x = nn.RNN(nn.OptimizedLSTMCell(self.hidden))(x, seq_lengths=n_frames)
        return nn.Dense(self.n_pdfs)(x)


class LstmAmStream(nn.Module):
    """Chunked stateful forward of LstmAm: same parameter tree (identical
    module construction order -> identical flax param names), but carries
    the per-layer LSTM (c, h) states across calls, so arbitrary chunkings
    reproduce the full-sequence LstmAm outputs EXACTLY (tested) — the
    neural-AM leg of the online pipeline (streaming frontend ->
    streaming scorer -> OnlineDecoder)."""

    n_pdfs: int
    hidden: int = 512
    layers: int = 2

    @nn.compact
    def __call__(self, feats: jax.Array, carries, n_valid=None):
        """n_valid [B] (optional): per-stream valid frame counts — returned
        carries are the state AT each stream's n_valid (frames beyond it do
        not advance the carry; n_valid == 0 returns the carry UNCHANGED),
        so ragged slot-batched serving (mogasr.serving.engine) stays exactly
        chunking-invariant."""
        x = feats
        new_carries = []
        for l in range(self.layers):
            rnn = nn.RNN(nn.OptimizedLSTMCell(self.hidden))
            carry, x = rnn(x, initial_carry=carries[l], return_carry=True,
                           seq_lengths=n_valid)
            if n_valid is not None:
                # flax's seq_lengths path does NOT preserve the initial
                # carry for rows with length 0 (verified) — restore them so
                # idle slots are true no-ops
                live = n_valid > 0
                carry = jax.tree_util.tree_map(
                    lambda new, old: jnp.where(live[:, None], new, old),
                    carry, carries[l],
                )
            new_carries.append(carry)
        return nn.Dense(self.n_pdfs)(x), new_carries


def lstm_stream_init(model: "LstmAm", batch: int, feat_dim: int):
    """Zero (c, h) carries for a batch of streams."""
    cell = nn.OptimizedLSTMCell(model.hidden)
    return [
        cell.initialize_carry(jax.random.key(0), (batch, feat_dim))
        for _ in range(model.layers)
    ]


def make_lstm_stream_step(model: "LstmAm", params, log_priors: jax.Array):
    """Jitted (carries, feats_chunk [B, Tc, D]) -> (carries, loglik chunk).

    Reuses the OFFLINE LstmAm parameters directly; the scorer applies the
    same prior scaling as pipeline.make_nn_scorer.
    """
    stream = LstmAmStream(n_pdfs=model.n_pdfs, hidden=model.hidden, layers=model.layers)

    @jax.jit
    def step(carries, feats):
        logits, new_carries = stream.apply(params, feats, carries)
        return new_carries, posteriors_to_loglik(logits, log_priors)

    return step


class BlstmAm(nn.Module):
    """Bidirectional stacked-LSTM frame classifier (offline decoding)."""

    n_pdfs: int
    hidden: int = 512
    layers: int = 2

    @nn.compact
    def __call__(self, feats: jax.Array, n_frames: jax.Array) -> jax.Array:
        x = feats
        for _ in range(self.layers):
            x = nn.Bidirectional(
                nn.RNN(nn.OptimizedLSTMCell(self.hidden)),
                nn.RNN(nn.OptimizedLSTMCell(self.hidden)),
            )(x, seq_lengths=n_frames)
        return nn.Dense(self.n_pdfs)(x)


class TdnnAm(nn.Module):
    """Time-delay NN (dilated 1-D convs over time) — the classic hybrid AM.

    Context grows multiplicatively with depth via dilation (1, 2, 4, ...)
    while staying convolutional, so XLA maps it onto the MXU as batched
    GEMMs — wider effective context than MlpAm splicing at the same FLOPs.
    """

    n_pdfs: int
    hidden: int = 512
    layers: int = 3
    kernel: int = 3

    @nn.compact
    def __call__(self, feats: jax.Array, n_frames: jax.Array) -> jax.Array:
        # zero out padding so convolutions don't smear garbage into the
        # valid region (loss masking alone can't prevent that)
        mask = (
            jnp.arange(feats.shape[1])[None, :] < n_frames[:, None]
        ).astype(feats.dtype)[:, :, None]
        x = feats * mask
        for i in range(self.layers):
            x = nn.Conv(
                self.hidden, kernel_size=(self.kernel,), kernel_dilation=(2 ** i,),
                padding="SAME",
            )(x)
            x = nn.LayerNorm()(x)
            x = nn.relu(x)
            # re-mask after every layer: bias/LayerNorm put nonzero values in
            # the padded region, which later dilated convs would smear into
            # valid frames (padding-AMOUNT invariance, not just garbage-proofing)
            x = x * mask
        return nn.Dense(self.n_pdfs)(x)


class ConformerAm(nn.Module):
    """Conformer frame classifier: 4x-subsampled Conformer encoder (the
    AED's — one code path, mogasr.am.aed.ConformerEncoder) + output head,
    repeat-upsampled back to the INPUT frame rate so every consumer
    (CTC loss, per-frame CE, scorers, graph decode) sees the standard
    [B, T, n_pdfs] contract. The attention/conv GEMMs run at T/4 — an
    matmul-friendly encoder.
    Offline only (no chunked stream variant here; use the streaming AED
    for that)."""

    n_pdfs: int
    hidden: int = 256
    layers: int = 3
    heads: int = 4
    conv_kernel: int = 15

    def setup(self):
        # deferred import: neural <- ctc <- aed would otherwise cycle
        from mogasr.am.aed import ConformerEncoder

        d = max(self.heads * (self.hidden // self.heads), self.heads)
        self.enc = ConformerEncoder(
            d_model=d, blocks=self.layers, heads=self.heads,
            conv_kernel=self.conv_kernel,
        )
        self.head = nn.Dense(self.n_pdfs)

    def __call__(self, feats: jax.Array, n_frames: jax.Array) -> jax.Array:
        enc, _n_out = self.enc(feats, n_frames)
        logits = self.head(enc)                      # [B, ceil(T/4), P]
        up = jnp.repeat(logits, 4, axis=1)           # back to frame rate
        return up[:, : feats.shape[1]]               # [B, T, P]

    def subsampled(self, feats: jax.Array, n_frames: jax.Array):
        """The 25 Hz head: (logits [B, ceil(T/4), P], n_out [B]) WITHOUT the
        repeat-upsample.  Greedy CTC collapse is frame-rate invariant
        (argmax of repeated rows repeats the argmax; collapse erases run
        lengths), so decoding here yields IDENTICAL hypotheses to
        ``__call__`` + full-rate decode while the argmax/collapse work
        shrinks 4x (round-2 VERDICT item 5; equivalence is tested).
        Call via ``model.apply(params, feats, n_frames, method="subsampled")``."""
        enc, n_out = self.enc(feats, n_frames)
        return self.head(enc), n_out


def moe_block_dense(
    x: jax.Array,        # [N, H] tokens
    Wr: jax.Array,       # [H, E] router
    W1: jax.Array,       # [E, H, F]
    b1: jax.Array,       # [E, F]
    W2: jax.Array,       # [E, F, H]
    b2: jax.Array,       # [E, H]
    valid: jax.Array,    # [N] bool — load-balance loss counts valid tokens only
) -> Tuple[jax.Array, jax.Array]:
    """Top-1-routed MoE FFN, dense single-device execution: every token is
    computed through every expert and the routed one selected (E-fold FLOPs
    but zero dynamism — the XLA-friendly form at single-chip scale). The
    expert-parallel twin (mogasr.dist.expert_parallel.make_moe_am_ep_train_step)
    executes the SAME parameters with all_to_all dispatch over an
    ('expert',) mesh and is equality-tested against this.

    Returns (y [N, H], load_balance_loss scalar) — the Switch-style balance
    term E * sum_e mean(gate_prob_e) * mean(route_frac_e) over valid tokens.
    """
    n_exp = Wr.shape[1]
    scores = x @ Wr                                        # [N, E]
    probs = jax.nn.softmax(scores, axis=-1)
    e = jnp.argmax(scores, axis=-1)                        # [N]
    gate = jnp.take_along_axis(probs, e[:, None], axis=-1)[:, 0]
    ys = jnp.einsum("nh,ehf->nef", x, W1) + b1[None]
    ys = jnp.einsum("nef,efh->neh", jax.nn.relu(ys), W2) + b2[None]
    y = gate[:, None] * ys[jnp.arange(x.shape[0]), e]      # [N, H]
    vw = valid.astype(jnp.float32)
    n_valid = jnp.maximum(jnp.sum(vw), 1.0)
    me = jnp.sum(probs * vw[:, None], axis=0) / n_valid
    onehot = jax.nn.one_hot(e, n_exp, dtype=jnp.float32)
    ce = jnp.sum(onehot * vw[:, None], axis=0) / n_valid
    lb = n_exp * jnp.sum(me * ce)
    return y, lb


class MoeAm(nn.Module):
    """Mixture-of-experts frame classifier: spliced context -> input
    projection -> ``layers`` pre-LN residual MoE FFN blocks (top-1 routing)
    -> head. The production expert-parallel architecture: per-expert FFN
    stacks shard over an ('expert',) mesh with all_to_all token dispatch
    (mogasr.dist.expert_parallel), while this dense form serves single-chip
    training and all decode/scoring paths unchanged.

    Load-balance losses are sown into the "losses" collection; the training
    step (make_train_step) applies with mutable=["losses"] and adds
    ``cfg.moe_lb_weight`` times their sum. Plain ``apply`` (scorers,
    decoders) silently drops them — sow is a no-op when the collection is
    immutable — so every existing consumer of [B, T, n_pdfs] logits works.
    """

    n_pdfs: int
    hidden: int = 512
    layers: int = 2
    context: int = 4
    n_experts: int = 4
    ffn: int = 0  # 0 -> 2 * hidden

    @nn.compact
    def __call__(self, feats: jax.Array, n_frames: jax.Array) -> jax.Array:
        B, T, _ = feats.shape
        ffn = self.ffn or 2 * self.hidden
        x = splice_frames(feats, n_frames, self.context)
        x = nn.Dense(self.hidden, name="in_proj")(x)       # [B, T, H]
        valid = (jnp.arange(T)[None, :] < n_frames[:, None]).reshape(-1)
        s_h = 1.0 / np.sqrt(self.hidden)
        s_f = 1.0 / np.sqrt(ffn)
        for l in range(self.layers):
            h = nn.LayerNorm(name=f"ln_{l}")(x).reshape(B * T, self.hidden)
            Wr = self.param(f"Wr_{l}", nn.initializers.normal(s_h),
                            (self.hidden, self.n_experts))
            W1 = self.param(f"W1_{l}", nn.initializers.normal(s_h),
                            (self.n_experts, self.hidden, ffn))
            b1 = self.param(f"b1_{l}", nn.initializers.zeros,
                            (self.n_experts, ffn))
            W2 = self.param(f"W2_{l}", nn.initializers.normal(s_f),
                            (self.n_experts, ffn, self.hidden))
            b2 = self.param(f"b2_{l}", nn.initializers.zeros,
                            (self.n_experts, self.hidden))
            y, lb = moe_block_dense(h, Wr, W1, b1, W2, b2, valid)
            self.sow("losses", f"moe_lb_{l}", lb)
            x = x + y.reshape(B, T, self.hidden)
        x = nn.LayerNorm(name="ln_out")(x)
        return nn.Dense(self.n_pdfs, name="head")(x)


def build_model(arch: str, n_pdfs: int, cfg: TrainConfig) -> nn.Module:
    if arch == "conformer":
        return ConformerAm(
            n_pdfs=n_pdfs, hidden=cfg.nn_hidden, layers=cfg.nn_layers
        )
    if arch == "mlp":
        return MlpAm(n_pdfs=n_pdfs, hidden=cfg.nn_hidden, layers=cfg.nn_layers, context=cfg.nn_context)
    if arch == "lstm":
        return LstmAm(n_pdfs=n_pdfs, hidden=cfg.nn_hidden, layers=max(cfg.nn_layers - 1, 1))
    if arch == "blstm":
        return BlstmAm(n_pdfs=n_pdfs, hidden=cfg.nn_hidden, layers=max(cfg.nn_layers - 1, 1))
    if arch == "tdnn":
        return TdnnAm(n_pdfs=n_pdfs, hidden=cfg.nn_hidden, layers=cfg.nn_layers)
    if arch == "moe":
        return MoeAm(
            n_pdfs=n_pdfs, hidden=cfg.nn_hidden,
            layers=max(cfg.nn_layers - 1, 1), context=cfg.nn_context,
            n_experts=cfg.nn_experts, ffn=cfg.moe_ffn,
        )
    raise ValueError(f"unknown arch {arch!r}")


def spec_augment(
    feats: jax.Array,     # [B, T, D]
    n_frames: jax.Array,  # [B]
    key: jax.Array,
    n_time_masks: int = 2,
    time_mask_width: int = 20,
    n_feat_masks: int = 2,
    feat_mask_width: int = 8,
) -> jax.Array:
    """SpecAugment-style time/feature masking for NN training robustness.

    Masks are zeroed regions (features are ~CMVN-normalized, so zero is the
    mean). Static shapes: mask positions are random, widths fixed.
    """
    B, T, D = feats.shape
    # cap widths so short utterances are never mostly erased: static cap from
    # the bucket size AND a dynamic per-utterance cap from n_frames (an
    # utterance much shorter than its padded bucket must not be zeroed whole)
    tw_static = max(min(time_mask_width, T // (4 * max(n_time_masks, 1))), 1)
    tw = jnp.maximum(
        jnp.minimum(tw_static, n_frames // (4 * max(n_time_masks, 1))), 1
    )[:, None, None]                                     # [B, 1, 1]
    fw = max(min(feat_mask_width, D // (4 * max(n_feat_masks, 1))), 1)
    out = feats
    keys = jax.random.split(key, n_time_masks + n_feat_masks)
    t_idx = jnp.arange(T)[None, :, None]
    d_idx = jnp.arange(D)[None, None, :]
    for i in range(n_time_masks):
        # maxval exclusive: +1 so the final frame can be masked too
        maxval = jnp.maximum(n_frames[:, None, None] - tw + 1, 1)
        start = jax.random.randint(keys[i], (B, 1, 1), 0, maxval)
        mask = (t_idx >= start) & (t_idx < start + tw)
        out = jnp.where(mask, 0.0, out)
    for i in range(n_feat_masks):
        start = jax.random.randint(
            keys[n_time_masks + i], (B, 1, 1), 0, max(D - fw + 1, 1)
        )
        mask = (d_idx >= start) & (d_idx < start + fw)
        out = jnp.where(mask, 0.0, out)
    return out


def frame_ce_loss(
    logits: jax.Array,   # [B, T, P]
    labels: jax.Array,   # [B, T] pdf ids, -1 padding
) -> Tuple[jax.Array, jax.Array]:
    """Masked frame cross-entropy -> (mean loss, frame accuracy)."""
    valid = labels >= 0
    safe = jnp.maximum(labels, 0)
    logp = jax.nn.log_softmax(logits, axis=-1)
    nll = -jnp.take_along_axis(logp, safe[:, :, None], axis=-1)[:, :, 0]
    n = jnp.maximum(jnp.sum(valid), 1)
    loss = jnp.sum(jnp.where(valid, nll, 0.0)) / n
    acc = jnp.sum(jnp.where(valid, jnp.argmax(logits, -1) == safe, False)) / n
    return loss, acc


def state_priors(labels: np.ndarray, n_pdfs: int, smooth: float = 1.0) -> np.ndarray:
    """log p(s) from alignment label counts (for hybrid decoding)."""
    counts = np.bincount(labels[labels >= 0].reshape(-1), minlength=n_pdfs) + smooth
    return np.log(counts / counts.sum()).astype(np.float32)


def posteriors_to_loglik(logits: jax.Array, log_priors: jax.Array) -> jax.Array:
    """Hybrid scaled likelihood: log p(x|s) ∝ log p(s|x) - log p(s)."""
    return jax.nn.log_softmax(logits, axis=-1) - log_priors[None, None, :]
