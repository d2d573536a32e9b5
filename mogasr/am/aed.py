"""Attention encoder-decoder (AED) ASR: Conformer encoder + Transformer
decoder with joint CTC/attention training and on-device beam search.

The third end-to-end family next to CTC (`am/ctc.py`) and RNN-T
(`am/rnnt.py`): the decoder conditions on the full label history through
self-attention and on the acoustics through cross-attention, trained with
label-smoothed cross-entropy plus an auxiliary CTC head on the encoder
(the standard joint CTC/attention recipe, Watanabe et al. 2017 shape).
No reference file can be cited (SURVEY.md §0: /root/reference is empty);
capability built from the published architecture (Gulati et al. 2020
Conformer; Vaswani et al. 2017 decoder).

Accelerator-first design decisions:
  - every path is static-shape: fixed label width L (padding -1), fixed
    beam width K and token budget U_max in the jitted beam search
    (`lax.scan` over decode steps — no data-dependent Python control flow);
  - the encoder subsamples time 4x with two stride-2 convs, so attention
    and the decoder run at 25 Hz — attention cost drops 16x and the matrix unit
    sees bigger per-frame GEMMs;
  - self-attention uses a learned relative-position bias table (clipped
    distance), gathered once per block — einsum attention, no dynamic
    shapes;
  - the Conformer conv module masks padded frames BEFORE the depthwise
    conv, so padding can never leak into valid frames (padding-invariance
    tested like every other reduction in the repo);
  - beam search recomputes the (cheap, causal) decoder over the full
    token buffer each step instead of carrying per-layer KV caches: one
    compiled graph, K*B-batched, and at ASR token counts (U_max ~ tens)
    the recompute is noise next to the encoder.

Unit conventions match ctc.py: unit ids 0..n_units-1; the CTC head's
blank is id n_units (blank = n_labels convention); the decoder vocabulary
appends sos = n_units and eos = n_units + 1 (sos is never a target and
its emission is masked at decode time).
"""

from __future__ import annotations

import functools
from typing import Any, Dict, NamedTuple, Optional, Tuple

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax

from mogasr.am.ctc import ctc_loss, masked_mean_objective
from mogasr.config import TrainConfig

NEG_INF = -1e30


def subsampled_frames(n_frames: jax.Array, n_convs: int = 2) -> jax.Array:
    """Frame count after ``n_convs`` stride-2 SAME convs: ceil-div by 2 each."""
    n = n_frames
    for _ in range(n_convs):
        n = -(-n // 2)
    return n


def _same_lohi(n: int, k: int = 3, s: int = 2) -> Tuple[int, int]:
    """TF-'SAME' (lo, hi) padding for kernel k stride s over n elements."""
    out = -(-n // s)
    pt = max((out - 1) * s + k - n, 0)
    return (pt // 2, pt - pt // 2)


class ConvSubsample(nn.Module):
    """Two stride-2 2-D convs over (time, freq) -> 4x frame-rate reduction,
    then a Dense projection to d_model (the standard Conformer front).

    causal=True left-pads time (no lookahead) so the module can run
    chunk-incrementally via ``step`` with EXACT offline equivalence; both
    modes produce ceil-div-2 frame counts per conv (subsampled_frames)."""

    d_model: int
    channels: int = 32  # aed_stream_init derives the cache layout from this
    causal: bool = False

    def setup(self):
        self.conv1 = nn.Conv(self.channels, (3, 3), strides=(2, 2),
                             padding="VALID")
        self.conv2 = nn.Conv(self.channels, (3, 3), strides=(2, 2),
                             padding="VALID")
        self.proj = nn.Dense(self.d_model)

    def _pad(self, x: jax.Array, time_pad: Tuple[int, int]) -> jax.Array:
        # x: [B, T, F, C]; freq is always SAME
        return jnp.pad(
            x, ((0, 0), time_pad, _same_lohi(x.shape[2]), (0, 0))
        )

    def __call__(self, feats: jax.Array) -> jax.Array:  # [B, T, D]
        x = feats[..., None]  # [B, T, D, 1]
        for conv in (self.conv1, self.conv2):
            # global mode pads time (1, 1), NOT TF-SAME: SAME's lo depends
            # on T's parity, so the same utterance padded to an even vs odd
            # bucket would get conv windows shifted by one frame (padding-
            # AMOUNT invariance is a repo requirement). (1, 1) yields the
            # same ceil(T/2) output count with T-independent alignment.
            tp = (2, 0) if self.causal else (1, 1)
            x = nn.relu(conv(self._pad(x, tp)))
        B, T4, D4, C = x.shape
        return self.proj(x.reshape(B, T4, D4 * C))

    def step(
        self, feats: jax.Array, raw_cache: jax.Array, c1_cache: jax.Array
    ) -> Tuple[jax.Array, jax.Array, jax.Array]:
        """Causal chunk step: VALID time-conv over [cache || chunk] exactly
        reproduces the left-padded offline conv. feats [B, F, D] with F a
        multiple of 4 (>= 4); caches: raw [B, 2, D], c1 [B, 2, ceil(D/2), C].
        Returns (subsampled [B, F/4, d_model], new_raw, new_c1)."""
        x = jnp.concatenate([raw_cache, feats], axis=1)[..., None]
        c1 = nn.relu(self.conv1(self._pad(x, (0, 0))))
        x2 = jnp.concatenate([c1_cache, c1], axis=1)
        c2 = nn.relu(self.conv2(self._pad(x2, (0, 0))))
        B, T4, D4, C = c2.shape
        return (
            self.proj(c2.reshape(B, T4, D4 * C)),
            feats[:, -2:],
            c1[:, -2:],
        )


class RelSelfAttention(nn.Module):
    """Multi-head self-attention with a learned clipped relative-position
    bias (T5-style): bias[h, clip(q - k, -max_rel, max_rel)] added to the
    attention logits. Static shapes, one gather per call.

    Queries and keys/values may differ (streaming: queries are the new
    chunk, keys/values include cached left context); qpos/kpos carry the
    positions so relative offsets match the offline computation exactly."""

    d_model: int
    heads: int
    max_rel: int = 64

    def setup(self):
        D = self.d_model
        self.q_proj = nn.Dense(D, use_bias=False)
        self.k_proj = nn.Dense(D, use_bias=False)
        self.v_proj = nn.Dense(D, use_bias=False)
        self.o_proj = nn.Dense(D)
        self.rel_bias = self.param(
            "rel_bias", nn.initializers.zeros, (self.heads, 2 * self.max_rel + 1)
        )

    def __call__(
        self,
        xq: jax.Array,           # [B, Q, D]
        xkv: jax.Array,          # [B, K, D]
        key_mask: jax.Array,     # [B, K]
        qpos: jax.Array,         # [Q]
        kpos: jax.Array,         # [K]
        attn_mask: Optional[jax.Array] = None,  # [Q, K]
    ) -> jax.Array:
        B, Q, D = xq.shape
        Kn = xkv.shape[1]
        H, hd = self.heads, D // self.heads
        q = self.q_proj(xq).reshape(B, Q, H, hd)
        k = self.k_proj(xkv).reshape(B, Kn, H, hd)
        v = self.v_proj(xkv).reshape(B, Kn, H, hd)
        logits = jnp.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(hd)
        rel = qpos[:, None] - kpos[None, :]
        idx = jnp.clip(rel, -self.max_rel, self.max_rel) + self.max_rel
        logits = logits + self.rel_bias[:, idx][None]  # [1, H, Q, K]
        mask = key_mask[:, None, None, :]
        if attn_mask is not None:
            mask = mask & attn_mask[None, None]
        logits = jnp.where(mask, logits, NEG_INF)
        out = jnp.einsum("bhqk,bkhd->bqhd", jax.nn.softmax(logits), v)
        return self.o_proj(out.reshape(B, Q, D))


class CrossAttention(nn.Module):
    """Decoder-side multi-head attention over encoder outputs."""

    heads: int

    @nn.compact
    def __call__(
        self, x: jax.Array, mem: jax.Array, mem_mask: jax.Array
    ) -> jax.Array:
        B, U, D = x.shape
        H, hd = self.heads, D // self.heads
        q = nn.Dense(D, use_bias=False)(x).reshape(B, U, H, hd)
        k = nn.Dense(D, use_bias=False)(mem).reshape(B, -1, H, hd)
        v = nn.Dense(D, use_bias=False)(mem).reshape(B, -1, H, hd)
        logits = jnp.einsum("buhd,bthd->bhut", q, k) / np.sqrt(hd)
        logits = jnp.where(mem_mask[:, None, None, :], logits, NEG_INF)
        out = jnp.einsum("bhut,bthd->buhd", jax.nn.softmax(logits), v)
        return nn.Dense(D)(out.reshape(B, U, D))


class _Ffn(nn.Module):
    mult: int = 4

    @nn.compact
    def __call__(self, x: jax.Array) -> jax.Array:
        D = x.shape[-1]
        return nn.Dense(D)(nn.swish(nn.Dense(self.mult * D)(x)))


class ConformerBlock(nn.Module):
    """Macaron FFN / MHSA / depthwise-conv / FFN with pre-LayerNorm.

    The conv module's BatchNorm is replaced by LayerNorm (no running
    statistics to thread through a functional train step; at these widths
    the difference is not measurable). Padded frames are zeroed before the
    depthwise conv so the kernel window never reads padding.

    causal=True left-pads the depthwise conv (no lookahead) — required for
    the chunk-streaming ``step`` path, which caches the last left_chunks
    of post-FFN1 frames (attention context) and conv_kernel-1 pre-conv
    frames per block and is EXACTLY equal to the offline chunk-masked
    forward (tested)."""

    d_model: int
    heads: int = 4
    conv_kernel: int = 15
    max_rel: int = 64
    causal: bool = False

    def setup(self):
        D = self.d_model
        self.ln_ffn1 = nn.LayerNorm()
        self.ffn1 = _Ffn()
        self.ln_attn = nn.LayerNorm()
        self.attn = RelSelfAttention(D, self.heads, self.max_rel)
        self.ln_conv = nn.LayerNorm()
        self.conv_in = nn.Dense(2 * D)
        self.dconv = nn.Conv(
            D, (self.conv_kernel,), padding="VALID", feature_group_count=D
        )
        self.ln_dconv = nn.LayerNorm()
        self.conv_out = nn.Dense(D)
        self.ln_ffn2 = nn.LayerNorm()
        self.ffn2 = _Ffn()
        self.ln_out = nn.LayerNorm()

    def _conv_module(self, x: jax.Array, frame_mask: Optional[jax.Array]) -> jax.Array:
        y = nn.glu(self.conv_in(self.ln_conv(x)), axis=-1)
        if frame_mask is not None:
            y = jnp.where(frame_mask[..., None], y, 0.0)
        k = self.conv_kernel
        tp = (k - 1, 0) if self.causal else ((k - 1) // 2, (k - 1) - (k - 1) // 2)
        y = self.dconv(jnp.pad(y, ((0, 0), tp, (0, 0))))
        return self.conv_out(nn.swish(self.ln_dconv(y)))

    def __call__(
        self,
        x: jax.Array,
        frame_mask: jax.Array,
        attn_mask: Optional[jax.Array] = None,
    ) -> jax.Array:
        T = x.shape[1]
        pos = jnp.arange(T)
        x = x + 0.5 * self.ffn1(self.ln_ffn1(x))
        h = self.ln_attn(x)
        x = x + self.attn(h, h, frame_mask, pos, pos, attn_mask)
        x = x + self._conv_module(x, frame_mask)
        x = x + 0.5 * self.ffn2(self.ln_ffn2(x))
        return self.ln_out(x)

    def step(
        self,
        x_new: jax.Array,     # [B, C, D] new (all-valid) frames
        x1_ctx: jax.Array,    # [B, Lc, D] cached post-FFN1 context
        ctx_valid: jax.Array, # [B, Lc]
        y_ctx: jax.Array,     # [B, conv_kernel-1, D] cached pre-conv frames
    ) -> Tuple[jax.Array, jax.Array, jax.Array]:
        B, C, D = x_new.shape
        Lc = x1_ctx.shape[1]
        x1 = x_new + 0.5 * self.ffn1(self.ln_ffn1(x_new))
        cat = jnp.concatenate([x1_ctx, x1], axis=1)
        h = self.ln_attn(cat)
        kmask = jnp.concatenate(
            [ctx_valid, jnp.ones((B, C), bool)], axis=1
        )
        x2 = x1 + self.attn(
            h[:, Lc:], h, kmask, jnp.arange(C) + Lc, jnp.arange(Lc + C)
        )
        y = nn.glu(self.conv_in(self.ln_conv(x2)), axis=-1)
        ycat = jnp.concatenate([y_ctx, y], axis=1)
        x3 = x2 + self.conv_out(nn.swish(self.ln_dconv(self.dconv(ycat))))
        x4 = x3 + 0.5 * self.ffn2(self.ln_ffn2(x3))
        new_x1_ctx = cat[:, -Lc:] if Lc > 0 else x1_ctx
        return self.ln_out(x4), new_x1_ctx, ycat[:, -(self.conv_kernel - 1):]


class ConformerEncoder(nn.Module):
    """Subsample 4x, then a stack of Conformer blocks.

    chunk_frames > 0 makes the encoder STREAMING-CAPABLE: attention is
    masked to the query's chunk plus left_chunks of left context (in
    subsampled frames), and all convolutions become causal. The offline
    forward with that mask and the chunk-incremental ``stream_step`` are
    exactly equal, so one checkpoint serves both modes."""

    d_model: int = 144
    blocks: int = 4
    heads: int = 4
    conv_kernel: int = 15
    chunk_frames: int = 0   # subsampled frames per chunk; 0 = offline/global
    left_chunks: int = 1

    def setup(self):
        causal = self.chunk_frames > 0
        self.sub = ConvSubsample(self.d_model, causal=causal)
        self.blks = [
            ConformerBlock(self.d_model, self.heads, self.conv_kernel,
                           causal=causal)
            for _ in range(self.blocks)
        ]

    def __call__(
        self, feats: jax.Array, n_frames: jax.Array
    ) -> Tuple[jax.Array, jax.Array]:
        mask_in = jnp.arange(feats.shape[1])[None, :] < n_frames[:, None]
        x = jnp.where(mask_in[..., None], feats, 0.0)
        x = self.sub(x)
        n_out = subsampled_frames(n_frames)
        mask = jnp.arange(x.shape[1])[None, :] < n_out[:, None]
        x = jnp.where(mask[..., None], x, 0.0)
        attn_mask = None
        if self.chunk_frames > 0:
            c = jnp.arange(x.shape[1]) // self.chunk_frames
            attn_mask = (c[None, :] <= c[:, None]) & (
                c[None, :] >= c[:, None] - self.left_chunks
            )
        for blk in self.blks:
            x = blk(x, mask, attn_mask)
        return x, n_out

    def stream_step(self, feats_chunk: jax.Array, state: dict):
        """One chunk of 4*chunk_frames (all-valid) feature frames ->
        (enc [B, chunk_frames, D], new state). See aed_stream_init."""
        x, raw, c1 = self.sub.step(feats_chunk, state["raw"], state["c1"])
        B, C, _ = x.shape
        x1_list, y_list = [], []
        for i, blk in enumerate(self.blks):
            x, x1c, yc = blk.step(x, state["x1"][i], state["valid"], state["y"][i])
            x1_list.append(x1c)
            y_list.append(yc)
        Lc = state["valid"].shape[1]
        if Lc > 0:
            valid = jnp.concatenate(
                [state["valid"], jnp.ones((B, C), bool)], axis=1
            )[:, -Lc:]
        else:
            valid = state["valid"]
        return x, {"raw": raw, "c1": c1, "valid": valid,
                   "x1": x1_list, "y": y_list}


def _sin_positions(U: int, D: int) -> np.ndarray:
    """Sinusoidal absolute positions for the decoder (any length, no params)."""
    pos = np.arange(U)[:, None]
    i = np.arange((D + 1) // 2)[None, :]  # ceil(D/2): survives odd d_model
    ang = pos / np.power(10000.0, 2 * i / D)
    out = np.zeros((U, D), np.float32)
    out[:, 0::2] = np.sin(ang)
    out[:, 1::2] = np.cos(ang[:, : D // 2])
    return out


class DecoderBlock(nn.Module):
    heads: int = 4

    @nn.compact
    def __call__(self, x, causal_mask, mem, mem_mask):
        B, U, D = x.shape
        H, hd = self.heads, D // self.heads
        y = nn.LayerNorm()(x)
        q = nn.Dense(D, use_bias=False)(y).reshape(B, U, H, hd)
        k = nn.Dense(D, use_bias=False)(y).reshape(B, U, H, hd)
        v = nn.Dense(D, use_bias=False)(y).reshape(B, U, H, hd)
        logits = jnp.einsum("buhd,bvhd->bhuv", q, k) / np.sqrt(hd)
        logits = jnp.where(causal_mask[None, None], logits, NEG_INF)
        att = jnp.einsum("bhuv,bvhd->buhd", jax.nn.softmax(logits), v)
        x = x + nn.Dense(D)(att.reshape(B, U, D))
        x = x + CrossAttention(self.heads)(nn.LayerNorm()(x), mem, mem_mask)
        x = x + _Ffn()(nn.LayerNorm()(x))
        return x


class AedModel(nn.Module):
    """Conformer encoder + Transformer decoder + CTC head.

    Vocabulary: ids 0..n_units-1 are real units; sos = n_units,
    eos = n_units + 1 (decoder side); the CTC head has n_units + 1
    outputs with blank = n_units (ctc.py convention)."""

    n_units: int
    d_model: int = 144
    enc_blocks: int = 4
    dec_blocks: int = 2
    heads: int = 4
    conv_kernel: int = 15
    chunk_frames: int = 0   # > 0: streaming-capable chunked encoder
    left_chunks: int = 1

    @property
    def sos(self) -> int:
        return self.n_units

    @property
    def eos(self) -> int:
        return self.n_units + 1

    @property
    def vocab(self) -> int:
        return self.n_units + 2

    def setup(self):
        self.encoder = ConformerEncoder(
            self.d_model, self.enc_blocks, self.heads, self.conv_kernel,
            self.chunk_frames, self.left_chunks,
        )
        self.embed = nn.Embed(self.vocab, self.d_model)
        self.dec = [DecoderBlock(self.heads) for _ in range(self.dec_blocks)]
        self.dec_norm = nn.LayerNorm()
        self.out = nn.Dense(self.vocab)
        self.ctc_head = nn.Dense(self.n_units + 1)

    def encode(self, feats, n_frames):
        return self.encoder(feats, n_frames)

    def encode_with_ctc(self, feats, n_frames):
        enc, n_out = self.encoder(feats, n_frames)
        return enc, n_out, self.ctc_head(enc)

    def encode_stream_step(self, feats_chunk, state):
        """Streaming chunk (chunk_frames > 0): -> (enc chunk, CTC logits
        chunk, new state). Exactly equal to the offline chunk-masked
        encode (tested)."""
        enc, state = self.encoder.stream_step(feats_chunk, state)
        return enc, self.ctc_head(enc), state

    def decode_logits(self, enc, n_out, tokens_in):
        """Causal decoder pass: tokens_in [B, U] -> logits [B, U, vocab]."""
        U = tokens_in.shape[1]
        mem_mask = jnp.arange(enc.shape[1])[None, :] < n_out[:, None]
        x = self.embed(jnp.maximum(tokens_in, 0))
        x = x * np.sqrt(self.d_model) + _sin_positions(U, self.d_model)
        causal = jnp.tril(jnp.ones((U, U), bool))
        for blk in self.dec:
            x = blk(x, causal, enc, mem_mask)
        return self.out(self.dec_norm(x))

    def __call__(self, feats, n_frames, tokens_in):
        enc, n_out, ctc_logits = self.encode_with_ctc(feats, n_frames)
        return self.decode_logits(enc, n_out, tokens_in), ctc_logits, n_out


def build_aed_model(
    n_units: int,
    tcfg: TrainConfig,
    dec_blocks: Optional[int] = None,
    heads: int = 4,
    chunk_frames: int = 0,
    left_chunks: int = 1,
) -> AedModel:
    """Single source of truth for the TrainConfig -> AedModel derivation
    (shared by pipeline.train_aed and the decode CLI, like
    rnnt.build_rnnt_model — a drift would break checkpoint restores).
    chunk_frames > 0 builds the streaming-capable chunked variant."""
    d = max(heads * (tcfg.nn_hidden // heads), heads)
    return AedModel(
        n_units=n_units,
        d_model=d,
        enc_blocks=tcfg.nn_layers,
        dec_blocks=dec_blocks if dec_blocks is not None else max(tcfg.nn_layers // 2, 1),
        heads=heads,
        chunk_frames=chunk_frames,
        left_chunks=left_chunks,
    )


def aed_stream_init(model: AedModel, batch: int, n_feats: int) -> dict:
    """Zero streaming state for ``AedModel.encode_stream_step``.

    The offline causal path left-pads every conv with zeros, so zero
    caches make the first chunk bit-equal to the offline prefix; `valid`
    starts all-False so early chunks see only the context that exists.
    Layout (B = batch, D = d_model, Lc = left_chunks * chunk_frames):
      raw  [B, 2, n_feats]          last 2 raw feature frames (conv1 input)
      c1   [B, 2, ceil(n_feats/2), 32]  last 2 post-conv1 frames
      valid [B, Lc]                 which attention-context frames exist
      x1   blocks x [B, Lc, D]      cached post-FFN1 frames (attention K/V)
      y    blocks x [B, k-1, D]     cached pre-depthwise-conv frames
    """
    if model.chunk_frames <= 0:
        raise ValueError("streaming state requires chunk_frames > 0")
    B, D = batch, model.d_model
    Lc = model.left_chunks * model.chunk_frames
    f1 = -(-n_feats // 2)
    return {
        "raw": jnp.zeros((B, 2, n_feats), jnp.float32),
        "c1": jnp.zeros((B, 2, f1,
                         ConvSubsample.channels), jnp.float32),
        "valid": jnp.zeros((B, Lc), bool),
        "x1": [jnp.zeros((B, Lc, D), jnp.float32)
               for _ in range(model.enc_blocks)],
        "y": [jnp.zeros((B, model.conv_kernel - 1, D), jnp.float32)
              for _ in range(model.enc_blocks)],
    }


def make_aed_stream_step(model: AedModel, params):
    """Jitted chunk step: (feats_chunk [B, 4*chunk_frames, F], state) ->
    (enc [B, chunk_frames, D], ctc_logits [B, chunk_frames, n_units+1],
    new state). Exactly equal to the offline chunk-masked encoder on the
    same prefix (tested in tests/test_aed_stream.py)."""

    @jax.jit
    def step(feats_chunk, state):
        return model.apply(
            params, feats_chunk, state, method=AedModel.encode_stream_step
        )

    return step


# --------------------------------------------------------------------------
# Training
# --------------------------------------------------------------------------


def make_teacher_batch(
    labels: jax.Array, n_labels: jax.Array, sos: int, eos: int
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """(labels [B, L] -1-padded) -> (dec_in [B, L+1], targets [B, L+1],
    target_mask [B, L+1]): dec_in = sos + labels; targets = labels + eos at
    position n_labels; positions past the eos are masked out."""
    B, L = labels.shape
    safe = jnp.maximum(labels, 0)
    dec_in = jnp.concatenate(
        [jnp.full((B, 1), sos, jnp.int32), safe.astype(jnp.int32)], axis=1
    )
    u = jnp.arange(L + 1, dtype=jnp.int32)[None, :]
    tgt = jnp.where(
        u < n_labels[:, None],
        jnp.pad(safe, ((0, 0), (0, 1))),
        eos,
    ).astype(jnp.int32)
    mask = u <= n_labels[:, None]
    return dec_in, tgt, mask


def smoothed_ce(
    logits: jax.Array,   # [B, U, V]
    targets: jax.Array,  # [B, U]
    mask: jax.Array,     # [B, U] bool
    smoothing: float = 0.1,
) -> jax.Array:
    """Per-utterance label-smoothed cross-entropy (sum over valid tokens)."""
    V = logits.shape[-1]
    logp = jax.nn.log_softmax(logits, axis=-1)
    tgt_lp = jnp.take_along_axis(logp, targets[..., None], axis=-1)[..., 0]
    mean_lp = logp.mean(axis=-1)
    tok = (1.0 - smoothing) * tgt_lp + smoothing * mean_lp
    return -jnp.sum(jnp.where(mask, tok, 0.0), axis=-1)


class AedTrainState(NamedTuple):
    params: Any
    opt_state: Any
    step: jax.Array


def init_aed_train_state(
    model: AedModel, cfg: TrainConfig, feat_dim: int, l_max: int, key
) -> AedTrainState:
    from mogasr.am.train_nn import make_optimizer

    feats = jnp.zeros((2, 16, feat_dim), jnp.float32)
    toks = jnp.zeros((2, l_max + 1), jnp.int32)
    params = model.init(key, feats, jnp.asarray([16, 16]), toks)
    opt = make_optimizer(cfg)
    return AedTrainState(params, opt.init(params), jnp.zeros((), jnp.int32))


def aed_objective(
    model: AedModel,
    params,
    feats,
    n_frames,
    labels,
    n_labels,
    ctc_weight: float = 0.3,
    smoothing: float = 0.1,
):
    """(1 - w) * label-smoothed attention CE + w * CTC on the encoder,
    both per-token-normalized over valid rows (masked_mean_objective)."""
    dec_in, tgt, mask = make_teacher_batch(labels, n_labels, model.sos, model.eos)
    dec_logits, ctc_logits, n_out = model.apply(
        params, feats, n_frames, dec_in
    )
    ce = smoothed_ce(dec_logits, tgt, mask, smoothing)
    # n_labels + 1: eos is a real prediction target
    ce_obj, ce_nll = masked_mean_objective(ce, n_frames, n_labels + 1)
    ctc_nll = ctc_loss(ctc_logits, n_out, labels, n_labels)
    ctc_obj, _ = masked_mean_objective(ctc_nll, n_out, jnp.maximum(n_labels, 1))
    loss = (1.0 - ctc_weight) * ce_obj + ctc_weight * ctc_obj
    return loss, {"loss": loss, "ce": ce_nll, "ctc": ctc_obj}


def make_aed_train_step(
    model: AedModel,
    cfg: TrainConfig,
    ctc_weight: float = 0.3,
    smoothing: float = 0.1,
    spec_augment: bool = False,
):
    from mogasr.am.train_nn import make_optimizer

    opt = make_optimizer(cfg)
    if spec_augment:
        from mogasr.am.neural import spec_augment as _sa

    @jax.jit
    def train_step(
        state: AedTrainState, feats, n_frames, labels, n_labels
    ) -> Tuple[AedTrainState, Dict[str, jax.Array]]:
        if spec_augment:
            key = jax.random.fold_in(jax.random.key(cfg.seed), state.step)
            feats_in = _sa(feats, n_frames, key)
        else:
            feats_in = feats

        def loss_fn(p):
            return aed_objective(
                model, p, feats_in, n_frames, labels, n_labels,
                ctc_weight=ctc_weight, smoothing=smoothing,
            )

        (_, metrics), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            state.params
        )
        updates, opt_state = opt.update(grads, state.opt_state, state.params)
        params = optax.apply_updates(state.params, updates)
        return AedTrainState(params, opt_state, state.step + 1), metrics

    return train_step


# --------------------------------------------------------------------------
# Decoding: batched on-device beam search
# --------------------------------------------------------------------------


def aed_fusion_matrix(model: AedModel, unit_lm, weight: float) -> jax.Array:
    """On-device shallow-fusion table for the AED beam: a [V, V] matrix
    whose (prev_token, token) entry is the weighted unit-bigram log-prob.

    Row sos carries the LM's sentence-initial distribution; sos/eos COLUMNS
    are zero (ending a hypothesis costs no LM term, matching the CTC
    fusion's telescoping semantics), and the eos row is zero (finished
    beams' forced-eos steps are LM-free). Inside the beam scan this is one
    row gather per step — the on-device form of shallow fusion (no host
    callback, no per-hypothesis LM state)."""
    V, sos = model.vocab, model.sos
    nu = unit_lm.n_units
    assert nu == model.n_units, (
        f"unit LM vocabulary ({nu}) != AED units ({model.n_units})"
    )
    m = np.zeros((V, V), np.float32)
    m[:nu, :nu] = weight * unit_lm.pair_logp
    m[sos, :nu] = weight * unit_lm.init_logp
    return jnp.asarray(m)


def make_aed_decoder(
    model: AedModel,
    params,
    beam: int = 4,
    max_tokens: int = 48,
    ctc_weight: float = 0.0,
    length_penalty: float = 0.0,
    return_all: bool = False,
    fusion: Optional[jax.Array] = None,
    early_exit: bool = True,
):
    """Jitted batched beam search: (feats, n_frames) -> (tokens [B, U_max],
    n_tokens [B], scores [B]).

    One decode loop over at most U_max steps; each step recomputes the
    causal decoder over the full [B*K, U_max] token buffer and reads
    position u (see module docstring for why recompute beats KV caches
    here). Finished beams propagate unchanged (only eos, at zero cost).
    ``early_exit`` (default) runs the loop as a `lax.while_loop` that stops
    once EVERY beam of every row has emitted eos — bitwise-identical
    hypotheses (post-finish steps are no-ops by construction: eos-only
    expansion at unchanged scores), but the serving finals' token budget
    (aed_final_max_tokens: U_max = 2 + T/4, a worst-case cap ~5-10x a real
    transcript) stops costing its worst case; the engine's drain
    finalization was the capacity-realtime bottleneck (round-3 VERDICT
    item 3). ``early_exit=False`` keeps the fixed `lax.scan` (the A/B
    reference; also what MWER fine-tuning differentiates through).
    With ctc_weight > 0 the final K hypotheses are rescored with the
    encoder's CTC head: score = (1 - w) * att + w * log p_ctc (joint
    decoding, rescoring flavor). length_penalty > 0 divides scores by
    (n_tokens + 1)^penalty at the final ranking."""
    K, U = beam, max_tokens
    sos, eos, V = model.sos, model.eos, model.vocab

    @jax.jit
    def decode(feats, n_frames, p=params):
        # p defaults to the bound checkpoint; pass updated params explicitly
        # to reuse the compiled decoder during fine-tuning (MWER) without
        # rebuilding/retracing.
        B = feats.shape[0]
        enc, n_out, ctc_logits = model.apply(
            p, feats, n_frames, method=AedModel.encode_with_ctc
        )
        enc_k = jnp.repeat(enc, K, axis=0)          # [B*K, T', D]
        n_out_k = jnp.repeat(n_out, K, axis=0)      # [B*K]

        toks0 = jnp.full((B, K, U), eos, jnp.int32)
        scores0 = jnp.where(
            jnp.arange(K)[None, :] == 0, 0.0, NEG_INF
        ) * jnp.ones((B, 1))
        fin0 = jnp.zeros((B, K), bool)

        def step(carry, u):
            toks, scores, fin = carry
            dec_in = jnp.concatenate(
                [jnp.full((B, K, 1), sos, jnp.int32), toks[:, :, :-1]], axis=2
            ).reshape(B * K, U)
            logits = model.apply(
                p, enc_k, n_out_k, dec_in, method=AedModel.decode_logits
            )
            logp = jax.nn.log_softmax(
                logits[jnp.arange(B * K), u].reshape(B, K, V), axis=-1
            )
            if fusion is not None:
                # each beam's previous token (sos at u == 0) selects its
                # LM row: one gather per step, telescoping to the weighted
                # unit-bigram log-prob of the hypothesis
                prev = jnp.where(
                    u == 0,
                    jnp.full((B, K), sos, jnp.int32),
                    jax.lax.dynamic_index_in_dim(
                        toks, jnp.maximum(u - 1, 0), axis=2, keepdims=False
                    ),
                )
                logp = logp + fusion[prev]
            logp = logp.at[:, :, sos].set(NEG_INF)
            eos_only = jnp.full((V,), NEG_INF).at[eos].set(0.0)
            logp = jnp.where(fin[..., None], eos_only[None, None, :], logp)
            cand = scores[..., None] + logp              # [B, K, V]
            flat = cand.reshape(B, K * V)
            top, idx = jax.lax.top_k(flat, K)
            src, tok = idx // V, (idx % V).astype(jnp.int32)
            toks = jnp.take_along_axis(toks, src[..., None], axis=1)
            toks = toks.at[:, :, u].set(tok)
            fin = jnp.take_along_axis(fin, src, axis=1) | (tok == eos)
            return (toks, top, fin), None

        if early_exit:
            def cond(carry):
                _toks, _scores, fin_c, u = carry
                return (u < U) & ~jnp.all(fin_c)

            def body(carry):
                toks_c, scores_c, fin_c, u = carry
                (toks_c, scores_c, fin_c), _ = step(
                    (toks_c, scores_c, fin_c), u)
                return (toks_c, scores_c, fin_c, u + 1)

            toks, scores, fin, _ = jax.lax.while_loop(
                cond, body, (toks0, scores0, fin0, jnp.asarray(0, jnp.int32))
            )
        else:
            (toks, scores, fin), _ = jax.lax.scan(
                step, (toks0, scores0, fin0), jnp.arange(U)
            )
        is_eos = toks == eos
        n_toks = jnp.where(
            is_eos.any(axis=-1), is_eos.argmax(axis=-1), U
        ).astype(jnp.int32)                               # [B, K]
        final = scores
        if ctc_weight > 0.0:
            labels = jnp.where(
                jnp.arange(U)[None, None, :] < n_toks[..., None], toks, -1
            ).reshape(B * K, U)
            ctc_k = jnp.repeat(ctc_logits, K, axis=0)
            ctc_lp = -ctc_loss(
                ctc_k, n_out_k, labels, n_toks.reshape(B * K)
            ).reshape(B, K)
            final = (1.0 - ctc_weight) * scores + ctc_weight * ctc_lp
        if length_penalty > 0.0:
            final = final / (n_toks.astype(jnp.float32) + 1.0) ** length_penalty
        if return_all:
            # all K final beams, best-first (N-best for rescoring / MWER)
            order = jnp.argsort(-final, axis=1)
            return (
                jnp.take_along_axis(toks, order[..., None], axis=1),
                jnp.take_along_axis(n_toks, order, axis=1),
                jnp.take_along_axis(final, order, axis=1),
            )
        best = jnp.argmax(final, axis=1)
        pick = lambda a: jnp.take_along_axis(
            a, best[:, None] if a.ndim == 2 else best[:, None, None], axis=1
        )
        return (
            pick(toks)[:, 0],
            pick(n_toks)[:, 0],
            pick(final)[:, 0],
        )

    return decode


_DECODER_CACHE: Dict[tuple, tuple] = {}


def aed_decode_batch(
    model: AedModel,
    params,
    feats,
    n_frames,
    beam: int = 4,
    max_tokens: int = 48,
    ctc_weight: float = 0.0,
    length_penalty: float = 0.0,
    fusion: Optional[jax.Array] = None,
):
    """Convenience host wrapper: -> list of unit-id lists (valid rows only
    trimmed by the caller via batch.size).

    The jitted beam decoder is CACHED per (model, params, options) — jit
    caches are per-function-object, so rebuilding it each call would pay
    the full beam-scan compile per batch (transcribe) / per final (serve).
    The cache holds the model/params refs, keeping their ids stable."""
    key = (id(model), id(params), beam, max_tokens, ctc_weight,
           length_penalty, None if fusion is None else id(fusion))
    hit = _DECODER_CACHE.get(key)
    if hit is None or hit[0] is not model or hit[1] is not params:
        dec = make_aed_decoder(
            model, params, beam=beam, max_tokens=max_tokens,
            ctc_weight=ctc_weight, length_penalty=length_penalty,
            fusion=fusion,
        )
        if len(_DECODER_CACHE) > 16:  # bound: a serve process lives long
            _DECODER_CACHE.clear()
        _DECODER_CACHE[key] = (model, params, fusion, dec)
    else:
        dec = hit[3]
    toks, n_toks, _ = jax.tree.map(np.asarray, dec(feats, n_frames))
    return [list(map(int, toks[b, : n_toks[b]])) for b in range(len(toks))]


# --------------------------------------------------------------------------
# MWER fine-tuning (minimum word/unit error rate; Prabhavalkar et al. 2018)
# --------------------------------------------------------------------------


def aed_seq_logprob(
    model: AedModel, params, enc, n_out, hyps, n_hyp_tokens
):
    """Teacher-forced total log-probability of unit sequences, INCLUDING the
    eos emission (so shorter hypotheses aren't spuriously favored).
    enc [R, T', D] / n_out [R] pair row-wise with hyps [R, U] (-1-padded),
    n_hyp_tokens [R]. Returns [R]."""
    dec_in, tgt, mask = make_teacher_batch(
        hyps, n_hyp_tokens, model.sos, model.eos
    )
    logits = model.apply(
        params, enc, n_out, dec_in, method=AedModel.decode_logits
    )
    lp = jax.nn.log_softmax(logits, axis=-1)
    tok_lp = jnp.take_along_axis(lp, tgt[..., None], axis=-1)[..., 0]
    return jnp.sum(jnp.where(mask, tok_lp, 0.0), axis=-1)


def aed_mwer_objective(
    model: AedModel,
    params,
    feats,
    n_frames,
    hyps,          # [B, N, U] int32 unit ids, -1-padded
    n_hyp_tokens,  # [B, N]
    hyp_mask,      # [B, N] bool — False: empty/duplicate N-best slot
    risks,         # [B, N] float — per-hypothesis error count (edit distance)
    labels,        # [B, L] reference targets (-1-padded), CE anchor
    n_labels,      # [B]
    ce_weight: float = 0.1,
):
    """Expected-risk over the model's own N-best, renormalized over the list
    (the standard MWER surrogate): L = sum_n p_hat(n) * (r_n - r_bar) with
    p_hat = softmax of sequence log-probs over the list and r_bar the mean
    risk of the valid slots (constant baseline — variance reduction only).
    A small CE anchor on the references keeps the distribution from
    collapsing away from the teacher-forced optimum during fine-tuning.
    Padded batch rows (n_frames == 0 or no valid hypothesis) are excluded."""
    B, N, U = hyps.shape
    enc, n_out = model.apply(params, feats, n_frames, method=AedModel.encode)
    enc_r = jnp.repeat(enc, N, axis=0)
    n_out_r = jnp.repeat(n_out, N, axis=0)
    seq_lp = aed_seq_logprob(
        model, params, enc_r, n_out_r,
        hyps.reshape(B * N, U), n_hyp_tokens.reshape(B * N),
    ).reshape(B, N)
    seq_lp = jnp.where(hyp_mask, seq_lp, NEG_INF)
    phat = jax.nn.softmax(seq_lp, axis=1)
    n_valid = jnp.maximum(jnp.sum(hyp_mask, axis=1), 1)
    rbar = jnp.sum(jnp.where(hyp_mask, risks, 0.0), axis=1) / n_valid
    row_risk = jnp.sum(phat * jnp.where(hyp_mask, risks, 0.0), axis=1)
    row_loss = row_risk - rbar
    row_ok = (n_frames > 0) & jnp.any(hyp_mask, axis=1)
    denom = jnp.maximum(jnp.sum(row_ok), 1)
    mwer = jnp.sum(jnp.where(row_ok, row_loss, 0.0)) / denom
    exp_risk = jnp.sum(jnp.where(row_ok, row_risk, 0.0)) / denom
    metrics = {"mwer": mwer, "expected_risk": exp_risk}
    loss = mwer
    if ce_weight > 0.0:
        dec_in, tgt, mask = make_teacher_batch(
            labels, n_labels, model.sos, model.eos
        )
        logits = model.apply(
            params, enc, n_out, dec_in, method=AedModel.decode_logits
        )
        ce = smoothed_ce(logits, tgt, mask, smoothing=0.0)
        ce_obj, _ = masked_mean_objective(ce, n_frames, n_labels + 1)
        loss = loss + ce_weight * ce_obj
        metrics["ce"] = ce_obj
    metrics["loss"] = loss
    return loss, metrics


def make_aed_mwer_step(
    model: AedModel, cfg: TrainConfig, ce_weight: float = 0.1
):
    """Jitted MWER fine-tuning step:
    (state, feats, n_frames, hyps, n_hyp_tokens, hyp_mask, risks,
     labels, n_labels) -> (state, metrics).
    N-best generation and risk computation happen OUTSIDE (host beam decode
    with return_all=True against the CURRENT params, edit distances vs the
    reference) — see pipeline.finetune_aed_mwer."""
    from mogasr.am.train_nn import make_optimizer

    opt = make_optimizer(cfg)

    @jax.jit
    def step(state, feats, n_frames, hyps, n_hyp_tokens, hyp_mask, risks,
             labels, n_labels):
        def loss_fn(p):
            return aed_mwer_objective(
                model, p, feats, n_frames, hyps, n_hyp_tokens, hyp_mask,
                risks, labels, n_labels, ce_weight=ce_weight,
            )

        (_, metrics), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            state.params
        )
        updates, opt_state = opt.update(grads, state.opt_state, state.params)
        params = optax.apply_updates(state.params, updates)
        return AedTrainState(params, opt_state, state.step + 1), metrics

    return step
