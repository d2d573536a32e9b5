"""RNN-Transducer (RNN-T): streaming-native sequence transduction.

Completes the end-to-end family beyond CTC (mogasr.am.ctc): the transducer
conditions each emission on the LABEL HISTORY through a prediction network,
removing CTC's conditional-independence assumption, and is the standard
architecture for streaming ASR.

Components (all Flax, lowered to XLA):

- encoder: any frame classifier body from mogasr.am.neural (the acoustic
  transcription network) producing [B, T, H_enc];
- prediction network: embedding + unidirectional LSTM over the label
  sequence (blank-free), [B, U] -> [B, U+1, H_pred] (position 0 = <sos>);
- joint network: broadcast-add + tanh + projection to V = n_labels + 1
  logits over the [B, T, U+1] lattice (blank LAST, matching ctc.py).

The transducer loss is the log-domain DP over the (t, u) lattice
(Graves 2012):

    alpha[t, u] = lse(alpha[t-1, u] + blank(t-1, u),
                      alpha[t, u-1] + emit(t, u-1))

implemented as a ``lax.scan`` over T whose carry is the alpha row [B, U+1];
the in-frame recursion over u is a second (inner) scan — both are
fixed-shape, padding-frozen, exactly the pattern of the CTC/FB scans.
``tests/test_rnnt.py`` checks the loss against an independent NumPy DP and
gradients against finite differences of that oracle.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax

from mogasr.config import TrainConfig

NEG_INF = -1e30


# --------------------------------------------------------------------------
# Model
# --------------------------------------------------------------------------


class RnntPrediction(nn.Module):
    """Label-history network: embed + LSTM; input labels are blank-free."""

    n_labels: int
    hidden: int = 256
    embed: int = 128

    @nn.compact
    def __call__(self, labels: jax.Array) -> jax.Array:
        # labels: [B, U] (-1 padding). Prepend <sos> (index n_labels) so the
        # output at position u conditions on labels[:u]; output [B, U+1, H].
        B, U = labels.shape
        sos = jnp.full((B, 1), self.n_labels, jnp.int32)
        x = jnp.concatenate([sos, jnp.maximum(labels, 0).astype(jnp.int32)], axis=1)
        emb = nn.Embed(self.n_labels + 1, self.embed)(x)
        return nn.RNN(nn.OptimizedLSTMCell(self.hidden))(emb)


class RnntPredictionStateless(nn.Module):
    """Stateless (last-label-only) prediction network.

    Output at position u depends ONLY on label u-1 (embed + Dense) — the
    low-data regularizer of Ghodsi et al. 2020: with no recurrent state the
    network cannot memorize training transcripts, so the acoustics must
    carry the modeling load (measured here: the LSTM prediction net drove
    held-out PER to ~0.87 on 48 training utts while train loss hit 0.01).
    Same [B, U] -> [B, U+1, H] interface as RnntPrediction, so every
    decoder (greedy/beam/device/streaming) works unchanged.
    """

    n_labels: int
    hidden: int = 256
    embed: int = 128

    @nn.compact
    def __call__(self, labels: jax.Array) -> jax.Array:
        B, U = labels.shape
        sos = jnp.full((B, 1), self.n_labels, jnp.int32)
        x = jnp.concatenate([sos, jnp.maximum(labels, 0).astype(jnp.int32)], axis=1)
        emb = nn.Embed(self.n_labels + 1, self.embed)(x)
        return nn.Dense(self.hidden)(jnp.tanh(emb))


class RnntJoint(nn.Module):
    """Joint network: enc [B, T, He] x pred [B, U1, Hp] -> [B, T, U1, V].

    setup-style (attribute names match the original compact names, so
    checkpoints are unchanged) so ``banded`` can reuse the same parameters
    to evaluate the joint only on a pruned (t, u) band (am/rnnt_pruned.py).
    """

    n_labels: int
    hidden: int = 256

    def setup(self):
        self.enc_proj = nn.Dense(self.hidden)
        self.pred_proj = nn.Dense(self.hidden)
        self.out = nn.Dense(self.n_labels + 1)

    def __call__(self, enc: jax.Array, pred: jax.Array) -> jax.Array:
        e = self.enc_proj(enc)[:, :, None, :]
        p = self.pred_proj(pred)[:, None, :, :]
        return self.out(jnp.tanh(e + p))

    def project_enc(self, enc: jax.Array) -> jax.Array:
        """The prediction-independent half: [B, T, He] -> [B, T, Hj].
        Greedy label-loop decoding computes this ONCE per utterance batch
        and reuses it every emission round (the enc_proj GEMM is the
        expensive half of the joint)."""
        return self.enc_proj(enc)

    def logits_vs_frames(self, e_proj: jax.Array, pred: jax.Array) -> jax.Array:
        """Joint logits of ONE prediction state against ALL frames:
        ([B, T, Hj] projected enc, [B, Hp] pred) -> [B, T, V].  Identical
        math to ``__call__`` with U1=1 — the per-element contractions are
        the same dot products, just batched over T in one GEMM."""
        p = self.pred_proj(pred)
        return self.out(jnp.tanh(e_proj + p[:, None, :]))

    def banded(
        self, enc: jax.Array, pred: jax.Array, u_start: jax.Array, band: int
    ) -> jax.Array:
        """Joint logits on the band u ∈ [u_start[t], u_start[t]+band) only:
        [B, T, band, V] instead of [B, T, U+1, V] — the pruned-transducer
        FLOPs/memory win (the tanh+out GEMMs shrink by (U+1)/band).

        ``pred`` is projected ONCE at [B, U+1, Hj] and the projected rows
        gathered per frame, so the gather moves Hj-wide rows, not raw
        prediction states through an extra GEMM.
        """
        B, T, _ = enc.shape
        e = self.enc_proj(enc)[:, :, None, :]              # [B, T, 1, Hj]
        p_all = self.pred_proj(pred)                       # [B, U+1, Hj]
        U1 = p_all.shape[1]
        idx = jnp.clip(
            u_start[:, :, None] + jnp.arange(band)[None, None, :], 0, U1 - 1
        )                                                  # [B, T, band]
        p = jnp.take_along_axis(
            p_all[:, None, :, :], idx[..., None], axis=2
        )                                                  # [B, T, band, Hj]
        return self.out(jnp.tanh(e + p))


class RnntModel(nn.Module):
    """Encoder + prediction + joint. Blank id = n_labels (last)."""

    n_labels: int
    enc_hidden: int = 256
    enc_layers: int = 2
    pred_hidden: int = 256
    joint_hidden: int = 256
    encoder_arch: str = "lstm"  # lstm (streaming) | blstm (offline)
    pred_arch: str = "lstm"     # lstm | stateless (low-data regularizer)
    aux_ctc: bool = False       # add a CTC head on the encoder (joint loss)
    simple_heads: bool = False  # factored am/lm heads for pruned training

    def setup(self):
        from mogasr.am.neural import BlstmAm, LstmAm

        cls = LstmAm if self.encoder_arch == "lstm" else BlstmAm
        # reuse the AM body; its final Dense yields the encoder features
        self.encoder = cls(
            n_pdfs=self.enc_hidden, hidden=self.enc_hidden, layers=self.enc_layers
        )
        pred_cls = (
            RnntPrediction if self.pred_arch == "lstm" else RnntPredictionStateless
        )
        self.prediction = pred_cls(self.n_labels, hidden=self.pred_hidden)
        self.joint = RnntJoint(self.n_labels, hidden=self.joint_hidden)
        if self.aux_ctc:
            self.ctc_head = nn.Dense(self.n_labels + 1)
        if self.simple_heads:
            # Factored "trivial" joint for pruned-transducer training
            # (am/rnnt_pruned.py): logit(t, u, v) ≈ simple_am(enc)[t, v]
            # + simple_lm(pred)[u, v] — cheap enough to score the FULL
            # (t, u) lattice, whose occupancies pick the band the real
            # joint is evaluated on.
            self.simple_am = nn.Dense(self.n_labels + 1)
            self.simple_lm = nn.Dense(self.n_labels + 1)

    def __call__(self, feats, n_frames, labels):
        enc = self.encoder(feats, n_frames)
        pred = self.prediction(labels)
        return self.joint(enc, pred)

    def forward_aux(self, feats, n_frames, labels):
        """(joint logits, CTC-head logits) — the auxiliary-CTC training path
        (hybrid CTC/transducer recipe: direct alignment-free supervision on
        the encoder so it cannot hide behind the prediction net)."""
        enc = self.encoder(feats, n_frames)
        pred = self.prediction(labels)
        return self.joint(enc, pred), self.ctc_head(enc)

    def encode(self, feats, n_frames):
        return self.encoder(feats, n_frames)

    def forward_simple(self, feats, n_frames, labels):
        """(am [B,T,V], lm [B,U+1,V], enc, pred, ctc_logits|None) — the cheap
        pass of pruned training: factored lattice scores plus the encoder/
        prediction activations the banded joint re-uses (one encoder run)."""
        enc = self.encoder(feats, n_frames)
        pred = self.prediction(labels)
        ctc_logits = self.ctc_head(enc) if self.aux_ctc else None
        return self.simple_am(enc), self.simple_lm(pred), enc, pred, ctc_logits

    def joint_banded(self, enc, pred, u_start, band: int):
        """Full joint evaluated only on the pruned band (RnntJoint.banded)."""
        return self.joint.banded(enc, pred, u_start, band)

    def init_targets(self, feats, n_frames, labels):
        """Init-only method touching every submodule this config owns, so
        one ``model.init`` covers plain / aux-CTC / pruned parameter trees
        (identical module set => identical tree for existing configs)."""
        enc = self.encoder(feats, n_frames)
        pred = self.prediction(labels)
        outs = [self.joint(enc, pred)]
        if self.aux_ctc:
            outs.append(self.ctc_head(enc))
        if self.simple_heads:
            outs.append(self.simple_am(enc))
            outs.append(self.simple_lm(pred))
        return tuple(outs)


def build_rnnt_model(
    n_labels: int,
    tcfg: TrainConfig,
    encoder_arch: str = "lstm",
    pred_arch: str = "stateless",
    aux_ctc: bool = True,
    simple_heads: bool = False,
) -> RnntModel:
    """Single source of truth for the TrainConfig -> RnntModel derivation,
    shared by pipeline.train_rnnt and the decode CLI (a drift between them
    would make checkpoint restores fail with an opaque tree mismatch)."""
    return RnntModel(
        n_labels=n_labels,
        enc_hidden=tcfg.nn_hidden,
        enc_layers=max(tcfg.nn_layers - 1, 1),
        pred_hidden=max(tcfg.nn_hidden // 4, 16),
        joint_hidden=max(tcfg.nn_hidden // 2, 32),
        encoder_arch=encoder_arch,
        pred_arch=pred_arch,
        aux_ctc=aux_ctc,
        simple_heads=simple_heads,
    )


# --------------------------------------------------------------------------
# Loss
# --------------------------------------------------------------------------


@jax.jit
def rnnt_loss(
    logits: jax.Array,    # [B, T, U+1, V] joint outputs (softmax applied here)
    n_frames: jax.Array,  # [B]
    labels: jax.Array,    # [B, U] (-1 padding), blank-free
    n_labels: jax.Array,  # [B]
) -> jax.Array:
    """Per-utterance transducer NLL -log p(y|x), shape [B]. Blank = V-1."""
    B, T, U1, V = logits.shape
    U = U1 - 1
    logp = jax.nn.log_softmax(logits, axis=-1)
    blank = logp[..., V - 1]                                   # [B, T, U+1]
    safe = jnp.maximum(labels, 0).astype(jnp.int32)
    # emit(t, u) = log P(y_{u+1} | t, u): gather the TRUE label at each u
    emit = jnp.take_along_axis(
        logp[:, :, :U, :], safe[:, None, :, None], axis=3
    )[..., 0]                                                  # [B, T, U]
    return rnnt_dp_nll(blank, emit, n_frames, n_labels)


def rnnt_dp_nll(
    blank: jax.Array,     # [B, T, U+1] log P(blank | t, u)
    emit: jax.Array,      # [B, T, U] log P(y_{u+1} | t, u) (true label)
    n_frames: jax.Array,  # [B]
    n_labels: jax.Array,  # [B]
) -> jax.Array:
    """The Graves lattice DP on pre-gathered emit/blank grids, shape [B].

    Shared by rnnt_loss (grids from the full joint) and the pruned
    transducer's "simple" loss (grids from the factored am+lm joint,
    am/rnnt_pruned.py) — and differentiable, so the pruning bounds come
    from ``jax.grad`` of this very function (the arc occupancies)."""
    B, T, U1 = blank.shape
    U = U1 - 1
    u_idx = jnp.arange(U1, dtype=jnp.int32)
    valid_u = u_idx[None, :] <= n_labels[:, None]              # [B, U+1]

    blank_tm = jnp.transpose(blank, (1, 0, 2))                 # [T, B, U+1]
    emit_tm = jnp.transpose(emit, (1, 0, 2))                   # [T, B, U]

    def emit_row(alpha_prev_col, emit_t):
        """In-frame recursion: alpha[t, u] from alpha[t, u-1] (emit edge).

        alpha_prev_col: [B, U+1] the blank-edge terms alpha[t-1, u]+blank;
        returns the completed row alpha[t, :].
        """
        def inner(carry, inputs):
            # carry: alpha[t, u-1]; inputs: (horizontal base at u, emit(t, u-1))
            base_u, e = inputs
            a_u = jnp.logaddexp(base_u, carry + e)
            return a_u, a_u

        a0 = alpha_prev_col[:, 0]
        _, rest = jax.lax.scan(
            inner, a0, (alpha_prev_col[:, 1:].swapaxes(0, 1), emit_t.swapaxes(0, 1))
        )
        return jnp.concatenate([a0[:, None], rest.swapaxes(0, 1)], axis=1)

    # t = 0 row: only emit edges from alpha[0,0] = 0
    base0 = jnp.full((B, U1), NEG_INF).at[:, 0].set(0.0)
    alpha0 = emit_row(base0, emit_tm[0])
    alpha0 = jnp.where(valid_u, alpha0, NEG_INF)

    def step(alpha, inputs):
        blank_t1, emit_t, t = inputs  # blank at t-1, emit at t
        base = alpha + blank_t1       # vertical (time) edges
        new = emit_row(base, emit_t)
        new = jnp.where(valid_u, new, NEG_INF)
        active = (t < n_frames)[:, None]
        return jnp.where(active, new, alpha), None

    ts = jnp.arange(1, T)
    alpha_T, _ = jax.lax.scan(step, alpha0, (blank_tm[:-1], emit_tm[1:], ts))

    # total = alpha[T-1, U] + blank(T-1, U), with per-utterance T and U
    last_u = n_labels.astype(jnp.int32)
    a_final = jnp.take_along_axis(alpha_T, last_u[:, None], axis=1)[:, 0]
    t_last = jnp.maximum(n_frames - 1, 0)
    blank_last = jnp.take_along_axis(
        jnp.take_along_axis(
            blank, t_last[:, None, None], axis=1
        )[:, 0, :],
        last_u[:, None], axis=1,
    )[:, 0]
    return -(a_final + blank_last)


def rnnt_loss_np(logp: np.ndarray, labels: Sequence[int]) -> float:
    """Independent NumPy oracle: -log p(y|x) for ONE utterance.

    logp: [T, U+1, V] log-softmaxed joint outputs; blank = V-1.
    """
    T, U1, V = logp.shape
    U = len(labels)
    assert U1 >= U + 1
    alpha = np.full((T, U + 1), -np.inf)
    for t in range(T):
        for u in range(U + 1):
            cands = []
            if t == 0 and u == 0:
                cands.append(0.0)
            if t > 0:
                cands.append(alpha[t - 1, u] + logp[t - 1, u, V - 1])
            if u > 0:
                cands.append(alpha[t, u - 1] + logp[t, u - 1, labels[u - 1]])
            alpha[t, u] = np.logaddexp.reduce(cands) if cands else -np.inf
    return float(-(alpha[T - 1, U] + logp[T - 1, U, V - 1]))


# --------------------------------------------------------------------------
# Training
# --------------------------------------------------------------------------


class RnntTrainState(NamedTuple):
    params: Any
    opt_state: Any
    step: jax.Array


def init_rnnt_train_state(
    model: RnntModel, cfg: TrainConfig, feat_dim: int, u_max: int, key
) -> RnntTrainState:
    from mogasr.am.train_nn import make_optimizer

    dummy_f = jnp.zeros((2, 8, feat_dim), jnp.float32)
    dummy_l = jnp.zeros((2, u_max), jnp.int32)
    params = model.init(
        key, dummy_f, jnp.asarray([8, 8]), dummy_l, method=RnntModel.init_targets
    )
    opt = make_optimizer(cfg)
    return RnntTrainState(params, opt.init(params), jnp.zeros((), jnp.int32))


def rnnt_objective(
    model: RnntModel, params, feats, n_frames, labels, n_labels,
    ctc_weight: float = 1.0,
):
    """Forward + transducer loss (+ auxiliary CTC when model.aux_ctc) with
    the shared masked normalization — one source of truth for the local and
    data-parallel train steps. Returns (loss, mean transducer NLL)."""
    from mogasr.am.ctc import ctc_loss, masked_mean_objective

    if model.aux_ctc:
        logits, ctc_logits = model.apply(
            params, feats, n_frames, labels, method=RnntModel.forward_aux
        )
    else:
        logits = model.apply(params, feats, n_frames, labels)
    nll = rnnt_loss(logits, n_frames, labels, n_labels)
    loss, mean_nll = masked_mean_objective(nll, n_frames, n_labels)
    if model.aux_ctc:
        ctc_nll = ctc_loss(ctc_logits, n_frames, labels, n_labels)
        ctc_mean, _ = masked_mean_objective(ctc_nll, n_frames, n_labels)
        loss = loss + ctc_weight * ctc_mean
    return loss, mean_nll


def make_rnnt_train_step(model: RnntModel, cfg: TrainConfig, ctc_weight: float = 1.0):
    """ctc_weight only applies when model.aux_ctc — the hybrid CTC/transducer
    loss L = L_rnnt + w * L_ctc on the encoder's CTC head."""
    from mogasr.am.train_nn import make_optimizer

    opt = make_optimizer(cfg)

    @jax.jit
    def train_step(state, feats, n_frames, labels, n_labels):
        def loss_fn(params):
            return rnnt_objective(
                model, params, feats, n_frames, labels, n_labels, ctc_weight
            )

        (loss, mean_nll), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            state.params
        )
        updates, opt_state = opt.update(grads, state.opt_state, state.params)
        params = optax.apply_updates(state.params, updates)
        return RnntTrainState(params, opt_state, state.step + 1), {
            "loss": loss, "utt_nll": mean_nll,
        }

    return train_step


# --------------------------------------------------------------------------
# Decoding
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=32)
def _encode_fn(model: RnntModel):
    @jax.jit
    def enc(params, feats, n_frames):
        return model.apply(params, feats, n_frames, method=RnntModel.encode)
    return enc


def rnnt_encode(model: RnntModel, params, feats, n_frames):
    """Production encoder forward, ONE jitted dispatch per call (eager
    apply would dispatch every op separately). The jitted fn is cached on
    the model config with params traced, so repeated calls never recompile
    at equal shapes."""
    return _encode_fn(model)(params, feats, n_frames)


class RnntDecoderFns(NamedTuple):
    """Jitted prediction/joint closures shared by greedy, beam, streaming."""

    pred_of: Any   # (hist [B, U_cap] -1-padded, lens [B]) -> [B, Hp]
    joint_of: Any  # (enc_t [B, He], pred_t [B, Hp]) -> [B, V] logits
    blank: int


def make_rnnt_decoder_fns(model: RnntModel, params) -> RnntDecoderFns:
    pred_cls = RnntPrediction if model.pred_arch == "lstm" else RnntPredictionStateless
    pred_def = pred_cls(model.n_labels, hidden=model.pred_hidden)
    pred_params = {"params": params["params"]["prediction"]}
    joint_def = RnntJoint(model.n_labels, hidden=model.joint_hidden)
    joint_params = {"params": params["params"]["joint"]}

    @jax.jit
    def pred_of(hist, lens):
        """Prediction output at each row's OWN position (index len(history);
        <sos> offsets by one, so that conditions on exactly the history)."""
        out = pred_def.apply(pred_params, hist)  # [B, U+1, H]
        return jnp.take_along_axis(out, lens[:, None, None], axis=1)[:, 0, :]

    @jax.jit
    def joint_of(enc_t, pred_t):  # [B, He], [B, Hp] -> [B, V]
        return joint_def.apply(
            joint_params, enc_t[:, None, :], pred_t[:, None, :]
        )[:, 0, 0, :]

    return RnntDecoderFns(pred_of, joint_of, model.n_labels)


class RnntGreedyState:
    """Greedy decode state for a batch of streams: fixed-size history buffer
    (ONE prediction-net compile — a growing-history shape recompiles per
    emission, which is pathological: every emission would pay a compile)."""

    def __init__(self, fns: RnntDecoderFns, batch: int, u_cap: int):
        self.fns = fns
        self.u_cap = u_cap
        self.hyps: List[List[int]] = [[] for _ in range(batch)]
        self.u_hist = np.full((batch, u_cap), -1, np.int32)
        self.frames_done = np.zeros(batch, np.int64)
        self._pred = None

    def _pred_now(self):
        lens = np.asarray([len(h) for h in self.hyps], np.int32)
        return self.fns.pred_of(jnp.asarray(self.u_hist), jnp.asarray(lens))

    def consume(self, enc_chunk, n_valid, max_symbols_per_frame: int = 4):
        """enc_chunk [B, Tc, He]; n_valid [B] valid frames in this chunk."""
        if self._pred is None:
            self._pred = self._pred_now()
        n_valid = np.asarray(n_valid)
        Tc = enc_chunk.shape[1]
        for t in range(Tc):
            active = n_valid > t
            if not active.any():
                break
            for _ in range(max_symbols_per_frame):
                logits = np.asarray(self.fns.joint_of(enc_chunk[:, t], self._pred))
                best = logits.argmax(-1)
                emit = active & (best != self.fns.blank) & np.asarray(
                    [len(h) < self.u_cap for h in self.hyps]
                )
                if not emit.any():
                    break
                for b in np.nonzero(emit)[0]:
                    self.u_hist[b, len(self.hyps[b])] = int(best[b])
                    self.hyps[b].append(int(best[b]))
                self._pred = self._pred_now()
        self.frames_done += n_valid

    def partial(self) -> List[List[int]]:
        return [list(h) for h in self.hyps]


def rnnt_greedy_decode(
    model: RnntModel,
    params,
    feats: jax.Array,     # [B, T, D]
    n_frames: jax.Array,  # [B]
    max_symbols_per_frame: int = 4,
    max_symbols: Optional[int] = None,
) -> List[List[int]]:
    """Frame-synchronous greedy decode (host loop over frames).

    At each frame, emit argmax labels (advancing the prediction state) until
    blank wins or the per-frame cap hits, then move to the next frame. The
    caps make the loop finite without changing results on real posteriors
    (blank dominates after the cap in practice).
    """
    enc = rnnt_encode(model, params, feats, n_frames)
    B, T = enc.shape[0], enc.shape[1]
    u_cap = int(max_symbols) if max_symbols is not None else min(2 * T, 400)
    state = RnntGreedyState(make_rnnt_decoder_fns(model, params), B, u_cap)
    state.consume(enc, np.asarray(n_frames), max_symbols_per_frame)
    return state.partial()


class RnntPredictionStep(nn.Module):
    """One prediction-net step: (label [B], lstm carry) -> (carry, out [B, H]).

    Mirrors RnntPrediction's submodule construction order (Embed then RNN),
    so it consumes the OFFLINE prediction parameters unchanged — the same
    identical-param-tree trick as neural.LstmAmStream.
    """

    n_labels: int
    hidden: int = 256
    embed: int = 128

    @nn.compact
    def __call__(self, label: jax.Array, carry):
        emb = nn.Embed(self.n_labels + 1, self.embed)(label.astype(jnp.int32))
        rnn = nn.RNN(nn.OptimizedLSTMCell(self.hidden))
        carry, out = rnn(emb[:, None, :], initial_carry=carry, return_carry=True)
        return carry, out[:, 0]


class RnntPredictionStatelessStep(nn.Module):
    """Step form of RnntPredictionStateless (carry is a pass-through dummy)."""

    n_labels: int
    hidden: int = 256
    embed: int = 128

    @nn.compact
    def __call__(self, label: jax.Array, carry):
        emb = nn.Embed(self.n_labels + 1, self.embed)(label.astype(jnp.int32))
        return carry, nn.Dense(self.hidden)(jnp.tanh(emb))


@functools.lru_cache(maxsize=32)
def _device_greedy_chunk_fn(model: RnntModel, u_cap: int, max_symbols_per_frame: int):
    """The device greedy frame loop with its decode state
    (prediction carry, prediction output, hypothesis buffer, lengths) is an
    explicit argument/result, so consecutive chunks continue EXACTLY where
    the previous chunk stopped — streaming == offline by construction."""
    step_cls = (
        RnntPredictionStep if model.pred_arch == "lstm" else RnntPredictionStatelessStep
    )
    pred_step_def = step_cls(model.n_labels, hidden=model.pred_hidden)
    joint_def = RnntJoint(model.n_labels, hidden=model.joint_hidden)
    blank = model.n_labels
    sos = model.n_labels

    def init_state(params, batch: int):  # runs once per stream — no jit
        pred_params = {"params": params["params"]["prediction"]}
        if model.pred_arch == "lstm":
            cell = nn.OptimizedLSTMCell(model.pred_hidden)
            carry0 = cell.initialize_carry(jax.random.key(0), (batch, 1))
        else:
            carry0 = jnp.zeros((batch, 1))
        carry0, pred0 = pred_step_def.apply(
            pred_params, jnp.full((batch,), sos, jnp.int32), carry0
        )
        hyp0 = jnp.full((batch, u_cap), -1, jnp.int32)
        lens0 = jnp.zeros((batch,), jnp.int32)
        return carry0, pred0, hyp0, lens0

    @jax.jit
    def consume(params, state, enc_chunk, n_valid):
        pred_params = {"params": params["params"]["prediction"]}
        joint_params = {"params": params["params"]["joint"]}
        B, Tc, _ = enc_chunk.shape
        cols = jnp.arange(u_cap)[None, :]

        def frame_step(st, inputs):
            carry, pred, hyp, lens = st
            enc_t, t = inputs
            active = t < n_valid
            for _ in range(max_symbols_per_frame):
                logits = joint_def.apply(
                    joint_params, enc_t[:, None, :], pred[:, None, :]
                )[:, 0, 0, :]
                best = jnp.argmax(logits, axis=-1).astype(jnp.int32)
                emit = active & (best != blank) & (lens < u_cap)
                label = jnp.where(emit, best, sos)
                new_carry, new_pred = pred_step_def.apply(pred_params, label, carry)
                carry = jax.tree.map(
                    lambda n, o: jnp.where(emit[:, None], n, o), new_carry, carry
                )
                pred = jnp.where(emit[:, None], new_pred, pred)
                slot = emit[:, None] & (cols == lens[:, None])
                hyp = jnp.where(slot, best[:, None], hyp)
                lens = lens + emit.astype(jnp.int32)
            return (carry, pred, hyp, lens), None

        state, _ = jax.lax.scan(
            frame_step, state,
            (jnp.transpose(enc_chunk, (1, 0, 2)), jnp.arange(Tc)),
        )
        return state

    return init_state, consume


@functools.lru_cache(maxsize=32)
def _label_loop_chunk_fn(model: RnntModel, u_cap: int, max_symbols_per_frame: int):
    """Chunk-resumable LABEL-LOOP greedy: `_device_greedy_chunk_fn`'s exact
    contract ((init_state, consume), state = (carry, pred, hyp, lens)) with
    `_label_loop_greedy_fn`'s sequential structure inside each chunk.

    The frame scan serializes Tc x max_symbols_per_frame tiny joint+
    prediction steps per chunk (~96 sequential kernels at the serving tick
    of 24 frames); here the sequential depth per chunk is the chunk's max
    EMISSION count (typically a handful), each round one batched
    [B*Tc, Hj] x [Hj, V] MXU GEMM. Resumability is free: the carried state
    is exactly the frame scan's, the frame cursor restarts at 0 each chunk
    (frames never span chunks), and the per-frame symbol cap resets with
    it — so chunked label-loop == chunked frame-scan == offline greedy
    (tested: test_rnnt_label_loop_chunked_equals_frame_scan)."""
    step_cls = (
        RnntPredictionStep if model.pred_arch == "lstm"
        else RnntPredictionStatelessStep
    )
    pred_step_def = step_cls(model.n_labels, hidden=model.pred_hidden)
    joint_def = RnntJoint(model.n_labels, hidden=model.joint_hidden)
    blank = model.n_labels
    sos = model.n_labels
    cap = int(max_symbols_per_frame)
    init_state, _ = _device_greedy_chunk_fn(model, u_cap, cap)

    @jax.jit
    def consume(params, state, enc_chunk, n_valid):
        pred_params = {"params": params["params"]["prediction"]}
        joint_params = {"params": params["params"]["joint"]}
        carry0, pred0, hyp0, lens0 = state
        B, Tc, _ = enc_chunk.shape
        n = n_valid.astype(jnp.int32)
        e_proj = joint_def.apply(joint_params, enc_chunk,
                                 method=RnntJoint.project_enc)  # [B, Tc, Hj]
        cols = jnp.arange(u_cap)[None, :]
        idxT = jnp.arange(Tc)[None, :]
        t0 = jnp.zeros((B,), jnp.int32)
        syms0 = jnp.zeros((B,), jnp.int32)

        def cond(st):
            t, syms, carry, pred, hyp, lens = st
            return jnp.any((t < n) & (lens < u_cap))

        def body(st):
            t, syms, carry, pred, hyp, lens = st
            logits = joint_def.apply(
                joint_params, e_proj, pred,
                method=RnntJoint.logits_vs_frames)               # [B, Tc, V]
            best = jnp.argmax(logits, axis=-1).astype(jnp.int32)  # [B, Tc]
            at_cap = (idxT == t[:, None]) & (syms[:, None] >= cap)
            cand = ((best != blank) & (idxT >= t[:, None])
                    & (idxT < n[:, None]) & ~at_cap)
            has = jnp.any(cand, axis=1)
            f = jnp.argmax(cand, axis=1).astype(jnp.int32)  # first True
            active = (t < n) & (lens < u_cap)
            emit = active & has
            label_f = jnp.take_along_axis(best, f[:, None], axis=1)[:, 0]
            label = jnp.where(emit, label_f, sos)
            new_carry, new_pred = pred_step_def.apply(pred_params, label, carry)
            carry = jax.tree.map(
                lambda nw, o: jnp.where(emit[:, None], nw, o), new_carry, carry)
            pred = jnp.where(emit[:, None], new_pred, pred)
            slot = emit[:, None] & (cols == lens[:, None])
            hyp = jnp.where(slot, label[:, None], hyp)
            lens = lens + emit.astype(jnp.int32)
            syms = jnp.where(emit, jnp.where(f == t, syms + 1, 1), syms)
            t = jnp.where(emit, f, jnp.where(active, n, t))
            return (t, syms, carry, pred, hyp, lens)

        st = jax.lax.while_loop(
            cond, body, (t0, syms0, carry0, pred0, hyp0, lens0))
        return st[2], st[3], st[4], st[5]

    return init_state, consume


def make_rnnt_stream_shared(
    model: RnntModel,
    params,
    feat_dim: int,
    u_cap: int = 200,
    max_symbols_per_frame: int = 4,
):
    """Jitted fns shared by MANY RnntDeviceStream instances.

    A serving process creates one stream per session; without sharing, each
    construction builds fresh jit closures and recompiles. Build this once
    and pass it as ``RnntDeviceStream(..., shared=...)`` — every session
    then reuses the same compiled encoder step and greedy scan.
    """
    enc_step, _ = make_rnnt_stream_encoder(model, params, 1, feat_dim)
    init_state, consume = _chunk_greedy_fn(
        model, int(u_cap), int(max_symbols_per_frame)
    )
    return enc_step, init_state, consume


def _chunk_greedy_fn(model: RnntModel, u_cap: int, cap: int,
                     impl: str = "frame_scan"):
    """Chunk-resumable greedy factory: impl in {frame_scan, label_loop},
    identical (init_state, consume) contract and identical hypotheses
    (tested); label_loop trades redundant MXU FLOPs for ~Tc/E sequential
    depth per chunk."""
    if impl == "label_loop":
        return _label_loop_chunk_fn(model, u_cap, cap)
    if impl != "frame_scan":
        raise ValueError(f"unknown chunk greedy impl {impl!r}")
    return _device_greedy_chunk_fn(model, u_cap, cap)


class RnntDeviceStream:
    """Online RNN-T: stateful encoder chunks -> chunk-resumable device greedy.

    One jitted dispatch per (encoder chunk, decode chunk); partials at any
    time; final equals the offline device greedy exactly (tested).
    """

    def __init__(self, model: RnntModel, params, batch: int, feat_dim: int,
                 u_cap: int = 200, max_symbols_per_frame: int = 4,
                 shared=None, impl: str = "frame_scan"):
        self.params = params
        if shared is None:
            self.enc_step, self.enc_carries = make_rnnt_stream_encoder(
                model, params, batch, feat_dim
            )
            init_state, self.consume_fn = _chunk_greedy_fn(
                model, int(u_cap), int(max_symbols_per_frame), impl
            )
        else:
            self.enc_step, init_state, self.consume_fn = shared
            self.enc_carries = _rnnt_stream_carries(model, batch, feat_dim)
        self.state = init_state(params, batch)

    def consume(self, feats_chunk: jax.Array, n_valid) -> List[List[int]]:
        """feats_chunk [B, Tc, D]; n_valid [B] valid frames. Returns partials."""
        self.enc_carries, enc = self.enc_step(self.enc_carries, feats_chunk)
        self.state = self.consume_fn(
            self.params, self.state, enc, jnp.asarray(n_valid)
        )
        return self.partial()

    def partial(self) -> List[List[int]]:
        _, _, hyp, lens = self.state
        hyp = np.asarray(hyp)
        lens = np.asarray(lens)
        return [hyp[b, : lens[b]].tolist() for b in range(hyp.shape[0])]


@functools.lru_cache(maxsize=32)
def _label_loop_greedy_fn(model: RnntModel, u_cap: int, max_symbols_per_frame: int):
    """Offline greedy decode as a LABEL LOOP (round-2 VERDICT item 6).

    The frame-scan greedy (`_device_greedy_chunk_fn`) serializes T x
    max_symbols_per_frame tiny joint+prediction steps — at T~600 that is
    ~2400 sequential sub-millisecond kernels per batch, pure latency.  The
    on-device restructure exploits the greedy recurrence's sparsity: the
    prediction state only changes on EMISSION, and between emissions the
    joint argmax over consecutive frames uses a CONSTANT prediction state.
    So run a `lax.while_loop` whose sequential depth is the max emission
    count (tens), not the frame count (hundreds):

      - hoist the prediction-independent joint half `enc_proj(enc)` out of
        the loop entirely (ONE [B*T, He]x[He, Hj] MXU GEMM per batch);
      - each round, score the current prediction state against ALL frames
        in one batched [B*T, Hj]x[Hj, V] GEMM, argmax over V, and jump
        every row straight to its first emitting frame;
      - emit one label per row per round (masked prediction-net step),
        honoring the same per-frame symbol cap as the frame scan: `syms`
        counts emissions at the current frame, and a row at the cap may
        only emit at frames strictly past it.

    Hypotheses are EXACTLY the frame-scan greedy's (tested): between two
    emissions the frame scan evaluates the same logits this version's
    batched round evaluates, sees blank argmax at each skipped frame, and
    emits the same label at the same frame.  Per round the extra work is
    scoring frames behind/ahead of each row's cursor — redundant FLOPs in
    MXU-friendly shapes, traded for a ~T/E reduction in sequential depth.
    """
    step_cls = (
        RnntPredictionStep if model.pred_arch == "lstm"
        else RnntPredictionStatelessStep
    )
    pred_step_def = step_cls(model.n_labels, hidden=model.pred_hidden)
    joint_def = RnntJoint(model.n_labels, hidden=model.joint_hidden)
    blank = model.n_labels
    sos = model.n_labels
    cap = int(max_symbols_per_frame)

    @jax.jit
    def decode(params, enc, n_frames):
        pred_params = {"params": params["params"]["prediction"]}
        joint_params = {"params": params["params"]["joint"]}
        B, T, _ = enc.shape
        n = n_frames.astype(jnp.int32)
        e_proj = joint_def.apply(joint_params, enc,
                                 method=RnntJoint.project_enc)   # [B, T, Hj]
        if model.pred_arch == "lstm":
            cell = nn.OptimizedLSTMCell(model.pred_hidden)
            carry0 = cell.initialize_carry(jax.random.key(0), (B, 1))
        else:
            carry0 = jnp.zeros((B, 1))
        carry0, pred0 = pred_step_def.apply(
            pred_params, jnp.full((B,), sos, jnp.int32), carry0)
        hyp0 = jnp.full((B, u_cap), -1, jnp.int32)
        lens0 = jnp.zeros((B,), jnp.int32)
        t0 = jnp.zeros((B,), jnp.int32)
        syms0 = jnp.zeros((B,), jnp.int32)
        cols = jnp.arange(u_cap)[None, :]
        idxT = jnp.arange(T)[None, :]

        def cond(st):
            t, syms, carry, pred, hyp, lens = st
            return jnp.any((t < n) & (lens < u_cap))

        def body(st):
            t, syms, carry, pred, hyp, lens = st
            logits = joint_def.apply(
                joint_params, e_proj, pred,
                method=RnntJoint.logits_vs_frames)               # [B, T, V]
            best = jnp.argmax(logits, axis=-1).astype(jnp.int32)  # [B, T]
            at_cap = (idxT == t[:, None]) & (syms[:, None] >= cap)
            cand = ((best != blank) & (idxT >= t[:, None])
                    & (idxT < n[:, None]) & ~at_cap)
            has = jnp.any(cand, axis=1)
            f = jnp.argmax(cand, axis=1).astype(jnp.int32)  # first True
            active = (t < n) & (lens < u_cap)
            emit = active & has
            label_f = jnp.take_along_axis(best, f[:, None], axis=1)[:, 0]
            label = jnp.where(emit, label_f, sos)
            new_carry, new_pred = pred_step_def.apply(pred_params, label, carry)
            carry = jax.tree.map(
                lambda nw, o: jnp.where(emit[:, None], nw, o), new_carry, carry)
            pred = jnp.where(emit[:, None], new_pred, pred)
            slot = emit[:, None] & (cols == lens[:, None])
            hyp = jnp.where(slot, label[:, None], hyp)
            lens = lens + emit.astype(jnp.int32)
            syms = jnp.where(emit, jnp.where(f == t, syms + 1, 1), syms)
            # emitting rows park at their emission frame (more symbols may
            # follow there); active rows with nothing left to emit finish
            t = jnp.where(emit, f, jnp.where(active, n, t))
            return (t, syms, carry, pred, hyp, lens)

        st = jax.lax.while_loop(
            cond, body, (t0, syms0, carry0, pred0, hyp0, lens0))
        return st[4], st[5]

    return decode


def make_rnnt_device_greedy(
    model: RnntModel,
    params,
    u_cap: int = 200,
    max_symbols_per_frame: int = 4,
    impl: str = "label_loop",
):
    """Fully on-device greedy decode: ONE jitted call per batch.

    The host greedy loop costs 1-2 synchronized dispatches PER FRAME —
    ruinous at any dispatch latency. This version runs the
    whole frame loop as a ``lax.scan`` carrying (prediction LSTM state,
    current prediction output, hypothesis buffer, lengths); the per-frame
    emission loop is ``max_symbols_per_frame`` masked sub-steps (a stream
    whose argmax is blank keeps identical logits in later sub-steps, so no
    explicit break is needed — blank stays blank). Results are EXACTLY the
    host greedy decode at equal caps (tested).

    Returns decode(enc [B, T, He], n_frames) -> (hyp [B, u_cap] -1-padded,
    lens [B]) as device arrays.

    ``impl="label_loop"`` (production default since round 3) decodes with
    sequential depth = max emission count via `_label_loop_greedy_fn` —
    measured >=2x the frame scan on the bench `rnnt` row at exactly equal
    hypotheses.  ``impl="frame_scan"`` keeps the chunk-resumable frame scan
    (`_device_greedy_chunk_fn`) that streaming uses; the
    streaming-equals-offline guarantee is now enforced by tests comparing
    both implementations rather than by sharing one loop.  Jitted fns are
    cached on (model config, caps) with params as a traced argument, so
    repeated calls never recompile at equal shapes.
    """
    if impl == "label_loop":
        label_decode = _label_loop_greedy_fn(
            model, int(u_cap), int(max_symbols_per_frame)
        )

        def decode(enc, n_frames):
            return label_decode(params, enc, jnp.asarray(n_frames))

        return decode
    if impl != "frame_scan":
        raise ValueError(f"unknown impl {impl!r}")
    init_state, consume = _device_greedy_chunk_fn(
        model, int(u_cap), int(max_symbols_per_frame)
    )

    def decode(enc, n_frames):
        state = init_state(params, int(enc.shape[0]))
        _, _, hyp, lens = consume(params, state, enc, jnp.asarray(n_frames))
        return hyp, lens

    return decode


def rnnt_greedy_decode_device(
    model: RnntModel,
    params,
    feats: jax.Array,
    n_frames: jax.Array,
    max_symbols_per_frame: int = 4,
    max_symbols: Optional[int] = None,
) -> List[List[int]]:
    """Device-scan greedy decode with the host-greedy interface."""
    enc = rnnt_encode(model, params, feats, n_frames)
    T = enc.shape[1]
    u_cap = int(max_symbols) if max_symbols is not None else min(2 * T, 400)
    decode = make_rnnt_device_greedy(
        model, params, u_cap=u_cap, max_symbols_per_frame=max_symbols_per_frame
    )
    hyp, lens = decode(enc, n_frames)
    hyp = np.asarray(hyp)
    lens = np.asarray(lens)
    return [hyp[b, : lens[b]].tolist() for b in range(hyp.shape[0])]


def make_rnnt_stream_encoder(model: RnntModel, params, batch: int, feat_dim: int):
    """Chunked stateful encoder for online RNN-T (lstm encoder_arch only).

    Returns (step, carries): ``carries, enc_chunk = step(carries, feats)``.
    Reuses the OFFLINE encoder parameters through LstmAmStream (identical
    param tree), so chunked outputs equal the offline encoder exactly and
    streaming greedy == offline greedy for any chunking (tested).
    """
    from mogasr.am.neural import LstmAmStream

    assert model.encoder_arch == "lstm", "streaming needs the lstm encoder"
    layers = model.enc_layers
    stream = LstmAmStream(n_pdfs=model.enc_hidden, hidden=model.enc_hidden, layers=layers)
    enc_params = {"params": params["params"]["encoder"]}
    carries = _rnnt_stream_carries(model, batch, feat_dim)

    @jax.jit
    def step(carries, feats):
        enc, new_carries = stream.apply(enc_params, feats, carries)
        return new_carries, enc

    return step, carries


def _rnnt_stream_carries(model: RnntModel, batch: int, feat_dim: int):
    """Fresh zero encoder carries for one stream (shape matches the
    streaming-encoder step returned by make_rnnt_stream_encoder)."""
    from mogasr.am.neural import LstmAm, lstm_stream_init

    offline = LstmAm(n_pdfs=model.enc_hidden, hidden=model.enc_hidden,
                     layers=model.enc_layers)
    return lstm_stream_init(offline, batch, feat_dim)


def rnnt_beam_decode(
    model: RnntModel,
    params,
    feats: jax.Array,     # [1 or B, T, D] (decoded one utterance at a time)
    n_frames: jax.Array,
    beam_size: int = 4,
    max_symbols_per_frame: int = 4,
    u_cap: int = 200,
    ext_score=None,
    ext_weight: float = 1.0,
) -> List[Tuple[float, List[int]]]:
    """Monotonic (batch-synchronous) RNN-T beam search for ONE utterance.

    At each frame, every live hypothesis expands over {blank, labels}; blank
    moves a hypothesis to the next frame, labels re-expand within the frame
    (up to the per-frame cap); identical prefixes are merged by logaddexp.
    All hypotheses' joints evaluate in ONE batched call per expansion round,
    and histories live in a fixed [beam, u_cap] buffer (single compile).

    ext_score(prefix, unit) adds a shallow-fusion term exactly once per
    label extension (same hook/semantics as the CTC prefix beam: the sum
    telescopes to the LM log-prob of the label sequence; alignment merges
    of a prefix share one LM term, so logaddexp merging stays consistent).

    Returns [(logp, label_seq)] best-first for the FIRST utterance.
    """
    fns = make_rnnt_decoder_fns(model, params)
    enc = rnnt_encode(model, params, feats, n_frames)
    T = int(np.asarray(n_frames)[0])
    blank = fns.blank

    # hypothesis set entering each frame: prefix -> logp
    beams: Dict[Tuple[int, ...], float] = {(): 0.0}

    def batch_pred(prefixes):
        H = len(prefixes)
        hist = np.full((H, u_cap), -1, np.int32)
        lens = np.zeros(H, np.int32)
        for i, p in enumerate(prefixes):
            hist[i, : len(p)] = p
            lens[i] = len(p)
        return fns.pred_of(jnp.asarray(hist), jnp.asarray(lens))

    for t in range(T):
        # A: hyps still consuming frame t; done: hyps that emitted blank at t
        A = dict(beams)
        done: Dict[Tuple[int, ...], float] = {}
        for _round in range(max_symbols_per_frame + 1):
            if not A:
                break
            prefixes = list(A.keys())
            scores = np.asarray([A[p] for p in prefixes])
            pred = batch_pred(prefixes)
            enc_t = jnp.broadcast_to(enc[0, t][None, :], (len(prefixes), enc.shape[2]))
            logp = np.asarray(
                jax.nn.log_softmax(fns.joint_of(enc_t, pred), axis=-1)
            )  # [H, V]
            # blank: finish the frame
            for i, p in enumerate(prefixes):
                s = scores[i] + logp[i, blank]
                done[p] = np.logaddexp(done[p], s) if p in done else s
            if _round == max_symbols_per_frame:
                break
            # labels: stay in the frame
            new_A: Dict[Tuple[int, ...], float] = {}
            for i, p in enumerate(prefixes):
                if len(p) >= u_cap:
                    continue
                for v in range(blank):
                    s = scores[i] + logp[i, v]
                    if ext_score is not None:
                        s += ext_weight * ext_score(p, v)
                    q = p + (v,)
                    new_A[q] = np.logaddexp(new_A[q], s) if q in new_A else s
            # prune the in-frame set against the best finished hypothesis
            if done:
                thresh = max(done.values())
                new_A = {p: s for p, s in new_A.items() if s > thresh - 10.0}
            A = dict(sorted(new_A.items(), key=lambda kv: -kv[1])[:beam_size])
        beams = dict(sorted(done.items(), key=lambda kv: -kv[1])[:beam_size])
    return sorted(((s, list(p)) for p, s in beams.items()), key=lambda x: -x[0])


_BEAM_BATCH_ROUND_CACHE: Dict[tuple, object] = {}


def _beam_batch_round_fn(model: RnntModel):
    """Cached jitted (pred_params, joint_params, enc, hist, lens, row_b, t)
    -> log-softmaxed joint [H, V]. Params are ARGUMENTS (not closed over),
    so the jit cache survives across calls and across parameter updates
    (MWER fine-tuning decodes against fresh params every step)."""
    key = (model.n_labels, model.pred_hidden, model.joint_hidden,
           model.pred_arch)
    fn = _BEAM_BATCH_ROUND_CACHE.get(key)
    if fn is not None:
        return fn
    pred_cls = (RnntPrediction if model.pred_arch == "lstm"
                else RnntPredictionStateless)
    pred_def = pred_cls(model.n_labels, hidden=model.pred_hidden)
    joint_def = RnntJoint(model.n_labels, hidden=model.joint_hidden)

    @jax.jit
    def round_logp(pred_params, joint_params, enc, hist, lens, row_b, t):
        out = pred_def.apply(pred_params, hist)            # [H, u_cap+1, Hp]
        pred_t = jnp.take_along_axis(out, lens[:, None, None], axis=1)[:, 0]
        enc_rows = enc[row_b, t]                           # [H, He]
        j = joint_def.apply(
            joint_params, enc_rows[:, None, :], pred_t[:, None, :]
        )[:, 0, 0, :]
        return jax.nn.log_softmax(j, axis=-1)

    if len(_BEAM_BATCH_ROUND_CACHE) > 16:
        _BEAM_BATCH_ROUND_CACHE.clear()
    _BEAM_BATCH_ROUND_CACHE[key] = round_logp
    return round_logp


def rnnt_beam_decode_batch(
    model: RnntModel,
    params,
    feats: jax.Array,     # [B, T, D]
    n_frames: jax.Array,  # [B]
    beam_size: int = 4,
    max_symbols_per_frame: int = 4,
    u_cap: int = 200,
) -> List[List[Tuple[float, List[int]]]]:
    """Monotonic RNN-T beam search for a BATCH — same hypotheses as
    ``rnnt_beam_decode`` per row (tested), at a fraction of the dispatches.

    The per-utterance beam issues 2-3 synchronized device calls per
    expansion round PER UTTERANCE, so it is dispatch-bound regardless of
    model size.
    Here every utterance's frame-t expansion round is fused into ONE jitted
    (prediction -> joint -> log_softmax) call over a fixed [B*beam] row
    buffer (padded rows are masked on host), so the whole batch costs the
    dispatch budget one utterance used to.

    Host-side candidate handling is vectorized and EXACT: within a round
    every (prefix, label) child is distinct, so the global top-``beam_size``
    of H x V candidates is contained in the per-row top-``beam_size`` — an
    argpartition per row replaces the reference's full-V Python dict sweep
    with identical results. Taking the per-row top-K BEFORE the done
    threshold also commutes with the reference's threshold-then-top-K
    order: the threshold removes a score-suffix of each row's sorted
    children, so a surviving child ranked > K within its row has >= K
    better same-row survivors and can never reach the global top-K — no
    "backfill" candidate outside the per-row top-K can exist (ADVICE r4).
    LM fusion hooks (``ext_score``) need full-V scoring before pruning;
    use the per-utterance decoder for that path.

    Returns, per utterance, [(logp, label_seq)] best-first.
    """
    blank = model.n_labels
    round_fn = _beam_batch_round_fn(model)
    pred_params = {"params": params["params"]["prediction"]}
    joint_params = {"params": params["params"]["joint"]}

    def round_logp(enc, hist, lens, row_b, t):
        return round_fn(pred_params, joint_params, enc, hist, lens, row_b,
                        jnp.asarray(t, jnp.int32))

    enc = rnnt_encode(model, params, feats, n_frames)
    B = feats.shape[0]
    nf = np.asarray(n_frames)
    T = int(nf.max()) if B else 0
    H_pad = B * beam_size
    beams: List[Dict[Tuple[int, ...], float]] = [{(): 0.0} for _ in range(B)]

    hist = np.full((H_pad, u_cap), -1, np.int32)
    lens = np.zeros(H_pad, np.int32)
    row_b = np.zeros(H_pad, np.int32)

    for t in range(T):
        active = [b for b in range(B) if t < nf[b]]
        A: Dict[int, Dict[Tuple[int, ...], float]] = {
            b: dict(beams[b]) for b in active}
        done: Dict[int, Dict[Tuple[int, ...], float]] = {
            b: {} for b in active}
        for _round in range(max_symbols_per_frame + 1):
            flat = [(b, p) for b in active for p in A[b]]
            if not flat:
                break
            H = len(flat)
            hist[:H] = -1
            for i, (b, p) in enumerate(flat):
                hist[i, : len(p)] = p
                lens[i] = len(p)
                row_b[i] = b
            # float64 host accumulation: the per-utterance reference's
            # score dicts promote to f64 after the first round (NEP-50:
            # python-float init + np.f32 logp -> f64), so matching ranked
            # lists on LONG utterances needs the same precision here
            logp = np.asarray(round_logp(
                enc, jnp.asarray(hist), jnp.asarray(lens),
                jnp.asarray(row_b), t))[:H].astype(np.float64)
            scores = np.asarray([A[b][p] for b, p in flat], np.float64)
            # blank: finish the frame
            bl = scores + logp[:, blank]
            for i, (b, p) in enumerate(flat):
                d = done[b]
                d[p] = np.logaddexp(d[p], bl[i]) if p in d else bl[i]
            if _round == max_symbols_per_frame:
                break
            # labels: per-row top-K children (exact — children are distinct)
            lab = scores[:, None] + logp[:, :blank]        # [H, blank]
            K = min(beam_size, blank)
            top_idx = np.argpartition(-lab, K - 1, axis=1)[:, :K]
            top_val = np.take_along_axis(lab, top_idx, axis=1)
            new_A: Dict[int, Dict[Tuple[int, ...], float]] = {
                b: {} for b in active}
            for i, (b, p) in enumerate(flat):
                if len(p) >= u_cap:
                    continue
                na = new_A[b]
                for v, s in zip(top_idx[i], top_val[i]):
                    na[p + (int(v),)] = float(s)
            for b in active:
                cands = new_A[b]
                if done[b]:
                    thresh = max(done[b].values())
                    cands = {p: s for p, s in cands.items()
                             if s > thresh - 10.0}
                A[b] = dict(
                    sorted(cands.items(), key=lambda kv: -kv[1])[:beam_size])
        for b in active:
            beams[b] = dict(
                sorted(done[b].items(), key=lambda kv: -kv[1])[:beam_size])
    return [
        sorted(((s, list(p)) for p, s in beams[b].items()),
               key=lambda x: -x[0])
        for b in range(B)
    ]


# --------------------------------------------------------------------------
# Fully on-device batched beam search (round 5)
# --------------------------------------------------------------------------


def rnnt_fusion_matrix(model: RnntModel, unit_lm, weight: float) -> jax.Array:
    """On-device shallow-fusion table for the RNN-T beams: a
    [V_lab + 1, V_lab] matrix whose (prev_label, label) entry is the
    weighted unit-bigram log-prob; row V_lab is the sentence-initial
    distribution (empty prefix). Blank is NOT a column: fusion applies
    exactly once per label extension, matching the per-utterance
    ``ext_score`` hook's telescoping semantics (the RNN-T twin of
    mogasr.am.aed.aed_fusion_matrix)."""
    V = model.n_labels
    assert unit_lm.n_units == V, (
        f"unit LM vocabulary ({unit_lm.n_units}) != RNN-T labels ({V})")
    m = np.zeros((V + 1, V), np.float32)
    m[:V, :] = weight * unit_lm.pair_logp
    m[V, :] = weight * unit_lm.init_logp
    return jnp.asarray(m)


@functools.lru_cache(maxsize=16)
def _beam_device_fn(
    model: RnntModel,
    beam_size: int,
    max_symbols_per_frame: int,
    u_cap: int,
    has_fusion: bool,
    has_bias: bool,
):
    """Cached jitted (params, feats, n_frames, fusion, bias_next,
    bias_delta) -> (hists, lens, scores) beam scan. Params and the
    fusion/bias tables are ARGUMENTS so one compile serves parameter
    updates (the MWER loop regenerates N-best against CURRENT params
    every step) and any table contents; the static cache key is (model,
    sizes, which hooks exist)."""
    return _make_beam_device_core(
        model, beam_size, max_symbols_per_frame, u_cap, has_fusion,
        has_bias)


def make_rnnt_beam_device(
    model: RnntModel,
    params,
    beam_size: int = 4,
    max_symbols_per_frame: int = 4,
    u_cap: int = 200,
    fusion: Optional[jax.Array] = None,      # [V+1, V] rnnt_fusion_matrix
    bias_next: Optional[np.ndarray] = None,  # [S, V] CompiledBiaser tables
    bias_delta: Optional[np.ndarray] = None,
):
    """Bind params/tables over the cached scan: -> decode(feats,
    n_frames). See _beam_device_fn; full design notes below."""
    fn = _beam_device_fn(
        model, int(beam_size), int(max_symbols_per_frame), int(u_cap),
        fusion is not None, bias_next is not None)
    f_arr = (jnp.asarray(fusion) if fusion is not None
             else jnp.zeros((1, 1), jnp.float32))
    bn_arr = (jnp.asarray(bias_next, jnp.int32) if bias_next is not None
              else jnp.zeros((1, 1), jnp.int32))
    bd_arr = (jnp.asarray(bias_delta, jnp.float32)
              if bias_delta is not None else jnp.zeros((1, 1), jnp.float32))

    def decode(feats, n_frames):
        return fn(params, feats, n_frames, f_arr, bn_arr, bd_arr)

    return decode


def _make_beam_device_core(
    model: RnntModel,
    beam_size: int,
    max_symbols_per_frame: int,
    u_cap: int,
    has_fusion: bool,
    has_bias: bool,
):
    """ONE-dispatch monotonic RNN-T beam search for a whole batch.

    The quality-critical decode mode (N-best for MWER, fusion, biasing)
    was the measured serving gap: the host-orchestrated beams pay one
    synchronized device call per (frame, expansion round), so they are
    bound by the dispatch floor regardless of model size. Here the ENTIRE search — encoder, per-frame
    expansion rounds, blank/label splitting, prefix merging, threshold
    pruning, top-K — is a single jitted `lax.scan` over frames:

    - the in-frame hypothesis set A lives in fixed [B, K, ...] buffers
      (history, length, score, per-hypothesis prediction-net carry/output,
      bias-automaton node), with dead rows at -inf;
    - each of the ``max_symbols_per_frame + 1`` rounds runs ONE batched
      joint over all B*K hypotheses; label children take a global
      top-K over the [K*V] candidates (exact: within-round children are
      distinct, see rnnt_beam_decode_batch) and step the prediction net
      once for the K winners (gather-by-parent, like the greedy scan);
    - blank children are merged into a fixed [B, K*(R+1)] `done` buffer by
      EXACT prefix comparison + logaddexp (the reference's dict merge,
      vectorized: each insert compares against all slots at once), and the
      reference's done-threshold prune (> max(done) - 10) uses the merged
      running max, matching the per-utterance order of operations;
    - frame end takes top-K of merged `done` as the next frame's A; rows
      past ``n_frames`` are inert (masked carry-through).

    Shallow fusion and contextual biasing are row-gathers against
    precomputed tables (`rnnt_fusion_matrix`,
    mogasr.decoder.biasing.CompiledBiaser), so the batched quality path no
    longer falls back to per-utterance decoding.

    Numerics: scores accumulate in device f32 (the per-utterance reference
    accumulates the same f32 joint log-probs in host f64), so ranked lists
    are exact-tested on short utterances and tolerance-contracted on long
    ones (tests/test_rnnt_device_beam.py).

    Returns a jitted ``(feats [B,T,D], n_frames [B]) ->
    (hists [B,K,u_cap], lens [B,K], scores [B,K])`` best-first; rows with
    score <= NEG_INF/2 are dead (fewer than K survivors).
    """
    K = int(beam_size)
    R = int(max_symbols_per_frame)
    V = model.n_labels
    blank = V
    sos = V
    Kd = K * (R + 1)
    NEG_HALF = NEG_INF / 2
    step_cls = (RnntPredictionStep if model.pred_arch == "lstm"
                else RnntPredictionStatelessStep)
    pred_step_def = step_cls(model.n_labels, hidden=model.pred_hidden)
    joint_def = RnntJoint(model.n_labels, hidden=model.joint_hidden)
    cols = jnp.arange(u_cap)

    def _insert_done(done, ch, cl, cs, cp, cc, cb):
        """Merge ONE blank-finished candidate per batch row into `done`
        (exact prefix compare + logaddexp; insert at the next free slot
        otherwise). All [B]-vectorized."""
        dh, dl, ds, dcnt, dp, dc, db = done
        B = ch.shape[0]
        valid_slot = ds > NEG_HALF
        same = (dh == ch[:, None, :]) | (cols[None, None, :] >= cl[:, None, None])
        eq = (dl == cl[:, None]) & valid_slot & same.all(-1)
        has = eq.any(1)
        pos = jnp.where(has, jnp.argmax(eq, axis=1), dcnt)
        cvalid = cs > NEG_HALF
        onehot = (jnp.arange(Kd)[None, :] == pos[:, None]) & cvalid[:, None]
        merged = jnp.where(
            has, jnp.logaddexp(
                jnp.take_along_axis(ds, pos[:, None], 1)[:, 0], cs), cs)
        ds = jnp.where(onehot, merged[:, None], ds)
        dh = jnp.where(onehot[..., None], ch[:, None, :], dh)
        dl = jnp.where(onehot, cl[:, None], dl)
        dp = jnp.where(onehot[..., None], cp[:, None, :], dp)
        dc = jax.tree_util.tree_map(
            lambda d, c: jnp.where(
                onehot.reshape((B, Kd) + (1,) * (c.ndim - 1)),
                c[:, None], d),
            dc, cc)
        if has_bias:
            db = jnp.where(onehot, cb[:, None], db)
        dcnt = dcnt + (cvalid & ~has).astype(jnp.int32)
        return dh, dl, ds, dcnt, dp, dc, db

    @jax.jit
    def decode(params, feats: jax.Array, n_frames: jax.Array,
               fusion_arr=None, bn_arr=None, bd_arr=None):
        pred_params = {"params": params["params"]["prediction"]}
        joint_params = {"params": params["params"]["joint"]}
        enc = rnnt_encode(model, params, feats, n_frames)   # [B, T, He]
        B, T = enc.shape[0], enc.shape[1]

        # initial beam: row 0 = empty prefix at 0.0; rows 1.. dead
        hist0 = jnp.full((B, K, u_cap), -1, jnp.int32)
        lens0 = jnp.zeros((B, K), jnp.int32)
        score0 = jnp.full((B, K), NEG_INF).at[:, 0].set(0.0)
        if model.pred_arch == "lstm":
            cell = nn.OptimizedLSTMCell(model.pred_hidden)
            carry0 = cell.initialize_carry(jax.random.key(0), (B * K, 1))
        else:
            carry0 = jnp.zeros((B * K, 1))
        carry0, pred0 = pred_step_def.apply(
            pred_params, jnp.full((B * K,), sos, jnp.int32), carry0)
        bn0 = jnp.zeros((B, K), jnp.int32)
        Hp = pred0.shape[-1]

        def frame_step(st, inputs):
            hist, lens, score, carry, pred, bnode = st
            # frame-entry snapshot: inactive rows (t >= n_frames) must
            # carry THIS state through, not the round-mutated locals
            hist_in, lens_in, score_in = hist, lens, score
            carry_in, pred_in, bnode_in = carry, pred, bnode
            enc_t, t = inputs                      # [B, He]
            active = t < n_frames                  # [B]
            done = (
                jnp.full((B, Kd, u_cap), -1, jnp.int32),
                jnp.zeros((B, Kd), jnp.int32),
                jnp.full((B, Kd), NEG_INF),
                jnp.zeros((B,), jnp.int32),
                jnp.zeros((B, Kd, Hp)),
                jax.tree_util.tree_map(
                    lambda x: jnp.zeros((B, Kd) + x.shape[1:], x.dtype),
                    carry),
                jnp.zeros((B, Kd), jnp.int32),
            )
            enc_rep = jnp.repeat(enc_t, K, axis=0)          # [B*K, He]
            for r in range(R + 1):
                logits = joint_def.apply(
                    joint_params, enc_rep[:, None, :], pred[:, None, :]
                )[:, 0, 0, :].reshape(B, K, V + 1)
                logp = jax.nn.log_softmax(logits, axis=-1)
                bl = score + logp[..., blank]               # [B, K]
                for k in range(K):
                    cand_carry = jax.tree_util.tree_map(
                        lambda x: x.reshape((B, K) + x.shape[1:])[:, k],
                        carry)
                    done = _insert_done(
                        done, hist[:, k], lens[:, k], bl[:, k],
                        pred.reshape(B, K, Hp)[:, k], cand_carry,
                        bnode[:, k])
                if r == R:
                    break
                lab = score[..., None] + logp[..., :V]      # [B, K, V]
                if has_fusion:
                    last = jnp.where(
                        lens > 0,
                        jnp.take_along_axis(
                            hist, jnp.maximum(lens - 1, 0)[..., None],
                            axis=2)[..., 0],
                        V)
                    lab = lab + fusion_arr[last]
                if has_bias:
                    lab = lab + bd_arr[bnode]
                lab = jnp.where(lens[..., None] >= u_cap, NEG_INF, lab)
                lab = jnp.where(score[..., None] < NEG_HALF, NEG_INF, lab)
                top_val, top_idx = jax.lax.top_k(lab.reshape(B, K * V), K)
                dmax = done[2].max(axis=1)                  # merged running max
                top_val = jnp.where(
                    top_val > dmax[:, None] - 10.0, top_val, NEG_INF)
                parent = top_idx // V
                lab_id = (top_idx % V).astype(jnp.int32)
                live = top_val > NEG_HALF
                hist = jnp.take_along_axis(hist, parent[..., None], axis=1)
                plen = jnp.take_along_axis(lens, parent, axis=1)
                at = jnp.clip(plen, 0, u_cap - 1)
                hist = jnp.where(
                    (cols[None, None, :] == at[..., None]) & live[..., None],
                    lab_id[..., None], hist)
                lens = plen + live.astype(jnp.int32)
                flat_parent = (
                    jnp.arange(B)[:, None] * K + parent).reshape(-1)
                carry = jax.tree_util.tree_map(
                    lambda x: x[flat_parent], carry)
                label_in = jnp.where(live, lab_id, sos).reshape(-1)
                carry, pred = pred_step_def.apply(
                    pred_params, label_in, carry)
                score = top_val
                if has_bias:
                    bnode = bn_arr[
                        jnp.take_along_axis(bnode, parent, axis=1), lab_id]

            # frame end: next A = top-K of the merged done set
            dh, dl, ds, _dcnt, dp, dc, db = done
            nsc, nidx = jax.lax.top_k(ds, K)
            nhist = jnp.take_along_axis(dh, nidx[..., None], axis=1)
            nlen = jnp.take_along_axis(dl, nidx, axis=1)
            npred = jnp.take_along_axis(dp, nidx[..., None], axis=1)
            ncarry = jax.tree_util.tree_map(
                lambda x: jnp.take_along_axis(
                    x, nidx.reshape((B, K) + (1,) * (x.ndim - 2)), axis=1
                ).reshape((B * K,) + x.shape[2:]),
                dc)
            nbn = (jnp.take_along_axis(db, nidx, axis=1) if has_bias
                   else bnode)

            def mix(new, old, bvec=active):
                return jnp.where(
                    bvec.reshape((-1,) + (1,) * (new.ndim - 1)), new, old)

            a_flat = jnp.repeat(active, K)
            return (
                mix(nhist, hist_in), mix(nlen, lens_in), mix(nsc, score_in),
                jax.tree_util.tree_map(
                    lambda n, o: mix(n, o, a_flat), ncarry, carry_in),
                mix(npred.reshape(B * K, Hp), pred_in, a_flat),
                mix(nbn, bnode_in),
            ), None

        st0 = (hist0, lens0, score0, carry0, pred0, bn0)
        (hist, lens, score, _c, _p, _b), _ = jax.lax.scan(
            frame_step, st0,
            (jnp.transpose(enc, (1, 0, 2)), jnp.arange(T)))
        return hist, lens, score

    return decode


def rnnt_beam_decode_device(
    model: RnntModel,
    params,
    feats,
    n_frames,
    beam_size: int = 4,
    max_symbols_per_frame: int = 4,
    u_cap: int = 200,
    fusion: Optional[jax.Array] = None,
    bias_next: Optional[np.ndarray] = None,
    bias_delta: Optional[np.ndarray] = None,
) -> List[List[Tuple[float, List[int]]]]:
    """Host wrapper over make_rnnt_beam_device with the same return shape
    as rnnt_beam_decode_batch: per utterance, [(logp, labels)] best-first.
    The jitted scan is cached per (model, sizes, hooks) — params are a
    jit ARGUMENT, so repeated calls (and parameter updates) reuse one
    compile."""
    dec = make_rnnt_beam_device(
        model, params, beam_size, max_symbols_per_frame, u_cap,
        fusion=fusion, bias_next=bias_next, bias_delta=bias_delta)
    hist, lens, score = dec(jnp.asarray(feats), jnp.asarray(n_frames))
    hist, lens, score = (np.asarray(hist), np.asarray(lens),
                         np.asarray(score))
    out: List[List[Tuple[float, List[int]]]] = []
    for b in range(hist.shape[0]):
        row = []
        for k in range(hist.shape[1]):
            if score[b, k] <= NEG_INF / 2:
                continue
            row.append((float(score[b, k]),
                        [int(x) for x in hist[b, k, : lens[b, k]]]))
        out.append(row)
    return out


# --------------------------------------------------------------------------
# MWER fine-tuning (expected edit-distance over the beam N-best) — the
# transducer twin of mogasr.am.aed's MWER: the sequence log-probability is
# the transducer forward marginal over ALL alignments (-rnnt_loss), so no
# teacher-forced path choice is needed.
# --------------------------------------------------------------------------


def rnnt_seq_logprob(model: RnntModel, params, feats, n_frames, hyps, n_hyp):
    """log P(hyp | x) marginalized over alignments: -rnnt_loss of the
    hypothesis as the label sequence. feats [R, T, D] rows pair with
    hyps [R, U] (-1-padded), n_hyp [R]. Returns [R]."""
    logits = model.apply(params, feats, n_frames, hyps)
    return -rnnt_loss(logits, n_frames, hyps, n_hyp)


def rnnt_mwer_objective(
    model: RnntModel,
    params,
    feats,
    n_frames,
    hyps,          # [B, N, U] int32, -1-padded
    n_hyp,         # [B, N]
    hyp_mask,      # [B, N] bool — False: empty/duplicate slot
    risks,         # [B, N] float
    labels,        # [B, L] reference targets (anchor)
    n_labels,      # [B]
    anchor_weight: float = 0.1,
    ctc_weight: float = 1.0,
):
    """Expected risk over the renormalized N-best (see aed_mwer_objective
    for the estimator; identical math, transducer sequence probabilities)
    plus anchor_weight * the standard transducer objective on the
    references."""
    B, N, U = hyps.shape
    feats_r = jnp.repeat(feats, N, axis=0)
    nfr = jnp.repeat(n_frames, N, axis=0)
    seq_lp = rnnt_seq_logprob(
        model, params, feats_r, nfr,
        hyps.reshape(B * N, U), n_hyp.reshape(B * N),
    ).reshape(B, N)
    seq_lp = jnp.where(hyp_mask, seq_lp, NEG_INF)
    phat = jax.nn.softmax(seq_lp, axis=1)
    n_valid = jnp.maximum(jnp.sum(hyp_mask, axis=1), 1)
    rbar = jnp.sum(jnp.where(hyp_mask, risks, 0.0), axis=1) / n_valid
    row_risk = jnp.sum(phat * jnp.where(hyp_mask, risks, 0.0), axis=1)
    row_ok = (n_frames > 0) & jnp.any(hyp_mask, axis=1)
    denom = jnp.maximum(jnp.sum(row_ok), 1)
    mwer = jnp.sum(jnp.where(row_ok, row_risk - rbar, 0.0)) / denom
    exp_risk = jnp.sum(jnp.where(row_ok, row_risk, 0.0)) / denom
    metrics = {"mwer": mwer, "expected_risk": exp_risk}
    loss = mwer
    if anchor_weight > 0.0:
        anchor, _ = rnnt_objective(
            model, params, feats, n_frames, labels, n_labels, ctc_weight
        )
        loss = loss + anchor_weight * anchor
        metrics["anchor"] = anchor
    metrics["loss"] = loss
    return loss, metrics


def make_rnnt_mwer_step(
    model: RnntModel, cfg: TrainConfig, anchor_weight: float = 0.1,
    ctc_weight: float = 1.0,
):
    """Jitted MWER step — N-best generation and risks stay on the host
    (pipeline.finetune_rnnt_mwer uses rnnt_beam_decode per utterance)."""
    from mogasr.am.train_nn import make_optimizer

    opt = make_optimizer(cfg)

    @jax.jit
    def step(state, feats, n_frames, hyps, n_hyp, hyp_mask, risks,
             labels, n_labels):
        def loss_fn(p):
            return rnnt_mwer_objective(
                model, p, feats, n_frames, hyps, n_hyp, hyp_mask, risks,
                labels, n_labels, anchor_weight=anchor_weight,
                ctc_weight=ctc_weight,
            )

        (_, metrics), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            state.params
        )
        updates, opt_state = opt.update(grads, state.opt_state, state.params)
        params = optax.apply_updates(state.params, updates)
        return RnntTrainState(params, opt_state, state.step + 1), metrics

    return step
