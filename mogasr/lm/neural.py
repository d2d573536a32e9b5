"""Neural language models (LSTM + causal Transformer): training, perplexity,
batched N-best rescoring.

The count-based models in lm/ngram.py cover first-pass decoding and exact
lattice rescoring (bounded context); this module adds the unbounded-context
neural LM used as a SECOND pass: extract N-best from the lattice, score every
hypothesis with the RNN-LM, and log-linearly interpolate with the first-pass
score (the standard two-pass neural rescoring recipe).

Device design: the whole N-best batch is scored in ONE jitted device call
— embedding + ``nn.RNN`` (a ``lax.scan`` over tokens) + dense — with static
padded shapes, rather than a per-hypothesis host loop. Training reuses the
repo's optimizer/config conventions (mogasr.am.train_nn.make_optimizer).

No reference file can be cited (SURVEY.md §0: /root/reference is empty);
the capability is the neural counterpart of lm/ngram.py's n-gram models.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from flax import linen as nn

from mogasr.config import TrainConfig


# --------------------------------------------------------------------------
# Vocabulary
# --------------------------------------------------------------------------


class LmVocab(NamedTuple):
    """Token inventory with reserved <s>/</s>/<unk> ids at the end."""

    tokens: Tuple[str, ...]  # regular tokens only (specials are implicit)

    @property
    def n_tokens(self) -> int:
        return len(self.tokens) + 3  # + bos, eos, unk

    @property
    def bos(self) -> int:
        return len(self.tokens)

    @property
    def eos(self) -> int:
        return len(self.tokens) + 1

    @property
    def unk(self) -> int:
        return len(self.tokens) + 2

    def encode(self, words: Sequence[str]) -> List[int]:
        idx = _index_cache(self)
        return [idx.get(w.lower(), self.unk) for w in words]


_INDEX_CACHE: Dict[int, Dict[str, int]] = {}


def _index_cache(vocab: LmVocab) -> Dict[str, int]:
    key = id(vocab.tokens)
    if key not in _INDEX_CACHE:
        _INDEX_CACHE[key] = {t: i for i, t in enumerate(vocab.tokens)}
    return _INDEX_CACHE[key]


def vocab_from_transcripts(transcripts: Sequence[Sequence[str]]) -> LmVocab:
    toks = sorted({w.lower() for s in transcripts for w in s})
    return LmVocab(tuple(toks))


# --------------------------------------------------------------------------
# Model
# --------------------------------------------------------------------------


class NeuralLm(nn.Module):
    """Token-level LSTM LM: P(w_u | w_<u). Input is [B, U] ids starting with
    <s>; output is next-token logits [B, U, V]."""

    n_tokens: int
    embed: int = 64
    hidden: int = 128
    layers: int = 1

    @nn.compact
    def __call__(self, tokens_in: jax.Array, n_tokens: jax.Array) -> jax.Array:
        x = nn.Embed(self.n_tokens, self.embed)(tokens_in)
        for _ in range(self.layers):
            x = nn.RNN(nn.OptimizedLSTMCell(self.hidden))(
                x, seq_lengths=n_tokens
            )
        return nn.Dense(self.n_tokens)(x)


class TransformerLm(nn.Module):
    """Causal Transformer LM: same (tokens_in [B,U], n_tokens [B]) -> logits
    [B,U,V] contract as NeuralLm, so every scorer/trainer/rescoring path is
    shared. More accelerator-idiomatic than the LSTM: each layer is a handful of
    batched GEMMs parallel over ALL positions (matrix-unit-saturating) instead of a
    U-step ``lax.scan`` whose per-token matmul is too small to fill the matrix units.

    Padding needs no extra mask: ``lm_batch`` pads strictly AFTER the valid
    prefix, so the causal mask already hides every padded key from every
    valid query (scores at padded QUERY positions are garbage but are
    excluded from the loss/score by ``n_tokens`` like in the LSTM path)."""

    n_tokens: int
    embed: int = 64        # model width
    hidden: int = 128      # FFN width
    layers: int = 2
    heads: int = 4
    max_len: int = 512     # positional-embedding capacity

    @nn.compact
    def __call__(self, tokens_in: jax.Array, n_tokens: jax.Array) -> jax.Array:
        B, U = tokens_in.shape
        D, H = self.embed, self.heads
        hd = D // H
        x = nn.Embed(self.n_tokens, D)(tokens_in)
        x = x + nn.Embed(self.max_len, D)(jnp.arange(U))[None]
        causal = jnp.tril(jnp.ones((U, U), bool))
        for _ in range(self.layers):
            h = nn.LayerNorm()(x)
            q = nn.Dense(D, use_bias=False)(h).reshape(B, U, H, hd)
            k = nn.Dense(D, use_bias=False)(h).reshape(B, U, H, hd)
            v = nn.Dense(D, use_bias=False)(h).reshape(B, U, H, hd)
            logits = jnp.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(hd)
            logits = jnp.where(causal[None, None], logits, -1e30)
            att = jnp.einsum("bhqk,bkhd->bqhd", jax.nn.softmax(logits), v)
            x = x + nn.Dense(D)(att.reshape(B, U, D))
            h = nn.LayerNorm()(x)
            x = x + nn.Dense(D)(nn.gelu(nn.Dense(self.hidden)(h)))
        return nn.Dense(self.n_tokens)(nn.LayerNorm()(x))


def build_nnlm(vocab: LmVocab, cfg: TrainConfig, arch: str = "lstm"):
    """arch="lstm" (NeuralLm) or "transformer" (TransformerLm); both share
    the (tokens_in, n_tokens) -> logits contract and all downstream code."""
    if arch == "transformer":
        return TransformerLm(
            n_tokens=vocab.n_tokens,
            embed=max(cfg.nn_hidden // 2, 16),
            hidden=cfg.nn_hidden,
            layers=cfg.nn_layers,
        )
    if arch != "lstm":
        raise ValueError(f"unknown nnlm arch: {arch!r}")
    return NeuralLm(
        n_tokens=vocab.n_tokens,
        embed=max(cfg.nn_hidden // 2, 8),
        hidden=cfg.nn_hidden,
        layers=cfg.nn_layers,
    )


# --------------------------------------------------------------------------
# Batching (host): [<s>, w1..wn] -> targets [w1..wn, </s>]
# --------------------------------------------------------------------------


def lm_batch(
    seqs: Sequence[Sequence[int]], vocab: LmVocab, u_max: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pad to a STATIC u_max (one compile across batches): returns
    (inp [B, u_max], tgt [B, u_max], n [B]) with n = len(seq) + 1 (eos is a
    real prediction target). Sequences longer than u_max - 1 are truncated."""
    B = len(seqs)
    inp = np.full((B, u_max), vocab.eos, np.int32)
    tgt = np.full((B, u_max), vocab.eos, np.int32)
    n = np.zeros(B, np.int32)
    for b, s in enumerate(seqs):
        s = list(s)[: u_max - 1]
        inp[b, 0] = vocab.bos
        inp[b, 1 : 1 + len(s)] = s
        tgt[b, : len(s)] = s
        tgt[b, len(s)] = vocab.eos
        n[b] = len(s) + 1
    return inp, tgt, n


# --------------------------------------------------------------------------
# Scoring and training
# --------------------------------------------------------------------------


def make_nnlm_scorer(model: NeuralLm, params):
    """Jitted batched sequence scorer: (inp, tgt, n) -> total logp [B]."""

    @jax.jit
    def score(inp, tgt, n):
        logits = model.apply(params, inp, n)
        logp = jax.nn.log_softmax(logits)
        tok_lp = jnp.take_along_axis(logp, tgt[..., None], axis=-1)[..., 0]
        mask = jnp.arange(tgt.shape[1])[None, :] < n[:, None]
        return jnp.sum(tok_lp * mask, axis=1)

    return score


class NnlmTrainState(NamedTuple):
    params: Any
    opt_state: Any
    step: jax.Array


def init_nnlm_train_state(
    model: NeuralLm, cfg: TrainConfig, key
) -> NnlmTrainState:
    from mogasr.am.train_nn import make_optimizer

    inp = jnp.zeros((2, 4), jnp.int32)
    params = model.init(key, inp, jnp.asarray([4, 4]))
    opt = make_optimizer(cfg)
    return NnlmTrainState(params, opt.init(params), jnp.zeros((), jnp.int32))


def make_nnlm_train_step(model: NeuralLm, cfg: TrainConfig):
    import optax

    from mogasr.am.train_nn import make_optimizer

    opt = make_optimizer(cfg)

    @jax.jit
    def train_step(state: NnlmTrainState, inp, tgt, n):
        def loss_fn(p):
            logits = model.apply(p, inp, n)
            logp = jax.nn.log_softmax(logits)
            tok_lp = jnp.take_along_axis(logp, tgt[..., None], axis=-1)[..., 0]
            mask = (jnp.arange(tgt.shape[1])[None, :] < n[:, None]).astype(
                jnp.float32
            )
            nll = -jnp.sum(tok_lp * mask)
            return nll / jnp.maximum(jnp.sum(mask), 1.0)

        loss, grads = jax.value_and_grad(loss_fn)(state.params)
        updates, opt_state = opt.update(grads, state.opt_state, state.params)
        params = optax.apply_updates(state.params, updates)
        return NnlmTrainState(params, opt_state, state.step + 1), {"loss": loss}

    return train_step


def train_nnlm(
    transcripts: Sequence[Sequence[str]],
    vocab: LmVocab,
    cfg: TrainConfig,
    batch_size: int = 64,
    seed: int = 0,
    arch: str = "lstm",
    logger=None,
) -> Tuple[Any, Any]:
    """Train the neural LM (LSTM or causal Transformer) on word transcripts
    for cfg.num_nn_steps steps.

    All batches pad to one global u_max so the step compiles exactly once."""
    model = build_nnlm(vocab, cfg, arch=arch)
    state = init_nnlm_train_state(model, cfg, jax.random.key(seed))
    step_fn = make_nnlm_train_step(model, cfg)

    seqs = [vocab.encode(s) for s in transcripts]
    u_max = max(len(s) for s in seqs) + 1
    rng = np.random.default_rng(seed)
    for i in range(cfg.num_nn_steps):
        pick = rng.integers(0, len(seqs), size=min(batch_size, len(seqs)))
        inp, tgt, n = lm_batch([seqs[j] for j in pick], vocab, u_max)
        state, m = step_fn(
            state, jnp.asarray(inp), jnp.asarray(tgt), jnp.asarray(n)
        )
        if logger is not None and (i % 50 == 0 or i == cfg.num_nn_steps - 1):
            logger.log({"stage": "train_nnlm", "step": i, "loss": float(m["loss"])})
    return model, jax.block_until_ready(state.params)


def nnlm_perplexity(
    model: NeuralLm, params, vocab: LmVocab,
    transcripts: Sequence[Sequence[str]],
) -> float:
    """Held-out per-token perplexity (eos counts as a token, as in training)."""
    seqs = [vocab.encode(s) for s in transcripts]
    u_max = max(len(s) for s in seqs) + 1
    inp, tgt, n = lm_batch(seqs, vocab, u_max)
    lp = make_nnlm_scorer(model, params)(
        jnp.asarray(inp), jnp.asarray(tgt), jnp.asarray(n)
    )
    return float(np.exp(-np.sum(np.asarray(lp)) / np.sum(n)))


# --------------------------------------------------------------------------
# N-best rescoring
# --------------------------------------------------------------------------


def rescore_nbest_nnlm(
    model: NeuralLm,
    params,
    vocab: LmVocab,
    nbest: Sequence[Sequence[Tuple[Sequence[str], float]]],
    weight: float = 0.5,
    u_max: Optional[int] = None,
) -> List[List[Tuple[List[str], float]]]:
    """Rescore per-utterance N-best lists [(words, first_pass_logp), ...].

    combined = first_pass_logp + weight * nnlm_logp (log-linear two-pass
    interpolation). ALL hypotheses of ALL utterances are scored in one
    padded device batch; returns each list re-sorted by combined score."""
    flat: List[Tuple[int, List[str], float]] = []
    for u, lst in enumerate(nbest):
        for words, lp in lst:
            flat.append((u, [w.lower() for w in words], float(lp)))
    if not flat:
        return [[] for _ in nbest]
    seqs = [vocab.encode(words) for _, words, _ in flat]
    if u_max is None:
        u_max = max(len(s) for s in seqs) + 1
    inp, tgt, n = lm_batch(seqs, vocab, u_max)
    lm_lp = np.asarray(
        make_nnlm_scorer(model, params)(
            jnp.asarray(inp), jnp.asarray(tgt), jnp.asarray(n)
        )
    )
    out: List[List[Tuple[List[str], float]]] = [[] for _ in nbest]
    for (u, words, lp), nlp in zip(flat, lm_lp):
        out[u].append((words, lp + weight * float(nlp)))
    for lst in out:
        lst.sort(key=lambda x: -x[1])
    return out


# --------------------------------------------------------------------------
# Save / load
# --------------------------------------------------------------------------


def save_nnlm(ckpt_dir: str, model, params, vocab: LmVocab) -> None:
    from mogasr.utils.checkpoint import save_checkpoint

    os.makedirs(ckpt_dir, exist_ok=True)
    with open(os.path.join(ckpt_dir, "nnlm.json"), "w") as f:
        json.dump(
            {
                "tokens": list(vocab.tokens),
                "arch": ("transformer" if isinstance(model, TransformerLm)
                         else "lstm"),
                "embed": model.embed,
                "hidden": model.hidden,
                "layers": model.layers,
            },
            f,
        )
    save_checkpoint(os.path.join(ckpt_dir, "ckpt"), {"params": params}, step=0)


def load_nnlm(ckpt_dir: str) -> Tuple[Any, Any, LmVocab]:
    from mogasr.utils.checkpoint import restore_checkpoint

    with open(os.path.join(ckpt_dir, "nnlm.json")) as f:
        meta = json.load(f)
    vocab = LmVocab(tuple(meta["tokens"]))
    cls = (TransformerLm if meta.get("arch", "lstm") == "transformer"
           else NeuralLm)
    model = cls(
        n_tokens=vocab.n_tokens,
        embed=meta["embed"],
        hidden=meta["hidden"],
        layers=meta["layers"],
    )
    template = {
        "params": model.init(
            jax.random.key(0), jnp.zeros((2, 4), jnp.int32), jnp.asarray([4, 4])
        )
    }
    ck = restore_checkpoint(os.path.join(ckpt_dir, "ckpt"), template)
    return model, ck["params"], vocab
