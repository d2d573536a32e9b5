"""Prefused LSTM forward: the GEMM-shaped evaluation of LstmAm checkpoints.

The stock ``nn.RNN(nn.OptimizedLSTMCell)`` scan computes BOTH matmuls per
frame — x_t @ W_i ([B,D]x[D,4H]) and h @ W_h ([B,H]x[H,4H]). At serving
batch sizes these per-step GEMMs are far too small to fill the matrix units, and the
input half does not even depend on the recurrence. This module evaluates
the SAME checkpoint by hoisting the input projection of ALL frames into a
single [B·T, D] x [D, 4H] GEMM per layer (matrix-unit-saturating, fused by XLA
with the surrounding elementwise work) and scanning only the irreducibly
sequential recurrent half — about half the scan FLOPs, and the other half
moved from latency-bound to throughput-bound execution.

Exactness: ``lstm_am_apply_prefused(params, feats, n_frames)`` consumes an
UNMODIFIED LstmAm parameter tree and reproduces ``LstmAm.apply`` logits on
valid frames to float tolerance (tested, incl. ragged batches); carries
freeze at each row's n_frames like flax's seq_lengths path, so padding
rows cannot contaminate state. Gate math mirrors flax's LSTMCell:
i/f/o = sigmoid, g = tanh, c' = f*c + i*g, h' = o*tanh(c').

Whether this path becomes the production default is a measurement question
on the card; it is exposed to benchmarks and scorers as
an opt-in first.
"""

from __future__ import annotations

from typing import Any, Optional

import jax
import jax.numpy as jnp


_IN_GATES = ("ii", "if", "ig", "io")
_REC_GATES = ("hi", "hf", "hg", "ho")


def _layer_keys(tree: dict) -> list:
    keys = sorted(
        (k for k in tree if k.startswith("OptimizedLSTMCell_")),
        key=lambda k: int(k.rsplit("_", 1)[1]),
    )
    if not keys:
        raise ValueError("not an LstmAm parameter tree (no LSTM cells)")
    return keys


def lstm_am_apply_prefused(
    params: Any,
    feats: jax.Array,      # [B, T, D]
    n_frames: jax.Array,   # [B]
) -> jax.Array:
    """Drop-in for ``LstmAm.apply(params, feats, n_frames)`` (same tree)."""
    p = params["params"]
    x = feats
    B, T = feats.shape[0], feats.shape[1]
    t_idx = jnp.arange(T)
    for key in _layer_keys(p):
        cp = p[key]
        w_in = jnp.concatenate([cp[g]["kernel"] for g in _IN_GATES], axis=1)
        w_rec = jnp.concatenate([cp[g]["kernel"] for g in _REC_GATES], axis=1)
        bias = jnp.concatenate([cp[g]["bias"] for g in _REC_GATES])
        H = w_rec.shape[0]
        # the hoisted input projection: one big GEMM over all frames
        xg = x @ w_in + bias                      # [B, T, 4H]

        def step(carry, inp, _w=w_rec, _H=H):
            c, h = carry
            xg_t, t = inp
            gates = xg_t + h @ _w                  # [B, 4H]
            i = jax.nn.sigmoid(gates[:, :_H])
            f = jax.nn.sigmoid(gates[:, _H:2 * _H])
            g = jnp.tanh(gates[:, 2 * _H:3 * _H])
            o = jax.nn.sigmoid(gates[:, 3 * _H:])
            c_new = f * c + i * g
            h_new = o * jnp.tanh(c_new)
            keep = (t < n_frames)[:, None]
            c2 = jnp.where(keep, c_new, c)
            h2 = jnp.where(keep, h_new, h)
            return (c2, h2), h2

        zeros = jnp.zeros((B, H), feats.dtype)
        _, x = jax.lax.scan(
            step, (zeros, zeros),
            (jnp.swapaxes(xg, 0, 1), t_idx),
        )
        x = jnp.swapaxes(x, 0, 1)                  # [B, T, H]
    d = p["Dense_0"]
    return x @ d["kernel"] + d["bias"]


def make_prefused_lstm_logits(params):
    """Jitted (feats, n_frames) -> logits closure over a fixed checkpoint."""

    @jax.jit
    def logits(feats, n_frames):
        return lstm_am_apply_prefused(params, feats, n_frames)

    return logits
