"""Quantized inference for the neural acoustic models: bf16 + dynamic int8.

The repo-wide precision policy (CLAUDE.md): parity-critical math runs
f32/HIGHEST; throughput paths may drop precision ONLY with
decode-decision-equivalence evidence.  This module supplies the dropped-
precision inference paths for the neural families:

- **bfloat16** (any Flax AM): cast float params + inputs to bf16 — the
  MXU-native mode; logits return as f32 so the downstream prior-scaled
  log-softmax and Viterbi stay exact.  Halves parameter HBM traffic and
  doubles MXU issue rate vs f32.
- **int8 (MLP + LSTM)**: weight kernels quantized per-OUTPUT-channel
  (symmetric, 127 levels — the scale folds into the existing per-channel
  epilogue), activations quantized dynamically per row; the GEMM runs
  int8 x int8 -> int32 via ``lax.dot_general(preferred_element_type=
  int32)``, which XLA lowers to the accelerator's int8 matrix path where it has
  one (4x f32 device-memory saving on weights).  For the LSTM the int8 GEMMs
  are the prefused input projections + output head (the bandwidth-bound
  bulk); the recurrence stays f32 (its error compounds over T and its
  small per-step GEMM is latency-bound — int8 buys nothing there).
  LayerNorm/bias/epilogue stay f32 — VPU work, numerically load-bearing.

Decode-decision equivalence is the shipping gate, not a hope:
tests/test_quantize.py trains a real frame classifier and requires the
quantized frame decisions and the decoded Viterbi paths to match f32.

No reference implementation exists for this capability (the
/root/reference mount is empty — SURVEY.md §0).
"""

from __future__ import annotations

from typing import Any, Dict

import jax
import jax.numpy as jnp

from mogasr.am.neural import MlpAm, splice_frames


# --------------------------------------------------------------------------
# bf16: generic over any Flax acoustic model
# --------------------------------------------------------------------------


def cast_float_leaves(tree: Any, dtype) -> Any:
    """Cast floating leaves to ``dtype``; integer leaves untouched."""
    return jax.tree.map(
        lambda x: x.astype(dtype)
        if jnp.issubdtype(jnp.asarray(x).dtype, jnp.floating) else x,
        tree,
    )


def make_bf16_logits(model, params):
    """Jitted (feats, n_frames) -> f32 logits with bf16 params/activations.

    Works for every AM family (MLP/LSTM/BLSTM/TDNN/Conformer): flax layers
    follow the input dtype; the cast params are closed over, so XLA
    constant-folds the conversion — zero runtime cast cost for weights.
    """
    p16 = cast_float_leaves(params, jnp.bfloat16)

    @jax.jit
    def logits(feats, n_frames):
        out = model.apply(p16, feats.astype(jnp.bfloat16), n_frames)
        return out.astype(jnp.float32)

    return logits


# --------------------------------------------------------------------------
# int8: per-channel weights, dynamic per-row activations
# --------------------------------------------------------------------------


def quantize_dense_int8(kernel: jax.Array):
    """(q int8 [din, dout], scale f32 [dout]): symmetric per-output-channel.

    Max-abs scaling to 127 levels; zero columns get scale 1 (q == 0)."""
    scale = jnp.max(jnp.abs(kernel), axis=0) / 127.0
    scale = jnp.where(scale > 0, scale, 1.0).astype(jnp.float32)
    q = jnp.clip(jnp.round(kernel / scale[None, :]), -127, 127).astype(
        jnp.int8
    )
    return q, scale


def int8_dynamic_dot(x: jax.Array, q: jax.Array, w_scale: jax.Array):
    """f32-equivalent of ``x @ kernel`` through the int8 MXU path.

    x [..., din] f32; activations quantized per ROW (dynamic max-abs — no
    calibration set needed), weights already int8 per-channel; the int32
    accumulator is rescaled by (row scale x channel scale)."""
    ax = jnp.max(jnp.abs(x), axis=-1, keepdims=True) / 127.0
    ax = jnp.where(ax > 0, ax, 1.0)
    xq = jnp.clip(jnp.round(x / ax), -127, 127).astype(jnp.int8)
    acc = jax.lax.dot_general(
        xq, q,
        (((x.ndim - 1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32,
    )
    return acc.astype(jnp.float32) * ax * w_scale


def quantize_mlp_int8(model: MlpAm, params) -> Dict[str, Any]:
    """Quantize an MlpAm checkpoint: Dense kernels -> int8 + scales;
    biases and LayerNorm affine stay f32."""
    p = params["params"]
    out: Dict[str, Any] = {}
    for name, leaf in p.items():
        if name.startswith("Dense_"):
            q, s = quantize_dense_int8(jnp.asarray(leaf["kernel"]))
            out[name] = {
                "q": q, "scale": s,
                "bias": jnp.asarray(leaf["bias"], jnp.float32),
            }
        else:
            out[name] = jax.tree.map(
                lambda x: jnp.asarray(x, jnp.float32), dict(leaf)
            )
    return out


def _layer_norm(x, scale, bias, eps=1e-6):
    mu = jnp.mean(x, axis=-1, keepdims=True)
    var = jnp.var(x, axis=-1, keepdims=True)
    return (x - mu) * jax.lax.rsqrt(var + eps) * scale + bias


def mlp_apply_int8(model: MlpAm, qparams, feats, n_frames):
    """Mirror of MlpAm.__call__ (am/neural.py:40-55) on quantized kernels:
    splice -> [int8 GEMM -> f32 LayerNorm -> relu] x layers -> int8 GEMM."""
    x = splice_frames(feats, n_frames, model.context)
    for i in range(model.layers):
        d = qparams[f"Dense_{i}"]
        x = int8_dynamic_dot(x, d["q"], d["scale"]) + d["bias"]
        ln = qparams[f"LayerNorm_{i}"]
        x = _layer_norm(x, ln["scale"], ln["bias"])
        x = jax.nn.relu(x)
    d = qparams[f"Dense_{model.layers}"]
    return int8_dynamic_dot(x, d["q"], d["scale"]) + d["bias"]


def quantize_lstm_int8(params) -> Dict[str, Any]:
    """Quantize an LstmAm checkpoint for the prefused forward
    (am/fast_lstm.py): the hoisted input-projection kernels [D, 4H] and the
    output Dense go int8 per-channel; the recurrent kernels, biases and
    gate math stay f32 (the recurrence integrates T steps — quantization
    error there compounds, and its small [B,H]x[H,4H] GEMM is latency-
    not bandwidth-bound, so int8 buys nothing)."""
    from mogasr.am.fast_lstm import _IN_GATES, _REC_GATES, _layer_keys

    p = params["params"]
    out: Dict[str, Any] = {"layers": []}
    for key in _layer_keys(p):
        cp = p[key]
        w_in = jnp.concatenate(
            [jnp.asarray(cp[g]["kernel"]) for g in _IN_GATES], axis=1
        )
        q, s = quantize_dense_int8(w_in)
        out["layers"].append({
            "q_in": q, "scale_in": s,
            "w_rec": jnp.concatenate(
                [jnp.asarray(cp[g]["kernel"], jnp.float32)
                 for g in _REC_GATES], axis=1
            ),
            "bias": jnp.concatenate(
                [jnp.asarray(cp[g]["bias"], jnp.float32)
                 for g in _REC_GATES]
            ),
        })
    d = p["Dense_0"]
    qd, sd = quantize_dense_int8(jnp.asarray(d["kernel"]))
    out["out"] = {"q": qd, "scale": sd,
                  "bias": jnp.asarray(d["bias"], jnp.float32)}
    return out


def lstm_apply_int8(qparams, feats, n_frames):
    """Prefused LstmAm forward (mirror of fast_lstm.lstm_am_apply_prefused)
    with int8 input-projection and output GEMMs, f32 recurrence."""
    x = feats
    B, T = feats.shape[0], feats.shape[1]
    t_idx = jnp.arange(T)
    for layer in qparams["layers"]:
        w_rec = layer["w_rec"]
        H = w_rec.shape[0]
        xg = int8_dynamic_dot(x, layer["q_in"], layer["scale_in"]) \
            + layer["bias"]                        # [B, T, 4H]

        def step(carry, inp, _w=w_rec, _H=H):
            c, h = carry
            xg_t, t = inp
            gates = xg_t + h @ _w
            i = jax.nn.sigmoid(gates[:, :_H])
            f = jax.nn.sigmoid(gates[:, _H:2 * _H])
            g = jnp.tanh(gates[:, 2 * _H:3 * _H])
            o = jax.nn.sigmoid(gates[:, 3 * _H:])
            c_new = f * c + i * g
            h_new = o * jnp.tanh(c_new)
            keep = (t < n_frames)[:, None]
            return (jnp.where(keep, c_new, c), jnp.where(keep, h_new, h)), \
                jnp.where(keep, h_new, h)

        zeros = jnp.zeros((B, H), jnp.float32)
        _, x = jax.lax.scan(
            step, (zeros, zeros), (jnp.swapaxes(xg, 0, 1), t_idx)
        )
        x = jnp.swapaxes(x, 0, 1)
    d = qparams["out"]
    return int8_dynamic_dot(x, d["q"], d["scale"]) + d["bias"]


def make_int8_logits(model, params):
    """Jitted (feats, n_frames) -> f32 logits through the int8 path.

    MlpAm (pure int8 GEMM stack) and LstmAm (int8 input-projection/output
    GEMMs, f32 recurrence); other archs raise so callers fall back
    explicitly, never silently."""
    from mogasr.am.neural import LstmAm

    if isinstance(model, MlpAm):
        qparams = quantize_mlp_int8(model, params)

        @jax.jit
        def logits(feats, n_frames):
            return mlp_apply_int8(model, qparams, feats, n_frames)

        return logits
    if isinstance(model, LstmAm):
        qlstm = quantize_lstm_int8(params)

        @jax.jit
        def lstm_logits(feats, n_frames):
            return lstm_apply_int8(qlstm, feats, n_frames)

        return lstm_logits
    raise NotImplementedError(
        "int8 inference is implemented for MlpAm/LstmAm (use bfloat16 for "
        f"{type(model).__name__})"
    )


def save_quantized(path: str, qparams) -> None:
    """Serialize a quantize_{mlp,lstm}_int8 tree to one .npz (~4x smaller
    than the f32 checkpoint: kernels are int8 + a per-channel f32 scale)."""
    import numpy as np

    flat = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}/{k}" if prefix else str(k), v)
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(f"{prefix}/{i}", v)
        else:
            flat[prefix] = np.asarray(node)

    walk("", qparams)
    np.savez_compressed(path, **flat)


def load_quantized(path: str):
    """Inverse of save_quantized: rebuild the nested qparams tree (lists
    recovered from integer path segments)."""
    import numpy as np

    data = np.load(path)
    root: Dict[str, Any] = {}
    for key in data.files:
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = jnp.asarray(data[key])

    def listify(node):
        if not isinstance(node, dict):
            return node
        keys = list(node.keys())
        if keys and all(k.isdigit() for k in keys):
            return [listify(node[str(i)]) for i in range(len(keys))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def make_quantized_logits(model, params, precision: str):
    """Dispatch: precision in {"float32", "bfloat16", "int8"} -> jitted
    (feats, n_frames) -> f32 logits closure."""
    if precision == "float32":
        @jax.jit
        def logits(feats, n_frames):
            return model.apply(params, feats, n_frames)

        return logits
    if precision == "bfloat16":
        return make_bf16_logits(model, params)
    if precision == "int8":
        return make_int8_logits(model, params)
    raise ValueError(f"unknown precision {precision!r}")
