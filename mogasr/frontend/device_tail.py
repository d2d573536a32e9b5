"""Batched DEVICE-resident streaming feature tail (deltas + CMVN + queue).

Why: the serving engines' measured ceiling was the host-mediated feature
path — every tick pulled the batched spectral output to host so each
slot's `StreamingFrontend.absorb` (deltas + CMVN, numpy) could run, paying
a device sync plus 1-core host loops per tick. Keeping the tail on
device lets a tick run sync-free end-to-end
(mogasr.serving.engine feature_path="device").

Three composable pieces, each a pure function an engine can fuse under ONE
jit together with the spectral GEMM chain:

- **Delta tail** (`_tail_core`): a [B, C, D_base] rolling window holding,
  per slot, the frames from ``emitted - lag`` onward (identical trim
  policy to the host StreamingFrontend's ``_base_buf``), with a
  valid-count vector — the array edges coincide with the host rolling
  buffer's edges, so regression-delta edge clamping lands on exactly the
  same frames. EXACT vs the per-slot host tail (tests/test_device_tail).
- **CMVN** (`_cmvn_sliding_core` / the affine global path): causal
  trailing-window normalization over a [B, W-1+O, D] rolling buffer of
  raw full-context rows. The host path accumulates window statistics in
  float64 cumsums; the device path computes each window's mean in f32 and
  its variance with a TWO-PASS sum of squared deviations (no E[x^2]-mean^2
  cancellation), so the contract is a tolerance (~1e-5 relative, tested),
  not bit-exactness — decode-decision equivalence is pinned by the
  engine-vs-host-feature-path tests.
- **Feature queue** (`_q_append_core` / `_q_pop_core`): a [B, Q, D]
  device-resident ragged queue between the feature tail and the decode
  stage, so finalized features never visit the host. Counts live on the
  HOST (pure integer bookkeeping mirrors the device emission rule
  exactly), so queue ops need no device->host sync.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from mogasr.config import FrontendConfig
from mogasr.frontend.jax_frontend import _deltas_batched


class TailState(NamedTuple):
    buf: jax.Array    # [B, C, D_base] rolling window (emitted - lag ...)
    valid: jax.Array  # [B] rows of buf that are real
    off: jax.Array    # [B] relative index of the first un-emitted frame
                      # (= min(frames_emitted, lag) — matches the host
                      # buffer's emitted - buf_start)


def tail_init(cfg: FrontendConfig, batch: int, chunk: int) -> TailState:
    """Carries for ``batch`` slots absorbing up to ``chunk`` rows per step."""
    lag = cfg.delta_order * cfg.delta_window
    C = 2 * lag + chunk
    return TailState(
        jnp.zeros((batch, C, cfg.base_dim), jnp.float32),
        jnp.zeros((batch,), jnp.int32),
        jnp.zeros((batch,), jnp.int32),
    )


def _tail_core(
    state: TailState,
    new_rows: jax.Array,   # [B, F, D_base]
    n_new: jax.Array,      # [B]
    final: jax.Array,      # [B] bool — flush the lookahead tail (end)
    delta_order: int,
    delta_window: int,
) -> Tuple[TailState, jax.Array, jax.Array]:
    """-> (state', out [B, F + lag, feat_dim], n_out [B]).

    out[b, :n_out[b]] are the newly-final full-context feature rows for
    slot b — identical to what the host tail would emit for the same
    absorb() call (tested).
    """
    B, C, D = state.buf.shape
    F = new_rows.shape[1]
    lag = delta_order * delta_window

    # ragged append: buf'[b, i] = buf[b, i] if i < valid else new[b, i-valid]
    idx = jnp.arange(C)[None, :]                     # [1, C]
    take_new = idx - state.valid[:, None]            # [B, C]
    appended = jnp.where(
        (idx < state.valid[:, None])[..., None],
        state.buf,
        jnp.take_along_axis(
            new_rows, jnp.clip(take_new, 0, F - 1)[..., None], axis=1),
    )
    appended = jnp.where(
        (idx < (state.valid + n_new)[:, None])[..., None], appended, 0.0)
    v = state.valid + n_new                          # [B]

    # full-order deltas over the valid region; _deltas_batched clamps at
    # [0, v) — the same edges as the host rolling buffer
    feats = [appended]
    prev = appended
    for _ in range(delta_order):
        prev = _deltas_batched(prev, v, delta_window)
        feats.append(prev)
    full = jnp.concatenate(feats, axis=-1)           # [B, C, feat_dim]

    # emit every frame with a complete lookahead; un-emitted frames start
    # at state.off relative to the buffer (0 at utterance start, `lag`
    # once warmed — exactly the host buffer's emitted - buf_start)
    lo = state.off                                   # [B]
    t_ready = jnp.where(final, v, v - lag)
    n_out = jnp.clip(t_ready - lo, 0, F + lag)
    out_idx = lo[:, None] + jnp.arange(F + lag)[None, :]
    out = jnp.take_along_axis(
        full, jnp.clip(out_idx, 0, C - 1)[..., None], axis=1)
    out = jnp.where(
        (jnp.arange(F + lag)[None, :] < n_out[:, None])[..., None], out, 0.0)

    # trim: keep `lag` rows of context before the next un-emitted frame
    emitted_rel = lo + n_out                         # rows now emitted (rel)
    drop = jnp.maximum(emitted_rel - lag, 0)
    keep_idx = drop[:, None] + jnp.arange(C)[None, :]
    buf2 = jnp.take_along_axis(
        appended, jnp.clip(keep_idx, 0, C - 1)[..., None], axis=1)
    v2 = v - drop
    buf2 = jnp.where((idx < v2[:, None])[..., None], buf2, 0.0)
    off2 = emitted_rel - drop
    # a finalized slot resets for reuse
    buf2 = jnp.where(final[:, None, None], 0.0, buf2)
    v2 = jnp.where(final, 0, v2)
    off2 = jnp.where(final, 0, off2)
    return TailState(buf2, v2, off2), out, n_out


_tail_step = jax.jit(
    _tail_core, static_argnames=("delta_order", "delta_window"))


# ---------------------------------------------------------------------------
# Sliding CMVN (causal trailing window) on device
# ---------------------------------------------------------------------------


def _cmvn_sliding_core(
    cbuf: jax.Array,     # [B, Wbuf, D] trailing raw full-context rows
    ch: jax.Array,       # [B] valid history rows (= min(emitted, W - 1))
    rows: jax.Array,     # [B, O, D] newly-final RAW rows (from _tail_core)
    n_rows: jax.Array,   # [B]
    final: jax.Array,    # [B] bool — reset the slot's history after this step
    window: int,
    norm_var: bool,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """-> (cbuf', ch', normalized rows [B, O, D]).

    Host semantics (StreamingFrontend._sliding_normalize): frame t is
    normalized by the stats of its trailing ``min(t + 1, window)`` raw
    frames (inclusive). The history invariant ``ch = min(emitted, W - 1)``
    means frame i of this step sits at buffer position ch + i and its
    count is ``min(ch + i + 1, W)`` — identical to the host's global-index
    arithmetic without tracking the global index.

    Numerics: f32 two-pass (mean, then mean of squared deviations) vs the
    host's f64 cumsum-difference — tolerance contract (module docstring).
    """
    B, Wbuf, D = cbuf.shape
    O = rows.shape[1]
    W = window

    # ragged append of the new raw rows at position ch (same pattern as
    # the tail buffer append)
    idx = jnp.arange(Wbuf)[None, :]                   # [1, Wbuf]
    src = idx - ch[:, None]                           # [B, Wbuf]
    appended = jnp.where(
        (idx < ch[:, None])[..., None],
        cbuf,
        jnp.take_along_axis(
            rows, jnp.clip(src, 0, O - 1)[..., None], axis=1),
    )
    appended = jnp.where(
        (idx < (ch + n_rows)[:, None])[..., None], appended, 0.0)

    # per-output-row trailing window gather: row i ends at buffer position
    # ch + i with cnt = min(ch + i + 1, W) valid rows
    i = jnp.arange(O)[None, :]                        # [1, O]
    end = ch[:, None] + i                             # [B, O]
    cnt = jnp.minimum(end + 1, W).astype(jnp.float32)  # [B, O]
    w_off = jnp.arange(W)[None, None, :]              # [1, 1, W]
    w_idx = end[:, :, None] - (W - 1) + w_off         # [B, O, W]
    valid = w_off >= (W - cnt[:, :, None])            # [B, O, W]
    g = jnp.take_along_axis(
        appended, jnp.clip(w_idx, 0, Wbuf - 1).reshape(B, O * W)[..., None],
        axis=1,
    ).reshape(B, O, W, D)
    vm = valid[..., None]
    mean = jnp.sum(jnp.where(vm, g, 0.0), axis=2) / cnt[..., None]  # [B,O,D]
    out = rows - mean
    if norm_var:
        dev = jnp.where(vm, g - mean[:, :, None, :], 0.0)
        var = jnp.sum(dev * dev, axis=2) / cnt[..., None]
        out = out / jnp.sqrt(jnp.maximum(var, 1e-10))

    # trim: keep the last min(ch + n_rows, W - 1) raw rows
    total = ch + n_rows
    keep = jnp.minimum(total, W - 1)
    drop = total - keep
    keep_idx = drop[:, None] + jnp.arange(Wbuf)[None, :]
    cbuf2 = jnp.take_along_axis(
        appended, jnp.clip(keep_idx, 0, Wbuf - 1)[..., None], axis=1)
    cbuf2 = jnp.where((idx < keep[:, None])[..., None], cbuf2, 0.0)
    cbuf2 = jnp.where(final[:, None, None], 0.0, cbuf2)
    keep = jnp.where(final, 0, keep)
    return cbuf2, keep, out


# ---------------------------------------------------------------------------
# Full feature tail: deltas -> CMVN, one pure step
# ---------------------------------------------------------------------------


class FeatTailState(NamedTuple):
    tail: TailState
    cbuf: jax.Array   # [B, Wbuf, D_feat] sliding-CMVN raw history
    ch: jax.Array     # [B] valid rows of cbuf


def feat_tail_init(
    cfg: FrontendConfig, batch: int, chunk: int
) -> FeatTailState:
    """Carries for ``batch`` slots absorbing up to ``chunk`` base rows per
    step, emitting up to ``chunk + lag`` normalized rows per step."""
    lag = cfg.delta_order * cfg.delta_window
    wbuf = (cfg.cmvn_window - 1 + chunk + lag) if cfg.cmvn == "sliding" else 1
    return FeatTailState(
        tail_init(cfg, batch, chunk),
        jnp.zeros((batch, wbuf, cfg.feat_dim), jnp.float32),
        jnp.zeros((batch,), jnp.int32),
    )


def _feat_tail_core(
    state: FeatTailState,
    new_rows: jax.Array,   # [B, F, D_base] spectral rows (energy col done)
    n_new: jax.Array,      # [B]
    final: jax.Array,      # [B] bool
    *,
    delta_order: int,
    delta_window: int,
    cmvn: str,
    cmvn_window: int,
    cmvn_norm_var: bool,
    cmvn_mean=None,        # [D_feat] (global mode)
    cmvn_istd=None,
) -> Tuple[FeatTailState, jax.Array, jax.Array]:
    """-> (state', normalized out [B, F + lag, D_feat], n_out [B]).

    The pure composable step: engines fuse this (plus the spectral GEMM
    chain and the queue append) under one jit so a tick's feature work is
    a single async dispatch."""
    tail, raw, n_out = _tail_core(
        state.tail, new_rows, n_new, final, delta_order, delta_window)
    cbuf, ch = state.cbuf, state.ch
    if cmvn == "sliding":
        cbuf, ch, out = _cmvn_sliding_core(
            cbuf, ch, raw, n_out, final, cmvn_window, cmvn_norm_var)
    elif cmvn == "global":
        out = (raw - cmvn_mean) * cmvn_istd
    elif cmvn == "none":
        out = raw
    else:  # pragma: no cover - engine construction rejects earlier
        raise NotImplementedError(
            f"device feature tail: cmvn={cmvn!r} (per-utterance CMVN is "
            "acausal; streaming modes are none/global/sliding)")
    # re-zero rows past n_out (the CMVN arithmetic touches garbage rows)
    O = out.shape[1]
    out = jnp.where(
        (jnp.arange(O)[None, :] < n_out[:, None])[..., None], out, 0.0)
    return FeatTailState(tail, cbuf, ch), out, n_out


@functools.partial(
    jax.jit,
    static_argnames=("delta_order", "delta_window", "cmvn", "cmvn_window",
                     "cmvn_norm_var"),
)
def _feat_tail_jit(state, new_rows, n_new, final, delta_order, delta_window,
                   cmvn, cmvn_window, cmvn_norm_var, cmvn_mean, cmvn_istd):
    return _feat_tail_core(
        state, new_rows, n_new, final,
        delta_order=delta_order, delta_window=delta_window, cmvn=cmvn,
        cmvn_window=cmvn_window, cmvn_norm_var=cmvn_norm_var,
        cmvn_mean=cmvn_mean, cmvn_istd=cmvn_istd)


def feat_tail_step(cfg: FrontendConfig, state: FeatTailState, new_rows,
                   n_new, final=None, cmvn_mean=None, cmvn_istd=None):
    """Batched full feature-tail absorb (host-callable; engines fuse the
    pure core instead). Mirrors StreamingFrontend.absorb + CMVN."""
    B = new_rows.shape[0]
    lag = cfg.delta_order * cfg.delta_window
    chunk = state.tail.buf.shape[1] - 2 * lag
    if new_rows.shape[1] > chunk:
        raise ValueError(
            f"feat_tail_step got {new_rows.shape[1]} rows but the state "
            f"was initialized for chunks of {chunk}")
    if final is None:
        final = jnp.zeros((B,), bool)
    mean = (jnp.asarray(cmvn_mean, jnp.float32).reshape(-1)
            if cmvn_mean is not None else jnp.zeros((cfg.feat_dim,)))
    istd = (jnp.asarray(cmvn_istd, jnp.float32).reshape(-1)
            if cmvn_istd is not None else jnp.ones((cfg.feat_dim,)))
    return _feat_tail_jit(
        state, jnp.asarray(new_rows, jnp.float32), jnp.asarray(n_new),
        jnp.asarray(final), cfg.delta_order, cfg.delta_window, cfg.cmvn,
        cfg.cmvn_window, cfg.cmvn_norm_var, mean, istd)


# ---------------------------------------------------------------------------
# Device-resident ragged feature queue (counts live on the host)
# ---------------------------------------------------------------------------


def _q_append_core(qbuf: jax.Array, qlen: jax.Array, rows: jax.Array,
                   n_rows: jax.Array) -> jax.Array:
    """Write rows[b, :n_rows[b]] at qbuf[b, qlen[b]:qlen[b]+n_rows[b]].
    The host guarantees qlen + n_rows <= Q (queue sizing invariant)."""
    Q = qbuf.shape[1]
    idx = jnp.arange(Q)[None, :]
    src = idx - qlen[:, None]
    new = jnp.take_along_axis(
        rows, jnp.clip(src, 0, rows.shape[1] - 1)[..., None], axis=1)
    return jnp.where(
        ((src >= 0) & (src < n_rows[:, None]))[..., None], new, qbuf)


def _q_pop_core(qbuf: jax.Array, take: jax.Array,
                n_take: int) -> Tuple[jax.Array, jax.Array]:
    """-> (feats [B, n_take, D] with rows >= take[b] zeroed, shifted qbuf).
    take[b] <= n_take; remaining rows shift to the front."""
    Q = qbuf.shape[1]
    feats = jnp.where(
        (jnp.arange(n_take)[None, :] < take[:, None])[..., None],
        qbuf[:, :n_take], 0.0)
    idx = jnp.arange(Q)[None, :] + take[:, None]
    shifted = jnp.take_along_axis(
        qbuf, jnp.clip(idx, 0, Q - 1)[..., None], axis=1)
    return feats, shifted


def tail_step(cfg: FrontendConfig, state: TailState, new_rows, n_new,
              final=None):
    """Batched tail absorb: (state, base rows [B, F, D_base], counts [B])
    -> (state', full-context feature rows [B, F + lag, feat_dim], counts).
    ``final[b]`` flushes slot b's lookahead tail with end-of-utterance edge
    replication and resets its carry."""
    B = new_rows.shape[0]
    lag = cfg.delta_order * cfg.delta_window
    chunk = state.buf.shape[1] - 2 * lag   # tail_init: C = 2*lag + chunk
    if new_rows.shape[1] > chunk:
        # the rolling buffer sizes emission for at most `chunk` rows per
        # step; more would silently drop frames (ADVICE r4)
        raise ValueError(
            f"tail_step got {new_rows.shape[1]} rows but the state was "
            f"initialized for chunks of {chunk}")
    if final is None:
        final = jnp.zeros((B,), bool)
    return _tail_step(
        state, jnp.asarray(new_rows, jnp.float32), jnp.asarray(n_new),
        jnp.asarray(final), cfg.delta_order, cfg.delta_window,
    )
