"""Pitch features: NCCF + on-device Viterbi lag tracking (Kaldi-style).

The classical third stream next to spectral features: per frame a
(POV, mean-subtracted log-f0, delta log-f0) triple, appended to
MFCC/fbank/PLP for tonal-language and noisy-channel robustness.  The
algorithm follows the Kaldi pitch tracker's shape (Ghahremani et al.,
ICASSP 2014) re-derived for batched device execution (no reference implementation
exists for this capability — the /root/reference mount is empty,
SURVEY.md §0):

1. **Downsample** to ``work_rate`` (4 kHz): windowed-sinc low-pass as ONE
   ``conv_general_dilated`` + stride — pitch lives below 400 Hz, and the
   lag grid at 4 kHz is 8x cheaper than at 16 kHz.
2. **NCCF** per (frame, lag): normalized cross-correlation
   ``<x, y_l> / sqrt(<x,x><y_l,y_l>)`` over a 25 ms window for lags
   spanning [min_f0, max_f0].  Computed as one batched einsum over a
   gathered [B, T, L, w] tensor — contraction-heavy, MXU-friendly,
   static shapes.
3. **Viterbi smoothing** over lag candidates: max-plus ``lax.scan`` over
   frames with an [L, L] transition penalty ∝ (Δ log lag)² — octave
   errors cost quadratically — and an on-device backtrace, the same
   skeleton as decoder/viterbi.py.
4. **Features**: POV = best-path NCCF (voicing confidence in [-1, 1]),
   log-f0 mean-subtracted over the utterance's valid frames (masked —
   padding-invariance is tested), and its first difference.

Frame timing mirrors the spectral front end (25 ms / 10 ms, snip_edges),
so ``features_with_pitch`` can concatenate streams frame-for-frame.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass(frozen=True)
class PitchConfig:
    min_f0: float = 50.0          # Hz, lowest trackable pitch
    max_f0: float = 400.0         # Hz, highest trackable pitch
    work_rate: int = 4000         # Hz, NCCF runs at this rate
    window_ms: float = 25.0       # NCCF window
    shift_ms: float = 10.0        # frame shift (match FrontendConfig)
    lag_penalty: float = 10.0     # Viterbi cost = penalty * (dlog lag)^2
    lowpass_taps: int = 63        # windowed-sinc length for the decimator
    eps: float = 1e-8


def _lowpass_kernel(cfg: PitchConfig, sample_rate: int) -> np.ndarray:
    """Hamming-windowed sinc low-pass at 0.9 * work_rate/2 (host, once)."""
    n = cfg.lowpass_taps
    cutoff = 0.45 * cfg.work_rate / sample_rate  # cycles/sample, pre-decim
    t = np.arange(n) - (n - 1) / 2
    h = 2 * cutoff * np.sinc(2 * cutoff * t)
    h *= np.hamming(n)
    return (h / h.sum()).astype(np.float32)


@functools.partial(jax.jit, static_argnames=("cfg", "sample_rate", "t_out"))
def extract_pitch(
    waves: jax.Array,       # [B, S] float32 at sample_rate
    n_samples: jax.Array,   # [B]
    cfg: PitchConfig = PitchConfig(),
    sample_rate: int = 16000,
    t_out: int = 0,         # frames to emit (0 = derive from S; pass the
                            # spectral front end's T to align streams)
) -> Tuple[jax.Array, jax.Array]:
    """(pitch_feats [B, T, 3], n_frames [B]): POV, centered log-f0, Δlog-f0.

    Padded frames are zero; n_frames follows the snip_edges frame count at
    ``sample_rate`` (identical to the spectral front end's)."""
    B, S = waves.shape
    factor = sample_rate // cfg.work_rate
    win = int(round(cfg.window_ms * 1e-3 * cfg.work_rate))      # 100 @ 4k
    shift = int(round(cfg.shift_ms * 1e-3 * cfg.work_rate))     # 40 @ 4k
    min_lag = int(np.floor(cfg.work_rate / cfg.max_f0))         # 10
    max_lag = int(np.ceil(cfg.work_rate / cfg.min_f0))          # 80
    lags = jnp.arange(min_lag, max_lag + 1)                     # [L]
    L = int(max_lag - min_lag + 1)

    # frame count: mirror the 16 kHz snip_edges formula
    win16 = int(round(cfg.window_ms * 1e-3 * sample_rate))
    shift16 = int(round(cfg.shift_ms * 1e-3 * sample_rate))
    T = t_out if t_out > 0 else max((S - win16) // shift16 + 1, 1)
    n_frames = jnp.maximum(
        (n_samples.astype(jnp.int32) - win16) // shift16 + 1, 0
    )
    n_frames = jnp.minimum(n_frames, T)

    # 1. low-pass + decimate: [B, S] -> [B, Sd].  Zero padded samples FIRST
    # so every downstream value is deterministic in the caller's padding
    # (padding-invariance is tested).
    waves = jnp.where(
        jnp.arange(S)[None, :] < n_samples[:, None], waves, 0.0
    )
    kern = jnp.asarray(_lowpass_kernel(cfg, sample_rate))
    pad = cfg.lowpass_taps // 2
    y = jax.lax.conv_general_dilated(
        waves[:, None, :], kern[None, None, :],
        window_strides=(factor,), padding=[(pad, pad)],
        dimension_numbers=("NCH", "OIH", "NCH"),
    )[:, 0, :]                                                  # [B, Sd]
    Sd = y.shape[1]
    # cut the conv tail at each utterance's OWN decimated length (what an
    # unpadded input would produce) — the sinc tail past n_samples would
    # otherwise leak padding-length dependence into the last frames
    nd = (n_samples.astype(jnp.int32) - 1) // factor + 1
    y = jnp.where(jnp.arange(Sd)[None, :] < nd[:, None], y, 0.0)

    # 2. gather extended frames [B, T, win + max_lag], zero out-of-range
    ext = win + max_lag
    starts = jnp.arange(T) * shift                              # [T]
    idx = starts[:, None] + jnp.arange(ext)[None, :]            # [T, ext]
    valid_idx = idx < Sd
    frames = jnp.take_along_axis(
        y[:, None, :], jnp.clip(idx, 0, Sd - 1)[None].repeat(B, 0), axis=2
    )                                                           # [B, T, ext]
    frames = jnp.where(valid_idx[None], frames, 0.0)
    base = frames[:, :, :win]
    base = base - jnp.mean(base, axis=-1, keepdims=True)        # DC removal

    # NCCF over the lag grid: windows [B, T, L, win] via one gather
    lag_idx = lags[:, None] + jnp.arange(win)[None, :]          # [L, win]
    shifted = jnp.take_along_axis(
        frames[:, :, None, :],
        jnp.broadcast_to(lag_idx[None, None], (B, T, L, win)),
        axis=3,
    )                                                           # [B, T, L, win]
    shifted = shifted - jnp.mean(shifted, axis=-1, keepdims=True)
    num = jnp.einsum("btw,btlw->btl", base, shifted)
    e0 = jnp.sum(base * base, axis=-1) + cfg.eps                # [B, T]
    e1 = jnp.sum(shifted * shifted, axis=-1) + cfg.eps          # [B, T, L]
    nccf = num / jnp.sqrt(e0[..., None] * e1)                   # [B, T, L]

    # 3. Viterbi over lag candidates (max-plus scan + device backtrace)
    log_lag = jnp.log(lags.astype(jnp.float32))
    trans = -cfg.lag_penalty * (log_lag[:, None] - log_lag[None, :]) ** 2
    nccf_tm = jnp.swapaxes(nccf, 0, 1)                          # [T, B, L]

    ident = jnp.arange(L, dtype=jnp.int32)

    def step(delta, inp):
        obs_t, t = inp
        scores = delta[:, :, None] + trans[None]                # [B, L, L]
        best = jnp.max(scores, axis=1) + obs_t
        bp = jnp.argmax(scores, axis=1).astype(jnp.int32)       # [B, L]
        # freeze past each utterance's last frame (identity backpointers),
        # so the track never depends on tail length or padding
        active = (t < n_frames)[:, None]
        return (jnp.where(active, best, delta),
                jnp.where(active, bp, ident[None]))

    delta0 = nccf_tm[0]
    delta_T, bps = jax.lax.scan(
        step, delta0, (nccf_tm[1:], jnp.arange(1, T))
    )                                                           # bps [T-1,B,L]
    l_final = jnp.argmax(delta_T, axis=1).astype(jnp.int32)     # [B]

    def back(l, bp_t):
        l_prev = jnp.take_along_axis(bp_t, l[:, None], axis=1)[:, 0]
        return l_prev, l

    l0, path_rev = jax.lax.scan(back, l_final, bps[::-1])
    path = jnp.concatenate([l0[None], path_rev[::-1]], axis=0)  # [T, B]
    path = jnp.swapaxes(path, 0, 1)                             # [B, T]

    # 4. features
    lag_of = jnp.take(lags, path).astype(jnp.float32)           # [B, T]
    f0 = cfg.work_rate / lag_of
    pov = jnp.take_along_axis(nccf, path[..., None], axis=2)[..., 0]
    mask = jnp.arange(T)[None, :] < n_frames[:, None]
    logf0 = jnp.log(f0)
    denom = jnp.maximum(jnp.sum(mask, axis=1), 1)
    mean_lf = jnp.sum(jnp.where(mask, logf0, 0.0), axis=1) / denom
    clf = logf0 - mean_lf[:, None]
    dlf = jnp.diff(logf0, axis=1, prepend=logf0[:, :1])
    feats = jnp.stack([pov, clf, dlf], axis=-1)                 # [B, T, 3]
    feats = jnp.where(mask[..., None], feats, 0.0)
    return feats, n_frames


def features_with_pitch(
    feats: jax.Array,        # [B, T, D] spectral features (any front end)
    n_frames: jax.Array,     # [B] its frame counts
    waves: jax.Array,        # [B, S] the same audio
    n_samples: jax.Array,    # [B]
    cfg: PitchConfig = PitchConfig(),
    sample_rate: int = 16000,
) -> jax.Array:
    """[B, T, D+3]: spectral features with the pitch triple appended,
    frame-aligned (both streams share the 25 ms / 10 ms snip_edges grid)."""
    p, _nf = extract_pitch(
        waves, n_samples, cfg, sample_rate, t_out=int(feats.shape[1])
    )
    return jnp.concatenate([feats, p], axis=-1)
