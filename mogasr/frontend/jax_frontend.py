"""Fused JAX/XLA audio front end operating on padded utterance batches on device.

Accelerator-first design (BASELINE.json north_star: "the audio front end ... becomes a
single fused JAX/Pallas kernel chain operating on padded utterance batches in
HBM"):

- The whole chain (pre-emphasis -> framing -> window -> power spectrum -> mel
  -> log -> DCT -> lifter -> deltas -> CMVN) is ONE jitted function; XLA fuses
  the elementwise stages into the GEMMs.
- The DFT is computed as a GEMM against a precomputed [frame_length, n_bins]
  cos/sin matrix with the analysis window folded in (GEMM-native NDFT; matmuls
  beat FFT on the MXU — see PAPERS.md, MelT). Zero-padding to n_fft is implicit:
  only the first frame_length rows of the DFT matrix are nonzero.
- Mel filterbank and DCT (with the cepstral lifter folded in) are GEMMs too.
- All parity-critical GEMMs run with Precision.HIGHEST so fp32 parity with the
  NumPy oracle holds on the accelerator (SURVEY.md §7 "hard parts" #1).
- Deltas use per-utterance edge replication via clipped gathers so padded
  batches match the per-utterance oracle exactly; CMVN is a masked reduction
  over valid frames only (padding-invariance, SURVEY.md §7 #4).

Static shapes only: the batch is padded to [B, max_samples]; outputs are
[B, T_max, feat_dim] plus a per-utterance frame count.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from mogasr.config import FrontendConfig
from mogasr.frontend import numpy_ref as npref

HIGHEST = jax.lax.Precision.HIGHEST


class FrontendConsts(NamedTuple):
    """Precomputed constant matrices for the fused front-end kernel chain."""

    dft_cos_w: jax.Array  # [frame_length, n_bins], window folded in
    dft_sin_w: jax.Array  # [frame_length, n_bins]
    mel: jax.Array        # [n_bins, n_mels]
    dct_lift: jax.Array   # [n_mels, n_ceps], lifter folded in
    window: jax.Array     # [frame_length] (for the energy path)
    plp_eql: Optional[jax.Array] = None   # [n_mels] equal-loudness weights
    plp_idft: Optional[jax.Array] = None  # [n_mels+2, lpc_order+1] iDCT-I
    plp_lift: Optional[jax.Array] = None  # [n_ceps] cepstral lifter


def build_consts(cfg: FrontendConfig) -> FrontendConsts:
    L, n_fft = cfg.frame_length, cfg.n_fft
    n_bins = n_fft // 2 + 1
    n = np.arange(L, dtype=np.float64)[:, None]
    k = np.arange(n_bins, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * n * k / n_fft
    win = npref.window_fn(cfg.window, L)
    dct = npref.dct_matrix(cfg.n_ceps, cfg.n_mels)
    dct = dct * npref.lifter_coeffs(cfg.n_ceps, cfg.cepstral_lifter)[None, :]
    f32 = lambda x: jnp.asarray(np.asarray(x, np.float32))
    plp = cfg.feature_type == "plp"
    return FrontendConsts(
        dft_cos_w=f32(np.cos(ang) * win[:, None]),
        dft_sin_w=f32(-np.sin(ang) * win[:, None]),
        mel=f32(npref.mel_filterbank_matrix(cfg)),
        dct_lift=f32(dct),
        window=f32(win),
        plp_eql=f32(npref.equal_loudness_weights(cfg)) if plp else None,
        plp_idft=f32(npref.plp_idft_matrix(cfg.n_mels, cfg.lpc_order)) if plp else None,
        plp_lift=f32(npref.lifter_coeffs(cfg.n_ceps, cfg.cepstral_lifter)) if plp else None,
    )


def _plp_cepstra(mel: jax.Array, cfg: FrontendConfig,
                 consts: FrontendConsts) -> jax.Array:
    """[N, n_mels] mel power -> [N, n_ceps] liftered PLP cepstra.

    Mirrors numpy_ref.plp_from_pspec: equal loudness, cube-root compression,
    iDCT-I autocorrelation (one GEMM), then Levinson-Durbin and the LPC->
    cepstrum recursion unrolled over the fixed (static) lpc_order — tiny
    elementwise chains XLA fuses; all heavy lifting stays in the GEMMs.
    """
    p = cfg.lpc_order
    aud = jnp.maximum(mel * consts.plp_eql[None, :], 0.0)
    compressed = jnp.cbrt(aud)
    padded = jnp.concatenate(
        [compressed[:, :1], compressed, compressed[:, -1:]], axis=1)
    R = jnp.dot(padded, consts.plp_idft, precision=HIGHEST)  # [N, p+1]
    floor = npref._PLP_R0_FLOOR
    # Levinson-Durbin, unrolled (p is static and small)
    a = [jnp.zeros(R.shape[0], R.dtype) for _ in range(p)]
    err = jnp.maximum(R[:, 0], floor)
    for i in range(p):
        acc = sum((a[j] * R[:, i - j] for j in range(i)), start=jnp.zeros_like(err))
        kref = (R[:, i + 1] - acc) / err
        new_a = [a[j] - kref * a[i - 1 - j] for j in range(i)]
        a = new_a + [kref] + a[i + 1:][: p - i - 1]
        err = jnp.maximum(err * (1.0 - kref * kref), floor * 1e-4)
    # LPC -> cepstrum
    c = [jnp.log(err)]
    for n_i in range(1, cfg.n_ceps):
        acc = sum(
            ((k_i / n_i) * c[k_i] * a[n_i - 1 - k_i] for k_i in range(1, n_i)),
            start=jnp.zeros_like(err),
        )
        c.append(a[n_i - 1] + acc)
    ceps = jnp.stack(c, axis=1)  # [N, n_ceps]
    return ceps * consts.plp_lift[None, :]


def _dither_noise(n: int, seed: int = npref._DITHER_SEED) -> jax.Array:
    """JAX mirror of numpy_ref.dither_noise_np for positions [0, n).

    Same murmur3-finalizer + Box-Muller over the sample counter, in uint32
    (wrapping) arithmetic; noise depends only on the position within the
    utterance, so batched == solo == streaming == oracle (float32-level).
    """
    i = jnp.arange(n, dtype=jnp.uint32)

    def mix(x):
        x = (x + jnp.uint32(seed)) * jnp.uint32(2654435761)
        x = x ^ (x >> 16)
        x = x * jnp.uint32(0x85EBCA6B)
        x = x ^ (x >> 13)
        x = x * jnp.uint32(0xC2B2AE35)
        x = x ^ (x >> 16)
        return x

    u1 = (mix(2 * i).astype(jnp.float32) + 0.5) / 4294967296.0
    u2 = (mix(2 * i + 1).astype(jnp.float32) + 0.5) / 4294967296.0
    return jnp.sqrt(-2.0 * jnp.log(u1)) * jnp.cos(2.0 * jnp.pi * u2)


def _frame_signal_strided(wave: jax.Array, t_max: int, cfg: FrontendConfig) -> jax.Array:
    """[B, N] -> [B, t_max, frame_length] via strided reshapes, NOT a gather.

    frame[t, k*H + r] = wave[(t + k) * H + r], so each hop-sized column chunk
    k is just a shifted [T, H] reshape of the waveform — slices and reshapes
    XLA handles at memcpy speed, where a 2-D gather of the same data is an
    indexed load per element.
    """
    B = wave.shape[0]
    L, H = cfg.frame_length, cfg.frame_shift
    n_chunks = -(-L // H)
    need = (t_max + n_chunks) * H
    if wave.shape[1] < need:
        wave = jnp.pad(wave, ((0, 0), (0, need - wave.shape[1])))
    cols = []
    for k in range(n_chunks):
        width = min(H, L - k * H)
        chunk = wave[:, k * H : k * H + t_max * H].reshape(B, t_max, H)
        cols.append(chunk[:, :, :width])
    return jnp.concatenate(cols, axis=-1)


def _deltas_batched(feats: jax.Array, n_frames: jax.Array, window: int) -> jax.Array:
    """Regression deltas with per-utterance edge replication on padded [B,T,D]."""
    B, T, _ = feats.shape
    t = jnp.arange(T, dtype=jnp.int32)[None, :]  # [1, T]
    last = jnp.maximum(n_frames - 1, 0)[:, None]  # [B, 1]
    denom = 2.0 * sum(i * i for i in range(1, window + 1))
    out = jnp.zeros_like(feats)
    for i in range(1, window + 1):
        fwd_idx = jnp.minimum(t + i, last)
        bwd_idx = jnp.clip(t - i, 0, None)
        bwd_idx = jnp.minimum(bwd_idx, last)
        fwd = jnp.take_along_axis(feats, fwd_idx[:, :, None], axis=1)
        bwd = jnp.take_along_axis(feats, bwd_idx[:, :, None], axis=1)
        out = out + i * (fwd - bwd)
    return out / denom


def _masked_cmvn(feats: jax.Array, mask: jax.Array, norm_var: bool) -> jax.Array:
    """Per-utterance CMVN over valid frames only. mask: [B, T] in {0,1}."""
    m = mask[:, :, None]
    count = jnp.maximum(jnp.sum(m, axis=1, keepdims=True), 1.0)
    mean = jnp.sum(feats * m, axis=1, keepdims=True) / count
    out = feats - mean
    if norm_var:
        var = jnp.sum((feats - mean) ** 2 * m, axis=1, keepdims=True) / count
        out = out / jnp.sqrt(jnp.maximum(var, 1e-10))
    return out * m


def _sliding_cmvn(
    feats: jax.Array, mask: jax.Array, norm_var: bool, window: int
) -> jax.Array:
    """Causal trailing-window CMVN (see numpy_ref.cmvn_sliding_np).

    Cumulative sums turn the windowed stats into two subtractions — O(T)
    and scan-free, so XLA fuses it into the feature chain."""
    m = mask[:, :, None]
    x = feats * m
    cs = jnp.cumsum(x, axis=1)
    css = jnp.cumsum(x * x, axis=1)
    T = feats.shape[1]

    def lag(a):
        if window >= T:
            return jnp.zeros_like(a)
        return jnp.concatenate(
            [jnp.zeros_like(a[:, :window]), a[:, :-window]], axis=1
        )

    s = cs - lag(cs)
    ss = css - lag(css)
    cnt = jnp.minimum(jnp.arange(T) + 1, window).astype(feats.dtype)[None, :, None]
    mean = s / cnt
    out = feats - mean
    if norm_var:
        var = ss / cnt - mean**2
        out = out / jnp.sqrt(jnp.maximum(var, 1e-10))
    return out * m


def make_frontend(cfg: FrontendConfig, max_samples: int):
    """Build the fused batched front end for a fixed max_samples bucket.

    Returns a jitted ``extract(waves[B, max_samples], num_samples[B]) ->
    (feats[B, T_max, feat_dim], num_frames[B])``.
    """
    consts = build_consts(cfg)
    t_max = max(cfg.num_frames(max_samples), 1)

    def frames_of(signal: jax.Array, num_samples: jax.Array) -> jax.Array:
        """[B, N] -> [B, t_max, L] under the configured edge convention."""
        B = signal.shape[0]
        if cfg.snip_edges:
            return _frame_signal_strided(signal, t_max, cfg)
        # snip_edges=False: centered frames with per-utterance symmetric
        # reflection at the TRUE waveform end (a gather — correctness over
        # speed; this is the parity knob, not the throughput default).
        L, H = cfg.frame_length, cfg.frame_shift
        starts = jnp.arange(t_max) * H + H // 2 - L // 2
        idx = starts[:, None] + jnp.arange(L)[None, :]          # [T, L]
        n = jnp.maximum(num_samples, 1)[:, None, None]          # [B, 1, 1]
        idx_b = jnp.broadcast_to(idx[None], (B, t_max, L))
        idx_b = jnp.where(idx_b < 0, -idx_b - 1, idx_b)
        idx_b = jnp.where(idx_b >= n, 2 * n - idx_b - 1, idx_b)
        idx_b = jnp.clip(idx_b, 0, signal.shape[1] - 1)
        out = jnp.take_along_axis(signal, idx_b.reshape(B, -1), axis=1)
        return out.reshape(B, t_max, L)

    @jax.jit
    def extract(waves: jax.Array, num_samples: jax.Array) -> Tuple[jax.Array, jax.Array]:
        waves = waves.astype(jnp.float32)
        B = waves.shape[0]
        if cfg.dither != 0.0:
            # position-keyed deterministic dither (one [N] row broadcast over
            # the batch — noise is a function of utterance position only, so
            # batched == solo == streaming == oracle)
            waves = waves + cfg.dither * _dither_noise(waves.shape[1])[None, :]
        if cfg.snip_edges:
            n_frames = jnp.where(
                num_samples < cfg.frame_length,
                0,
                1 + (num_samples - cfg.frame_length) // cfg.frame_shift,
            ).astype(jnp.int32)
        else:
            n_frames = (
                (num_samples + cfg.frame_shift // 2) // cfg.frame_shift
            ).astype(jnp.int32)
        n_frames = jnp.minimum(n_frames, t_max)

        # Pre-emphasis on the full padded waveform (Kaldi convention: sample 0
        # is emphasized against itself).
        prev = jnp.concatenate([waves[:, :1], waves[:, :-1]], axis=1)
        emph = waves - cfg.preemphasis * prev

        frames = frames_of(emph, num_samples)  # [B, T_max, L]

        flat = frames.reshape(B * t_max, cfg.frame_length)
        # Windowed GEMM-native DFT -> power spectrum. fp32 HIGHEST for parity.
        re = jnp.dot(flat, consts.dft_cos_w, precision=HIGHEST)
        im = jnp.dot(flat, consts.dft_sin_w, precision=HIGHEST)
        pspec = re * re + im * im  # [B*T, n_bins]

        mel = jnp.dot(pspec, consts.mel, precision=HIGHEST)
        logmel = jnp.log(jnp.maximum(mel, cfg.log_floor))

        if cfg.feature_type == "fbank":
            base = logmel.reshape(B, t_max, cfg.n_mels)
        else:
            if cfg.feature_type == "plp":
                ceps = _plp_cepstra(mel, cfg, consts)
            else:
                ceps = jnp.dot(logmel, consts.dct_lift, precision=HIGHEST)
            if cfg.use_energy:
                raw = frames_of(waves, num_samples).reshape(
                    B * t_max, cfg.frame_length
                )
                energy = jnp.log(
                    jnp.maximum(jnp.sum(raw * raw, axis=-1), cfg.log_floor)
                )
                ceps = ceps.at[:, 0].set(energy)
            base = ceps.reshape(B, t_max, cfg.n_ceps)

        feats = [base]
        prev_f = base
        for _ in range(cfg.delta_order):
            prev_f = _deltas_batched(prev_f, n_frames, cfg.delta_window)
            feats.append(prev_f)
        out = jnp.concatenate(feats, axis=-1)

        mask = (jnp.arange(t_max)[None, :] < n_frames[:, None]).astype(jnp.float32)
        if cfg.cmvn == "utterance":
            out = _masked_cmvn(out, mask, cfg.cmvn_norm_var)
        elif cfg.cmvn == "sliding":
            out = _sliding_cmvn(out, mask, cfg.cmvn_norm_var, cfg.cmvn_window)
        else:
            out = out * mask[:, :, None]
        return out, n_frames

    return extract


@functools.lru_cache(maxsize=32)
def cached_frontend(cfg: FrontendConfig, max_samples: int):
    return make_frontend(cfg, max_samples)


def extract_features(wave: np.ndarray, cfg: FrontendConfig) -> np.ndarray:
    """Single-utterance convenience entry point mirroring the reference API.

    ``extract_features(wave, config) -> [T, feat_dim] float32`` (SURVEY.md §1
    L1 public interface). Batched callers should use :func:`make_frontend`.
    """
    wave = np.asarray(wave)
    n = wave.shape[0]
    fn = cached_frontend(cfg, n)
    feats, n_frames = fn(wave[None, :], jnp.asarray([n]))
    t = int(n_frames[0])
    return np.asarray(feats[0, :t])
