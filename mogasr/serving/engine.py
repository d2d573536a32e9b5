"""Batched streaming session engines: ONE device dispatch chain per tick for
ALL live sessions.

BASELINE.json configs[4] is the streaming/serving shape. The naive server
(cli/serve.py per-session mode) steps each session independently, so every
audio event costs its own synchronized batch-1 dispatch chain, capping a chip at
1/dispatch-latency realtime streams REGARDLESS of available compute.
Batched serving amortizes the
dispatch: sessions live in slots of fixed ``[B, ...]`` device state and one
``tick()`` advances every live session together:

    tick:  [B,F,L] spectral GEMMs  ->  delta tail -> CMVN -> feature queue
           ->  decode stage        (async dispatches)

The decode dispatch consumes features finalized by EARLIER ticks, so the
feature and decode stages of a tick overlap on device. Two feature paths
(constructor `feature_path`):

- "device" (the serving production arm, round 5): spectral + delta tail +
  sliding/global CMVN + queue append run as ONE fused jit per tick
  (mogasr/frontend/device_tail.py) and decode pops rows straight off a
  device-resident feature queue; all counts are host integer mirrors of
  the device emission rule, so a tick issues only ASYNC dispatches — with
  deferred decode absorption the host blocks only at partial()/finalize()
  boundaries. Sliding CMVN on device is an f32 tolerance contract (~1e-4)
  vs the host f64 path.
- "host" (library default — bit-exact): the r2-r4 path; the host pulls
  the batched spectral output each tick and runs each slot's
  StreamingFrontend.absorb (exact delta/CMVN lag bookkeeping) in numpy,
  blocking roughly once per tick.

Four families share the slot scaffolding (`_BaseSlotEngine`):

- ``BatchedSessionEngine``  — GMM/hybrid + shared-graph Viterbi (exact,
  word-loop decoding; per-slot backpointer histories);
- ``BatchedCtcEngine``      — stateful LSTM + CTC streaming decode (masked
  LSTM carries: frames beyond a slot's valid count do not advance state);
- ``BatchedRnntEngine``     — stateful LSTM encoder + the chunk-resumable
  on-device RNN-T greedy scan (am.rnnt._device_greedy_chunk_fn) carrying
  every session's prediction-network state in shared ``[B, ...]`` rows;
  the device hypothesis buffer is harvested to host EVERY tick, so its
  static size only covers one tick's worst case and sessions can run
  unboundedly long;
- ``BatchedAedEngine``      — chunked streaming Conformer: atomic
  4*chunk_frames chunks per slot per tick (masked cache merges), CTC-greedy
  partials, exact chunk-masked attention finals (length-bucketed compiles).

Exactness: a session's features, partials, and final results are identical
to a dedicated per-session pipeline (tests/test_serving_engine.py) —
batching changes WHEN work is dispatched, never what is computed. Ragged
arrival is handled with per-slot valid-frame counts (masked inside the
shared device scan) and per-slot host state: under ragged feeding a slot's
frames are NOT contiguous rows of any global history, so each slot keeps
its own.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from mogasr.config import DecodeConfig, FrontendConfig
from mogasr.decoder.online import NEG_INF, _chunk_step
from mogasr.frontend.streaming import StreamingFrontend, _chunk_kernel
from mogasr.hmm import graph as gr


class _Slot:
    """Host-side per-session state. Device state lives in the engine's
    shared [B, ...] arrays at this slot's row."""

    def __init__(self, fe: StreamingFrontend, frame_len: int, feat_dim: int):
        self.fe = fe
        self.pend_frames = np.zeros((0, frame_len), np.float32)
        self.pend_energy: Optional[np.ndarray] = None
        self.feat_q = np.zeros((0, feat_dim), np.float32)
        self.n_frames = 0
        self.samples = 0
        self.finishing = False   # end() called: flush tail when frames drain
        self.flushed = False     # finalize_absorbed() has run
        self.overflowed = False  # hit the engine's per-session frame cap
        # device feature path: integer mirrors of the device tail's
        # emission rule (base rows absorbed / final rows emitted) — the
        # host never pulls features, it re-derives the counts
        self.t_avail = 0
        self.emitted = 0


class _BaseSlotEngine:
    """Slot/session lifecycle + the batched spectral stage, shared by the
    decode families. Subclasses implement the decode stage hooks."""

    def __init__(
        self,
        fcfg: FrontendConfig,
        capacity: int = 16,
        tick_frames: int = 24,
        cmvn_mean: Optional[np.ndarray] = None,
        cmvn_istd: Optional[np.ndarray] = None,
        feature_path: str = "host",
    ):
        self.fcfg = fcfg
        self.capacity = int(capacity)
        self.tick_frames = int(tick_frames)
        self.cmvn_mean = cmvn_mean
        self.cmvn_istd = cmvn_istd
        # batched spectral kernel: [B*F, frame_len] through the same fused
        # GEMM chain as the single-session streamer (one compile)
        self._spec = _chunk_kernel(fcfg, self.capacity * self.tick_frames)
        self.slots: List[Optional[_Slot]] = [None] * self.capacity
        self._sid_to_slot: Dict[object, int] = {}
        self._reset_pending = np.zeros(self.capacity, bool)
        self._overflow_events: List[object] = []
        self.ticks = 0
        self.frames_decoded = 0
        # feature_path="device" (the serving/bench production arm):
        # spectral -> delta tail -> CMVN -> feature queue run as ONE fused
        # async dispatch per tick and decode pops features straight off
        # the device queue — the host never sees feature rows (the
        # per-tick spectral pull + per-slot numpy absorb loop was every
        # engine's measured tick floor). Sliding CMVN on device is an f32 tolerance contract
        # (~1e-4) vs the host f64 path (mogasr/frontend/device_tail.py),
        # so the LIBRARY default stays "host" — the bit-exact path the
        # engine-vs-dedicated equality tests pin — and production call
        # sites opt in explicitly.
        if feature_path not in ("device", "host"):
            raise ValueError(
                f"feature_path must be 'device' or 'host': {feature_path}")
        if feature_path == "device" and fcfg.cmvn not in (
                "none", "global", "sliding"):
            raise ValueError(
                "feature_path='device' supports cmvn none/global/sliding "
                f"(got {fcfg.cmvn!r}); use feature_path='host'")
        self.feature_path = feature_path
        if feature_path == "device":
            from mogasr.frontend import device_tail as DT

            B, F = self.capacity, self.tick_frames
            lag = fcfg.delta_order * fcfg.delta_window
            self._lag = lag
            # queue bound: <= F-1 unconsumed rows survive a tick (atomic
            # AED chunks) + one step emits <= F + lag rows
            self._q_cap = 2 * F + lag
            self._ft_state = DT.feat_tail_init(fcfg, B, F)
            self._qbuf = jnp.zeros((B, self._q_cap, fcfg.feat_dim),
                                   jnp.float32)
            self._q_len = np.zeros(B, np.int64)
            g_mean = (jnp.asarray(cmvn_mean, jnp.float32).reshape(-1)
                      if cmvn_mean is not None
                      else jnp.zeros((fcfg.feat_dim,)))
            g_istd = (jnp.asarray(cmvn_istd, jnp.float32).reshape(-1)
                      if cmvn_istd is not None
                      else jnp.ones((fcfg.feat_dim,)))
            spec = self._spec
            use_energy = fcfg.use_energy and fcfg.feature_type in (
                "mfcc", "plp")

            @jax.jit
            def _feat_step(ft_state, qbuf, frames, nfr, energy, final, qlen):
                b_, f_, l_ = frames.shape
                base = spec(frames.reshape(b_ * f_, l_)).reshape(b_, f_, -1)
                if use_energy:
                    base = base.at[:, :, 0].set(energy)
                ft_state, out, n_out = DT._feat_tail_core(
                    ft_state, base, nfr, final,
                    delta_order=fcfg.delta_order,
                    delta_window=fcfg.delta_window,
                    cmvn=fcfg.cmvn, cmvn_window=fcfg.cmvn_window,
                    cmvn_norm_var=fcfg.cmvn_norm_var,
                    cmvn_mean=g_mean, cmvn_istd=g_istd)
                return ft_state, DT._q_append_core(qbuf, qlen, out, n_out)

            @jax.jit
            def _q_pop(qbuf, take):
                return DT._q_pop_core(qbuf, take, F)

            self._feat_step_fn = _feat_step
            self._q_pop_fn = _q_pop

    # ---- session lifecycle ---------------------------------------------

    @property
    def n_live(self) -> int:
        return len(self._sid_to_slot)

    def has(self, sid) -> bool:
        return sid in self._sid_to_slot

    def audio_seconds(self, sid) -> float:
        s = self.slots[self._sid_to_slot[sid]]
        return s.samples / self.fcfg.sample_rate

    def start(self, sid) -> bool:
        """Allocate a slot; False if sid exists or engine is full."""
        if sid in self._sid_to_slot:
            return False
        try:
            b = self.slots.index(None)
        except ValueError:
            return False
        fe = StreamingFrontend(
            self.fcfg, chunk_frames=self.tick_frames,
            cmvn_mean=self.cmvn_mean, cmvn_istd=self.cmvn_istd,
        )
        self.slots[b] = _Slot(fe, self.fcfg.frame_length, self.fcfg.feat_dim)
        self._sid_to_slot[sid] = b
        self._init_slot(b)
        return True

    def feed(self, sid, pcm: np.ndarray) -> None:
        """Buffer audio (host framing only; device work happens in tick())."""
        s = self.slots[self._sid_to_slot[sid]]
        if s.finishing:
            raise ValueError("feed() after end()")
        s.samples += len(pcm)
        frames, energy = s.fe.accept_samples(pcm)
        if frames.shape[0]:
            s.pend_frames = np.concatenate([s.pend_frames, frames])
            if energy is not None:
                s.pend_energy = (
                    energy if s.pend_energy is None
                    else np.concatenate([s.pend_energy, energy])
                )

    def end(self, sid) -> None:
        """No more audio; tail frames flush as subsequent ticks drain.
        (Device feature path: the flush itself is a device step, so it
        happens inside the next tick().)"""
        s = self.slots[self._sid_to_slot[sid]]
        s.finishing = True
        if (self.feature_path == "host" and len(s.pend_frames) == 0
                and not s.flushed):
            tail = s.fe.finalize_absorbed()
            if tail.shape[0]:
                s.feat_q = np.concatenate([s.feat_q, tail])
            s.flushed = True

    def _feat_avail(self, b: int) -> int:
        """Finalized feature rows queued for decode at slot b."""
        return (int(self._q_len[b]) if self.feature_path == "device"
                else len(self.slots[b].feat_q))

    def drained(self, sid) -> bool:
        b = self._sid_to_slot[sid]
        return self.slots[b].flushed and self._feat_avail(b) == 0

    def overflowed(self, sid) -> bool:
        """True once sid hit the engine's per-session frame cap: its
        hypothesis is truncated at the cap (frames beyond it were dropped,
        the session itself stays healthy and finalizable)."""
        return self.slots[self._sid_to_slot[sid]].overflowed

    def take_overflow_events(self) -> List[object]:
        """Sids that NEWLY overflowed since the last call (for the server
        loop to emit per-session error events)."""
        out, self._overflow_events = self._overflow_events, []
        return out

    def _release(self, sid) -> _Slot:
        b = self._sid_to_slot.pop(sid)
        s = self.slots[b]
        self.slots[b] = None
        self._reset_pending[b] = True
        if self.feature_path == "device":
            # the device tail/CMVN rows were reset by the final=True flush;
            # any unconsumed queue rows (AED sub-chunk tail) just expire
            self._q_len[b] = 0
        return s

    def run_to_drain(self, sid):
        """Convenience: tick until sid's frames drain, then finalize."""
        if not self.slots[self._sid_to_slot[sid]].finishing:
            # drained() requires the end() flush flag — without it this
            # loop would spin no-op ticks forever
            raise ValueError("run_to_drain() before end()")
        while not self.drained(sid):
            self.tick()
        return self.finalize(sid)

    def partials(self, sids) -> Dict[object, list]:
        """Best-so-far hypotheses for many sessions (overridden where one
        shared device pull can serve them all)."""
        return {sid: self.partial(sid) for sid in sids}

    # ---- family hooks ----------------------------------------------------

    def _take(self, available: int) -> int:
        """Frames to consume from a slot's feature queue this tick (the AED
        family overrides this: chunks are atomic)."""
        return min(available, self.tick_frames)

    def _slot_frame_cap(self) -> Optional[int]:
        """Per-session decoded-frame bound, or None for unbounded. A family
        with bounded device history (BatchedSessionEngine history='device')
        returns its max_frames; tick() then truncates the offending session
        at the cap instead of raising out of the shared dispatch — one
        overlong client must never take down every other session."""
        return None

    def _init_slot(self, b: int) -> None:
        """Per-slot decode state for a new session (host side)."""

    def _apply_resets(self, mask: np.ndarray) -> None:
        """Clear device decode state for freed slots (before the next scan)."""
        raise NotImplementedError

    def _dispatch_decode(self, feats: np.ndarray, n_valid: np.ndarray):
        """Issue the decode-stage device work; return an opaque handle."""
        raise NotImplementedError

    def _absorb_decode(self, handle, n_valid: np.ndarray) -> None:
        """Pull decode-stage results; update per-slot host state."""
        raise NotImplementedError

    def finalize(self, sid):
        raise NotImplementedError

    # ---- the batched tick ----------------------------------------------

    def tick(self) -> None:
        """Advance every live session: one decode dispatch over all slots'
        finalized features, one spectral dispatch over all slots' pending
        frames. Dispatches are issued before any host pull so the device
        pipelines them; the host blocks ~once (host feature path) or not
        at all (device feature path + device-resident decode state)."""
        if self.feature_path == "device":
            self._tick_device()
            return
        B, F = self.capacity, self.tick_frames
        L, D = self.fcfg.frame_length, self.fcfg.feat_dim

        # --- dispatch decode stage first (features finalized by earlier
        # ticks), so it overlaps the spectral stage on device; the buffer is
        # allocated lazily like the spectral one — idle ticks (and every
        # first tick after start) should not zero B*F*D floats for nothing
        feats = None
        n_valid = np.zeros(B, np.int32)
        cap = self._slot_frame_cap()
        for b, s in enumerate(self.slots):
            if s is None or len(s.feat_q) == 0:
                continue
            n = self._take(len(s.feat_q))
            if cap is not None and s.n_frames + n > cap:
                # Truncate at the cap BEFORE dispatching (ADVICE r3): the
                # session's hypothesis freezes at cap frames, excess queued
                # features are dropped so it still drains and finalizes,
                # and every other session is untouched.
                n = max(0, cap - s.n_frames)
                s.feat_q = s.feat_q[:n]
                if not s.overflowed:
                    s.overflowed = True
                    for sid, bb in self._sid_to_slot.items():
                        if bb == b:
                            self._overflow_events.append(sid)
                            break
                if n == 0:
                    continue
            if feats is None:
                feats = np.zeros((B, F, D), np.float32)
            feats[b, :n] = s.feat_q[:n]
            n_valid[b] = n
        if self._reset_pending.any():
            self._apply_resets(self._reset_pending.copy())
            self._reset_pending[:] = False
        handle = (self._dispatch_decode(feats, n_valid)
                  if feats is not None and n_valid.any() else None)

        # --- spectral stage over pending (pre-emphasized) frames
        nfr = np.zeros(B, np.int32)
        fr = None
        for b, s in enumerate(self.slots):
            if s is None or len(s.pend_frames) == 0:
                continue
            if fr is None:
                fr = np.zeros((B, F, L), np.float32)
            n = min(len(s.pend_frames), F)
            fr[b, :n] = s.pend_frames[:n]
            nfr[b] = n
        if fr is not None:
            base = np.asarray(
                self._spec(jnp.asarray(fr.reshape(B * F, L)))
            ).reshape(B, F, -1)

        # --- host pulls + bookkeeping (device now runs both stages)
        if handle is not None:
            self._absorb_decode(handle, n_valid)
            for b, s in enumerate(self.slots):
                n = int(n_valid[b])
                if n == 0:
                    continue
                s.n_frames += n
                s.feat_q = s.feat_q[n:]
                self.frames_decoded += n
        if fr is not None:
            for b, s in enumerate(self.slots):
                n = int(nfr[b])
                if n == 0:
                    continue
                rows = base[b, :n]
                if s.pend_energy is not None:
                    rows = rows.copy()
                    rows[:, 0] = s.pend_energy[:n]
                    s.pend_energy = s.pend_energy[n:]
                s.pend_frames = s.pend_frames[n:]
                out = s.fe.absorb(rows)
                if out.shape[0]:
                    s.feat_q = np.concatenate([s.feat_q, out])
                if s.finishing and len(s.pend_frames) == 0 and not s.flushed:
                    tail = s.fe.finalize_absorbed()
                    if tail.shape[0]:
                        s.feat_q = np.concatenate([s.feat_q, tail])
                    s.flushed = True
        self.ticks += 1

    def _tick_device(self) -> None:
        """Device-feature-path tick: decode pops straight off the device
        feature queue; the spectral GEMMs, delta tail, CMVN, and queue
        append run as ONE fused async dispatch. All counts are host
        integer mirrors of the device emission rule, so nothing here
        blocks (families that pull decode output per tick still sync in
        their own _absorb_decode unless they defer)."""
        B, F = self.capacity, self.tick_frames
        L = self.fcfg.frame_length
        cap = self._slot_frame_cap()

        # --- decode stage from features finalized by earlier ticks
        take = np.zeros(B, np.int32)
        for b, s in enumerate(self.slots):
            if s is None or self._q_len[b] == 0:
                continue
            n = self._take(int(self._q_len[b]))
            after = self._q_len[b] - n
            if cap is not None and s.n_frames + n > cap:
                # truncate at the cap (see the host-path comment): consume
                # up to the cap, drop the rest of the queue
                n = max(0, cap - s.n_frames)
                after = 0
                if not s.overflowed:
                    s.overflowed = True
                    for sid, bb in self._sid_to_slot.items():
                        if bb == b:
                            self._overflow_events.append(sid)
                            break
            take[b] = n
            self._q_len[b] = after
        if self._reset_pending.any():
            self._apply_resets(self._reset_pending.copy())
            self._reset_pending[:] = False
        handle = None
        if take.any():
            feats, self._qbuf = self._q_pop_fn(
                self._qbuf, jnp.asarray(take))
            handle = self._dispatch_decode(feats, take)

        # --- spectral + tail + CMVN + queue append (one fused dispatch)
        nfr = np.zeros(B, np.int32)
        final = np.zeros(B, bool)
        emit = np.zeros(B, np.int64)
        fr = None
        energy = None
        for b, s in enumerate(self.slots):
            if s is None:
                continue
            n = min(len(s.pend_frames), F)
            if n:
                if fr is None:
                    fr = np.zeros((B, F, L), np.float32)
                    energy = np.zeros((B, F), np.float32)
                fr[b, :n] = s.pend_frames[:n]
                s.pend_frames = s.pend_frames[n:]
                if s.pend_energy is not None:
                    energy[b, :n] = s.pend_energy[:n]
                    s.pend_energy = s.pend_energy[n:]
                nfr[b] = n
            fin = (s.finishing and len(s.pend_frames) == 0 and not s.flushed)
            if n or fin:
                s.t_avail += n
                new_emitted = (s.t_avail if fin
                               else max(s.t_avail - self._lag, s.emitted))
                emit[b] = new_emitted - s.emitted
                s.emitted = new_emitted
            if fin:
                final[b] = True
                s.flushed = True
        if nfr.any() or final.any():
            if fr is None:
                fr = np.zeros((B, F, L), np.float32)
                energy = np.zeros((B, F), np.float32)
            self._ft_state, self._qbuf = self._feat_step_fn(
                self._ft_state, self._qbuf, jnp.asarray(fr),
                jnp.asarray(nfr), jnp.asarray(energy), jnp.asarray(final),
                jnp.asarray(self._q_len))
            self._q_len += emit
            assert int(self._q_len.max(initial=0)) <= self._q_cap, (
                "device feature queue overflow — sizing invariant broken")

        # --- decode-stage host bookkeeping (no feature pulls)
        if handle is not None:
            self._absorb_decode(handle, take)
            for b, s in enumerate(self.slots):
                n = int(take[b])
                if n:
                    s.n_frames += n
                    self.frames_decoded += n
        self.ticks += 1


# ---------------------------------------------------------------------------
# GMM / hybrid family: shared-graph exact Viterbi
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, donate_argnums=(0, 1))
def _reset_viterbi(delta: jax.Array, started: jax.Array, mask: jax.Array):
    delta = jnp.where(mask[:, None], NEG_INF, delta)
    started = started & ~mask
    return delta, started


@functools.partial(jax.jit, donate_argnums=(0, 1))
def _hist_append(
    bp_hist: jax.Array,    # [Tmax, B, J] uint8 (donated, updated in place)
    exit_hist: jax.Array,  # [Tmax, B] int32 (donated)
    bps: jax.Array,        # [F, B, J] this tick's backpointer codes
    exit_args: jax.Array,  # [F, B] this tick's loop-exit argmaxes
    offs: jax.Array,       # [B] int32: each slot's frame count BEFORE the tick
    n_valid: jax.Array,    # [B] int32: valid frames this tick
):
    """Scatter one tick's backpointers into the device-resident history.

    Slots advance raggedly, so frame f of the tick lands at per-slot row
    ``offs[b] + f``; invalid (f >= n_valid[b]) positions get an out-of-range
    row index and ``mode="drop"`` discards them. The whole write is ~F*B*J
    bytes of HBM traffic — the point is that NOTHING is pulled to the host
    (the host pull of this [F, B, J] stream was the binding constraint of
    the GMM engine at capacity 64)."""
    F, B = exit_args.shape
    t_max = bp_hist.shape[0]
    f = jnp.arange(F, dtype=jnp.int32)
    t_idx = offs[None, :] + f[:, None]                          # [F, B]
    t_idx = jnp.where(f[:, None] < n_valid[None, :], t_idx, t_max)
    b_idx = jnp.broadcast_to(jnp.arange(B, dtype=jnp.int32)[None, :], (F, B))
    bp_hist = bp_hist.at[t_idx, b_idx, :].set(bps, mode="drop")
    exit_hist = exit_hist.at[t_idx, b_idx].set(
        exit_args.astype(exit_hist.dtype), mode="drop"
    )
    return bp_hist, exit_hist


def _hist_backtrace(bp_hist, exit_hist, n_frames, j_last):
    """Batched reverse walk of the device-resident history.

    Same bp-code semantics as the host `_slot_backtrace` / decoder.online
    backtrace (0 stay, 1 from j-1, 3 from j-2, 2 enter-from-loop via the
    frame's exit argmax); equality with the host walk is pinned by the
    engine-vs-dedicated tests run in history="device" mode. Returns
    (path [B, Tmax] int32 with -1 past n, entered [B, Tmax] bool)."""
    t_total = bp_hist.shape[0]

    def back_step(j, t):
        bp_t = jax.lax.dynamic_index_in_dim(bp_hist, t, 0, keepdims=False)
        ex_t = jax.lax.dynamic_index_in_dim(exit_hist, t, 0, keepdims=False)
        j_cur = jnp.where(t == n_frames - 1, j_last, j)
        b = jnp.take_along_axis(bp_t, j_cur[:, None], axis=1)[:, 0]
        mid = (t >= 1) & (t <= n_frames - 1)
        j_prev = jnp.where(
            b == 0, j_cur,
            jnp.where(b == 1, j_cur - 1,
                      jnp.where(b == 3, j_cur - 2, ex_t)),
        )
        path_t = jnp.where(t < n_frames, j_cur, -1)
        entered_t = jnp.where(mid, b == 2, (t == 0) & (n_frames > 0))
        return jnp.where(mid, j_prev, j_cur), (path_t, entered_t)

    ts = jnp.arange(t_total - 1, -1, -1, dtype=jnp.int32)
    _, (path_rev, entered_rev) = jax.lax.scan(
        back_step, jnp.zeros_like(j_last), ts
    )
    return path_rev[::-1].T, entered_rev[::-1].T


@jax.jit
def _bt_partial(bp_hist, exit_hist, n_frames, delta):
    """Backtrace every slot from its best-so-far state (one dispatch for
    ALL sessions' partials)."""
    j_last = jnp.argmax(delta, axis=1).astype(jnp.int32)
    return _hist_backtrace(bp_hist, exit_hist, n_frames, j_last)


@jax.jit
def _bt_final(bp_hist, exit_hist, n_frames, delta, final_logp):
    """Backtrace from the final-state-weighted best (exact finalize)."""
    j_last = jnp.argmax(delta + final_logp, axis=1).astype(jnp.int32)
    return _hist_backtrace(bp_hist, exit_hist, n_frames, j_last)


class BatchedSessionEngine(_BaseSlotEngine):
    """Slot-batched streaming recognizer, GMM/hybrid family.

    graph:    ONE shared decode loop graph (e.g. pipeline.word_decode_graph)
    score_fn: stateless scorer [B, F, D] -> [B, F, S] (e.g. a closure over
              pipeline.score_batch and a GmmSet, or a jitted MLP apply)
    fcfg:     front-end config (streaming-compatible: snip_edges, and cmvn
              in {none, global, sliding})
    """

    def __init__(
        self,
        graph,
        score_fn: Callable[[jax.Array], jax.Array],
        fcfg: FrontendConfig,
        dcfg: Optional[DecodeConfig] = None,
        capacity: int = 16,
        tick_frames: int = 24,
        beam: float = 0.0,
        cmvn_mean: Optional[np.ndarray] = None,
        cmvn_istd: Optional[np.ndarray] = None,
        history: str = "device",
        max_frames: int = 3000,
        feature_path: str = "host",
    ):
        """history="device" (default) keeps the backpointer stream in HBM
        ([max_frames, B, J] uint8, scatter-appended per tick) and backtraces
        with a batched reverse scan on device — the host never sees the
        [F, B, J] stream, which was the engine's measured binding constraint
        at capacity 64. Sessions are then bounded at
        max_frames frames (default 30 s at 10 ms hop). history="host" keeps
        the round-2 per-slot host chunk lists: unbounded sessions, one
        [F, B, J] pull + O(n) python backtrace per partial."""
        super().__init__(fcfg, capacity, tick_frames, cmvn_mean, cmvn_istd,
                         feature_path=feature_path)
        dcfg = dcfg or DecodeConfig()
        if history not in ("device", "host"):
            raise ValueError(f"history must be 'device' or 'host': {history}")
        self.graph = graph
        self.score_fn = score_fn
        self.acoustic_scale = float(dcfg.acoustic_scale)
        self.beam = float(beam)
        self.history = history
        self.max_frames = int(max_frames)
        B = self.capacity
        self.graphs = {
            k: jnp.asarray(v) for k, v in gr.batch_graphs([graph] * B).items()
        }
        self.J = int(self.graphs["emit_id"].shape[1])
        self.delta = jnp.full((B, self.J), NEG_INF)
        self.started = jnp.zeros((B,), bool)
        if history == "device":
            self.bp_dev = jnp.zeros((self.max_frames, B, self.J), jnp.uint8)
            self.exit_dev = jnp.zeros((self.max_frames, B), jnp.int32)
        # (tick, final) -> backtrace result: device state only mutates in
        # tick(), so callers looping partial(sid) between ticks pay ONE
        # [max_frames, B, J] backtrace dispatch, not capacity-many
        self._bt_cache: Dict[Tuple[int, bool], tuple] = {}
        # per-slot backpointer histories, indexed by slot row (host mode)
        self._bp_hist: List[List[np.ndarray]] = [[] for _ in range(B)]
        self._exit_hist: List[List[np.ndarray]] = [[] for _ in range(B)]

    # -- hooks --

    def _init_slot(self, b: int) -> None:
        # device-mode history needs no reset: a reused slot rewrites rows
        # 0..n-1 in order and the backtrace reads only t < n
        self._bp_hist[b] = []
        self._exit_hist[b] = []

    def _n_frames_vec(self) -> np.ndarray:
        return np.array(
            [s.n_frames if s is not None else 0 for s in self.slots],
            np.int32,
        )

    def _apply_resets(self, mask: np.ndarray) -> None:
        self.delta, self.started = _reset_viterbi(
            self.delta, self.started, jnp.asarray(mask)
        )

    def _slot_frame_cap(self) -> Optional[int]:
        # Device history is a [max_frames, B, J] ring-less buffer: tick()
        # truncates any session at the cap (overflowed flag + event) so the
        # shared dispatch below can never be asked to write past it.
        return self.max_frames if self.history == "device" else None

    def _dispatch_decode(self, feats: np.ndarray, n_valid: np.ndarray):
        scores = self.score_fn(jnp.asarray(feats))
        self.delta, self.started, bps, exit_args = _chunk_step(
            self.delta, self.started, scores, jnp.asarray(n_valid),
            self.graphs, self.acoustic_scale, self.beam,
        )
        if self.history == "device":
            offs = self._n_frames_vec()
            assert int((offs + n_valid).max()) <= self.max_frames, (
                "tick()'s _slot_frame_cap truncation should make this "
                "unreachable")
            self.bp_dev, self.exit_dev = _hist_append(
                self.bp_dev, self.exit_dev, bps, exit_args,
                jnp.asarray(offs), jnp.asarray(n_valid),
            )
            return True  # all state stays on device; nothing to absorb
        return bps, exit_args

    def _absorb_decode(self, handle, n_valid: np.ndarray) -> None:
        if self.history == "device":
            return
        bps, exit_args = handle
        bps_np = np.asarray(bps)          # [F, B, J] — the tick's sync
        exits_np = np.asarray(exit_args)  # [F, B]
        for b in range(self.capacity):
            n = int(n_valid[b])
            if n == 0:
                continue
            self._bp_hist[b].append(bps_np[:n, b].copy())
            self._exit_hist[b].append(exits_np[:n, b].copy())

    # -- results --

    def _slot_backtrace(self, b: int, n: int, j_last: int):
        """Walks the per-tick backpointer CHUNK LIST in reverse instead of
        concatenating it — partial() runs per tick, and re-concatenating a
        session's whole history each time is O(T²·J) host work over its
        life (same bp-code semantics as decoder/online.py's backtrace; the
        engine-vs-dedicated equality tests pin the two together)."""
        path = np.full(n, -1, np.int64)
        entered = np.zeros(n, bool)
        if n == 0:
            return path, entered
        chunks_bp = self._bp_hist[b]
        chunks_ex = self._exit_hist[b]
        j = int(j_last)
        ci = len(chunks_bp) - 1
        start = sum(len(c) for c in chunks_bp) - len(chunks_bp[ci])
        for t in range(n - 1, 0, -1):
            while t < start:
                ci -= 1
                start -= len(chunks_bp[ci])
            local = t - start
            path[t] = j
            bcode = chunks_bp[ci][local, j]
            entered[t] = bcode == 2
            if bcode == 0:
                pass
            elif bcode == 1:
                j = j - 1
            elif bcode == 3:
                j = j - 2
            else:
                j = int(chunks_ex[ci][local])
        path[0] = j
        entered[0] = True
        return path, entered

    def _words_of(self, path: np.ndarray, entered: np.ndarray) -> List[str]:
        from mogasr.hmm.graph import path_words

        return path_words(self.graph, path, entered)

    def _device_backtrace_all(self, final: bool):
        """One dispatch: backtrace EVERY slot on device; pull [B, Tmax].
        Cached per (tick, final): delta/bp_dev only change inside tick()."""
        key = (self.ticks, final)
        hit = self._bt_cache.get(key)
        if hit is not None:
            return hit
        n = jnp.asarray(self._n_frames_vec())
        if final:
            path, entered = _bt_final(
                self.bp_dev, self.exit_dev, n, self.delta,
                self.graphs["final_logp"],
            )
        else:
            path, entered = _bt_partial(
                self.bp_dev, self.exit_dev, n, self.delta
            )
        res = (np.asarray(path), np.asarray(entered))
        if next(iter(self._bt_cache), (self.ticks,))[0] != self.ticks:
            self._bt_cache.clear()   # drop stale tick's entries
        self._bt_cache[key] = res
        return res

    def partial(self, sid, delta_np: Optional[np.ndarray] = None) -> List[str]:
        """Best-so-far hypothesis. In host mode, pass ``delta_np =
        np.asarray(engine.delta)`` when emitting partials for many sessions
        to pay one device pull (device mode: use partials())."""
        b = self._sid_to_slot[sid]
        s = self.slots[b]
        if s.n_frames == 0:
            return []
        if self.history == "device":
            path, entered = self._device_backtrace_all(final=False)
            return self._words_of(path[b, : s.n_frames],
                                  entered[b, : s.n_frames])
        row = (delta_np[b] if delta_np is not None
               else np.asarray(self.delta[b]))
        path, entered = self._slot_backtrace(b, s.n_frames, int(row.argmax()))
        return self._words_of(path, entered)

    def partials(self, sids) -> Dict[object, list]:
        """Partials for many sessions with ONE device dispatch (device mode)
        or ONE [B, J] delta pull (host mode)."""
        sids = list(sids)
        if not sids:
            return {}
        if self.history == "device":
            path, entered = self._device_backtrace_all(final=False)
            out: Dict[object, list] = {}
            for sid in sids:
                b = self._sid_to_slot[sid]
                n = self.slots[b].n_frames
                out[sid] = (self._words_of(path[b, :n], entered[b, :n])
                            if n else [])
            return out
        deltas = np.asarray(self.delta)
        return {sid: self.partial(sid, delta_np=deltas) for sid in sids}

    def finalize(self, sid) -> Tuple[List[str], float]:
        """Exact final result (applies final_logp); frees the slot.
        All frames must have drained: drive tick() until drained(sid)."""
        b = self._sid_to_slot[sid]
        s = self.slots[b]
        assert self.drained(sid), "finalize before drained()"
        audio_s = s.samples / self.fcfg.sample_rate
        if s.n_frames == 0:
            words: List[str] = []
        elif self.history == "device":
            path, entered = self._device_backtrace_all(final=True)
            words = self._words_of(path[b, : s.n_frames],
                                   entered[b, : s.n_frames])
        else:
            final = (np.asarray(self.delta[b])
                     + np.asarray(self.graphs["final_logp"][b]))
            path, entered = self._slot_backtrace(
                b, s.n_frames, int(final.argmax()))
            words = self._words_of(path, entered)
        self._release(sid)
        return words, audio_s

    def finalize_many(self, sids) -> Dict[object, Tuple[List[str], float]]:
        """Finalize MANY drained sessions with ONE device backtrace dispatch
        (device mode; host mode just loops). Frees their slots."""
        sids = [sid for sid in sids if sid in self._sid_to_slot]
        if self.history != "device" or not sids:
            return {sid: self.finalize(sid) for sid in sids}
        path, entered = self._device_backtrace_all(final=True)
        out: Dict[object, Tuple[List[str], float]] = {}
        for sid in sids:
            b = self._sid_to_slot[sid]
            s = self.slots[b]
            assert self.drained(sid), "finalize before drained()"
            audio_s = s.samples / self.fcfg.sample_rate
            n = s.n_frames
            words = self._words_of(path[b, :n], entered[b, :n]) if n else []
            self._release(sid)
            out[sid] = (words, audio_s)
        return out


# ---------------------------------------------------------------------------
# Neural CTC family: stateful LSTM + streaming CTC decode
# ---------------------------------------------------------------------------

@jax.jit
def _reset_carries(carries, mask: jax.Array):
    return jax.tree_util.tree_map(
        lambda x: jnp.where(
            mask.reshape((-1,) + (1,) * (x.ndim - 1)), 0.0, x
        ),
        carries,
    )


class BatchedCtcEngine(_BaseSlotEngine):
    """Slot-batched streaming recognizer, neural CTC family (cli/serve.py
    --ctc): stateful LSTM chunks scored for ALL sessions in one dispatch
    (ragged slots via masked carries — LstmAmStream(n_valid)), then per-slot
    host CTC streaming decode (greedy or prefix beam, optional biasing).

    stream_model: am.neural.LstmAmStream (parameters of the OFFLINE LstmAm)
    make_decoder: () -> am.ctc.CtcStreamDecoder (greedy/beam/biased)
    init_carries: [B]-batched zero carries (am.neural.lstm_stream_init)
    """

    def __init__(
        self,
        stream_model,
        params,
        make_decoder: Callable[[], object],
        init_carries,
        fcfg: FrontendConfig,
        capacity: int = 16,
        tick_frames: int = 24,
        cmvn_mean: Optional[np.ndarray] = None,
        cmvn_istd: Optional[np.ndarray] = None,
        feature_path: str = "host",
        defer_absorb: bool = True,
    ):
        super().__init__(fcfg, capacity, tick_frames, cmvn_mean, cmvn_istd,
                         feature_path=feature_path)
        self.make_decoder = make_decoder
        self.carries = init_carries
        self._decoders: List[Optional[object]] = [None] * self.capacity
        # Deferred absorption (round 5, mirrors the AED engine's round-4
        # fix): the per-tick [B, F, V] logp pull is a synchronized
        # dispatch; deferring it to partial()/finalize() boundaries leaves
        # the tick fully async. False = the immediate-pull A/B arm.
        self.defer_absorb = bool(defer_absorb)
        self._pending: List[tuple] = []

        @jax.jit
        def _step(carries, feats, n_valid):
            logits, new_carries = stream_model.apply(
                params, feats, carries, n_valid
            )
            return jax.nn.log_softmax(logits, axis=-1), new_carries

        self._step = _step

    # -- hooks --

    def _init_slot(self, b: int) -> None:
        self._decoders[b] = self.make_decoder()

    def _apply_resets(self, mask: np.ndarray) -> None:
        self.carries = _reset_carries(self.carries, jnp.asarray(mask))

    def _dispatch_decode(self, feats: np.ndarray, n_valid: np.ndarray):
        logp, self.carries = self._step(
            self.carries, jnp.asarray(feats), jnp.asarray(n_valid)
        )
        return logp

    def _absorb_decode(self, handle, n_valid: np.ndarray) -> None:
        self._pending.append((handle, n_valid.copy()))
        # bound the device-resident backlog (same rationale as the AED
        # engine: ~[B, F, V] buffers must not pile up unboundedly)
        if not self.defer_absorb or len(self._pending) >= 64:
            self._flush_pending()

    def _flush_pending(self) -> None:
        """Pull every queued chunk logp in one block and replay the
        per-slot streaming decoders. Slots are only re-assigned through
        finalize, which flushes first, so pending rows always belong to
        the decoders currently installed."""
        if not self._pending:
            return
        pending, self._pending = self._pending, []
        jax.block_until_ready(pending[-1][0])   # one sync for the backlog
        for logp, n_valid in pending:
            logp_np = np.asarray(logp)
            for b in range(self.capacity):
                n = int(n_valid[b])
                if n:
                    self._decoders[b].step(logp_np[b, :n])

    # -- results --

    def partial(self, sid) -> List[int]:
        """Best-so-far unit ids (flushes the deferred logp backlog)."""
        self._flush_pending()
        return list(self._decoders[self._sid_to_slot[sid]].partial())

    def finalize(self, sid) -> Tuple[List[int], float]:
        self._flush_pending()
        b = self._sid_to_slot[sid]
        s = self.slots[b]
        assert self.drained(sid), "finalize before drained()"
        audio_s = s.samples / self.fcfg.sample_rate
        units = list(self._decoders[b].finalize())
        self._decoders[b] = None
        self._release(sid)
        return units, audio_s


# ---------------------------------------------------------------------------
# RNN-T family: stateful LSTM encoder + on-device chunk-resumable greedy
# ---------------------------------------------------------------------------

@jax.jit
def _reset_rows(state, state0, mask: jax.Array):
    """Restore freed slots' rows of a [B, ...] pytree to pristine values."""
    return jax.tree_util.tree_map(
        lambda cur, init: jnp.where(
            mask.reshape((-1,) + (1,) * (cur.ndim - 1)), init, cur
        ),
        state, state0,
    )


@jax.jit
def _clear_hyp(state):
    """Empty the per-tick hypothesis buffer (symbols already harvested)."""
    carry, pred, hyp, lens = state
    return carry, pred, jnp.full_like(hyp, -1), jnp.zeros_like(lens)


class BatchedRnntEngine(_BaseSlotEngine):
    """Slot-batched streaming recognizer, RNN-T family (cli/serve.py --rnnt).

    One tick = ONE stateful-LSTM encoder dispatch over all slots (masked
    carries, as in the CTC family) + ONE chunk-resumable device greedy scan
    (am.rnnt._device_greedy_chunk_fn) advancing every session's prediction
    state together — frames at/after a slot's valid count are inert inside
    the scan, so ragged arrival is exact.

    Unlike the dedicated RnntDeviceStream (whose [B, u_cap] hypothesis
    buffer caps a stream's TOTAL symbols), the engine harvests emitted
    symbols to per-slot host lists every tick and clears the device buffer,
    so its static size is exactly one tick's worst case
    (tick_frames * max_symbols_per_frame) and sessions are unbounded.

    model/params: am.rnnt.RnntModel (encoder_arch='lstm') + its checkpoint.
    """

    def __init__(
        self,
        model,
        params,
        fcfg: FrontendConfig,
        capacity: int = 16,
        tick_frames: int = 24,
        max_symbols_per_frame: int = 4,
        cmvn_mean: Optional[np.ndarray] = None,
        cmvn_istd: Optional[np.ndarray] = None,
        greedy_impl: str = "frame_scan",
        feature_path: str = "host",
        defer_absorb: bool = True,
    ):
        super().__init__(fcfg, capacity, tick_frames, cmvn_mean, cmvn_istd,
                         feature_path=feature_path)
        from mogasr.am.neural import LstmAmStream
        from mogasr.am.rnnt import _chunk_greedy_fn, _rnnt_stream_carries

        assert model.encoder_arch == "lstm", "streaming needs the lstm encoder"
        B = self.capacity
        self.params = params
        # chunked stateful encoder reusing the OFFLINE encoder params
        # (same construction as am.rnnt.make_rnnt_stream_encoder, plus the
        # n_valid mask so idle/ragged slots do not advance their carries)
        enc_stream = LstmAmStream(
            n_pdfs=model.enc_hidden, hidden=model.enc_hidden,
            layers=model.enc_layers,
        )
        enc_params = {"params": params["params"]["encoder"]}
        self.enc_carries = _rnnt_stream_carries(model, B, fcfg.feat_dim)

        @jax.jit
        def _enc_step(carries, feats, n_valid):
            enc, new_carries = enc_stream.apply(
                enc_params, feats, carries, n_valid
            )
            return new_carries, enc

        self._enc_step = _enc_step
        u_cap = self.tick_frames * int(max_symbols_per_frame)
        init_state, self._consume = _chunk_greedy_fn(
            model, u_cap, int(max_symbols_per_frame), greedy_impl
        )
        self.dec_state = init_state(params, B)
        # pristine rows (SOS-stepped carry/pred, empty buffer) for slot reset
        self._dec_state0 = jax.tree_util.tree_map(jnp.copy, self.dec_state)
        self._enc_carries0 = jax.tree_util.tree_map(jnp.copy, self.enc_carries)
        self._units: List[List[int]] = [[] for _ in range(B)]
        # deferred harvest of the per-tick [B, u_cap] hypothesis buffers
        # (each tick's buffer is a distinct array — the device clear makes
        # them safe to pull late); same backlog bound as the CTC/AED paths
        self.defer_absorb = bool(defer_absorb)
        self._pending: List[tuple] = []

    # -- hooks --

    def _init_slot(self, b: int) -> None:
        self._units[b] = []

    def _apply_resets(self, mask: np.ndarray) -> None:
        m = jnp.asarray(mask)
        self.enc_carries = _reset_rows(self.enc_carries, self._enc_carries0, m)
        self.dec_state = _reset_rows(self.dec_state, self._dec_state0, m)

    def _dispatch_decode(self, feats: np.ndarray, n_valid: np.ndarray):
        nv = jnp.asarray(n_valid)
        self.enc_carries, enc = self._enc_step(
            self.enc_carries, jnp.asarray(feats), nv
        )
        self.dec_state = self._consume(self.params, self.dec_state, enc, nv)
        _carry, _pred, hyp, lens = self.dec_state
        # the harvest handle holds the tick's buffer; next tick starts empty
        self.dec_state = _clear_hyp(self.dec_state)
        return hyp, lens

    def _absorb_decode(self, handle, n_valid: np.ndarray) -> None:
        self._pending.append(handle)
        if not self.defer_absorb or len(self._pending) >= 64:
            self._flush_pending()

    def _flush_pending(self) -> None:
        """Harvest every queued tick's hypothesis buffer in one block.
        Slot rows are only re-assigned through finalize (which flushes
        first), so pending buffers always belong to the current _units."""
        if not self._pending:
            return
        pending, self._pending = self._pending, []
        jax.block_until_ready(pending[-1][0])   # one sync for the backlog
        for hyp, lens in pending:
            hyp_np = np.asarray(hyp)    # [B, u_cap]
            lens_np = np.asarray(lens)  # [B]
            for b in range(self.capacity):
                n = int(lens_np[b])
                if n:
                    self._units[b].extend(hyp_np[b, :n].tolist())

    # -- results --

    def partial(self, sid) -> List[int]:
        """Best-so-far unit ids (flushes the deferred harvest backlog)."""
        self._flush_pending()
        return list(self._units[self._sid_to_slot[sid]])

    def finalize(self, sid) -> Tuple[List[int], float]:
        self._flush_pending()
        b = self._sid_to_slot[sid]
        s = self.slots[b]
        assert self.drained(sid), "finalize before drained()"
        audio_s = s.samples / self.fcfg.sample_rate
        units = list(self._units[b])
        self._units[b] = []
        self._release(sid)
        return units, audio_s


# ---------------------------------------------------------------------------
# Streaming AED family: chunk-masked Conformer chunks + exact attention final
# ---------------------------------------------------------------------------

class BatchedAedEngine(_BaseSlotEngine):
    """Slot-batched streaming recognizer, chunked-AED family (cli/serve.py
    --aed --engine).

    The streaming AED consumes ATOMIC chunks of ``4 * chunk_frames`` feature
    frames, so a tick advances each slot by exactly one chunk (or not at
    all): ONE batched ``encode_stream_step`` dispatch carries every live
    session's per-block caches in shared ``[B, ...]`` rows, with idle slots'
    caches restored by a masked merge (garbage rows are computed and
    discarded — the XLA-friendly alternative to ragged control flow).
    CTC-greedy partials come from the chunk's CTC head via per-slot host
    decoders (same as the per-session server); ``finalize`` runs the EXACT
    chunk-masked attention beam over the session's full feature history
    (identical encoder, so one checkpoint serves both stages).

    Final-pass compile discipline: feature histories are padded up to
    ``final_bucket`` frames (the chunk-masked encoder is padding-invariant
    under n_frames masking) and ``max_tokens`` derives from the BUCKETED
    length, so the number of distinct jit variants is bounded by the number
    of buckets, not utterance lengths. The per-session serve path uses the
    same convention, so engine finals equal per-session finals exactly.
    """

    def __init__(
        self,
        model,
        params,
        fcfg: FrontendConfig,
        capacity: int = 8,
        beam: int = 4,
        ctc_weight: float = 0.3,
        final_bucket: int = 256,
        cmvn_mean: Optional[np.ndarray] = None,
        cmvn_istd: Optional[np.ndarray] = None,
        final_early_exit: bool = True,
        defer_absorb: bool = True,
        feature_path: str = "host",
        stream_precision: str = "float32",
    ):
        """stream_precision="bfloat16" runs the per-tick chunk step
        (encoder caches + CTC head) with bf16 params/activations — the
        engine's ceiling is encoder compute. The master cache state stays f32 (cast in/out per step,
        so rounding does not accumulate across a session) and the
        attention FINALS stay f32 exact; only CTC-greedy PARTIALS can
        flip on near-ties (decision-equivalence-tested like the offline
        bf16 scorers, tests/test_engine_device_feats.py)."""
        from mogasr.am import aed as A

        raw_per = 4 * model.chunk_frames
        assert raw_per > 0, "streaming AED needs chunk_frames > 0"
        super().__init__(fcfg, capacity, raw_per, cmvn_mean, cmvn_istd,
                         feature_path=feature_path)
        if stream_precision not in ("float32", "bfloat16"):
            raise ValueError(f"stream_precision: {stream_precision}")
        self.stream_precision = stream_precision
        self.model = model
        self.params = params
        self.beam = int(beam)
        self.ctc_weight = float(ctc_weight)
        self.final_bucket = int(final_bucket)
        # finals stop once every beam hits eos (identical hypotheses,
        # tested) instead of paying the worst-case token budget
        # aed_final_max_tokens(T)=2+T/4; False = the fixed-scan A/B arm
        self.final_early_exit = bool(final_early_exit)
        # Deferred absorption (round 4): the per-tick logp pull was HALF the
        # engine's sync budget (profiled: 216 ms/tick vs 6.6 ms of raw
        # chunk-step compute — the tick is dispatch/sync-bound, not
        # compute-bound). Chunk logps stay device-resident and the host
        # CTC-greedy partial decoders replay them at the next partial()/
        # finalize() boundary — one block for the whole backlog instead of
        # one per tick. False = the immediate-pull A/B arm (r3 production).
        self.defer_absorb = bool(defer_absorb)
        self._pending: List[tuple] = []
        B = self.capacity
        self.enc_state = A.aed_stream_init(model, B, fcfg.feat_dim)
        self._state0 = jax.tree_util.tree_map(jnp.copy, self.enc_state)
        self._decoders: List[Optional[object]] = [None] * B
        self._feats_hist: List[List[np.ndarray]] = [[] for _ in range(B)]
        self._final_decoders: Dict[int, object] = {}

        if stream_precision == "bfloat16":
            from mogasr.am.quantize import cast_float_leaves

            params16 = cast_float_leaves(params, jnp.bfloat16)

            @jax.jit
            def _step(state, feats, live):
                s16 = cast_float_leaves(state, jnp.bfloat16)
                _enc, ctc_logits, new_state = model.apply(
                    params16, feats.astype(jnp.bfloat16), s16,
                    method=A.AedModel.encode_stream_step
                )
                new_state = cast_float_leaves(new_state, jnp.float32)
                merged = jax.tree_util.tree_map(
                    lambda n, o: jnp.where(
                        live.reshape((-1,) + (1,) * (n.ndim - 1)), n, o
                    ),
                    new_state, state,
                )
                return (jax.nn.log_softmax(
                    ctc_logits.astype(jnp.float32), axis=-1), merged)
        else:
            @jax.jit
            def _step(state, feats, live):
                _enc, ctc_logits, new_state = model.apply(
                    params, feats, state, method=A.AedModel.encode_stream_step
                )
                merged = jax.tree_util.tree_map(
                    lambda n, o: jnp.where(
                        live.reshape((-1,) + (1,) * (n.ndim - 1)), n, o
                    ),
                    new_state, state,
                )
                return jax.nn.log_softmax(ctc_logits, axis=-1), merged

        self._step = _step

    # -- hooks --

    def _take(self, available: int) -> int:
        return self.tick_frames if available >= self.tick_frames else 0

    def _init_slot(self, b: int) -> None:
        from mogasr.am.ctc import CtcStreamDecoder

        self._decoders[b] = CtcStreamDecoder(
            blank_id=self.model.n_units, mode="greedy"
        )
        self._feats_hist[b] = []

    def _apply_resets(self, mask: np.ndarray) -> None:
        self.enc_state = _reset_rows(
            self.enc_state, self._state0, jnp.asarray(mask)
        )

    def _dispatch_decode(self, feats: np.ndarray, n_valid: np.ndarray):
        logp, self.enc_state = self._step(
            self.enc_state, jnp.asarray(feats), jnp.asarray(n_valid > 0)
        )
        return logp, feats

    def _absorb_decode(self, handle, n_valid: np.ndarray) -> None:
        logp, feats = handle
        if self.feature_path == "host":
            # feature history is host data already; only the logp pull is
            # deferred
            for b in range(self.capacity):
                if n_valid[b]:
                    self._feats_hist[b].append(feats[b, : n_valid[b]].copy())
            feats = None
        self._pending.append((logp, feats, n_valid.copy()))
        # bound the device-resident backlog: a server that rarely asks for
        # partials must not accumulate [B, chunk, V] logp buffers without
        # limit (~2.5 MB each at production sizes)
        if not self.defer_absorb or len(self._pending) >= 64:
            self._flush_pending()

    def _flush_pending(self) -> None:
        """Pull every queued chunk logp (and, on the device feature path,
        the consumed feature rows for the attention-final history) in one
        block and replay the host CTC-greedy partial decoders. Called
        before any consumer of decoder state (partial/finalize); slots are
        only re-assigned through finalize, which flushes first, so pending
        rows always belong to the decoders currently installed."""
        if not self._pending:
            return
        pending, self._pending = self._pending, []
        jax.block_until_ready(pending[-1][0])  # one sync for the backlog
        for logp, feats, n_valid in pending:
            logp_np = np.asarray(logp)
            feats_np = np.asarray(feats) if feats is not None else None
            for b in range(self.capacity):
                if n_valid[b]:
                    self._decoders[b].step(logp_np[b])
                    if feats_np is not None:
                        self._feats_hist[b].append(
                            feats_np[b, : n_valid[b]].copy())

    # -- results --

    def drained(self, sid) -> bool:
        """The sub-chunk feature tail is consumed by the attention final,
        not the streaming stage."""
        b = self._sid_to_slot[sid]
        return self.slots[b].flushed and self._feat_avail(b) < self.tick_frames

    def _leftover_rows(self, b: int, s: _Slot) -> List[np.ndarray]:
        """Emitted-but-unconsumed feature rows (the sub-chunk tail) for the
        attention final. Device path: one small queue pull per finalize."""
        if self.feature_path == "device":
            n = int(self._q_len[b])
            return [np.asarray(self._qbuf[b, :n])] if n else []
        return [s.feat_q] if len(s.feat_q) else []

    def partial(self, sid) -> List[int]:
        """Best-so-far CTC-greedy unit ids (flushes the deferred backlog:
        one block per partial boundary, not per tick)."""
        self._flush_pending()
        return list(self._decoders[self._sid_to_slot[sid]].partial())

    def _final_decoder(self, t_bucket: int):
        from mogasr.am import aed as A

        dec = self._final_decoders.get(t_bucket)
        if dec is None:
            dec = A.make_aed_decoder(
                self.model, self.params, beam=self.beam,
                max_tokens=aed_final_max_tokens(t_bucket),
                ctc_weight=self.ctc_weight,
                early_exit=self.final_early_exit,
            )
            self._final_decoders[t_bucket] = dec
        return dec

    def finalize(self, sid) -> Tuple[List[int], float]:
        self._flush_pending()
        b = self._sid_to_slot[sid]
        s = self.slots[b]
        assert self.drained(sid), "finalize before drained()"
        audio_s = s.samples / self.fcfg.sample_rate
        parts = self._feats_hist[b] + self._leftover_rows(b, s)
        fa = (np.concatenate(parts, axis=0) if parts
              else np.zeros((0, self.fcfg.feat_dim), np.float32))
        T = fa.shape[0]
        if T == 0:
            units: List[int] = []
        else:
            Tb = -(-T // self.final_bucket) * self.final_bucket
            padded = np.zeros((1, Tb, fa.shape[1]), np.float32)
            padded[0, :T] = fa
            toks, n_toks, _ = self._final_decoder(Tb)(
                jnp.asarray(padded), jnp.asarray([T], np.int32)
            )
            toks, n_toks = np.asarray(toks), np.asarray(n_toks)
            units = list(map(int, toks[0, : n_toks[0]]))
        self._decoders[b] = None
        self._feats_hist[b] = []
        self._release(sid)
        return units, audio_s

    def finalize_many(self, sids) -> Dict[object, Tuple[List[int], float]]:
        """Finalize MANY drained sessions with one batched attention-beam
        dispatch per T-bucket instead of a batch-1 chain per session.

        Sessions whose padded histories share a `final_bucket` ceiling are
        stacked into one [N_bucket, Tb, D] call of the SAME cached decoder
        (jit retraces per batch shape; N is rounded up to a power of two
        with nframes=1 dummy rows so compile variants stay bounded by
        T-buckets x log2(capacity)). Beam rows are independent, so the
        hypotheses equal per-session ``finalize`` — exactly on CPU,
        decision-equivalent on an accelerator (batch-shape tiling
        noise). At epoch drain in benchmarks/bench_serve.py
        this turns capacity-many sequential final chains into a handful."""
        self._flush_pending()
        sids = [sid for sid in sids if sid in self._sid_to_slot]
        out: Dict[object, Tuple[List[int], float]] = {}
        groups: Dict[int, list] = {}
        for sid in sids:
            b = self._sid_to_slot[sid]
            s = self.slots[b]
            assert self.drained(sid), "finalize before drained()"
            audio_s = s.samples / self.fcfg.sample_rate
            parts = self._feats_hist[b] + self._leftover_rows(b, s)
            fa = (np.concatenate(parts, axis=0) if parts
                  else np.zeros((0, self.fcfg.feat_dim), np.float32))
            if fa.shape[0] == 0:
                out[sid] = ([], audio_s)
                self._decoders[b] = None
                self._feats_hist[b] = []
                self._release(sid)
                continue
            Tb = -(-fa.shape[0] // self.final_bucket) * self.final_bucket
            groups.setdefault(Tb, []).append((sid, b, fa, audio_s))
        for Tb, items in groups.items():
            nb = 1 << (len(items) - 1).bit_length()
            padded = np.zeros((nb, Tb, self.fcfg.feat_dim), np.float32)
            nf = np.ones((nb,), np.int32)  # dummy rows: 1 zero frame
            for i, (_sid, _b, fa, _a) in enumerate(items):
                padded[i, : fa.shape[0]] = fa
                nf[i] = fa.shape[0]
            toks, n_toks, _ = self._final_decoder(Tb)(
                jnp.asarray(padded), jnp.asarray(nf)
            )
            toks, n_toks = np.asarray(toks), np.asarray(n_toks)
            for i, (sid, b, _fa, audio_s) in enumerate(items):
                out[sid] = (list(map(int, toks[i, : n_toks[i]])), audio_s)
                self._decoders[b] = None
                self._feats_hist[b] = []
                self._release(sid)
        return out


def aed_final_max_tokens(t_frames: int) -> int:
    """Shared finalization token cap (engine AND per-session serve use the
    same convention so their finals are identical)."""
    return max(8, 2 + t_frames // 4)
