#!/usr/bin/env python3
"""Voice-activity detection as vectorized frame-mask computation.

Three levels, all pure JAX:

1. ``voice_activity_detection`` — fixed dual-threshold mask
   ``(E > T_E) & (Z < T_Z)`` (reference ``signal_processing/vad.py:12-41``;
   note voiced frames have *low* ZCR).
2. ``adaptive_voice_activity_detection`` — EWMA-of-means thresholds blended
   from history vs the current batch, clamped alpha [0, 0.99], floor/ceiling
   applied (reference vad.py:44-99).
3. The streaming composite VAD of the runtime engine (energy gate AND
   (zcr gate OR entropy gate), OR'd with the per-frame adaptive decision, then
   hangover/release smoothing — reference engine.py:253-288) — expressed as
   **parallel prefix computations** instead of a per-frame Python state
   machine:

   - the hangover/release automaton's output depends only on the distance
     ``d`` since the last initially-voiced frame: ``vad = d < ON + OFF``
     (hold counts ON frames, then OFF-1 further frames stay voiced while the
     release counter ramps). A cummax over voiced indices yields ``d`` for
     every frame at once (``lax.associative_scan``), so the whole block is
     data-parallel. A ``lax.scan`` transliteration of the
     automaton is kept as ``hangover_smooth_scan`` and the two are asserted
     equal in tests.
   - the adaptive-VAD trailing history (deque(maxlen=256) of past frame
     features, engine.py:96-97) becomes a windowed trailing mean computed
     with one convolution against a ones-kernel; the carried state is the
     last 256 feature values plus a count.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "voice_activity_detection",
    "adaptive_voice_activity_detection",
    "VadState",
    "initial_vad_state",
    "streaming_vad",
    "hangover_smooth",
    "hangover_smooth_scan",
    "pack_state",
    "unpack_state",
    "initial_packed_state",
]

# A plain numpy scalar, NOT jnp: a module-level jnp constant would force
# backend initialization at import time, making ``import sspv_tpu`` fail
# outright when the device is unavailable.
_NEG_LARGE = np.int32(-(2**30))

# Trace-evidence counter: bumped at TRACE time whenever the blocked
# two-level-cumsum trailing-sum implementation is actually selected (i.e.
# ``f % history_len == 0`` and impl == "blocked"). Tests and the driver
# dryrun read this to prove the production-default path — not the conv
# fallback — was compiled into a given program; cached jit calls don't
# retrace, so assert on a delta across a *fresh* pipeline/jit, not absolutes.
BLOCKED_TRACE_COUNT = 0


def voice_activity_detection(
    energy: jnp.ndarray,
    zcr: jnp.ndarray,
    energy_threshold: float,
    zcr_threshold: float,
) -> jnp.ndarray:
    """Fixed dual-threshold VAD mask (True == voice)."""
    e = jnp.asarray(energy, dtype=jnp.float32)
    z = jnp.asarray(zcr, dtype=jnp.float32)
    return (e > jnp.float32(energy_threshold)) & (z < jnp.float32(zcr_threshold))


def adaptive_voice_activity_detection(
    energy: jnp.ndarray,
    zcr: jnp.ndarray,
    energy_history: jnp.ndarray | None,
    zcr_history: jnp.ndarray | None,
    alpha: float = 0.8,
    min_energy_threshold: float = 1e-6,
    max_zcr_threshold: float = 0.5,
) -> jnp.ndarray:
    """Adaptive VAD over a batch: one threshold pair from blended means.

    ``energy_history``/``zcr_history`` are 1-D arrays of past per-frame means
    (empty/None falls back to the current batch mean), matching the reference
    list-of-floats semantics.
    """
    e = jnp.asarray(energy, dtype=jnp.float32)
    z = jnp.asarray(zcr, dtype=jnp.float32)
    cur_e = jnp.mean(e) if e.size else jnp.float32(0.0)
    cur_z = jnp.mean(z) if z.size else jnp.float32(0.0)

    def _hist_mean(hist, cur):
        if hist is None:
            return cur
        h = jnp.asarray(hist, dtype=jnp.float32)
        if h.size == 0:
            return cur
        return jnp.mean(h)

    hist_e = _hist_mean(energy_history, cur_e)
    hist_z = _hist_mean(zcr_history, cur_z)

    a = jnp.float32(max(0.0, min(float(alpha), 0.99)))
    e_th = jnp.maximum(
        jnp.float32(min_energy_threshold), a * hist_e + (1 - a) * cur_e
    )
    z_th = jnp.minimum(jnp.float32(max_zcr_threshold), a * hist_z + (1 - a) * cur_z)
    return (e > e_th) & (z < z_th)


# ---------------------------------------------------------------------------
# Streaming composite VAD (engine semantics), block-parallel with carry state
# ---------------------------------------------------------------------------


class VadState(NamedTuple):
    """Carry state threaded between streaming blocks.

    ``energy_buf``/``zcr_buf``: last ``history_len`` per-frame features,
    zero-padded at the front while ``count < history_len``.
    ``count``: number of valid history entries (int32 scalar).
    ``last_voiced``: index of the most recent initially-voiced frame relative
    to the *next* block's first frame (<= -1; the initial virtual value
    ``-(ON+1)`` reproduces the automaton's cold-start behavior).
    """

    energy_buf: jnp.ndarray
    zcr_buf: jnp.ndarray
    count: jnp.ndarray
    last_voiced: jnp.ndarray


def initial_vad_state(history_len: int = 256, hangover_on: int = 3) -> VadState:
    return VadState(
        energy_buf=jnp.zeros((history_len,), dtype=jnp.float32),
        zcr_buf=jnp.zeros((history_len,), dtype=jnp.float32),
        count=jnp.int32(0),
        last_voiced=jnp.int32(-(int(hangover_on) + 1)),
    )


def pack_state(state: VadState) -> jnp.ndarray:
    """Flatten a ``VadState`` into ONE f32 vector ``(2*history_len + 2,)``.

    The two int32 scalars are bitcast (not value-cast), so the round trip is
    exact for every possible value — including the ``-(2**30)``-magnitude
    cold-start ``last_voiced``, which a value cast to f32 would round.

    Why: each device buffer moved is a separate host<->device transfer;
    carrying the streaming state as one buffer instead of four halves the
    engine's per-dispatch transfer count.
    """
    scalars = jnp.stack(
        [jnp.int32(state.count), jnp.int32(state.last_voiced)]
    )
    return jnp.concatenate(
        [
            jnp.asarray(state.energy_buf, jnp.float32),
            jnp.asarray(state.zcr_buf, jnp.float32),
            jax.lax.bitcast_convert_type(scalars, jnp.float32),
        ]
    )


def unpack_state(packed: jnp.ndarray, history_len: int) -> VadState:
    """Inverse of :func:`pack_state` (shape-static; safe inside jit)."""
    scalars = jax.lax.bitcast_convert_type(packed[-2:], jnp.int32)
    return VadState(
        energy_buf=packed[:history_len],
        zcr_buf=packed[history_len : 2 * history_len],
        count=scalars[0],
        last_voiced=scalars[1],
    )


def initial_packed_state(
    history_len: int = 256, hangover_on: int = 3
) -> np.ndarray:
    """Host-side packed initial state (no device round-trip needed)."""
    out = np.zeros((2 * history_len + 2,), dtype=np.float32)
    scalars = np.array([0, -(int(hangover_on) + 1)], dtype=np.int32)
    out[-2:] = scalars.view(np.float32)
    return out


def _blocked_trailing_sums(ext: jnp.ndarray, f: int, history_len: int) -> jnp.ndarray:
    """Sliding-window sums via two-level block cumsums (requires
    ``f % history_len == 0`` so ``ext`` reshapes into whole blocks).

    The window at frame ``t = q*H + r`` spans a suffix of block ``q`` plus a
    prefix of block ``q+1``; one vectorized cumsum per direction along the
    lane axis yields every prefix/suffix at once. ~12 fused elementwise ops
    instead of the H shifted adds a ones-kernel convolution lowers to
    (tools/vad_microbench.py).

    Both cumsums are DIRECT summations. Subtractive forms
    (``total - prefix`` or ``cumsum(b) - b``) cancel catastrophically when a
    quiet window follows loud audio inside one block (error scales with the
    block total, not the window sum — percent-level on realistic
    loud-speech-then-pause energies), which flips threshold decisions.
    Direct sums stay at the ~1e-7 relative level of the convolution;
    decision parity vs the sequential oracle is enforced by the
    chunking/padding and dynamic-range fuzz tests.
    """
    global BLOCKED_TRACE_COUNT
    BLOCKED_TRACE_COUNT += 1
    h = history_len
    nb = f // h
    b = ext.reshape(*ext.shape[:-1], nb + 1, h)
    # inclusive prefix sums, then shift right one lane for the exclusive
    # form P[i, r] = sum(b[i, :r]) (pad-after-cumsum: same additions as
    # cumsum-after-shift, one fewer materialization)
    incl = jax.lax.cumsum(b, axis=b.ndim - 1)
    pre = jnp.pad(
        incl[..., :-1], [(0, 0)] * (b.ndim - 1) + [(1, 0)]
    )
    # inclusive suffix sums S[i, r] = sum(b[i, r:]) — the reverse scan is a
    # primitive flag, no array reversal materialized
    suf = jax.lax.cumsum(b, axis=b.ndim - 1, reverse=True)
    return (suf[..., :nb, :] + pre[..., 1:, :]).reshape(*ext.shape[:-1], f)


def _trailing_means(
    values: jnp.ndarray,
    buf: jnp.ndarray,
    count: jnp.ndarray,
    history_len: int,
    impl: str = "conv",
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Per-frame mean of the previous <= history_len feature values.

    Returns ``(means, new_buf)``; frames with an empty history get the current
    value itself (vad.py:88-89 falls back to the current mean).
    ``impl``: "conv" (ones-kernel convolution) or "blocked" (two-level block
    cumsums; falls back to conv when ``f % history_len != 0``).
    """
    f = values.shape[0]
    ext = jnp.concatenate([buf, values])  # (history_len + f,)
    if impl == "blocked" and f and f % history_len == 0:
        sums = _blocked_trailing_sums(ext, f, history_len)
    else:
        kernel = jnp.ones((history_len,), dtype=jnp.float32)
        # sums[t] = sum(ext[t : t+history_len]) = trailing window ending just
        # before frame t.  jnp.convolve(ext, ones, 'valid') gives f+1 sums.
        # Precision pinned: at DEFAULT an accelerator may run this f32
        # convolution in reduced precision (TF32 on the GPU's tensor
        # cores); threshold decisions need f32 sums.
        sums = jnp.convolve(
            ext, kernel, mode="valid", precision=jax.lax.Precision.HIGHEST
        )[:f]
    idx = jnp.arange(f, dtype=jnp.int32)
    counts = jnp.minimum(count + idx, history_len)
    means = jnp.where(
        counts > 0, sums / jnp.maximum(counts, 1).astype(jnp.float32), values
    )
    new_buf = ext[-history_len:]
    return means, new_buf


def _trailing_means_pair(
    v1: jnp.ndarray,
    v2: jnp.ndarray,
    buf1: jnp.ndarray,
    buf2: jnp.ndarray,
    count: jnp.ndarray,
    history_len: int,
    impl: str = "conv",
):
    """Trailing means for two feature streams sharing one count.

    On the blocked path the two streams are stacked into a single batched
    two-level-cumsum call — per-row arithmetic is identical to two separate
    calls, but the op count of the VAD stage is halved. Returns ``((means1, means2), (new_buf1, new_buf2))``.
    """
    f = v1.shape[0]
    if impl == "blocked" and f and f % history_len == 0:
        vals = jnp.stack([v1, v2])  # (2, f)
        bufs = jnp.stack([buf1, buf2])  # (2, history_len)
        ext = jnp.concatenate([bufs, vals], axis=1)  # (2, history_len + f)
        sums = _blocked_trailing_sums(ext, f, history_len)  # (2, f)
        idx = jnp.arange(f, dtype=jnp.int32)
        counts = jnp.minimum(count + idx, history_len)
        means = jnp.where(
            counts > 0, sums / jnp.maximum(counts, 1).astype(jnp.float32), vals
        )
        new_bufs = ext[:, -history_len:]
        return (means[0], means[1]), (new_bufs[0], new_bufs[1])
    m1, b1 = _trailing_means(v1, buf1, count, history_len, impl)
    m2, b2 = _trailing_means(v2, buf2, count, history_len, impl)
    return (m1, m2), (b1, b2)


# Lane width of one blocked-cummax row. The flat associative_scan lowers to
# log2(f) levels of strided odd/even slices over the whole frame axis; the
# blocked form reduces the recursion to a 256x-smaller problem plus three
# lane-major passes.
_CUMMAX_BLOCK = 256


def _cummax(seeds: jnp.ndarray) -> jnp.ndarray:
    """Inclusive cummax of a 1-D int32 vector.

    For long multiples of ``_CUMMAX_BLOCK`` (every padded full-length VAD
    pass: f is padded to a multiple of history_len == 256), uses a
    two-level block decomposition: an inclusive lane-axis cummax within
    each ``(f/256, 256)`` row, then a 256x-smaller exclusive cummax over
    row totals, combined with one elementwise max. max is exactly
    associative, so the result is BIT-identical to the flat scan (tests
    assert equality against ``hangover_smooth_scan``). Short or unaligned
    blocks (streaming buckets) keep the flat ``associative_scan``."""
    f = seeds.shape[0]
    if f < 4 * _CUMMAX_BLOCK or f % _CUMMAX_BLOCK:
        return jax.lax.associative_scan(jnp.maximum, seeds)
    rows = seeds.reshape(f // _CUMMAX_BLOCK, _CUMMAX_BLOCK)
    within = jax.lax.cummax(rows, axis=1)
    totals = within[:, -1]
    # exclusive cummax of row totals: shift the inclusive form right one row
    carry = jnp.concatenate(
        [jnp.full((1,), _NEG_LARGE), jax.lax.cummax(totals, axis=0)[:-1]]
    )
    return jnp.maximum(within, carry[:, None]).reshape(f)


def hangover_smooth(
    vad_initial: jnp.ndarray,
    last_voiced: jnp.ndarray,
    hangover_on: int,
    release_off: int,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Hangover/release smoothing via cummax of voiced indices.

    Equivalent to the sequential automaton (engine.py:275-288) for all
    ``hangover_on >= 0`` and ``release_off >= 0``: with ``d`` the distance to
    the last initially-voiced frame (virtual voiced frame at ``-(ON+1)``
    before the stream), the smoothed output is 1 iff
    ``d < ON + max(OFF, 1)`` — the hold covers d in 1..ON, and the release
    counter emits a further OFF-1 voiced frames (none when OFF <= 1).
    Asserted equal to the ``lax.scan`` transliteration
    (``hangover_smooth_scan``) over randomized configs in tests.
    Returns ``(vad_int32, new_last_voiced)``.
    """
    f = vad_initial.shape[0]
    on = max(int(hangover_on), 0)
    off = max(int(release_off), 0)
    idx = jnp.arange(f, dtype=jnp.int32)
    seeds = jnp.where(vad_initial, idx, _NEG_LARGE)
    last = _cummax(seeds)
    last = jnp.maximum(last, last_voiced)
    d = idx - last
    vad = (d < jnp.int32(on + max(off, 1))).astype(jnp.int32)
    new_last_voiced = last[-1] - jnp.int32(f) if f else last_voiced
    return vad, new_last_voiced


def hangover_smooth_scan(
    vad_initial: jnp.ndarray,
    hold0: jnp.ndarray,
    silence_run0: jnp.ndarray,
    hangover_on: int,
    release_off: int,
) -> tuple[jnp.ndarray, tuple[jnp.ndarray, jnp.ndarray]]:
    """Exact ``lax.scan`` transliteration of the engine automaton.

    Kept as the oracle for the parallel version and as the fallback for
    exotic configurations (``hangover_on == 0``).
    """
    on = jnp.int32(int(hangover_on))
    off = jnp.int32(int(release_off))

    def step(carry, v):
        hold, run = carry
        def voiced(_):
            return (jnp.maximum(hold, on), jnp.int32(0), jnp.int32(1))
        def silent(_):
            def holding(_):
                return (hold - 1, jnp.int32(0), jnp.int32(1))
            def releasing(_):
                new_run = run + 1
                out = jnp.where(new_run >= off, jnp.int32(0), jnp.int32(1))
                return (jnp.int32(0), new_run, out)
            return jax.lax.cond(hold > 0, holding, releasing, None)
        hold2, run2, out = jax.lax.cond(v, voiced, silent, None)
        return (hold2, run2), out

    (hold, run), vads = jax.lax.scan(step, (hold0, silence_run0), vad_initial)
    return vads, (hold, run)


def streaming_vad(
    energy: jnp.ndarray,
    zcr: jnp.ndarray,
    entropy: jnp.ndarray,
    state: VadState,
    *,
    energy_threshold: float,
    zcr_threshold: float,
    entropy_voice_max: float,
    use_adaptive: bool,
    adaptive_alpha: float,
    min_energy_threshold: float = 1e-6,
    max_zcr_threshold: float = 0.5,
    hangover_on: int = 3,
    release_off: int = 2,
    history_len: int = 256,
    valid: jnp.ndarray | None = None,
    trailing_impl: str = "conv",
    adaptive_margin: float = 1.0,
    composite_mode: str = "or",
) -> tuple[jnp.ndarray, jnp.ndarray, VadState]:
    """The engine's per-frame composite VAD over a block of frames.

    Semantics per frame t (reference engine.py:253-288):

    1. ``vad_initial = (E>T_E) & ((Z<T_Z) | (H<T_H))``
    2. ``vad_adaptive``: thresholds blended from the trailing history mean of
       the previous frames (scalar per frame in the streaming engine) with
       clamped alpha, then ``(E>th_e) & (Z<th_z)``
    3. if ``use_adaptive``: ``vad_initial |= vad_adaptive``
    4. hangover/release smoothing.

    ``valid`` (optional bool mask) marks padded tail frames of a bucketed
    block: invalid frames produce outputs but do not advance state.
    Returns ``(vad int32, vad_adaptive int32, new_state)``.
    """
    f = energy.shape[0]
    e = jnp.asarray(energy, dtype=jnp.float32)
    z = jnp.asarray(zcr, dtype=jnp.float32)
    h = jnp.asarray(entropy, dtype=jnp.float32)

    if valid is not None:
        # Masked frames must not pollute history sums or the cummax.
        e_in = jnp.where(valid, e, 0.0)
        z_in = jnp.where(valid, z, 0.0)
    else:
        e_in, z_in = e, z

    alpha = max(0.0, min(float(adaptive_alpha), 0.99))
    (e_hist_mean, z_hist_mean), (new_e_buf, new_z_buf) = _trailing_means_pair(
        e_in, z_in, state.energy_buf, state.zcr_buf, state.count,
        history_len, trailing_impl,
    )

    # NOTE on masking: _trailing_means uses count+arange(f); with padded tails
    # this overcounts for frames after an invalid frame. Buckets pad only the
    # tail, and outputs of padded frames are discarded, so only the *state*
    # needs correcting below.
    a = jnp.float32(alpha)
    th_e = jnp.maximum(jnp.float32(min_energy_threshold), a * e_hist_mean + (1 - a) * e)
    th_z = jnp.minimum(jnp.float32(max_zcr_threshold), a * z_hist_mean + (1 - a) * z)
    # Opt-in sustained-noise release (Config.VAD_ADAPTIVE_ENERGY_MARGIN,
    # NOT reference semantics): the adaptive energy threshold tracks the
    # trailing mean, so under stationary noise ~half the frames sit above
    # it and `vad_initial |= vad_adaptive` never releases (measured:
    # docs/vad_eval_r4.jsonl babble/hum rows). Requiring E > margin*th_e
    # (margin > 1) makes frames at the noise mean fail the adaptive gate.
    # The default 1.0 takes the static branch below — reference-exact
    # traces are untouched.
    if float(adaptive_margin) != 1.0:
        th_e = th_e * jnp.float32(adaptive_margin)
    vad_adaptive = (e > th_e) & (z < th_z)

    energy_gate = e > jnp.float32(energy_threshold)
    zcr_gate = z < jnp.float32(zcr_threshold)
    entropy_gate = h < jnp.float32(entropy_voice_max)
    vad_initial = energy_gate & (zcr_gate | entropy_gate)
    if use_adaptive:
        if composite_mode == "and":
            # Opt-in noise-robust composite (Config.VAD_COMPOSITE_MODE,
            # NOT reference semantics): REQUIRE the adaptive gate. The
            # reference's OR can only add positives, and its fixed gates
            # cannot separate tonal babble/hum from voiced speech (the
            # absolute energy gate passes any realistic amplitude; tonal
            # noise has low entropy AND low zcr — per-gate measurements in
            # docs/vad_eval_r4.jsonl). The adaptive energy threshold tracks
            # the trailing mean, which stationary noise sits well below
            # (median E/th ~0.33 at 5 dB), so ANDing it releases there.
            vad_initial = vad_initial & vad_adaptive
        else:
            vad_initial = vad_initial | vad_adaptive

    if valid is not None:
        vad_initial_masked = vad_initial & valid
    else:
        vad_initial_masked = vad_initial

    vad, new_last = hangover_smooth(
        vad_initial_masked, state.last_voiced, hangover_on, release_off
    )

    if valid is not None:
        n_valid = jnp.sum(valid.astype(jnp.int32))
        # Re-pack history buffers so only valid frames entered them: since
        # padding is a contiguous tail of zeros and invalid features were
        # zeroed, rolling the ext window back by the pad count realigns it.
        pad = jnp.int32(f) - n_valid
        ext_e = jnp.concatenate([state.energy_buf, e_in])
        ext_z = jnp.concatenate([state.zcr_buf, z_in])
        new_e_buf = jax.lax.dynamic_slice(
            ext_e, (ext_e.shape[0] - history_len - pad,), (history_len,)
        )
        new_z_buf = jax.lax.dynamic_slice(
            ext_z, (ext_z.shape[0] - history_len - pad,), (history_len,)
        )
        new_count = jnp.minimum(state.count + n_valid, history_len)
        # last_voiced: relative to the next block start == index n_valid.
        idx = jnp.arange(f, dtype=jnp.int32)
        seeds = jnp.where(vad_initial_masked, idx, _NEG_LARGE)
        # initial= keeps a zero-frame masked block (f == 0) from crashing
        # jnp.max's empty reduction at trace time
        last_any = jnp.maximum(
            jnp.max(seeds, initial=-(2 ** 30)), state.last_voiced
        )
        new_last = last_any - n_valid
    else:
        new_count = jnp.minimum(state.count + f, history_len)

    new_state = VadState(new_e_buf, new_z_buf, new_count, new_last)
    return vad, vad_adaptive.astype(jnp.int32), new_state
