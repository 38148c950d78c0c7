#!/usr/bin/env python3
"""The fused frame→features→VAD pipeline.

This is the batched replacement for the reference engine's inner per-frame
Python loop (engine.py:240-311): instead of dispatching one 512-pt FFT, one
mel matvec and one DCT per 10 ms frame through Python, whole blocks of frames
are processed in a single jitted, XLA-fused computation:

    raw frames (F, frame_size) f32
      -> window multiply
      -> short-time energy, zero-crossing rate           (elementwise)
      -> power spectrum via windowed-DFT matmul          (matmul)
      -> mel filterbank matmul -> log -> DCT matmul      (matmul)
      -> spectral entropy from the shared spectrum       (elementwise)
      -> composite VAD as parallel prefix ops            (ops/vad.py)

All constants (window, windowed DFT bases, mel filterbank, DCT, lifter) are
precomputed host-side (ops/bases.py) exactly like the reference precomputes
its window once (engine.py:83).

`FeaturePipeline` carries the configuration and the jitted callables;
`FeaturePipeline.process_block` is the streaming workhorse (carried VadState,
bucketed shapes), `process_signal` the offline batch API.
"""

from __future__ import annotations

import threading as _threading
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from . import bases, vad as vad_ops
from .precision import resolve as _resolve_precision
from .preprocessing import frame_signal, stream_frames
from .frequency_features import entropy_from_power

__all__ = ["FeatureConfig", "FeatureBlock", "FeaturePipeline"]

# Trace-evidence counter (same pattern as ops/vad.py BLOCKED_TRACE_COUNT):
# bumped at TRACE time whenever the signal-VIEW implementation — not the
# materialized-frames path — is compiled into a program. The multi-device
# dry run asserts on a delta across a fresh trace to prove the production
# 320/160 geometry takes the view route under the mesh.
VIEW_TRACE_COUNT = 0


class FeatureConfig(NamedTuple):
    """Static configuration snapshot for one pipeline instance."""

    sample_rate: int = 16000
    frame_size: int = 320
    hop_size: int = 160
    window_type: str = "hamming"
    n_fft: int = 512
    entropy_n_fft: int = 512
    num_filters: int = 26
    num_ceps: int = 13
    lifter: int = 22
    energy_threshold: float = 1000.0
    zcr_threshold: float = 0.3
    entropy_voice_max: float = 0.65
    use_adaptive_vad: bool = True
    adaptive_alpha: float = 3.0  # engine passes ADAPTIVE_VAD_ENERGY_K; clamped to 0.99
    # Opt-in sustained-noise knobs (ops/vad.py streaming_vad; NOT part of
    # the reference contract — leave at defaults for parity). Per-gate
    # measurements behind both: docs/vad_eval_r4.jsonl.
    # adaptive_margin multiplies the adaptive energy threshold (1.0 =
    # reference-exact, traced without the multiply; >1 tightens the
    # adaptive gate — helps white-noise precision slightly).
    adaptive_margin: float = 1.0
    # composite_mode "or" (reference: vad_initial |= vad_adaptive) or
    # "and" (REQUIRE the relative-energy adaptive gate — the only gate in
    # the feature set that releases under tonal babble/hum).
    composite_mode: str = "or"
    hangover_on: int = 3
    release_off: int = 2
    history_len: int = 256
    # Matmul precision for the DFT/mel/DCT matmuls and the pitch legs'
    # DFT/inverse-ACF matmuls (ops/precision.py for what each name means on
    # the GPU): "highest" (float32 — the default), "high" (one TF32 pass on
    # the tensor cores) or "default". On the H100, "high" leaves the mfcc
    # NMSE at ~4e-6, under the 1e-5 gate but without a 10x margin
    # (PERF.md), so float32 ships.
    precision: str = "highest"
    # DFT basis layout for the spectrum matmuls: "merged" (default — live
    # cos/sin bins packed into one (frame, n_fft) basis, Nyquist bin as a
    # fused matvec) or "pair" (two (frame, n_fft//2+1) bases). Per-bin dot
    # products are mathematically identical between layouts (compiled
    # reductions reassociate at ~3e-7 relative); "merged" needs even n_fft
    # and falls back to "pair" otherwise.
    dft_layout: str = "merged"
    # Trailing-history sum implementation for the adaptive VAD: "blocked"
    # (two-level block cumsums — default; falls back to conv when the block
    # length is not a multiple of history_len) or "conv" (ones-kernel
    # convolution). Both are decision-exact against the oracle; only the
    # blocked form partitions correctly on a sharded frame axis.
    vad_trailing_impl: str = "blocked"
    # Offline signal-view decomposition (frame_size == 2*hop geometry):
    # "hop_phase" (default — top/bottom half-frame matmuls against split
    # bases; measured fastest end-to-end) or "frame_parity" (even-index
    # frames as one contiguous (F/2, frame_size) reshape of the signal,
    # odd-index frames another, full-K matmuls — opt-in). Neither
    # materializes the 2x-duplicated frame matrix.
    view_layout: str = "hop_phase"

    @classmethod
    def from_config(cls, config=None) -> "FeatureConfig":
        from ..config import Config

        c = config or Config
        return cls(
            sample_rate=int(c.SAMPLE_RATE),
            frame_size=int(c.FRAME_SIZE),
            hop_size=int(c.HOP_SIZE),
            window_type=str(c.WINDOW_TYPE),
            n_fft=int(c.MFCC_N_FFT),
            entropy_n_fft=int(c.SPECTRAL_ENTROPY_N_FFT),
            num_filters=int(c.MEL_FILTERS),
            num_ceps=int(c.NUM_MFCC),
            lifter=int(c.MFCC_LIFTER),
            energy_threshold=float(c.ENERGY_THRESHOLD),
            zcr_threshold=float(c.ZCR_THRESHOLD),
            entropy_voice_max=float(c.SPECTRAL_ENTROPY_VOICE_MAX),
            use_adaptive_vad=bool(c.USE_ADAPTIVE_VAD),
            adaptive_alpha=float(c.ADAPTIVE_VAD_ENERGY_K),
            adaptive_margin=float(
                getattr(c, "VAD_ADAPTIVE_ENERGY_MARGIN", 1.0) or 1.0
            ),
            composite_mode=str(
                getattr(c, "VAD_COMPOSITE_MODE", "or") or "or"
            ).lower(),
            hangover_on=int(c.VAD_HANGOVER_ON),
            release_off=int(c.VAD_RELEASE_OFF),
            history_len=int(getattr(c, "VAD_HISTORY_LEN", 256)),
            precision=str(
                getattr(c, "TPU_MATMUL_PRECISION", "highest") or "highest"
            ).lower(),
            dft_layout=str(
                getattr(c, "TPU_DFT_LAYOUT", "merged") or "merged"
            ).lower(),
            vad_trailing_impl=str(
                getattr(c, "TPU_VAD_TRAILING_IMPL", "blocked") or "blocked"
            ).lower(),
            view_layout=str(
                getattr(c, "TPU_VIEW_LAYOUT", "hop_phase") or "hop_phase"
            ).lower(),
        )


class FeatureBlock(NamedTuple):
    """Per-frame outputs of one processed block (device arrays)."""

    energy: jnp.ndarray  # (F,) f32
    zcr: jnp.ndarray  # (F,) f32
    entropy: jnp.ndarray  # (F,) f32
    mfcc: jnp.ndarray  # (F, num_ceps) f32
    vad: jnp.ndarray  # (F,) i32 smoothed composite decision
    vad_adaptive: jnp.ndarray  # (F,) i32


class FeaturePipeline:
    """Configured, jit-compiled frame→feature→VAD pipeline."""

    def __init__(self, cfg: FeatureConfig | None = None):
        self.cfg = cfg or FeatureConfig()
        if self.cfg.num_ceps > self.cfg.num_filters:
            # A length-N DCT-II has exactly N coefficients: clamp like
            # compute_mfcc (frequency_features.py) and the reference's
            # full-DCT-then-slice, instead of emitting aliased extra columns.
            self.cfg = self.cfg._replace(num_ceps=self.cfg.num_filters)
        c = self.cfg
        from .windows import get_window

        self._window = get_window(c.window_type, c.frame_size)
        self._wc, self._ws = bases.windowed_dft_bases(
            c.frame_size, c.n_fft, c.window_type
        )
        if c.entropy_n_fft != c.n_fft:
            self._wc_ent, self._ws_ent = bases.windowed_dft_bases(
                c.frame_size, c.entropy_n_fft, c.window_type
            )
        else:
            self._wc_ent = self._ws_ent = None
        # merged layout (see bases.merged_windowed_dft_bases):
        # built alongside the pair bases; None when disabled or n_fft is odd.
        self._wm = self._wnyq = None
        self._wm_ent = self._wnyq_ent = None
        if c.dft_layout == "merged":
            if c.n_fft % 2 == 0:
                self._wm, self._wnyq = bases.merged_windowed_dft_bases(
                    c.frame_size, c.n_fft, c.window_type
                )
            if c.entropy_n_fft != c.n_fft and c.entropy_n_fft % 2 == 0:
                self._wm_ent, self._wnyq_ent = bases.merged_windowed_dft_bases(
                    c.frame_size, c.entropy_n_fft, c.window_type
                )
        self._fb_t = bases.mel_filterbank_np(
            c.num_filters, c.n_fft, c.sample_rate
        ).T.copy()  # (n_bins, num_filters)
        self._dct = bases.dct_ortho_matrix(c.num_filters, c.num_ceps)
        self._lifter = bases.lifter_vector(c.num_ceps, c.lifter)

        self._precision = _resolve_precision(c.precision)
        # Every jitted callable is created here (never lazily on first call):
        # the compiled-function inventory stays auditable in one place and a
        # first call racing from two threads can't jit the same impl twice.
        self._features_jit = jax.jit(self._features)
        self._block_jit = jax.jit(self._process_block_impl)
        self._signal_jit = jax.jit(self._process_signal_impl)
        self._block_packed_jit = jax.jit(self._process_block_packed_impl)
        self._signal_masked_jit = jax.jit(self._process_signal_masked_impl)
        self._signal_packed_jit = jax.jit(self._process_signal_packed_impl)
        self._block_packed_pitch_jit = jax.jit(
            self._process_block_packed_pitch_impl
        )
        self._signal_packed_pitch_jit = jax.jit(
            self._process_signal_packed_pitch_impl
        )
        # fused features+VAD+pitch programs are per pitch band (fmin/fmax
        # set static lag-band geometry), so they cannot be built here; the
        # dicts + lock keep the builds race-free and the inventory auditable
        self._sigpitch_jits: dict = {}
        self._block_pitch_jits: dict = {}
        self._sigpitch_lock = _threading.Lock()

    # -- core feature computation (traced) ---------------------------------

    def _spectrum_bases(self, which: str):
        """(merged, nyq, wc, ws) for the requested spectrum; merged is None
        when the pair layout applies (knob off or odd n_fft)."""
        if which == "entropy" and self._wc_ent is not None:
            return self._wm_ent, self._wnyq_ent, self._wc_ent, self._ws_ent
        return self._wm, self._wnyq, self._wc, self._ws

    def _power_spectrum(self, frames: jnp.ndarray, which: str = "mfcc") -> jnp.ndarray:
        """Windowed power spectrum from RAW frames via the DFT matmul pair
        (or the single merged-basis matmul + Nyquist matvec; bases.py)."""
        wm, wnyq, wc, ws = self._spectrum_bases(which)
        if wm is not None:
            half = wm.shape[1] // 2
            m = jnp.matmul(frames, jnp.asarray(wm), precision=self._precision,
                           preferred_element_type=jnp.float32)
            nyq = jnp.matmul(frames, jnp.asarray(wnyq), precision=self._precision,
                             preferred_element_type=jnp.float32)
            power = m[:, :half] * m[:, :half] + m[:, half:] * m[:, half:]
            return jnp.concatenate([power, (nyq * nyq)[:, None]], axis=-1)
        re = jnp.matmul(frames, jnp.asarray(wc), precision=self._precision,
                        preferred_element_type=jnp.float32)
        im = jnp.matmul(frames, jnp.asarray(ws), precision=self._precision,
                        preferred_element_type=jnp.float32)
        return re * re + im * im

    def _features(self, frames_raw: jnp.ndarray) -> dict:
        """Per-frame features from raw (unwindowed) frames, one fused trace."""
        return self._features_plain(jnp.asarray(frames_raw, dtype=jnp.float32))

    def _features_plain(self, x: jnp.ndarray) -> dict:
        """Plain-JAX (XLA-fused) frames-path features — the canonical
        reference-semantics math (engine.py:244-297 per-frame loop, batched);
        also reused per parity by the frame-parity signal-view layout."""
        c = self.cfg
        w = jnp.asarray(self._window)
        windowed = x * w
        energy = jnp.sum(windowed * windowed, axis=-1)
        signs = jnp.sign(windowed)
        crossings = jnp.sum(jnp.abs(jnp.diff(signs, axis=-1)) > 0, axis=-1)
        zcr = crossings.astype(jnp.float32) / jnp.float32(c.frame_size)

        power = self._power_spectrum(x, "mfcc")
        power_ent = self._power_spectrum(x, "entropy") if self._wc_ent is not None else power
        return self._spectral_tail(energy, zcr, power, power_ent)

    def _spectral_tail(self, energy, zcr, power, power_ent) -> dict:
        """Shared mel→log→DCT→lifter + entropy tail over computed spectra
        (used by both the frames path and the signal-view path)."""
        mel = jnp.maximum(
            jnp.matmul(power, jnp.asarray(self._fb_t), precision=self._precision,
                       preferred_element_type=jnp.float32),
            jnp.float32(1e-10),
        )
        mfcc = jnp.matmul(jnp.log(mel), jnp.asarray(self._dct), precision=self._precision,
                          preferred_element_type=jnp.float32)
        mfcc = mfcc * jnp.asarray(self._lifter)
        return {
            "energy": energy.astype(jnp.float32),
            "zcr": zcr,
            "entropy": entropy_from_power(power_ent),
            "mfcc": mfcc.astype(jnp.float32),
        }

    def _process_block_impl(
        self,
        frames_raw: jnp.ndarray,
        state: vad_ops.VadState,
        valid: jnp.ndarray,
    ) -> tuple[FeatureBlock, vad_ops.VadState]:
        feats = self._features(frames_raw)
        return self._vad_stage(feats, state, valid)

    def _vad_stage(
        self, feats: dict, state: vad_ops.VadState, valid
    ) -> tuple[FeatureBlock, vad_ops.VadState]:
        """Composite VAD over computed per-frame features (shared tail of the
        frames-based and signal-view paths)."""
        vad, vad_adaptive, new_state = self._vad_core(
            feats["energy"], feats["zcr"], feats["entropy"], state, valid
        )
        block = FeatureBlock(
            energy=feats["energy"],
            zcr=feats["zcr"],
            entropy=feats["entropy"],
            mfcc=feats["mfcc"],
            vad=vad,
            vad_adaptive=vad_adaptive,
        )
        return block, new_state

    def _vad_core(self, energy, zcr, entropy, state, valid):
        """The single streaming_vad call site: (e, z, h, state, valid) ->
        (vad, vad_adaptive, new_state). Split from :meth:`_vad_stage` so the
        hoisted long-signal paths can pad ONLY the three (F,) vectors to the
        blocked-impl length, never copying the (F, num_ceps) mfcc matrix
        through a pad + slice that VAD never reads."""
        c = self.cfg
        return vad_ops.streaming_vad(
            energy,
            zcr,
            entropy,
            state,
            energy_threshold=c.energy_threshold,
            zcr_threshold=c.zcr_threshold,
            entropy_voice_max=c.entropy_voice_max,
            use_adaptive=c.use_adaptive_vad,
            adaptive_alpha=c.adaptive_alpha,
            adaptive_margin=c.adaptive_margin,
            composite_mode=c.composite_mode,
            hangover_on=c.hangover_on,
            release_off=c.release_off,
            history_len=c.history_len,
            valid=valid,
            trailing_impl=c.vad_trailing_impl,
        )

    # Column layout of the packed feature block (split_packed_block is the
    # inverse; the prefix order is frozen — see PACKED_PREFIX_COLS):
    # 0 energy, 1 zcr, 2 entropy, 3 vad, 4 vad_adaptive, 5: mfcc (num_ceps).
    PACKED_PREFIX_COLS = 5

    def _pack_block(self, block: FeatureBlock) -> jnp.ndarray:
        """One (F, PACKED_PREFIX_COLS + num_ceps) f32 matrix — the single
        shared packer for both packed dispatch paths, so the column layout
        can never drift between them."""
        return jnp.concatenate(
            [
                block.energy[:, None],
                block.zcr[:, None],
                block.entropy[:, None],
                # vad values are 0/1: a value cast to f32 is exact
                block.vad.astype(jnp.float32)[:, None],
                block.vad_adaptive.astype(jnp.float32)[:, None],
                block.mfcc,
            ],
            axis=1,
        )

    def _packed_block_core(self, frames_raw, packed_state, n_valid):
        """Traced prologue shared by the plain and pitch-enabled packed
        block programs (one copy keeps their feature paths in lockstep):
        unpack state, build the valid mask, run the block pipeline.
        Returns ``(block, new_state, valid)``."""
        c = self.cfg
        state = vad_ops.unpack_state(packed_state, c.history_len)
        valid = jnp.arange(frames_raw.shape[0], dtype=jnp.int32) < n_valid
        block, new_state = self._process_block_impl(frames_raw, state, valid)
        return block, new_state, valid

    def _process_block_packed_impl(
        self, frames_raw: jnp.ndarray, packed_state: jnp.ndarray, n_valid: jnp.ndarray
    ) -> tuple[jnp.ndarray, jnp.ndarray]:
        block, new_state, _ = self._packed_block_core(
            frames_raw, packed_state, n_valid
        )
        return self._pack_block(block), vad_ops.pack_state(new_state)

    def process_block_packed(
        self, frames_raw, packed_state, n_valid: int
    ) -> tuple[jnp.ndarray, jnp.ndarray]:
        """Streaming block with single-buffer I/O.

        Instead of 4 state leaves in, 6 block leaves + 4 state leaves out
        (each leaf a separate host<->device transfer), this variant moves
        exactly three buffers per dispatch:
        frames + packed state in, one ``(F, 5+num_ceps)`` f32 block out (the
        new packed state stays on device). Bit-identical outputs to
        ``process_block`` with a full-width ``valid`` mask (tests enforce).

        Returns ``(packed_block, new_packed_state)``; split the block with
        :meth:`split_packed_block`.
        """
        return self._block_packed_jit(
            jnp.asarray(frames_raw, dtype=jnp.float32),
            packed_state,
            jnp.int32(n_valid),
        )

    def _process_signal_packed_impl(
        self, samples: jnp.ndarray, packed_state: jnp.ndarray, true_len: jnp.ndarray
    ) -> tuple[jnp.ndarray, jnp.ndarray]:
        """Raw int16 SAMPLES in (bucketed length), packed feature block out.

        The streaming counterpart of :meth:`_process_block_packed_impl` that
        frames ON DEVICE via the signal-view path (50%-overlap geometry):
        the host ships ``(n_bucket+1)*hop`` int16 samples instead of an
        ``(n_bucket, frame_size)`` float32 frame matrix — 4x fewer bytes
        (2x dtype, 2x overlap duplication). ``true_len`` (traced scalar) is
        the un-padded
        sample count; frames beyond it are masked out of the carried state.
        """
        block, new_state, _x, _n, _true_n = self._packed_signal_core(
            samples, packed_state, true_len
        )
        return self._pack_block(block), vad_ops.pack_state(new_state)

    def _packed_signal_core(self, samples, packed_state, true_len):
        """Traced prologue shared by the plain and pitch-enabled packed
        samples programs (one copy keeps their framing/masking arithmetic
        in lockstep). Returns ``(block, new_state, x, n, true_n)``."""
        c = self.cfg
        state = vad_ops.unpack_state(packed_state, c.history_len)
        x = samples.astype(jnp.float32)
        length = int(samples.shape[0])
        n = 1 + (length - c.frame_size) // c.hop_size
        true_n = jnp.where(
            true_len >= c.frame_size,
            1 + (true_len - c.frame_size) // c.hop_size,
            0,
        ).astype(jnp.int32)
        block, new_state = self._process_signal_view_impl(
            x, state, n, true_n=true_n
        )
        return block, new_state, x, n, true_n

    def process_signal_packed(
        self, samples, packed_state, true_len: int
    ) -> tuple[jnp.ndarray, jnp.ndarray]:
        """Bucketed raw-sample streaming dispatch (see the impl docstring).
        Requires the 50%-overlap geometry and a strictly positive window
        (callers gate on :meth:`supports_samples_dispatch`)."""
        return self._signal_packed_jit(
            jnp.asarray(samples, dtype=jnp.int16),
            packed_state,
            jnp.int32(true_len),
        )

    def supports_samples_dispatch(self) -> bool:
        c = self.cfg
        return c.frame_size == 2 * c.hop_size and self._window_strictly_positive()

    def initial_packed_state(self) -> np.ndarray:
        return vad_ops.initial_packed_state(
            self.cfg.history_len, self.cfg.hangover_on
        )

    def split_packed_block(self, packed_host: np.ndarray, n: int) -> FeatureBlock:
        """Host-side view split of a fetched packed block (first ``n`` rows)."""
        p = np.asarray(packed_host)[:n]
        return FeatureBlock(
            energy=p[:, 0],
            zcr=p[:, 1],
            entropy=p[:, 2],
            vad=p[:, 3].astype(np.int32),
            vad_adaptive=p[:, 4].astype(np.int32),
            mfcc=p[:, self.PACKED_PREFIX_COLS :],
        )

    # -- packed dispatch with a fused pitch track (engine opt-in) ----------
    # Layout: the frozen prefix + mfcc columns of _pack_block, then two
    # appended columns [f0, confidence] — append-only so the prefix layout
    # can never drift between the plain and pitch-enabled packed programs.

    def _pack_block_pitch(self, block: FeatureBlock, f0, conf) -> jnp.ndarray:
        return jnp.concatenate(
            [self._pack_block(block), f0[:, None], conf[:, None]], axis=1
        )

    def _gated_frames_pitch(self, frames_raw, gate_vad, min_conf):
        """Shared fused-pitch tail of both packed-pitch programs: the
        frames-path matmul-ACF track with the traced-threshold gate — the
        SAME contract as the serving stream (``_block_pitch_jit``), so the
        engine and ``/v1/stream?pitch=1`` report identical F0 decisions."""
        from .pitch import pitch_track_gated

        c = self.cfg
        return pitch_track_gated(
            frames_raw, gate_vad, min_conf,
            sample_rate=c.sample_rate, acf_impl="dft",
        )

    def _process_block_packed_pitch_impl(
        self, frames_raw, packed_state, n_valid, min_conf
    ):
        block, new_state, valid = self._packed_block_core(
            frames_raw, packed_state, n_valid
        )
        gate_vad = jnp.where(valid, block.vad, 0)
        f0, conf = self._gated_frames_pitch(frames_raw, gate_vad, min_conf)
        return self._pack_block_pitch(block, f0, conf), vad_ops.pack_state(
            new_state
        )

    def process_block_packed_pitch(
        self, frames_raw, packed_state, n_valid: int, min_confidence: float
    ):
        """:meth:`process_block_packed` plus the fused VAD-gated pitch track:
        one ``(F, 7+num_ceps)`` block out, still exactly three buffers per
        dispatch. Feature columns are bit-identical to the plain packed
        program's (tests/test_engine_pitch.py); split with
        :meth:`split_packed_block_pitch`."""
        return self._block_packed_pitch_jit(
            jnp.asarray(frames_raw, dtype=jnp.float32),
            packed_state,
            jnp.int32(n_valid),
            jnp.float32(min_confidence),
        )

    def _process_signal_packed_pitch_impl(
        self, samples, packed_state, true_len, min_conf
    ):
        block, new_state, x, n, true_n = self._packed_signal_core(
            samples, packed_state, true_len
        )
        # pitch needs the (F, frame) matrix: materialize it ON DEVICE (the
        # host still ships only int16 samples — the transfer win of the
        # samples layout is untouched; the frame matrix lives and dies in
        # device memory, bounded by the bucket size)
        frames = self._device_stream_frames(x)
        valid = jnp.arange(n, dtype=jnp.int32) < true_n
        gate_vad = jnp.where(valid, block.vad, 0)
        f0, conf = self._gated_frames_pitch(frames, gate_vad, min_conf)
        return self._pack_block_pitch(block, f0, conf), vad_ops.pack_state(
            new_state
        )

    def process_signal_packed_pitch(
        self, samples, packed_state, true_len: int, min_confidence: float
    ):
        """:meth:`process_signal_packed` plus the fused VAD-gated pitch
        track (same three-buffer I/O; the frame matrix pitch needs is built
        on device, so the host->device payload stays int16 samples)."""
        return self._signal_packed_pitch_jit(
            jnp.asarray(samples, dtype=jnp.int16),
            packed_state,
            jnp.int32(true_len),
            jnp.float32(min_confidence),
        )

    def split_packed_block_pitch(
        self, packed_host: np.ndarray, n: int
    ) -> tuple[FeatureBlock, np.ndarray, np.ndarray]:
        """Host-side split of a pitch-enabled packed block: the FeatureBlock
        plus the two appended columns ``(f0, confidence)``."""
        p = np.asarray(packed_host)[:n]
        block = FeatureBlock(
            energy=p[:, 0],
            zcr=p[:, 1],
            entropy=p[:, 2],
            vad=p[:, 3].astype(np.int32),
            vad_adaptive=p[:, 4].astype(np.int32),
            mfcc=p[:, self.PACKED_PREFIX_COLS : -2],
        )
        return block, p[:, -2], p[:, -1]

    def _device_stream_frames(self, signal: jnp.ndarray) -> jnp.ndarray:
        """Streaming-style framing ON DEVICE: only full frames, no padding
        (engine.py:240-242 semantics) — shared impl in
        ``preprocessing.stream_frames``."""
        return stream_frames(signal, self.cfg.frame_size, self.cfg.hop_size)

    def _window_strictly_positive(self) -> bool:
        return bool(np.all(self._window > 0))

    def host_rows_view(self, sig: np.ndarray) -> np.ndarray | None:
        """``(n+1, hop)`` HOST rows view of a 1-D host signal — a free numpy
        reshape (no copy: the slice of a contiguous array is contiguous) —
        when the 50%-overlap view geometry applies; ``None`` otherwise.

        Uploading rows instead of the flat signal makes the device program
        start from the 2-D layout, so a 1-D device input's on-device
        relayout copy is skipped. Trailing samples beyond ``(n+1)*hop`` are
        dropped exactly as the view path itself drops them."""
        c = self.cfg
        if not (
            c.frame_size == 2 * c.hop_size
            and sig.ndim == 1
            and len(sig) >= c.frame_size
            and self._window_strictly_positive()
        ):
            return None
        n = 1 + (len(sig) - c.frame_size) // c.hop_size
        return sig[: (n + 1) * c.hop_size].reshape(n + 1, c.hop_size)

    def _features_from_rows_parity(self, rows: jnp.ndarray) -> dict:
        """Per-frame features from a ``(F+1, hop)`` signal view via the
        frame-parity decomposition (50%-overlap geometry): even-index frames
        are ``rows[:2*ne].reshape(ne, frame_size)`` — a contiguous view, no
        duplicated samples — and odd-index frames
        ``rows[1:2*no+1].reshape(no, frame_size)``. Each parity runs the
        exact frames-path math (``_features_plain``) with the full
        ``frame_size`` contraction dim (K=320 instead of the hop-phase
        K=160 halves), then the per-frame outputs
        interleave back to frame order (tiny ``(F, 5+num_ceps)``-scale
        relayouts, not the ``(F, n_fft)`` spectra)."""
        x = jnp.asarray(rows, dtype=jnp.float32)
        hop = self.cfg.hop_size
        f = int(x.shape[0]) - 1
        ne = (f + 1) // 2
        no = f // 2
        fa = self._features_plain(x[: 2 * ne].reshape(ne, 2 * hop))
        if no == 0:
            return fa
        fb = self._features_plain(x[1 : 2 * no + 1].reshape(no, 2 * hop))
        out = {}
        for k, va in fa.items():
            vb = fb[k]
            if no < ne:
                vb = jnp.pad(vb, ((0, ne - no),) + ((0, 0),) * (vb.ndim - 1))
            out[k] = jnp.stack([va, vb], axis=1).reshape(
                (2 * ne,) + va.shape[1:]
            )[:f]
        return out

    def _features_from_rows(self, rows: jnp.ndarray) -> dict:
        """Per-frame features from a ``(F+1, hop)`` signal view, for the
        50%-overlap geometry (frame_size == 2*hop): frame i is
        ``concat(rows[i], rows[i+1])``.

        Avoids materializing the 2x-duplicated frame matrix entirely — the
        windowed DFT becomes two hop-phase matmuls against the top/bottom
        halves of the windowed basis, energy a pair of matvecs against the
        squared window halves, and ZCR a shared per-row sign-change count
        plus a frame-boundary term. Requires a strictly positive window
        (sign(x*w) == sign(x)); the hop-phase sums reassociate float adds vs
        the frames path at the ~1e-7 relative level.
        """
        if self.cfg.view_layout == "frame_parity":
            return self._features_from_rows_parity(rows)
        c = self.cfg
        hop = c.hop_size
        x = jnp.asarray(rows, dtype=jnp.float32)
        top, bot = x[:-1], x[1:]

        w = jnp.asarray(self._window)
        w2 = w * w
        energy = jnp.matmul(top * top, w2[:hop], precision=self._precision) + jnp.matmul(
            bot * bot, w2[hop:], precision=self._precision
        )

        signs = jnp.sign(x)
        row_changes = jnp.sum(jnp.abs(jnp.diff(signs, axis=1)) > 0, axis=1)
        boundary = jnp.abs(signs[1:, 0] - signs[:-1, -1]) > 0
        crossings = row_changes[:-1] + row_changes[1:] + boundary.astype(jnp.int32)
        zcr = crossings.astype(jnp.float32) / jnp.float32(c.frame_size)

        def spectrum_pair(wc, ws):
            re = jnp.matmul(top, jnp.asarray(wc[:hop]), precision=self._precision,
                            preferred_element_type=jnp.float32) + jnp.matmul(
                bot, jnp.asarray(wc[hop:]), precision=self._precision,
                preferred_element_type=jnp.float32)
            im = jnp.matmul(top, jnp.asarray(ws[:hop]), precision=self._precision,
                            preferred_element_type=jnp.float32) + jnp.matmul(
                bot, jnp.asarray(ws[hop:]), precision=self._precision,
                preferred_element_type=jnp.float32)
            return re * re + im * im

        def spectrum_merged(wm, wnyq):
            half = wm.shape[1] // 2
            m = jnp.matmul(top, jnp.asarray(wm[:hop]), precision=self._precision,
                           preferred_element_type=jnp.float32) + jnp.matmul(
                bot, jnp.asarray(wm[hop:]), precision=self._precision,
                preferred_element_type=jnp.float32)
            nyq = jnp.matmul(top, jnp.asarray(wnyq[:hop]), precision=self._precision,
                             preferred_element_type=jnp.float32) + jnp.matmul(
                bot, jnp.asarray(wnyq[hop:]), precision=self._precision,
                preferred_element_type=jnp.float32)
            power = m[:, :half] * m[:, :half] + m[:, half:] * m[:, half:]
            return jnp.concatenate([power, (nyq * nyq)[:, None]], axis=-1)

        def spectrum(which):
            wm, wnyq, wc, ws = self._spectrum_bases(which)
            if wm is not None:
                return spectrum_merged(wm, wnyq)
            return spectrum_pair(wc, ws)

        power = spectrum("mfcc")
        power_ent = (
            spectrum("entropy") if self._wc_ent is not None else power
        )
        return self._spectral_tail(energy, zcr, power, power_ent)

    def _process_signal_view_impl(
        self,
        signal: jnp.ndarray,
        state: vad_ops.VadState,
        n: int,
        true_n: jnp.ndarray | None = None,
        force_full_vad: bool = False,
    ):
        """Offline path for frame_size == 2*hop without frame materialization;
        long signals scan over row blocks with one-row overlap. ``true_n``
        (traced scalar) marks the real frame count when the signal was padded
        to a bucketed length — frames beyond it are masked out of the VAD
        state so one compiled program serves many signal lengths.

        ``signal`` may be 1-D samples or the host-formed ``(n+1, hop)`` rows
        view (:meth:`host_rows_view`): uploading rows directly starts the
        program in the 2-D layout, skipping the on-device 1-D→2-D relayout
        copy. Bit-identical: all downstream arithmetic reads only row
        contents.

        ``force_full_vad``: route the short-signal (n <= SCAN_BLOCK_FRAMES)
        tail through :meth:`_vad_full_length` (pad the gate vectors to a
        ``history_len`` multiple, blocked trailing sums, masked tail)
        instead of the exact-length :meth:`_vad_stage`. Mesh programs MUST
        set this: the exact-length path's conv trailing-sum fallback
        (``jnp.convolve``, window ``history_len``) is mis-partitioned by
        GSPMD when the frame axis is sharded at certain non-multiple frame
        counts (observed: trailing means inflated ~4x at n=17/99 on an
        8-way mesh — sharded-vs-unsharded A/B in tests/test_parallel.py::
        test_long_edge_sizes), while the blocked two-level-cumsum
        form partitions correctly at every tested size. Decision-identical
        to the oracle on both forms (single-chip traces are unchanged:
        at a 256-multiple n this lowers the very same blocked pass)."""
        global VIEW_TRACE_COUNT
        VIEW_TRACE_COUNT += 1
        c = self.cfg
        hop = c.hop_size
        x = jnp.asarray(signal, dtype=jnp.float32)
        if x.ndim == 2:
            assert x.shape == (n + 1, hop), (x.shape, n, hop)
            rows = x
        else:
            rows = x[: (n + 1) * hop].reshape(n + 1, hop)
        b = self.SCAN_BLOCK_FRAMES
        if n <= b:
            feats = self._features_from_rows(rows)
            if force_full_vad:
                return self._vad_full_length(feats, state, n, true_n)
            valid = None if true_n is None else jnp.arange(n, dtype=jnp.int32) < true_n
            return self._vad_stage(feats, state, valid)

        # Long signals. The feature stage is frame-local (embarrassingly
        # parallel); only the VAD composite needs the carried state — and
        # that composite is a parallel prefix, chunk-invariant by contract
        # (tests/test_vad_streaming.py), so the matmuls are hoisted out of
        # any state-carrying loop. A features-only scan bounds the materialized (F, n_fft) DFT/power
        # intermediates at one block (~150 MB) regardless of length — but
        # the carry is gone, so each step is pure matmul work.
        nb = -(-n // b)
        pad_rows = nb * b + 1 - (n + 1)
        if pad_rows:
            rows = jnp.pad(rows, ((0, pad_rows), (0, 0)))
        starts = jnp.arange(nb, dtype=jnp.int32) * b

        def step(_, start):
            rb = jax.lax.dynamic_slice(rows, (start, 0), (b + 1, hop))
            return 0, self._features_from_rows(rb)

        _, feats_b = jax.lax.scan(step, jnp.int32(0), starts)
        feats = {
            k: v.reshape(nb * b, *v.shape[2:])[:n]
            for k, v in feats_b.items()
        }
        # ONE full-length VAD pass. Pad ONLY the three (F,) gate vectors to
        # a multiple of history_len so the blocked trailing-sum impl
        # (requires f % history_len == 0) serves the production default;
        # padded frames are masked invalid and the decisions sliced back.
        # mfcc bypasses the pad entirely — VAD never reads it. Bit-identity
        # with a per-block construction holds because the blocked sums' window
        # decomposition is aligned to stream position mod history_len in
        # both forms (SCAN_BLOCK_FRAMES is a multiple of history_len) and
        # the hangover cummax is associative-exact (tests enforce equality
        # to the sequential oracle under any chunking).
        return self._vad_full_length(feats, state, n, true_n)

    def _vad_full_length(self, feats, state, n, true_n=None):
        """Full-length VAD over hoisted per-frame features: pad e/z/h to the
        blocked-impl length, one parallel-prefix pass, slice decisions back.
        Shared tail of the view and frames long-signal paths."""
        c = self.cfg
        h = c.history_len
        f_pad = -(-n // h) * h
        limit = jnp.int32(n) if true_n is None else true_n
        e, z, ent = feats["energy"], feats["zcr"], feats["entropy"]
        if f_pad != n:
            e, z, ent = (
                jnp.pad(v, (0, f_pad - n)) for v in (e, z, ent)
            )
        valid = None
        if f_pad != n or true_n is not None:
            valid = jnp.arange(f_pad, dtype=jnp.int32) < limit
        vad, vad_adaptive, new_state = self._vad_core(e, z, ent, state, valid)
        if f_pad != n:
            vad, vad_adaptive = vad[:n], vad_adaptive[:n]
        block = FeatureBlock(
            energy=feats["energy"],
            zcr=feats["zcr"],
            entropy=feats["entropy"],
            mfcc=feats["mfcc"],
            vad=vad,
            vad_adaptive=vad_adaptive,
        )
        return block, new_state

    def _empty_block(self) -> FeatureBlock:
        return FeatureBlock(
            energy=jnp.zeros((0,), jnp.float32),
            zcr=jnp.zeros((0,), jnp.float32),
            entropy=jnp.zeros((0,), jnp.float32),
            mfcc=jnp.zeros((0, self.cfg.num_ceps), jnp.float32),
            vad=jnp.zeros((0,), jnp.int32),
            vad_adaptive=jnp.zeros((0,), jnp.int32),
        )

    # Frames per lax.scan step on the long-signal path. The scan keeps the
    # compiled program size independent of signal length (one block body +
    # a loop). 32768 frames = ~52 s of audio per step, so per-step overhead
    # stays small while one block's (F, n_fft) intermediates stay ~150 MB.
    SCAN_BLOCK_FRAMES = 32768

    def _process_signal_impl(self, signal: jnp.ndarray, state: vad_ops.VadState):
        """signal (L,) f32 -> (FeatureBlock, VadState), entirely on device:
        framing + features + composite VAD in one compiled program. Long
        signals run as a lax.scan over fixed-size frame blocks with the
        VadState carried (the batched version of the reference's chunked
        consumer loop, engine.py:229-242).

        A 2-D ``(n+1, hop)`` input is the host-formed rows view
        (:meth:`host_rows_view`) and routes straight to the view path."""
        c = self.cfg
        if signal.ndim == 2:
            assert int(signal.shape[1]) * 2 == c.frame_size, signal.shape
            return self._process_signal_view_impl(
                signal, state, int(signal.shape[0]) - 1
            )
        length = int(signal.shape[0])
        if (
            c.frame_size == 2 * c.hop_size
            and length >= c.frame_size
            and self._window_strictly_positive()
        ):
            n = 1 + (length - c.frame_size) // c.hop_size
            return self._process_signal_view_impl(signal, state, n)
        frames = self._device_stream_frames(signal)
        f = int(frames.shape[0])
        if f == 0:
            return self._empty_block(), state
        b = self.SCAN_BLOCK_FRAMES
        if f <= b:
            return self._process_block_impl(frames, state, None)
        # Same hoist as _process_signal_view_impl: frame-local features out
        # of the VadState scan, then ONE full-length parallel-prefix VAD.
        nb = -(-f // b)
        pad = nb * b - f
        if pad:
            frames = jnp.pad(frames, ((0, pad), (0, 0)))

        def step(_, fr):
            return 0, self._features(fr)

        _, feats_b = jax.lax.scan(
            step, jnp.int32(0), frames.reshape(nb, b, -1)
        )
        feats = {
            k: v.reshape(nb * b, *v.shape[2:])[:f]
            for k, v in feats_b.items()
        }
        return self._vad_full_length(feats, state, f)

    # -- public API ----------------------------------------------------------

    def initial_state(self) -> vad_ops.VadState:
        return vad_ops.initial_vad_state(self.cfg.history_len, self.cfg.hangover_on)

    def features(self, frames_raw) -> dict:
        """Jitted per-frame features for raw ``(F, frame_size)`` frames."""
        return self._features_jit(jnp.asarray(frames_raw, dtype=jnp.float32))

    def process_block(
        self, frames_raw, state: vad_ops.VadState, valid=None
    ) -> tuple[FeatureBlock, vad_ops.VadState]:
        """Process one streaming block of raw frames with carried VAD state.

        ``valid`` may mark a padded tail (bucketed shapes); None means all
        frames valid (and skips the state-correction pass entirely).
        """
        return self._block_jit(
            jnp.asarray(frames_raw, dtype=jnp.float32), state, valid
        )

    def stream_frames(self, samples: np.ndarray) -> np.ndarray:
        """Streaming-style framing on the host: only full frames, no tail
        padding (engine.py:240-242 semantics). Returns raw float32 frames.
        int16 input goes through the fused native kernel."""
        c = self.cfg
        samples = np.asarray(samples)
        if samples.dtype == np.int16:
            from ..utils.native import frame_i16_to_f32

            return frame_i16_to_f32(samples, c.frame_size, c.hop_size)
        n = len(samples)
        if n < c.frame_size:
            return np.zeros((0, c.frame_size), dtype=np.float32)
        f = 1 + (n - c.frame_size) // c.hop_size
        idx = (
            np.arange(c.frame_size)[None, :]
            + np.arange(f)[:, None] * c.hop_size
        )
        return samples.astype(np.float32)[idx]

    # Length buckets (in seconds) for process_signal_auto: arbitrary-length
    # inputs pad up to one of these so jit compiles a handful of programs
    # instead of one per file length.
    SIGNAL_BUCKET_SECONDS = (2, 8, 32, 128, 512, 2048)

    def _process_signal_masked_impl(self, padded, state, true_n):
        c = self.cfg
        if padded.ndim == 2:  # host-formed rows view (host_rows_view)
            n = int(padded.shape[0]) - 1
        else:
            length = int(padded.shape[0])
            n = 1 + (length - c.frame_size) // c.hop_size
        return self._process_signal_view_impl(padded, state, n, true_n=true_n)

    def process_signal_auto(
        self, signal, state: vad_ops.VadState | None = None
    ) -> tuple[FeatureBlock, vad_ops.VadState]:
        """Arbitrary-length offline processing with bucketed compile shapes:
        the signal is zero-padded up to the next ``SIGNAL_BUCKET_SECONDS``
        bucket and padded frames are masked out of the VAD state, so any
        number of differently-sized files shares at most a handful of
        compiled programs. Requires the 50%-overlap geometry; other
        geometries fall back to exact-length processing.

        int16 input ships to the device AS int16 (the cast to float32 runs
        on device, exactly) — half the host->device bytes of a float32
        signal, the offline counterpart of the engine's samples-dispatch
        layout."""
        c = self.cfg
        sig = np.asarray(signal)
        if sig.dtype != np.int16:
            sig = sig.astype(np.float32, copy=False)
        if state is None:
            state = self.initial_state()
        if not (
            c.frame_size == 2 * c.hop_size
            and self._window_strictly_positive()
            and len(sig) >= c.frame_size
        ):
            return self.process_signal_device(sig, state)
        true_n = 1 + (len(sig) - c.frame_size) // c.hop_size
        sr = c.sample_rate
        target = next(
            (s * sr for s in self.SIGNAL_BUCKET_SECONDS if len(sig) <= s * sr),
            None,
        )
        if target is None:
            # beyond the largest bucket: quantize to the next MULTIPLE of it
            # so N oversized files of distinct lengths share one program per
            # quantum instead of one exact-length compile per length — the
            # masked path slices
            # the padding off exactly either way
            quantum = self.SIGNAL_BUCKET_SECONDS[-1] * sr
            target = -(-len(sig) // quantum) * quantum
        if target > len(sig):
            sig = np.pad(sig, (0, target - len(sig)))
        rows = self.host_rows_view(sig)
        block, new_state = self._signal_masked_jit(
            jnp.asarray(sig if rows is None else rows), state, jnp.int32(true_n)
        )
        return FeatureBlock(*(x[:true_n] for x in block)), new_state

    def _signal_pitch_jit(self, fmin: float, fmax: float):
        """Jitted fused ``(padded, state, true_n, min_conf) -> (block,
        state, f0, conf)`` for one pitch band: the masked feature/VAD
        program and the scan-blocked pitch track in ONE compiled program,
        with pitch gated on the in-program VAD. One device dispatch (and
        one host->device signal transfer) where the two-call path pays two
        of each — the fixed per-dispatch cost dominates a short serving
        request."""
        key = (float(fmin), float(fmax))
        fn = self._sigpitch_jits.get(key)
        if fn is not None:
            return fn
        from .pitch import pitch_track_signal_gated

        c = self.cfg

        def impl(padded, state, true_n, min_conf):
            block, new_state = self._process_signal_masked_impl(
                padded, state, true_n
            )
            n_pad = block.vad.shape[0]
            # hangover can spill decisions past true_n into the padded
            # tail; the two-call path zero-fills those gate slots
            # (pitch_signal_auto), so mask identically here
            gate_vad = jnp.where(
                jnp.arange(n_pad, dtype=jnp.int32) < true_n, block.vad, 0
            )
            # shared traced-threshold gate (ops/pitch.py): thresholds never
            # force a compile, and all fused programs share one definition
            f0, conf = pitch_track_signal_gated(
                padded, gate_vad, min_conf,
                frame_size=c.frame_size, hop_size=c.hop_size,
                sample_rate=c.sample_rate, fmin=key[0], fmax=key[1],
                precision=c.precision,
            )
            return block, new_state, f0, conf

        with self._sigpitch_lock:
            if key not in self._sigpitch_jits:
                # bounded like ops/pitch._pitch_jit_cached (serve's snapped
                # band grid alone permits 153 pairs): a band-sweeping caller
                # must not accumulate compiled executables without limit
                while len(self._sigpitch_jits) >= 256:
                    self._sigpitch_jits.pop(
                        next(iter(self._sigpitch_jits))
                    )
                self._sigpitch_jits[key] = jax.jit(impl)
            return self._sigpitch_jits[key]

    def _block_pitch_jit(self, fmin: float, fmax: float):
        """Jitted fused ``(frames_raw, state, valid, min_conf) -> (block,
        state, f0, conf)`` for one pitch band: the streaming frame-block
        program (:meth:`process_block`) plus the frames-path VAD-gated pitch
        track in ONE compiled program — real-time F0 at frame-block latency
        for one extra matmul, zero extra dispatches. Gate semantics shared
        with every other fused program (ops/pitch.py:pitch_track_gated);
        the ACF uses the Wiener-Khinchin matmul form (``acf_impl="dft"``,
        ~lag_max-fold less memory traffic than the unrolled
        sliding sums; same form the offline signal path uses), so the
        comparator contract is ``pitch_track(frames, vad, acf_impl="dft")``
        — see ops/time_features.py:autocorrelation_via_dft for its parity
        vs the reference loop (time_features.py:73-76)."""
        key = (float(fmin), float(fmax))
        fn = self._block_pitch_jits.get(key)
        if fn is not None:
            return fn
        from .pitch import pitch_track_gated

        c = self.cfg

        def impl(frames_raw, state, valid, min_conf):
            block, new_state = self._process_block_impl(
                frames_raw, state, valid
            )
            gate_vad = jnp.where(valid, block.vad, 0)
            f0, conf = pitch_track_gated(
                frames_raw, gate_vad, min_conf,
                sample_rate=c.sample_rate, fmin=key[0], fmax=key[1],
                acf_impl="dft",
            )
            return block, new_state, f0, conf

        with self._sigpitch_lock:
            if key not in self._block_pitch_jits:
                while len(self._block_pitch_jits) >= 256:
                    self._block_pitch_jits.pop(
                        next(iter(self._block_pitch_jits))
                    )
                self._block_pitch_jits[key] = jax.jit(impl)
            return self._block_pitch_jits[key]

    def stream_pitch(
        self,
        chunks,
        state: vad_ops.VadState | None = None,
        buckets: tuple[int, ...] | None = None,
        fmin: float = 50.0,
        fmax: float = 400.0,
        min_confidence: float = 0.3,
    ):
        """:meth:`stream` plus a real-time VAD-gated F0 track: yields
        ``(FeatureBlock, f0, conf)`` per completed frame block, all three
        sliced to the block's true frame count, computed in ONE fused device
        dispatch per block. The blocks are bit-identical to :meth:`stream`'s
        (the two generators share ``_stream_core``) and the concatenated
        ``f0`` bit-matches the offline frames-path track on the same signal
        (tests/test_stream_pitch.py)."""
        fn = self._block_pitch_jit(fmin, fmax)
        mc = np.float32(min_confidence)

        def dispatch(part, st, valid):
            block, new_state, f0, conf = fn(
                jnp.asarray(part, dtype=jnp.float32), st, valid, mc
            )
            return new_state, (block, f0, conf)

        for m, (block, f0, conf) in self._stream_core(
            chunks, state, buckets, dispatch
        ):
            yield (
                FeatureBlock(*(x[:m] for x in block)),
                np.asarray(f0)[:m],
                np.asarray(conf)[:m],
            )

    def process_signal_pitch_auto(
        self,
        signal,
        state: vad_ops.VadState | None = None,
        fmin: float = 50.0,
        fmax: float = 400.0,
        min_confidence: float = 0.3,
    ):
        """Features + VAD + VAD-gated pitch in ONE device dispatch, with the
        same bucketed-compile contract (and identical outputs) as
        :meth:`process_signal_auto` followed by :meth:`pitch_signal_auto`.
        Returns ``(block, state, f0, confidence)`` with ``f0``/``conf`` as
        host arrays of ``block.vad.shape[0]``. Non-view geometries and
        sub-frame inputs fall back to the two-call path."""
        c = self.cfg
        sig = np.asarray(signal)
        if sig.dtype != np.int16:
            sig = sig.astype(np.float32, copy=False)
        if state is None:
            state = self.initial_state()
        if not (
            c.frame_size == 2 * c.hop_size
            and self._window_strictly_positive()
            and len(sig) >= c.frame_size
        ):
            block, new_state = self.process_signal_auto(sig, state)
            f0, conf = self.pitch_signal_auto(
                sig, np.asarray(block.vad), fmin=fmin, fmax=fmax,
                min_confidence=min_confidence,
            )
            return block, new_state, f0, conf
        true_n = 1 + (len(sig) - c.frame_size) // c.hop_size
        sr = c.sample_rate
        target = next(
            (s * sr for s in self.SIGNAL_BUCKET_SECONDS if len(sig) <= s * sr),
            None,
        )
        if target is None:  # oversized: same quantization as the auto path
            quantum = self.SIGNAL_BUCKET_SECONDS[-1] * sr
            target = -(-len(sig) // quantum) * quantum
        if target > len(sig):
            sig = np.pad(sig, (0, target - len(sig)))
        fn = self._signal_pitch_jit(fmin, fmax)
        rows = self.host_rows_view(sig)
        block, new_state, f0, conf = fn(
            jnp.asarray(sig if rows is None else rows), state,
            jnp.int32(true_n), np.float32(min_confidence),
        )
        block = FeatureBlock(*(x[:true_n] for x in block))
        return (
            block, new_state,
            np.asarray(f0)[:true_n], np.asarray(conf)[:true_n],
        )

    def pitch_signal_auto(
        self,
        signal,
        vad,
        fmin: float = 50.0,
        fmax: float = 400.0,
        min_confidence: float = 0.3,
    ) -> tuple[np.ndarray, np.ndarray]:
        """VAD-gated pitch track with the same bucketed-compile contract as
        :meth:`process_signal_auto`: the signal pads to a
        ``SIGNAL_BUCKET_SECONDS`` bucket (pitch is frame-local and the pad
        frames are gated by vad=0, so the slice is exact), the jitted
        program is shared per (geometry, band), and the confidence
        threshold is traced. The single pitch path behind the analyze CLI,
        the batch CLI, and the HTTP serving layer. int16 input transfers
        as int16. Returns host ``(f0, confidence)`` of ``len(vad)``."""
        from .pitch import pitch_track_signal_jit

        c = self.cfg
        sig = np.asarray(signal)
        if sig.dtype != np.int16:
            sig = sig.astype(np.float32, copy=False)
        vad = np.asarray(vad)
        n = int(vad.shape[0])
        if len(sig) < c.frame_size or n == 0:
            z = np.zeros((0,), np.float32)
            return z, z
        sr = c.sample_rate
        target = next(
            (s * sr for s in self.SIGNAL_BUCKET_SECONDS if len(sig) <= s * sr),
            None,
        )
        if target is None:
            # same oversized-length quantization as process_signal_auto
            quantum = self.SIGNAL_BUCKET_SECONDS[-1] * sr
            target = -(-len(sig) // quantum) * quantum
        psig = np.pad(sig, (0, target - len(sig)))
        n_pad = 1 + (len(psig) - c.frame_size) // c.hop_size
        pvad = np.zeros((n_pad,), np.int32)
        # vad may be ceil-framed (pad_tail) while n_pad is floor-framed on
        # the bucketed signal: when the signal lands exactly on a bucket (or
        # beyond the largest), n can exceed n_pad by one — copy the overlap
        # and zero-fill (unvoiced) the missing tail frames below.
        m = min(n, n_pad)
        pvad[:m] = vad[:m]
        fn = pitch_track_signal_jit(
            frame_size=c.frame_size, hop_size=c.hop_size, sample_rate=sr,
            fmin=float(fmin), fmax=float(fmax), precision=c.precision,
        )
        prows = self.host_rows_view(psig)
        f0, conf = fn(
            psig if prows is None else prows, pvad, np.float32(min_confidence)
        )
        f0 = np.asarray(f0)[:n]
        conf = np.asarray(conf)[:n]
        if n > f0.shape[0]:
            f0 = np.pad(f0, (0, n - f0.shape[0]))
            conf = np.pad(conf, (0, n - conf.shape[0]))
        return f0, conf

    def process_signal_device(
        self, signal, state: vad_ops.VadState | None = None
    ) -> tuple[FeatureBlock, vad_ops.VadState]:
        """Fully on-device path: jitted framing + features + VAD. ``signal``
        may already be a device array (e.g. device_put ahead of time by a
        double-buffered feeder); nothing round-trips to the host. int16
        input transfers as int16 and casts on device (half the bytes)."""
        if state is None:
            state = self.initial_state()
        if isinstance(signal, jax.Array):
            sig = (
                signal
                if signal.dtype in (jnp.int16, jnp.float32)
                else signal.astype(jnp.float32)
            )
        else:
            sig = np.asarray(signal)
            if sig.dtype != np.int16:
                sig = sig.astype(np.float32, copy=False)
            rows = self.host_rows_view(sig)
            if rows is not None:
                sig = rows
        return self._signal_jit(sig, state)

    def stream(self, chunks, state: vad_ops.VadState | None = None,
               buckets: tuple[int, ...] | None = None):
        """Generator API over an iterable of 1-D sample chunks (any dtype):
        carries the overlap tail and VadState across chunks and yields a
        ``FeatureBlock`` per chunk that completed >=1 frame. The functional
        counterpart of the AudioRuntime engine for library consumers.

        Frame blocks are padded to a small fixed set of bucket shapes
        (default ``Config.TPU_STREAM_BUCKETS``) so jit compiles a handful of
        programs regardless of chunk-size jitter; padded tails are masked and
        sliced off. Blocks larger than the top bucket are split.

        >>> for block in pipe.stream(wav_chunks):
        ...     consume(np.asarray(block.vad))
        """
        def dispatch(part, st, valid):
            block, new_state = self.process_block(part, st, valid=valid)
            return new_state, (block,)

        for m, (block,) in self._stream_core(chunks, state, buckets, dispatch):
            yield FeatureBlock(*(x[:m] for x in block))

    def _stream_core(self, chunks, state, buckets, dispatch):
        """Shared carry/framing/bucket-padding loop of :meth:`stream` and
        :meth:`stream_pitch` — ONE copy, because the two generators are
        contractually bit-identical on the feature path
        (tests/test_stream_pitch.py) and a bucketing change applied to only
        one would silently break that. ``dispatch(part, state, valid) ->
        (new_state, outputs)``; yields ``(true_m, outputs)``."""
        import jax.numpy as jnp_  # local alias to keep the generator lazy

        c = self.cfg
        if buckets is None:
            from ..config import Config, parse_buckets

            buckets = parse_buckets(
                getattr(Config, "TPU_STREAM_BUCKETS", (32, 256, 2048))
            )
        if state is None:
            state = self.initial_state()
        carry = np.zeros((0,), dtype=np.float32)
        top = buckets[-1]
        for chunk in chunks:
            chunk = np.asarray(chunk)
            carry = np.concatenate([carry, chunk.astype(np.float32)])
            frames = self.stream_frames(carry)
            n = frames.shape[0]
            if n == 0:
                continue
            carry = carry[n * c.hop_size :]
            for lo in range(0, n, top):
                part = frames[lo : lo + top]
                m = part.shape[0]
                bucket = next((b for b in buckets if m <= b), top)
                if bucket != m:
                    part = np.pad(part, ((0, bucket - m), (0, 0)))
                valid = jnp_.asarray(np.arange(bucket) < m)
                state, outputs = dispatch(part, state, valid)
                yield m, outputs

    def process_signal(
        self, signal, state: vad_ops.VadState | None = None, pad_tail: bool = False
    ) -> tuple[FeatureBlock, vad_ops.VadState]:
        """Offline batch path: frame a whole 1-D signal and process it as one
        block. ``pad_tail=True`` uses the batch ``framing`` contract
        (zero-padded tail); False matches the streaming engine (drop tail)."""
        c = self.cfg
        sig = np.asarray(signal)
        if pad_tail:
            frames = frame_signal(
                jnp.asarray(sig, dtype=jnp.float32), c.frame_size, c.hop_size
            )
        else:
            frames = self.stream_frames(sig)
        if state is None:
            state = self.initial_state()
        if int(frames.shape[0]) == 0:
            return self._empty_block(), state
        return self.process_block(frames, state)
