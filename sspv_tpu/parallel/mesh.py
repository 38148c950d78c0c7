#!/usr/bin/env python3
"""Device-mesh scale-out for the speech front-end.

The reference has **no** distributed stack (SURVEY.md §2: "Parallelism /
distributed components: NONE" — its concurrency is two Python threads and a
lock, engine.py:99-103). The multi-device paths here are therefore about
*scale-out of the batch workload*, not parity:

- **data parallelism** ("dp"): a batch of independent audio signals (files)
  sharded across devices; every signal carries its own VAD state, so there is
  no cross-device communication at all — XLA runs each shard locally.
- **sequence parallelism** ("sp"): one long signal's frame axis sharded
  across devices. The feature stage is embarrassingly parallel per frame; the
  composite VAD's trailing-history sums and last-voiced cummax are prefix
  computations whose halo/carry exchange XLA lowers to collectives
  (collective-permute / all-gather of 256-element halos), which run over
  NVLink between the GPUs of one host.

Both paths go through ``jax.jit`` with ``NamedSharding`` annotations — no
hand-written collectives; XLA SPMD inserts them.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import vad as vad_ops
from ..ops.pipeline import FeatureBlock, FeatureConfig, FeaturePipeline

__all__ = [
    "make_mesh",
    "BatchPipeline",
]


def make_mesh(n_devices: int | None = None, dp: int | None = None) -> Mesh:
    """Build a ("data", "seq") mesh over the first ``n_devices`` devices.

    ``dp`` fixes the data-parallel extent (defaults to the largest power-of-2
    divisor <= sqrt-ish split); the rest becomes the sequence axis.
    """
    devices = jax.devices()
    n = n_devices or len(devices)
    if dp is None:
        dp = 1
        while n % (dp * 2) == 0 and dp * 2 * dp <= n:
            dp *= 2
    assert n % dp == 0, (n, dp)
    arr = np.array(devices[:n]).reshape(dp, n // dp)
    return Mesh(arr, axis_names=("data", "seq"))


def _as_transfer_dtype(signals) -> np.ndarray:
    """Keep int16 input as int16 for the host->device transfer (the traced
    framing casts to float32 on device, exactly); everything else becomes
    float32 host-side."""
    arr = np.asarray(signals)
    if arr.dtype != np.int16:
        arr = arr.astype(np.float32, copy=False)
    return arr


class BatchPipeline:
    """Sharded batch processing over a device mesh.

    ``process_batch``: (B, L) signals, B sharded over "data", each signal's
    frame axis sharded over "seq". ``process_long``: one (L,) signal with
    frames sharded over the whole mesh. Every program here lowers the same
    XLA paths as the single-device ``FeaturePipeline``.
    """

    def __init__(self, mesh: Mesh, cfg: FeatureConfig | None = None):
        self.mesh = mesh
        self.pipe = FeaturePipeline(cfg or FeatureConfig())
        self._batch_jit = {}

    def _batch_impl(self, signals: jnp.ndarray, states: vad_ops.VadState):
        """vmapped per-signal pipeline; frame axis sharding is constrained so
        XLA partitions the heavy feature matmuls over "seq" too."""

        def one(signal, state):
            frames = self.pipe._device_stream_frames(signal)
            frames = jax.lax.with_sharding_constraint(
                frames, NamedSharding(self.mesh, P("seq", None))
            )
            return self.pipe._process_block_impl(frames, state, None)

        return jax.vmap(one)(signals, states)

    def initial_states(self, batch: int) -> vad_ops.VadState:
        s = self.pipe.initial_state()
        return jax.tree.map(lambda x: jnp.broadcast_to(x, (batch,) + x.shape), s)

    def process_batch(
        self, signals, states: vad_ops.VadState | None = None
    ) -> tuple[FeatureBlock, vad_ops.VadState]:
        """Process a (B, L) batch of equal-length signals, B over "data".
        int16 batches transfer as int16 and cast on device (half the bytes)."""
        signals = _as_transfer_dtype(signals)
        b = signals.shape[0]
        if states is None:
            states = self.initial_states(b)
        key = ("batch", signals.shape)
        if key not in self._batch_jit:
            in_sh = NamedSharding(self.mesh, P("data", None))
            state_sh = NamedSharding(self.mesh, P("data"))
            self._batch_jit[key] = jax.jit(
                self._batch_impl,
                in_shardings=(in_sh, jax.tree.map(lambda _: state_sh, states)),
            )
        return self._batch_jit[key](signals, states)

    def _masked_row(self, signal, length, state):
        """Traced per-row body shared by :meth:`process_batch_masked` and
        :meth:`process_batch_masked_pitch`: frame, shard the frame axis over
        "seq", mask the zero-padded tail out of the VAD state. One definition
        keeps the fused block bit-identical to the plain one by construction.
        Returns ``(block, new_state, valid)``."""
        c = self.pipe.cfg
        frames = self.pipe._device_stream_frames(signal)
        frames = jax.lax.with_sharding_constraint(
            frames, NamedSharding(self.mesh, P("seq", None))
        )
        n = frames.shape[0]
        true_n = jnp.where(
            length >= c.frame_size,
            1 + (length - c.frame_size) // c.hop_size,
            0,
        )
        valid = jnp.arange(n, dtype=jnp.int32) < true_n
        block, new_state = self.pipe._process_block_impl(frames, state, valid)
        return block, new_state, valid

    def process_batch_masked(
        self, signals, lengths, states: vad_ops.VadState | None = None
    ) -> tuple[FeatureBlock, vad_ops.VadState]:
        """Process a (B, L) zero-padded batch of *unequal-length* signals, B
        over "data": ``lengths[i]`` is signal i's true sample count. Padded
        frames are masked out of each signal's VAD state (the same valid-mask
        machinery the bucketed streaming engine uses), so one compiled
        program serves any mix of file lengths that pads to L. int16
        batches transfer as int16 and cast on device (half the bytes)."""
        signals = _as_transfer_dtype(signals)
        lengths = jnp.asarray(lengths, dtype=jnp.int32)
        b = signals.shape[0]
        if states is None:
            states = self.initial_states(b)
        key = ("batch_masked", signals.shape)
        if key not in self._batch_jit:

            def impl(sigs, lens, sts):
                def one(signal, length, state):
                    block, new_state, _ = self._masked_row(
                        signal, length, state
                    )
                    return block, new_state

                return jax.vmap(one)(sigs, lens, sts)

            in_sh = NamedSharding(self.mesh, P("data", None))
            len_sh = NamedSharding(self.mesh, P("data"))
            self._batch_jit[key] = jax.jit(
                impl,
                in_shardings=(in_sh, len_sh,
                              jax.tree.map(lambda _: len_sh, states)),
            )
        return self._batch_jit[key](signals, lengths, states)

    def process_batch_masked_pitch(
        self,
        signals,
        lengths,
        states: vad_ops.VadState | None = None,
        fmin: float = 50.0,
        fmax: float = 400.0,
        min_confidence: float = 0.3,
    ):
        """:meth:`process_batch_masked` plus the VAD-gated pitch track in ONE
        sharded device call: returns ``(block, states, f0, conf)`` with
        ``f0``/``conf`` of shape (B, frames). The two-call alternative pays a
        second dispatch, re-ships the (B, L) signal batch, and round-trips
        the VAD gate through the host; outputs are
        bit-identical to it (tests/test_parallel.py). ``min_confidence`` is
        traced (the inner track runs ungated at ``-inf``; the outer
        comparison is the sole confidence gate), so thresholds never force a
        recompile — one program per (shape, band)."""
        signals = _as_transfer_dtype(signals)
        lengths = jnp.asarray(lengths, dtype=jnp.int32)
        b = signals.shape[0]
        if states is None:
            states = self.initial_states(b)
        c = self.pipe.cfg
        key = ("batch_masked_pitch", signals.shape, float(fmin), float(fmax))
        if key not in self._batch_jit:
            from ..ops.pitch import pitch_track_signal_gated

            def impl(sigs, lens, sts, min_conf):
                def one(signal, length, state, mc):
                    block, new_state, valid = self._masked_row(
                        signal, length, state
                    )
                    # hangover can spill decisions past a short row's true
                    # frame range into the zero padding; gate pitch on the
                    # masked VAD exactly like the two-call path does host-side
                    gate_vad = jnp.where(valid, block.vad, 0)
                    # shared traced-threshold gate (ops/pitch.py)
                    f0, conf = pitch_track_signal_gated(
                        signal, gate_vad, mc,
                        frame_size=c.frame_size, hop_size=c.hop_size,
                        sample_rate=c.sample_rate, fmin=fmin, fmax=fmax,
                        precision=c.precision,
                    )
                    return block, new_state, f0, conf

                return jax.vmap(one, in_axes=(0, 0, 0, None))(
                    sigs, lens, sts, min_conf
                )

            in_sh = NamedSharding(self.mesh, P("data", None))
            len_sh = NamedSharding(self.mesh, P("data"))
            self._batch_jit[key] = jax.jit(
                impl,
                in_shardings=(in_sh, len_sh,
                              jax.tree.map(lambda _: len_sh, states), None),
            )
        return self._batch_jit[key](
            signals, lengths, states, jnp.float32(min_confidence)
        )

    def process_long_pitch(
        self,
        signal,
        state: vad_ops.VadState | None = None,
        fmin: float = 50.0,
        fmax: float = 400.0,
        min_confidence: float = 0.3,
    ):
        """:meth:`process_long` plus the VAD-gated pitch track in ONE mesh
        program: ``(block, state, f0, conf)`` with the frame axis sharded
        over the flattened ("data", "seq") mesh; both halves ride the XLA
        view path. The gate definition is the shared one
        (``ops.pitch.pitch_track_signal_gated`` semantics: ungated inner
        track, one outer traced confidence comparison), so outputs are
        bit-identical to the two-call construction on the same path
        (tests/test_parallel.py)."""
        signal = _as_transfer_dtype(signal)
        if state is None:
            state = self.pipe.initial_state()
        key = ("long_pitch", signal.shape, float(fmin), float(fmax))
        if key not in self._batch_jit:
            from ..ops.pitch import pitch_track_signal_gated

            c = self.pipe.cfg
            length = int(signal.shape[0])
            n = 1 + (length - c.frame_size) // c.hop_size
            use_view = (
                c.frame_size == 2 * c.hop_size
                and length >= c.frame_size
                and self.pipe._window_strictly_positive()
            )

            sharding = NamedSharding(self.mesh, P(("data", "seq")))

            def impl(sig, st, min_conf):
                sig = jax.lax.with_sharding_constraint(sig, sharding)
                # force_full_vad: see process_long — the conv trailing-sum
                # fallback is not GSPMD-safe on a sharded frame axis
                if use_view:
                    block, new_state = self.pipe._process_signal_view_impl(
                        sig, st, n, force_full_vad=True
                    )
                else:
                    frames = self.pipe._device_stream_frames(sig)
                    block, new_state = self.pipe._vad_full_length(
                        self.pipe._features(frames), st,
                        int(frames.shape[0]),
                    )
                f0, conf = pitch_track_signal_gated(
                    sig, block.vad, min_conf,
                    frame_size=c.frame_size, hop_size=c.hop_size,
                    sample_rate=c.sample_rate, fmin=fmin, fmax=fmax,
                    precision=c.precision,
                )
                return block, new_state, f0, conf

            self._batch_jit[key] = jax.jit(impl)
        return self._batch_jit[key](
            signal, state, jnp.float32(min_confidence)
        )

    def process_long(
        self, signal, state: vad_ops.VadState | None = None
    ) -> tuple[FeatureBlock, vad_ops.VadState]:
        """Process one long (L,) signal with the frame axis sharded over the
        flattened ("data", "seq") mesh — sequence parallelism.

        With the 50%-overlap geometry this routes through the signal-view
        path — the same machinery as single-device
        ``process_signal_device`` (hoisted frame-local features, one
        full-length parallel-prefix VAD; past ``SCAN_BLOCK_FRAMES`` frames
        the XLA feature stage scans carry-less blocks) — under the mesh,
        so the prefix ops' exchanges lower to collectives. int16 transfers
        as int16 and casts on device (half the bytes)."""
        signal = _as_transfer_dtype(signal)
        if state is None:
            state = self.pipe.initial_state()
        key = ("long", signal.shape)
        if key not in self._batch_jit:
            c = self.pipe.cfg
            length = int(signal.shape[0])
            sharding = NamedSharding(self.mesh, P(("data", "seq")))
            use_view = (
                c.frame_size == 2 * c.hop_size
                and length >= c.frame_size
                and self.pipe._window_strictly_positive()
            )
            if use_view:
                n = 1 + (length - c.frame_size) // c.hop_size

                def impl(sig, st):
                    sig = jax.lax.with_sharding_constraint(sig, sharding)
                    # force_full_vad: the exact-length conv trailing-sum
                    # fallback is mis-partitioned by GSPMD at some sharded
                    # frame counts (see _process_signal_view_impl)
                    return self.pipe._process_signal_view_impl(
                        sig, st, n, force_full_vad=True
                    )

            else:

                def impl(sig, st):
                    frames = self.pipe._device_stream_frames(sig)
                    frames = jax.lax.with_sharding_constraint(
                        frames,
                        NamedSharding(self.mesh, P(("data", "seq"), None)),
                    )
                    # same GSPMD conv-fallback hazard as the view route:
                    # run the padded blocked VAD tail, not _vad_stage
                    feats = self.pipe._features(frames)
                    return self.pipe._vad_full_length(
                        feats, st, int(frames.shape[0])
                    )

            self._batch_jit[key] = jax.jit(impl)
        return self._batch_jit[key](signal, state)
