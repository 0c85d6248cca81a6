"""Live streaming runner: port of `t41x.runner`.

Ties the native block runtime to the chain and the output servers: the
functional re-expression of the reference's main loop (tmr4/T41_SDR
`T41_SDR.ino:1000-1338`), which interleaved DSP, display and control on
one core.  Here:

  * an acquisition source (hardware frontend, network, or the paced
    capture streamer) pushes I/Q blocks into a lock-free ring
    (`t41x_torch.io.runtime`),
  * the runner pops blocks, runs the chain, meters load (the
    reference's CPU-load %), and
  * publishes spectrum/S-meter frames to the control server, feeds the
    CW decoder incrementally and, in ft8 mode, the FT8 slot manager,
    which decodes each completed 15 s slot eagerly, outside the graph.
    The slot manager reads the slot time of the audio it is fed
    (`_fed_clock`), not the clock at the moment of the feed.

Control changes (band/mode/tune via the `Radio` API, the CAT server or
the operator session) take effect between blocks.

On a CUDA radio each chain spec is captured once as a CUDA graph — the
counterpart of `t41x`'s one jitted graph per chain spec: `block` for
`step`, `block_batch` over B blocks for `step_batch`.  A step copies the
ring's block through a pinned host buffer into the graph's static input,
copies `Radio.params` into its static parameters (so a retune, a volume
change or Codec_gain's band gain reaches the graph without a capture),
replays it, and reads what the host needs.  The captured region ends by
copying every new state leaf into the state it read, so each replay is
self-contained.  A new `Radio.chain` gets new graphs and releases the
old ones.  `graphs=False` runs the chain eagerly instead; a CPU radio
always does.  A capture that fails raises: there is no fallback.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from t41x_torch import constants as C
from t41x_torch.chain import ChannelParams
from t41x_torch.dsp.spectrum import smeter_dbm
from t41x_torch.io.runtime import BlockRing, LoadMeter
from t41x_torch.radio import Radio
from t41x_torch.utils import tracing
from t41x_torch.utils.checkpoint import flatten_with_path, map_leaves

# what the host reads after a block or a batch (t41x.runner's reads)
_TAPS = ("rf_spectrum", "audio_spectrum", "smeter_avg")
_CLIPS = ("adc_half_clip", "adc_quarter_clip")


def _fed_clock(clock, slots):
    """The slot time of the first sample of the audio `slots` (a
    `SlotManager`) is about to take: `clock` read once, at the first
    feed, then advanced by the audio fed since.  t41x's slot manager
    (copied) syncs only on a feed whose clock reading lies within that
    feed's own length before the 15 s boundary; a live feed lands some
    time after its audio was captured, later still after a slow step, so
    with the clock read at every feed a late feed steps past the
    boundary and the manager waits a whole slot (1 of 6 live slots on
    the card).  Counted from the audio, the boundary falls in the block
    that holds it.  After its sync the manager counts samples itself."""
    anchor = []

    def now() -> float:
        fed = slots.samples_fed / slots.rate
        if not anchor:
            anchor.append(clock() - fed)
        return anchor[0] + fed

    return now


def _leaves(tree) -> list:
    return [leaf for _, leaf in flatten_with_path(tree)]


def _clone(tree):
    return map_leaves(lambda _, t: t.clone(), tree)


@functools.cache
def _warmup_stream(device: torch.device) -> torch.cuda.Stream:
    """One warm-up stream a device: cuBLAS keeps a workspace for every
    stream it runs on, so a new stream a capture would keep 32 MB more
    at every spec change."""
    return torch.cuda.Stream(device)


@tracing.setup_span("capture")
def capture(fn, state, inputs: list, dev: torch.device):
    """`fn(state) -> (new_state, outputs dict)` captured as one CUDA graph
    on `dev`'s current stream (call it inside `torch.cuda.device(dev)`),
    ending by copying every new state leaf over the leaf of `state` it
    replaces, so each replay continues from the last.  It first runs
    once on a clone of the state, on a side stream: the kernel build and
    every design cache or upload made on first use happen there, not
    inside the capture.  The capture leaves its stage map with the
    tracer (`t41x_torch.utils.tracing`; the clones and copy-back are the
    stage `writeback`).  Returns (graph, outputs), which the next replay
    overwrites; the graph is a `tracing.Graph`, whose `replay()` is the
    launch span."""
    side = _warmup_stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        fn(_clone(state))
    torch.cuda.current_stream(dev).wait_stream(side)
    graph, stages = torch.cuda.CUDAGraph(), tracing.capturing(dev)
    with torch.cuda.graph(graph, capture_error_mode="thread_local"), stages:
        new_state, out = fn(state)
        with tracing.stage("writeback"):
            live = _leaves(state)
            ptrs = {t.untyped_storage().data_ptr()
                    for t in live + list(inputs)}

            def detached(t):
                # a result that shares memory with a captured input is
                # cloned before any state leaf is overwritten
                return (t.clone() if t.untyped_storage().data_ptr() in ptrs
                        else t)

            new = [n if n is o else detached(n)
                   for n, o in zip(_leaves(new_state), live, strict=True)]
            out = {k: detached(v) for k, v in out.items()}
            for n, o in zip(new, live):
                if n is not o:
                    o.copy_(n)
    return tracing.Graph(graph), out


class _Graph:
    """One chain call captured as a CUDA graph: its static input block(s)
    (with a pinned host buffer to stage them), static parameters and
    outputs.  The outputs are overwritten by the next replay."""

    def __init__(self, fn, params: ChannelParams, state, shape: tuple):
        dev = state.nco_phase.device
        self.pinned = torch.zeros(shape, dtype=torch.complex64,
                                  pin_memory=True)
        self.iq = torch.zeros(shape, dtype=torch.complex64, device=dev)
        self.params = ChannelParams(*(t.clone() for t in params))
        # the warm-up and the capture run on the chain's card: a graph
        # captures on the current card's stream, whatever `dev` is
        with torch.cuda.device(dev):
            self._capture(fn, state, dev)

    def _capture(self, fn, state, dev) -> None:
        self.graph, self.out = capture(
            lambda st: fn(self.params, st, self.iq), state, [self.iq], dev)

    def run(self, params: ChannelParams, blocks) -> dict:
        """Replay on `blocks`: one (channels..., BLOCK) array, or a list
        of B of them for a batch."""
        if isinstance(blocks, list):
            for staged, blk in zip(self.pinned, blocks, strict=True):
                staged.copy_(torch.from_numpy(blk))
        else:
            self.pinned.copy_(torch.from_numpy(blocks))
        self.iq.copy_(self.pinned, non_blocking=True)
        for static, p in zip(self.params, params):
            static.copy_(p)
        with torch.cuda.device(self.iq.device):
            self.graph.replay()
        return self.out


class StreamRunner:
    """channels: a channel-batch shape (e.g. (256,)) — the ring then
    carries (channels..., BLOCK) I/Q per entry and one call serves every
    channel.  batch_blocks: process B ring entries per call
    (`block_batch`): B blocks buy B budgets per replay.  graphs: capture
    and replay CUDA graphs on a CUDA radio (False: run the chain
    eagerly).

    The S-meter, the CW keying, the FT8 slots and Codec_gain follow the
    operator channel, channel 0 of the batch, in `step` as in
    `step_batch`.  (`t41x.runner.StreamRunner.step` converts the whole
    (channels,) S-meter and keying arrays to one float and one bool,
    which raises for any channel batch.)"""

    def __init__(self, radio: Radio, ring: BlockRing | None = None,
                 control_server=None, cat_handler=None, slot_clock=None,
                 channels: tuple[int, ...] = (), batch_blocks: int = 1,
                 display_every: int = 4, graphs: bool = True):
        self.channels = tuple(channels)
        self.batch_blocks = int(batch_blocks)
        # batched mode: publish display taps every Nth call — the
        # reference's updateDisplayFlag refreshes the panadapter once
        # per screen pass, not per DSP block (Display.cpp:261-267)
        self.display_every = int(display_every)
        self._batch_count = 0
        n_floats = 2 * C.BLOCK_SIZE
        for d in self.channels:
            n_floats *= d
        self.radio = radio
        self.device = radio.device
        self.graphs = bool(graphs) and self.device.type == "cuda"
        self.ring = ring or BlockRing(block_floats=n_floats)
        self.control = control_server
        self.cat = cat_handler
        self.slot_clock = slot_clock  # wall-clock fn for FT8 slot sync
        self.load = LoadMeter(force_python=self.batch_blocks > 1)
        self.blocks_processed = 0
        self._state = None
        self._chain = None
        self._graph_of: dict[str, _Graph] = {}
        self._morse = None
        self._ft8_slots = None
        self._codec_gain = None
        self.audio_chunks: list[np.ndarray] = []
        self.keep_audio = False
        self.last_rf_spectrum_db: np.ndarray | None = None
        self.last_audio_spectrum: np.ndarray | None = None
        self.last_smeter_dbm: float | None = None

    # ------------------------------------------------------------------
    def _ensure_chain(self):
        chain = self.radio.chain  # rebuilds on config change
        if chain is not self._chain:
            if self._graph_of:
                # release the old spec's graphs and their memory pools
                self._graph_of = {}
                torch.cuda.empty_cache()
            self._chain = chain
            self._state = chain.init_state(self.channels)
            if chain.spec.mode == "cw":
                from t41x_torch.decode.cw_text import MorseDecoder

                self._morse = MorseDecoder(wpm_hint=self.radio.config.cw_wpm)
            if chain.spec.mode == "ft8":
                from t41x_torch.decode.ft8 import decode as ft8_decode
                from t41x_torch.decode.ft8 import message
                from t41x_torch.decode.ft8.slots import SlotManager

                # t41x's default decode_fn, on the radio's device
                my_grid = self.radio.config.my_grid
                self._ft8_slots = SlotManager(
                    decode_fn=functools.partial(
                        ft8_decode.decode_audio,
                        hashes=message.CallHashTable(), my_grid=my_grid,
                        device=self.device),
                    my_grid=my_grid)
                if self.slot_clock is not None:
                    self._ft8_slots.clock = _fed_clock(self.slot_clock,
                                                       self._ft8_slots)
        return chain

    def _shape(self, batch: bool) -> tuple:
        lead = (self.batch_blocks,) if batch else ()
        return lead + self.channels + (C.BLOCK_SIZE,)

    def _graph(self, batch: bool, params: ChannelParams) -> _Graph:
        kind = "batch" if batch else "block"
        if kind not in self._graph_of:
            fn = self._chain.block_batch if batch else self._chain.block
            self._graph_of[kind] = _Graph(fn, params, self._state,
                                          self._shape(batch))
        return self._graph_of[kind]

    def _run(self, batch: bool, params: ChannelParams, blocks) -> dict:
        """One chain call on the live state (`blocks`: one block, or a
        list of B for a batch): a graph replay, or the chain run eagerly.
        Returns the outputs (tensors on the device)."""
        if self.graphs:
            return self._graph(batch, params).run(params, blocks)
        fn = self._chain.block_batch if batch else self._chain.block
        iq = torch.from_numpy(np.stack(blocks) if batch else blocks).to(
            self.device)
        self._state, out = fn(params, self._state, iq)
        return out

    def _fetch(self, out: dict, keys, index=()) -> dict:
        """`out[k][index]` as NumPy for each of `keys` that `out` holds;
        the copies wait for the call, so they are the step's sync (an
        explicit one when nothing is read)."""
        host = {k: out[k][index].cpu().numpy() for k in keys if k in out}
        if not host and self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return host

    def _streams(self) -> tuple:
        """The outputs read back for every block: the audio when it is
        kept or the FT8 slots take it, the CW keying when the decoder
        runs."""
        audio = self.keep_audio or self._ft8_slots is not None
        return ((("audio_24k",) if audio else ())
                + (("cw_keyed",) if self._morse is not None else ()))

    def _publish_smeter(self, avg) -> None:
        dbm = float(smeter_dbm(torch.from_numpy(np.asarray(avg))))
        self.last_smeter_dbm = dbm
        if self.control is not None:
            self.control.publish_smeter(dbm)
        if self.cat is not None:
            self.cat.smeter_dbm = dbm

    def prime(self) -> None:
        """Build the current chain's kernels and caches and capture its
        graph WITHOUT consuming ring data or advancing state — call
        before attaching a real-time source so the first live block
        doesn't pay the build and capture stall (which would overflow
        the ring at rate_factor=1)."""
        self._ensure_chain()
        params = self.radio.params(self.channels)
        batch = self.batch_blocks > 1
        if self.graphs:
            self._graph(batch, params)
            return
        fn = self._chain.block_batch if batch else self._chain.block
        fn(params, _clone(self._state),
           torch.zeros(self._shape(batch), dtype=torch.complex64,
                       device=self.device))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @property
    def state(self):
        """The live chain state.  Read it to checkpoint; assign a state
        of the same layout to resume: it is copied into the live
        tensors, which the captured graphs read and write in place."""
        self._ensure_chain()
        return self._state

    @state.setter
    def state(self, new) -> None:
        self._ensure_chain()
        for (path, dst), src in zip(flatten_with_path(self._state),
                                    _leaves(new), strict=True):
            if tuple(dst.shape) != tuple(src.shape):
                raise ValueError(f"state {path}: {tuple(src.shape)} vs "
                                 f"{tuple(dst.shape)}")
            dst.copy_(src)

    def step(self) -> dict | None:
        """Process one block from the ring (None if ring empty)."""
        block = self.ring.pop_iq()
        if block is None:
            return None
        block = block.reshape(self.channels + (C.BLOCK_SIZE,))
        self._ensure_chain()
        params = self.radio.params(self.channels)
        self.load.begin()
        out = self._run(False, params, block)
        host = self._fetch(out, _TAPS + _CLIPS + self._streams())
        self.load.end()
        self.blocks_processed += 1

        ch0 = (0,) * len(self.channels)
        results = {"load_percent": self.load.percent}
        if self.keep_audio:
            self.audio_chunks.append(host["audio_24k"])
        # latest display taps, for the control server AND the live
        # operator session (t41x_torch.io.repl)
        if "rf_spectrum" in host:
            self.last_rf_spectrum_db = \
                10 * np.log10(host["rf_spectrum"] + 1e-12)
            if self.control is not None:
                self.control.publish_rf_spectrum(self.last_rf_spectrum_db)
        if "audio_spectrum" in host:
            self.last_audio_spectrum = host["audio_spectrum"]
        if "smeter_avg" in host:
            self._publish_smeter(host["smeter_avg"][ch0])
        if self._morse is not None and "cw_keyed" in host:
            text = self._morse.feed([bool(host["cw_keyed"][ch0])])
            if text:
                results["cw_text"] = text
        if self._ft8_slots is not None:
            decoded = self._ft8_slots.feed(host["audio_24k"][ch0])
            if decoded:
                results["ft8"] = decoded
        if "adc_half_clip" in host:
            self._apply_codec_gain(host["adc_half_clip"][None],
                                   host["adc_quarter_clip"][None])
        return results

    def _apply_codec_gain(self, halfs, quarts) -> None:
        """Step the band RF gain from per-block ADC clip flags — the
        reference's Codec_gain loop (Process.cpp:939,979-1027), run on
        the operator channel."""
        if self._codec_gain is None:
            from t41x_torch.chain.codec_gain import CodecGain

            self._codec_gain = CodecGain()
        ch0 = (slice(None),) + (0,) * len(self.channels)
        g = int(self.radio.config.band.rf_gain)
        for h, q in zip(halfs[ch0].reshape(-1), quarts[ch0].reshape(-1)):
            g = self._codec_gain.step(bool(h), bool(q), g)
        self.radio.config.band.rf_gain = g

    def step_batch(self) -> dict | None:
        """Process `batch_blocks` ring entries in ONE chain call (None if
        fewer are queued).  Display taps publish from the batch's last
        block; the CW decoder is fed every block's keying, the FT8 slots
        every block's audio."""
        if self.ring.available() < self.batch_blocks:
            return None
        blocks = [self.ring.pop_iq().reshape(self.channels + (C.BLOCK_SIZE,))
                  for _ in range(self.batch_blocks)]
        self._ensure_chain()
        params = self.radio.params(self.channels)
        self._batch_count += 1
        display = self._batch_count % self.display_every == 0
        ch0 = (0,) * len(self.channels)
        self.load.begin()
        out = self._run(True, params, blocks)
        host = self._fetch(out, _CLIPS + self._streams())
        if display:
            host.update({k + "_last": v for k, v in self._fetch(
                out, _TAPS, (-1,) + ch0).items()})
        self.load.end(self.batch_blocks)
        self.blocks_processed += self.batch_blocks

        results = {"load_percent": self.load.percent}
        if self.keep_audio:
            audio = host["audio_24k"]   # (B, ..., 256)
            self.audio_chunks.append(
                np.moveaxis(audio, 0, -2).reshape(self.channels + (-1,)))
        if "rf_spectrum_last" in host:
            self.last_rf_spectrum_db = 10 * np.log10(
                host["rf_spectrum_last"] + 1e-12)
            if self.control is not None:
                self.control.publish_rf_spectrum(self.last_rf_spectrum_db)
        if "audio_spectrum_last" in host:
            self.last_audio_spectrum = host["audio_spectrum_last"]
        if "smeter_avg_last" in host:
            self._publish_smeter(host["smeter_avg_last"])
        if self._morse is not None and "cw_keyed" in host:
            keyed = host["cw_keyed"]      # (B, ...)
            text = self._morse.feed([bool(k[ch0]) for k in keyed])
            if text:
                results["cw_text"] = text
        if self._ft8_slots is not None:
            decoded = self._ft8_slots.feed(
                host["audio_24k"][(slice(None),) + ch0].reshape(-1))
            if decoded:
                results["ft8"] = decoded
        if "adc_half_clip" in host:
            self._apply_codec_gain(host["adc_half_clip"],
                                   host["adc_quarter_clip"])
        return results

    def drain(self, max_blocks: int | None = None) -> int:
        """Process everything currently available; returns block count."""
        n = 0
        while max_blocks is None or n < max_blocks:
            if self.batch_blocks > 1:
                if self.step_batch() is None:
                    break
                n += self.batch_blocks
            else:
                if self.step() is None:
                    break
                n += 1
        return n

    @property
    def audio(self) -> np.ndarray:
        if not self.audio_chunks:
            return np.zeros(0, np.float32)
        return np.concatenate(self.audio_chunks)
