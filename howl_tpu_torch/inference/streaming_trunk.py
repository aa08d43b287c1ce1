"""Streaming-trunk live serving: per-layer conv caches (counterpart of
``howl_tpu/inference/streaming_trunk.py``).

The per-window online engines re-run the res8 trunk over the whole 41-frame
window every hop, though a hop adds only ~1.7 pooled trunk frames. This
engine keeps a short ring per trunk stage and computes only each hop's newly
final frames of every layer (``Res8.trunk_stream_step``).

Its scores are the offline fused-trunk scorer's (``StreamingEngine``,
``fused_trunk=True``) applied to the growing stream: window k's logits pool
the pooled-trunk frames [round(k * S / P), + span) of a trunk over all the
audio so far. The trunk's 3x3 convs look one frame ahead a layer, so window
k's span is final only ``lag`` hops later (4 at the defaults, 250 ms); the
FSM runs on window k's own timestamps, and only the host sees the fire
``lag`` hops after the audio that caused it.

The emission schedule (``TrunkSchedule``: new frames a hop, the mel slab's
offset, the span's gap) cycles with a short period; each step looks its
phase's constants up in ``schedule.by_phase``. ``hop_block=H`` (a multiple
of the period) scores H hops with one trunk call. The prefill of a stream's
caches runs the whole-clip trunk (``Res8.trunk_intermediates``, the stem
kernel K2 on a card) over a window of preroll, in blocks of
``prefill_block`` streams; each hop's frames come from the plain log-mel
chain (``ops/frontend.py``, ``center=False``) and its slab stem from
``F.conv2d``, where the JAX package runs XLA. In float32 the prefill and
every step run with TF32 off (``ops/tf32.py``), as ``online.py``'s engines.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from howl_tpu_torch.inference.config import EngineConfig, hop_geometry
from howl_tpu_torch.inference.detect import DetectState
from howl_tpu_torch.inference.online import _HopEngine, chain_log_mels
from howl_tpu_torch.models.base import ModelSpec
from howl_tpu_torch.ops.frontend import FrontendConfig
from howl_tpu_torch.ops.tf32 import exact_if_float32


class TrunkSchedule:
    """Host-side emission schedule for the streaming trunk (a copy of the
    JAX package's, which is pure Python).

    All quantities follow from (initial mel frames m0, stride_frames S,
    pool_t P, span, layers): after hop j the stream has M_j = m0 + S*j final
    mel frames, the newest final pooled stem frame is p_j = (M_j - 1 - P) //
    P (conv0 needs one mel frame of right context; a pooled frame needs its
    whole P-group), and stage i's frontier is p_j - i. Window k's span is
    final once p_{k+lag} - layers >= r(k) + span - 1 with r(k) = round(k*S/P)
    (Python's ``round``: half to even, as the offline engine's window starts).
    """

    def __init__(self, m0: int, stride_frames: int, pool_t: int, span: int, layers: int = 6):
        self.m0, self.S, self.P = m0, stride_frames, pool_t
        self.span, self.layers = span, layers
        # the base period of the mel/pooled-frame phase; with an even t0 the
        # half-integer ties of r(k) alternate their rounding from period to
        # period, so the gap cycle is 2 * t0
        t0 = pool_t // math.gcd(stride_frames, pool_t)
        self.period = 2 * t0 if t0 % 2 == 0 else t0
        self.n_new = max(self._p(j) - self._p(j - 1) for j in range(1, self.period + 1))
        self.slab_frames = self.n_new * pool_t + 2
        # mel cache: large enough for the slab at every phase offset
        tails = [self._slab_tail_off(j) for j in range(1, self.period + 1)]
        assert min(tails) >= 0
        self.mel_cache_len = self.slab_frames + max(tails)
        # decision lag (hops): the first at which every window's span is final
        self.lag = next(
            (
                lag
                for lag in range(0, 64)
                if all(self._p(k + lag) - layers >= self._r(k) + span - 1 for k in range(4 * self.period))
            ),
            None,
        )
        if self.lag is None:
            raise ValueError(
                f"no decision lag <= 64 hops exists for geometry (m0={m0}, "
                f"stride_frames={stride_frames}, pool_t={pool_t}, span={span}): "
                "the window/stride combination cannot be served by the streaming trunk"
            )
        gaps = [self._gap(j) for j in range(self.lag, self.lag + self.period)]
        self.s6_ring_len = span + max(gaps)
        # per-phase constants, phase = j % period
        self.by_phase = {}
        for j in range(self.lag + self.period, self.lag + 2 * self.period):
            self.by_phase[j % self.period] = {
                "delta": self._p(j) - self._p(j - 1),
                "slab_start": self.mel_cache_len - self.slab_frames - self._slab_tail_off(j),
                "gap": self._gap(j),
            }
        # the schedule must actually be periodic
        for j in range(self.lag, self.lag + 6 * self.period):
            e = self.by_phase[j % self.period]
            assert e["delta"] == self._p(j) - self._p(j - 1), f"aperiodic delta at hop {j}"
            assert e["gap"] == self._gap(j), f"aperiodic gap at hop {j}"
            assert e["slab_start"] == self.mel_cache_len - self.slab_frames - self._slab_tail_off(j)

    def _m(self, j: int) -> int:
        return self.m0 + self.S * j

    def _p(self, j: int) -> int:
        return (self._m(j) - 1 - self.P) // self.P

    def _r(self, k: int) -> int:
        return round(k * self.S / self.P)

    def _slab_tail_off(self, j: int) -> int:
        """Mel frames between the slab's newest frame and the stream's newest:
        the slab covers mel frames [P*(p_j - n_new + 1) - 1, P*(p_j + 1)]."""
        return (self._m(j) - 1) - self.P * (self._p(j) + 1)

    def _gap(self, j: int) -> int:
        k = j - self.lag
        return (self._p(j) - self.layers) - (self._r(k) + self.span - 1)

    def blocked(self, hop_block: int) -> dict:
        """Constants for serving ``hop_block`` hops a device step; hop_block
        must be a multiple of ``period`` so that every block sees the same
        phase pattern. Returns delta (new pooled frames a block),
        slab_frames, slab_start, mel_cache_len, gaps (per hop of the block,
        against the block end's frontier) and s6_ring_len."""
        H = int(hop_block)
        if H < 1 or H % self.period:
            raise ValueError(
                f"hop_block={H} must be a positive multiple of the schedule "
                f"period ({self.period}) so every block shares one phase pattern"
            )
        delta = self.S * H // self.P
        slab_frames = delta * self.P + 2
        jE0 = ((self.lag // H) + 2) * H  # a steady-state, phase-aligned block end
        tail_off = self._slab_tail_off(jE0)
        gaps = tuple(
            (self._p(jE0) - self.layers) - (self._r(jE0 - H + h - self.lag) + self.span - 1)
            for h in range(1, H + 1)
        )
        mel_cache_len = slab_frames + tail_off
        # the single phase pattern must actually repeat block to block
        for jE in range(jE0 + H, jE0 + 6 * H, H):
            assert self._p(jE) - self._p(jE - H) == delta, f"aperiodic block delta at {jE}"
            assert self._slab_tail_off(jE) == tail_off, f"aperiodic slab offset at {jE}"
            for h in range(1, H + 1):
                g = (self._p(jE) - self.layers) - (self._r(jE - H + h - self.lag) + self.span - 1)
                assert g == gaps[h - 1], f"aperiodic gap at block end {jE}, hop {h}"
        return {
            "hop_block": H,
            "delta": delta,
            "slab_frames": slab_frames,
            "slab_start": 0,  # the mel cache is exactly [slab | tail_off newest]
            "mel_cache_len": mel_cache_len,
            "gaps": gaps,
            "s6_ring_len": self.span + max(gaps),
        }


def trunk_schedule(cfg: EngineConfig, frontend: FrontendConfig, pool_t: int) -> TrunkSchedule:
    """The schedule of a trunk engine on ``cfg`` and ``frontend`` whose stem
    pools ``pool_t`` mel frames; the hub checks ``hop_block`` against its
    period before it reads any weights."""
    window_frames, stride_frames, _ = hop_geometry(cfg, frontend)
    hop, n_fft = frontend.hop_length, frontend.n_fft
    # the prefill's mel frontier: the last centered frame wholly inside the
    # preroll (frame i spans [i*hop - n_fft/2, i*hop + n_fft/2))
    m0 = (window_frames * hop - n_fft // 2) // hop + 1
    return TrunkSchedule(m0, stride_frames, pool_t, max(window_frames // pool_t, 1))


def make_chained_runner(engine: "FusedStreamingOnlineEngine", ring_hops: int, super_steps: int):
    """A bulk replay of hops through a freshly reset engine, for the bench:
    returns ``(run, init)``, and ``carry, last_fired = run(buf, *carry)``
    with carry ``(tail, mel_cache, rings, s6_ring, state)``. Each step takes
    the last one's carry, so the hops run one after another on the device;
    nothing is copied to the host.

    Per-hop engines: ``super_steps`` periods of hops, hop j reading its
    streams' audio at offset ``(j % ring_hops) * hop_samples`` of a
    (num_streams, ring_hops * hop_samples) buffer; ``ring_hops`` must not be
    a multiple of the schedule period, or every phase would replay one chunk
    (the JAX runner refuses it, since XLA would hoist that frontend out of
    the chain). Blocked engines: ``super_steps`` blocks of ``hop_block``
    hops from a (num_streams, ring_hops * hop_block * hop_samples) buffer,
    ``ring_hops >= 2``. Hops before the decision lag are pushed with
    valid=False, and the FSM clock runs on the window index k = j - lag, as
    ``push`` does; the runner never rebases the clock, so keep the replayed
    time under ~70 min.
    """
    period, lag = engine.schedule.period, engine.schedule.lag
    hop = engine.hop_samples
    init = (engine.tail, engine.mel_cache, engine.rings, engine.s6_ring, engine.state)
    if engine.hop_block > 1:
        if ring_hops < 2:
            raise ValueError("ring_hops must be >= 2 so chunk slices vary per block")
        H = engine.hop_block
        block_samples = H * hop

        def run_blocked(buf, tail, mel_cache, rings, s6_ring, state):
            fired = None
            for m in range(super_steps):
                off = (m % ring_hops) * block_samples
                k0 = m * H + 1 - lag
                tail, mel_cache, rings, s6_ring, state, _, fireds, _ = engine._block_step(
                    buf[:, off : off + block_samples], tail, mel_cache, rings, s6_ring, state, k0, k0 * engine.stride_ms,
                )
                fired = fireds[:, -1]
            return (tail, mel_cache, rings, s6_ring, state), fired

        return run_blocked, init

    if ring_hops % period == 0:
        raise ValueError(
            f"ring_hops={ring_hops} is a multiple of the schedule period ({period}): every phase would "
            "replay the same chunk"
        )

    def run(buf, tail, mel_cache, rings, s6_ring, state):
        fired = None
        for m in range(super_steps):
            for i in range(period):
                j = m * period + 1 + i
                off = (j % ring_hops) * hop
                tail, mel_cache, rings, s6_ring, state, _, fired, _ = engine._hop_step(
                    (1 + i) % period, buf[:, off : off + hop], tail, mel_cache, rings, s6_ring, state,
                    max(j - lag, 0) * engine.stride_ms, j >= lag,
                )
        return (tail, mel_cache, rings, s6_ring, state), fired

    return run, init


class FusedStreamingOnlineEngine(_HopEngine):
    """Live N-stream scorer with per-layer trunk caches (res8).

    ``push`` takes each hop's new samples and returns the fire flag for the
    window ``schedule.lag`` hops back; its posteriors are the offline
    fused-trunk scorer's up to the order of float32 sums. ``hop_block=H`` (a
    multiple of ``schedule.period``) scores H hops in one step: the same
    per-hop decisions, seen at the block's end (at worst ``lag + H - 1``
    hops after the audio). ``shard_streams`` splits the streams, the caches
    and the rings over a mesh (``online.py``).
    """

    _STREAM_STATE = _HopEngine._STREAM_STATE + ("mel_cache", "rings", "s6_ring", "tail", "last_probs")
    _CLOCKS = _HopEngine._CLOCKS + ("_j",)

    def __init__(
        self,
        model,
        variables,
        cfg: EngineConfig,
        frontend: FrontendConfig,
        zmuv_mean: float = 0.0,
        zmuv_std: float = 1.0,
        spec: Optional[ModelSpec] = None,
        num_streams: int = 1,
        compute_dtype=None,
        prefill_block: int = 8192,
        hop_block: int = 1,
        dft_precision="auto",
        device="cuda",
    ):
        super().__init__(model, variables, cfg, frontend, zmuv_mean, zmuv_std, spec, num_streams, compute_dtype,
                         dft_precision, device)
        if not self.spec.uses_trunk:
            raise ValueError(f"FusedStreamingOnlineEngine serves a window classifier with a trunk (res8); "
                             f"got {self.spec}")
        self.prefill_block = max(int(prefill_block), 1)
        hop, n_fft = frontend.hop_length, frontend.n_fft
        pool_t = self.model.pooling[0]
        self.schedule = trunk_schedule(cfg, frontend, pool_t)
        self.span, self.m0 = self.schedule.span, self.schedule.m0
        self.hop_block = int(hop_block)
        p0 = (self.m0 - 1 - pool_t) // pool_t
        if self.hop_block == 1:
            self._ring_frames = self.schedule.n_new + 2
            self._s6_ring_len = self.schedule.s6_ring_len
            self._mel_cache_len = self.schedule.mel_cache_len
            # every stage ring must fit inside the preroll: the deepest reaches
            # back to stem frame p0 - 5 - (n_new + 1)
            if p0 - 5 - (self.schedule.n_new + 1) < 0:
                raise ValueError(
                    f"window too short for the streaming trunk: {self.m0} prefill mel frames "
                    f"give only {p0 + 1} pooled frames; need >= {7 + self.schedule.n_new}"
                )
        else:
            self.block = self.schedule.blocked(self.hop_block)
            self._ring_frames = self.block["delta"] + 2
            self._s6_ring_len = self.block["s6_ring_len"]
            self._mel_cache_len = self.block["mel_cache_len"]
            # a block ingests a whole ring of new frames, so only each stage's
            # 2 newest prefill frames are read; the deepest is s5's (stem
            # frames p0 - 6 and p0 - 5)
            if p0 - 6 < 0:
                raise ValueError(
                    f"window too short for the streaming trunk: {self.m0} prefill mel "
                    f"frames give only {p0 + 1} pooled frames; need >= 8"
                )
            if self._mel_cache_len > self.m0:
                raise ValueError(
                    f"hop_block={self.hop_block} needs a {self._mel_cache_len}-frame mel "
                    f"cache but the {self.window_frames}-frame window prefills only "
                    f"{self.m0}; use a smaller hop_block or a longer window"
                )
        # the same centered-grid audio tail as IncrementalOnlineEngine
        base = n_fft - hop
        self.tail_samples = base + ((n_fft // 2 - base) % hop)
        self._frontend_nc = dataclasses.replace(frontend, center=False)
        self.reset()

    # ---- state ----

    def reset(self, preroll_audio: Optional[np.ndarray] = None):
        """Reset the streams. A stream starts with a window of preroll
        (silence by default), as a zeroed ring buffer would; every trunk
        cache is prefilled from the preroll's whole-clip trunk, so frame
        values match the offline trunk of (preroll + pushed audio)."""
        if self._reset_shards(preroll_audio):
            return
        n = self.num_streams
        want = (n, self.window_frames * self.frontend.hop_length)
        if preroll_audio is None:
            preroll = torch.zeros(want, dtype=torch.float32, device=self.device)
        else:
            preroll = torch.as_tensor(preroll_audio, dtype=torch.float32).to(self.device)
            if preroll.ndim == 1:  # one preroll for every stream
                preroll = preroll.expand(n, -1)
        if tuple(preroll.shape) != want:
            raise ValueError(f"preroll must be {want}, got {tuple(preroll.shape)}")
        # the whole-clip trunk keeps every stage of the preroll alive at once
        # (~100 KB a stream), the rings only ~30 KB: blocks cap the transient
        blocks = [self._prefill(preroll[lo : lo + self.prefill_block]) for lo in range(0, n, self.prefill_block)]
        if len(blocks) == 1:
            self.mel_cache, self.rings, self.s6_ring, self.tail = blocks[0]
        else:
            self.mel_cache = torch.cat([b[0] for b in blocks])
            self.rings = {name: torch.cat([b[1][name] for b in blocks]) for name in blocks[0][1]}
            self.s6_ring = torch.cat([b[2] for b in blocks])
            self.tail = torch.cat([b[3] for b in blocks])
        del blocks
        self.state = self._new_state()
        self.carry = None
        self._j = 0  # hops pushed so far
        self.curr_time = 0.0  # the window-k clock (k = j - lag)
        self.last_labels = None
        self.last_probs = None
        self.last_fired = None

    def _mels(self, audio: torch.Tensor, frontend: FrontendConfig) -> torch.Tensor:
        """ZMUV'd log-mels (B, F, T) in float32 from the plain chain."""
        mels = chain_log_mels(audio, frontend, self._dft_precision)
        return (mels - self.zmuv_mean) / self.zmuv_std

    @torch.no_grad()
    @exact_if_float32
    def _prefill(self, preroll: torch.Tensor):
        """(mel_cache, rings, s6_ring, tail) of a block of streams from their
        (B, window_frames * hop) preroll."""
        sched = self.schedule
        feats_ft = self._mels(preroll, self.frontend)[:, :, : sched.m0]  # the final frames only
        dt = self.compute_dtype or torch.float32
        outs = self.model.trunk_intermediates(feats_ft[:, None].to(dt), self._stem_taps)
        p0 = (sched.m0 - 1 - sched.P) // sched.P
        rings = {}
        frontiers = [("s0", p0)] + [(f"s{i}", p0 - i) for i in range(1, 6)] + [("r2", p0 - 2), ("r4", p0 - 4)]
        for name, frontier in frontiers:
            lo = frontier - self._ring_frames + 1
            seg = outs[name][:, max(lo, 0) : frontier + 1]
            if lo < 0:
                # blocked rings can be deeper than the preroll trunk; the first
                # block's whole-ring ingest drops the zero slots before anything reads them
                seg = torch.cat([seg.new_zeros((seg.shape[0], -lo) + tuple(seg.shape[2:])), seg], dim=1)
            rings[name] = seg.contiguous()
        s6_means = outs["s6"].float().mean(dim=2)  # (B, T6, maps)
        newest = p0 - sched.layers
        take = min(newest + 1, self._s6_ring_len)
        s6_ring = torch.zeros((preroll.shape[0], self._s6_ring_len, s6_means.shape[-1]), dtype=torch.float32,
                              device=preroll.device)
        s6_ring[:, self._s6_ring_len - take :] = s6_means[:, newest + 1 - take : newest + 1]
        # the mel cache: the newest mel_cache_len ZMUV'd frames, time-major
        mel_cache = feats_ft[:, :, -self._mel_cache_len :].transpose(1, 2).contiguous()  # (B, Tc, F)
        return mel_cache, rings, s6_ring, preroll[:, -self.tail_samples :].contiguous()

    def _trunk(self, new_audio, tail, mel_cache, rings, s6_ring, slab_start, slab_frames, delta):
        """The part of a step before the head: the new mel frames into the
        cache (the newest ``mel_cache_len`` kept: a block's shift can exceed
        it), the slab through ``trunk_stream_step``, the s6 ring."""
        buf = torch.cat([tail, new_audio], dim=-1)
        mels = self._mels(buf, self._frontend_nc).transpose(1, 2)  # (B, new frames, F)
        mel_cache = torch.cat([mel_cache, mels], dim=1)[:, -self._mel_cache_len :]
        slab = mel_cache[:, slab_start : slab_start + slab_frames][..., None]
        rings, s6_new = self.model.trunk_stream_step(slab.to(self.compute_dtype or torch.float32), rings, delta)
        s6_ring = torch.cat([s6_ring[:, delta:], s6_new[:, s6_new.shape[1] - delta :]], dim=1)
        return buf[:, -self.tail_samples :], mel_cache, rings, s6_ring

    @torch.no_grad()
    @exact_if_float32
    def _hop_step(self, phase: int, new_audio, tail, mel_cache, rings, s6_ring, state: DetectState, t_now, valid):
        """One hop at schedule phase ``phase``: (tail, mel_cache, rings,
        s6_ring, state, label, fired_now, probs)."""
        e = self.schedule.by_phase[phase]
        tail, mel_cache, rings, s6_ring = self._trunk(
            new_audio, tail, mel_cache, rings, s6_ring, e["slab_start"], self.schedule.slab_frames, e["delta"]
        )
        hi = self._s6_ring_len - e["gap"]
        wmean = s6_ring[:, hi - self.span : hi].mean(dim=1)  # (B, maps) float32
        state, label, fired_now, probs = self._decide(self.model.head(wmean), state, t_now, valid)
        return tail, mel_cache, rings, s6_ring, state, label, fired_now, probs

    @torch.no_grad()
    @exact_if_float32
    def _block_step(self, new_audio, tail, mel_cache, rings, s6_ring, state: DetectState, k0: int, t_base: float):
        """One block of ``hop_block`` hops, the first deciding window ``k0``
        at time ``t_base``: (tail, mel_cache, rings, s6_ring, state, labels
        (B, H), fireds (B, H), probs (B, H, L))."""
        blk = self.block
        # one trunk call for the whole block: delta equals the ring's capacity
        tail, mel_cache, rings, s6_ring = self._trunk(
            new_audio, tail, mel_cache, rings, s6_ring, blk["slab_start"], blk["slab_frames"], blk["delta"]
        )
        ring_len = self._s6_ring_len
        wmeans = torch.stack([s6_ring[:, ring_len - g - self.span : ring_len - g].mean(dim=1) for g in blk["gaps"]],
                             dim=1)  # (B, H, maps) float32
        probs = torch.softmax(self.model.head(wmeans).float(), -1)  # (B, H, L)
        labels, fireds, all_probs = [], [], []
        for h in range(self.hop_block):  # the per-hop FSM, the same semantics as per-hop serving
            state, lab, fired, p = self._decide_probs(probs[:, h], state, t_base + h * self.stride_ms, k0 + h >= 0)
            labels.append(lab)
            fireds.append(fired)
            all_probs.append(p)
        return (tail, mel_cache, rings, s6_ring, state, torch.stack(labels, dim=1), torch.stack(fireds, dim=1),
                torch.stack(all_probs, dim=1))

    # ---- public API ----

    def push(self, new_audio) -> bool:
        """Feed every stream's newest audio; True if the wakeword fired for
        any newly final window.

        Per-hop (hop_block=1): (num_streams, hop_samples); the flag covers
        the window ``schedule.lag`` hops back. Blocked: (num_streams,
        hop_block * hop_samples); the flags cover the block's ``hop_block``
        windows (``last_fired`` is (B, hop_block))."""
        audio = self._as_audio(new_audio)
        want = (self.num_streams, self.hop_block * self.hop_samples)
        if tuple(audio.shape) != want:
            raise ValueError(f"push expects {want}" + (f" (hop_block={self.hop_block})" if self.hop_block > 1 else "")
                             + f", got {tuple(audio.shape)}")
        return self._hop(audio)

    def _advance(self, audio: torch.Tensor):
        if self.hop_block > 1:
            return self._advance_block(audio)
        self._j += 1
        emitting = self._j - self.schedule.lag >= 0  # window k = j - lag is decided now
        if emitting:
            self._maybe_rebase()
        (self.tail, self.mel_cache, self.rings, self.s6_ring, self.state, label, fired_now,
         self.last_probs) = self._hop_step(
            self._j % self.schedule.period, audio, self.tail, self.mel_cache, self.rings, self.s6_ring,
            self.state, self.curr_time, emitting,
        )
        if emitting:
            self.curr_time += self.stride_ms
        return label, fired_now

    def _advance_block(self, audio: torch.Tensor):
        H = self.hop_block
        k0 = self._j + 1 - self.schedule.lag  # the window of the block's first hop
        self._j += H
        self._maybe_rebase()
        # hops before the lag are pushed with valid=False and their (negative)
        # times are never recorded; curr_time counts valid hops only
        t_base = self.curr_time + min(k0, 0) * self.stride_ms
        (self.tail, self.mel_cache, self.rings, self.s6_ring, self.state, labels, fireds,
         self.last_probs) = self._block_step(
            audio, self.tail, self.mel_cache, self.rings, self.s6_ring, self.state, k0, t_base
        )
        self.curr_time += (max(0, k0 + H) - max(0, k0)) * self.stride_ms
        return labels, fireds  # (B, H): hop h decides window k0 + h
