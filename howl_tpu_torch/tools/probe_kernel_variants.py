"""Time variants of one kernel source, each with a piece of its work taken
out, to see where the kernel's time goes.

    python -m howl_tpu_torch.tools.probe_kernel_variants --probe t1-wgmma [--source howl_tpu_torch/csrc/trunk_proto.cu]
    python -m howl_tpu_torch.tools.probe_kernel_variants --probe m2-wgmma [--source howl_tpu_torch/csrc/micro_gemm.cu]
    python -m howl_tpu_torch.tools.probe_kernel_variants --probe m3-wgmma [--source howl_tpu_torch/csrc/micro_poly.cu]
    python -m howl_tpu_torch.tools.probe_kernel_variants --probe int8-fused [--source howl_tpu_torch/csrc/int8_trunk_fused.cu]
    python -m howl_tpu_torch.tools.probe_kernel_variants --probe k1-x3 [--source ...] [--baseline <another checkout>/howl_tpu_torch/csrc]
    python -m howl_tpu_torch.tools.probe_kernel_variants --probe k1-f32 [--source ...] [--baseline <another checkout>/howl_tpu_torch/csrc]
    python -m howl_tpu_torch.tools.probe_kernel_variants --probe hbm-copy [--baseline <another checkout>/howl_tpu_torch/csrc]
    python -m howl_tpu_torch.tools.probe_kernel_variants --probe auto-copy [--baseline <another checkout>/howl_tpu_torch/csrc]

A probe names a kernel source (or several, built together), its C entries,
the study inputs it runs on and a list of variants; a variant is a list of
exact text edits to the sources (each must match once among them all), such
as a loop bound multiplied by a condition that is false at run time, so the
compiler keeps the code and the launch skips it. Every variant is built with
nvcc (sm_90a, one shared library each, under
``howl_tpu_torch/_build/probes``, all variants at once) and timed at the
study's full size with CUDA events over 20 calls, the variants in turns,
twice over (A B C ... C B A), after every case has run once and the first
for two seconds more, untimed, so that the first timed run does not find
the card's clocks low. Only the first variant computes the function;
the others are for timing. An edit that no longer matches its source once
stops the probe before anything is built. ``--baseline DIR`` adds another
checkout's copies of the sources (built on that checkout's headers) to the
turns, as they are, and for ``hbm-copy`` also with its own loads-only and
stores-only cuts, which match the two copy sources as they were before
their stages were swept (one CTA a chunk, or a contiguous share); for
``k1-x3`` and ``k1-f32`` the baseline's K1 entry may take no frame tile
(a checkout from before it was a parameter) and then runs its one tile
against this checkout's default, 128 frames. A probe whose function is one
PyTorch call times that call in the same turns.

Probes:
  t1-wgmma     the trunk proto T1 on ``wgmma`` (``csrc/trunk_proto.cu``),
               full build, at the trunk study's inputs (512 clips x 8 s): as
               it is; no epilogue (no layer's output stored); each layer's
               weights copied only for the first two layers (the others reuse
               those slots); no pool product.
  m2-wgmma     the frontend study's GEMM M2 on ``wgmma``
               (``csrc/micro_gemm.cu``), n_dots 1 and 3, at the frontend
               study's inputs (328,192 frame rows): as it is; W staged once
               per tile and reused for every stage (no refills).
  m3-wgmma     the frontend study's polyphase kernel M3 on ``wgmma``
               (``csrc/micro_poly.cu``), n_dots 1 and 3, at the frontend
               study's inputs (H (512, 768, 200)): as it is; no H staging
               after the first tile (every tile multiplies the first one's
               hop rows); W staged once, its first three stages reused for
               every stage; no stores of the output (those under ``keep``
               stay, so every product still runs); four W slots with H in
               13-row stages, the other way to share the same shared
               memory; A read in the 128-byte swizzle, and W likewise (the
               same shared-memory reads in another pattern); H's slot
               refilled without waiting for the other warps.
  int8-fused   the fused int8 trunk (``csrc/int8_trunk_fused.cu``) at the
               serving batch, (512, 213, 10, 45) in bf16 and float32, res8
               weights from seed 0 calibrated on the first 64 clips: as it
               is (five warpgroups in bf16, three in float32); one
               warpgroup fewer; one more; no epilogue (the products of
               every layer run, nothing is stored); no quantize (each
               layer's output reaches the s8 buffer unquantized, one store
               as before).
  k1-x3        the tensor-core frontend kernel (``csrc/frontend_tc.cu``) at
               the serving batch, 512 clips x 8 s, 40 mels, bf16 out, "tm",
               at each of its grades ("bf16", "bf16x2", "bf16x3"): as it is;
               no x_lo @ W_hi products ("bf16x3": the second group of a W_hi
               stage); no second and third mel products; no store of the
               span's remainder.
  k1-f32       the same kernel at the same batch, at "bf16x3" and at the
               exact grade "f32" (six products of bf16 parts), each cut
               adding to the one before: as it is; no x_lo products (the
               third group of a W_hi stage); nor x_mid products (the second
               group of a W_hi or W_mid stage); nor the W_lo stream (two
               passes of W streamed a half, not three). "bf16x3" is the same
               in every one of these. Then, alone: no wait between a stage's
               groups (each waits only for the one before it, so its A
               fragments are reloaded while that group runs: the time the
               reloads cost, for "bf16x3" too; the results are wrong).
  hbm-copy     the bandwidth sweep's two copy kernels, built together
               (``csrc/hbm_manual_copy.cu``, ``csrc/hbm2hbm.cu``), on its 256
               MB float32 array, the manual copy at k = 2, cb = 512, with
               ``out.copy_(x)`` in the same turns: as it is; loads only (no
               stores); stores only (no loads, no waits for them); then the
               design's levers added one at a time: none (each CTA's stages
               one contiguous share of the array, no L2 policy, no
               prefetch); + the sweep (stage j to CTA j % CTAs); + the L2
               evict-first policy on loads and stores; as it is (+ the
               whole-array copy's L2 prefetch of its next stage).
  auto-copy    the bandwidth sweep's auto copy (``csrc/hbm_auto_copy.cu``)
               on its 256 MB array at every leg of the sweep (float32 at bn
               = 256 .. 4096, bf16 at 1024 and 4096), with ``x + s`` in the
               same turns: as it is; loads only (the stores behind a
               condition on the loaded bytes that never holds); stores only
               (no loads); then the design's levers added one at a time:
               none (CTA g walks block g's stages, the grid of one CTA a
               block that the read and stream legs keep; each thread's
               pieces landed in shared memory by ``cp.async`` and read back;
               eight CTAs an SM; no L2 policy); + a CTA a stage; + registers
               (the pieces straight into registers); + four CTAs an SM (the
               unused shared memory that caps them); as it is (+ the L1
               no-allocate and L2 evict-first policy). Then two other
               designs: a persistent grid (every CTA that fits the card,
               each sweeping stages j, j + CTAs, ...); one load a thread (4
               KB stages, eight CTAs an SM).

Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from howl_tpu_torch.ops import _build

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

T1_WGMMA_EDITS = {
    "as it is": [],
    "no epilogue": [("if (m >= m_tiles(L) || !store) return;", "if (m >= m_tiles(L) || !store || cx.pos >= 0) return;")],
    "two weight copies": [
        ("if (cx.tid == 0 && c + 1 < cx.n_layers) issue_w(cx, c + 1);", "if (cx.tid == 0 && c + 1 < 2) issue_w(cx, c + 1);"),
        ("  mbar_wait(&cx.w_full[c & 1], (c >> 1) & 1);", "  if (c < 2) mbar_wait(&cx.w_full[c & 1], (c >> 1) & 1);"),
        ("if (tid == 0 && c + 6 < cx.n_layers) issue_w(cx, c + 6);", "if (tid == 0 && c + 6 < 2) issue_w(cx, c + 6);"),
        ("mbar_wait(&cx.w_full[(c + 5) & 1], ((c + 5) >> 1) & 1);", "if (c + 5 < 2) mbar_wait(&cx.w_full[(c + 5) & 1], 0);"),
    ],
    "no pool product": [("for (int e = 0; e < kPoolBatch; ++e) {\n          const int ks",
                         "for (int e = 0; e < kPoolBatch * (pos < 0); ++e) {\n          const int ks")],
}

M2_EDITS = {
    "as it is": [],
    "no W refills": [("const bool refill = next < n_stages;", "const bool refill = next < n_stages && next < kWSlots;"),
                     ("mbar_wait(&w_full[slot], (w_par >> slot) & 1u);\n          w_par ^= 1u << slot;",
                      "if (qq < kWSlots) {\n          mbar_wait(&w_full[slot], (w_par >> slot) & 1u);\n"
                      "          w_par ^= 1u << slot;\n          }")],
}

M3_EDITS = {
    "as it is": [],
    "no H staging": [("if (k % kHEvery == 0 && k / kHEvery < kHStages && d == 0 && has_next) round_h(v++);",
                      "if (k % kHEvery == 0 && k / kHEvery < kHStages && d == 0 && has_next && n_dots < 0) round_h(v++);")],
    "W staged once": [("if (next >= n_w) return;", "if (next >= n_w || next >= kWSlots) return;"),
                      ("mbar_wait(&w_full[slot], (q / kWSlots) & 1u);",
                       "if (q < kWSlots) mbar_wait(&w_full[slot], (q / kWSlots) & 1u);")],
    "no stores": [("if ((hp == 0 && j < kOutCols / 8 && last) || keep)",
                   "if ((hp == 0 && j < kOutCols / 8 && last && n_dots < 0) || keep)")],
    "four W slots, 13-row H stages": [("constexpr int kWSlots = 3;", "constexpr int kWSlots = 4;"),
                                      ("constexpr int kHRows = 26; ", "constexpr int kHRows = 13; ")],
    # 130 rows of 128 bytes, padded to whole 1,024-byte atoms, a 64-k block: four blocks fill the two A buffers
    "A swizzled": [("wgmma_m64n256k16_ss(acc, da + (buf * kABytes + step_a_bytes(step)) / 16,",
                    "wgmma_m64n256k16_ss(acc, desc_sw128(a_u + (64 * wg + step_shift(step)) * 128 + "
                    "step_k16(step) % 4 * 32 + step_k16(step) / 4 * 17408),")],
    # a step as 256 rows of 128 bytes, each k16 step 32 bytes on: the slots' room read in M2's pattern
    "W swizzled": [("db + (slot * kWStageBytes + u * kStepBytes) / 16, step > 0);",
                    "desc_sw128(ring_u + slot * kWStageBytes + u * 32), step > 0);")],
    # the refill of an H slot issued without waiting for the other warps to finish with it
    "H refill unwaited": [("      mbar_wait(&h_empty[slot], (v / kHSlots) & 1u);\n      if (lane == 0) issue_h",
                           "      if (lane == 0) issue_h")],
}

# the fused int8 trunk: the epilogue's call behind a condition that is false at run time (no s32 sum reaches it)
_INT8_EPILOGUE = "if (cx.wg + kWG * i < tiles) epilogue<T, L>(cx, acc, row0(i), k);"
_INT8_BF16 = "static constexpr int kT = 43, kWG = 5;"
_INT8_F32 = "static constexpr int kT = 24, kWG = 3;"
INT8_FUSED_EDITS = {
    "as it is": [],
    "one warpgroup fewer": [(_INT8_BF16, _INT8_BF16.replace("5;", "4;")), (_INT8_F32, _INT8_F32.replace("3;", "2;"))],
    "one warpgroup more": [(_INT8_BF16, _INT8_BF16.replace("5;", "6;")), (_INT8_F32, _INT8_F32.replace("3;", "4;"))],
    "no epilogue": [(_INT8_EPILOGUE, _INT8_EPILOGUE.replace("< tiles)", "< tiles && acc[0] == 0x7ffffff3)"))],
    "no quantize": [("static_cast<uint16_t>(__byte_perm(quantize(o0, inv_next), quantize(o1, inv_next), 0x0040));",
                     "static_cast<uint16_t>(__float_as_uint(o0) ^ __float_as_uint(o1));")],
}


K1_X3_EDITS = {
    "as it is": [],
    "no x_lo products": [("          if (kX3 && j < stages_per_pass) {",
                          "          if (kX3 && j < stages_per_pass && n_mels < 0) {")],
    "no lo mel products": [("          mel_product(q, fb_s);             // p_lo @ fb_hi\n"
                            "          mel_product(p, fb_s + fb_bytes);  // p_hi @ fb_lo",
                            "          if (n_mels < 0) {\n            mel_product(q, fb_s);\n"
                            "            mel_product(p, fb_s + fb_bytes);\n          }")],
    "no span remainder": [("          if (kX3)\n            reinterpret_cast<uint2*>(s_audio_lo)",
                           "          if (kX3 && n_mels < 0)\n            reinterpret_cast<uint2*>(s_audio_lo)")],
}

_F32_X_LO = "          if (kF32 && j < stages_per_pass) {  // a W_hi stage: x_lo against it"
_F32_X_MID = "          if (kF32 && j < 2 * stages_per_pass) {  // a W_hi or W_mid stage: x_mid against it"
_F32_W_LO = "  const int w_passes = kParts > 1 ? kParts : n_passes;"
_GROUP_WAIT = "            wgmma_commit();\n            wgmma_wait<0>();\n            wgmma_keep(a);"


def _unreached(line: str) -> tuple:
    """The edit that puts a condition false at run time into ``line``'s ``if``."""
    return line, line.replace(") {", " && n_mels < 0) {", 1)


K1_F32_EDITS = {
    "as it is": [],
    "no x_lo products": [_unreached(_F32_X_LO)],
    "nor x_mid products": [_unreached(_F32_X_LO), _unreached(_F32_X_MID)],
    "nor the W_lo stream": [_unreached(_F32_X_LO), _unreached(_F32_X_MID),
                            (_F32_W_LO, _F32_W_LO.replace("? kParts :", "? kParts - (kF32 && n_mels > 0) :"))],
    "no wait between groups": [(_GROUP_WAIT, _GROUP_WAIT.replace("wgmma_wait<0>", "wgmma_wait<1>"))],
}

# the bandwidth sweep's two copy kernels, built together: csrc/hbm_manual_copy.cu and csrc/hbm2hbm.cu
_M_COUNT = "  const long long stages = sweep.count(blockIdx.x, ctas);"
_M_STAGE = "    const long long j = blockIdx.x + m * ctas;"
_M_LOAD = "    bulk_load_hint(buf, x + at, bytes, &full[slot], policy);"
_M_STORE = "    bulk_store_hint(out + at, buf, bytes, policy);"
_M_LOAD_WAIT = f"    mbar_arrive_expect_tx(&full[slot], bytes);\n{_M_LOAD}\n    mbar_wait(&full[slot], phase);"
_H_COUNT = "  const long long n = sweep.count(blockIdx.x, ctas);  // this CTA's stages"
_H_STAGE = "  auto stage = [&](long long m) { return blockIdx.x + m * ctas; };  // its m-th, in the array's order"
_H_LOAD = "    bulk_load_hint(ring + slot * kSlotBytes, x + sweep.offset(j), sweep.bytes(j), &full[slot], policy);"
_H_STORE = "    bulk_store_hint(out + sweep.offset(j), ring + slot * kSlotBytes, sweep.bytes(j), policy);"
_H_PREFETCH = "    if (m + 1 < n) bulk_prefetch_l2("
_H_WAIT = "    mbar_wait(&full[slot], (phase >> slot) & 1u);\n    phase ^= 1u << slot;\n"
# a CTA's stages as one contiguous share of the array (the first n_stages % ctas CTAs one more), not every ctas-th
_SHARE = "blockIdx.x * (sweep.n_stages / ctas) + min(static_cast<long long>(blockIdx.x), sweep.n_stages % ctas) + m"
_CONTIGUOUS = [(_M_COUNT, "  const long long stages = sweep.n_stages / ctas + (blockIdx.x < sweep.n_stages % ctas);"),
               (_M_STAGE, f"    const long long j = {_SHARE};"),
               (_H_COUNT, "  const long long n = sweep.n_stages / ctas + (blockIdx.x < sweep.n_stages % ctas);"),
               (_H_STAGE, f"  auto stage = [&](long long m) {{ return {_SHARE}; }};")]
_NO_POLICY = [(_M_LOAD, "    bulk_load(buf, x + at, bytes, &full[slot]);"), (_M_STORE, "    bulk_store(out + at, buf, bytes);"),
              (_H_LOAD, "    bulk_load(ring + slot * kSlotBytes, x + sweep.offset(j), sweep.bytes(j), &full[slot]);"),
              (_H_STORE, "    bulk_store(out + sweep.offset(j), ring + slot * kSlotBytes, sweep.bytes(j));")]
_NO_PREFETCH = [(_H_PREFETCH, _H_PREFETCH.replace("n)", "n && n < 0)"))]
_H_FIRST = "for (long long m = 0; m < kSlots && m < n; ++m) load(m);"
_H_REFILL = "      load(m - 1 + kSlots);"
HBM_COPY_EDITS = {
    "as it is": [],
    "loads only": [(_M_STORE, "    if (k < 0)" + _M_STORE[3:]), (_H_STORE, "    if (n < 0)" + _H_STORE[3:])],
    "stores only": [(_M_LOAD_WAIT, "    if (k < 0) {\n" + _M_LOAD_WAIT + "\n    }"),
                    (_H_FIRST, _H_FIRST.replace("m < n;", "m < n && n < 0;")),
                    (_H_REFILL, "      if (n < 0)" + _H_REFILL[5:]), (_H_WAIT, "    if (n < 0)" + _H_WAIT[3:])],
    "no levers": _CONTIGUOUS + _NO_POLICY + _NO_PREFETCH,
    "+ sweep": _NO_POLICY + _NO_PREFETCH,
    "+ sweep, evict-first": _NO_PREFETCH,
}
# the same cuts in the two sources as they were before the sweep (one CTA a chunk, or a contiguous share of 32 KB
# chunks; one issuing thread), for --baseline with that checkout's csrc directory
_FENCE = "    // the slot was written and is read by bulk copies alone: no generic access, so no proxy fence\n"
_B_WAIT_M = "    mbar_wait(&full[slot], (phase >> slot) & 1u);\n    phase ^= 1u << slot;\n" + _FENCE + "    walk"
_B_WAIT_H = _B_WAIT_M.replace("    walk", "    bulk")
_B_FIRST_M = "for (int i = 0; i < k && i < n; ++i) walk.load("
_B_FIRST_H = "for (int i = 0; i < kSlots && i < n; ++i) load(i);"
_B_STORE_H = "    bulk_store(out + (first + i) * kSlotBytes"
HBM_COPY_BASELINE_EDITS = {
    "as it is": [],
    "loads only": [("    walk.store(i, dst);", "    if (k < 0) walk.store(i, dst);"),
                   (_B_STORE_H, "    if (n < 0)" + _B_STORE_H[3:])],
    "stores only": [(_B_FIRST_M, _B_FIRST_M.replace("i < n;", "i < n && k < 0;")),
                    ("    if (i + k < n) walk.load(", "    if (i + k < n && k < 0) walk.load("),
                    (_B_WAIT_M, "    if (k < 0)" + _B_WAIT_M[3:]),
                    (_B_FIRST_H, _B_FIRST_H.replace("i < n;", "i < n && n < 0;")),
                    ("      load(i - 1 + kSlots);", "      if (n < 0) load(i - 1 + kSlots);"),
                    (_B_WAIT_H, "    if (n < 0)" + _B_WAIT_H[3:])],
}

# the bandwidth sweep's auto copy, csrc/hbm_auto_copy.cu
_AC_GRID = "  const long long ctas = n_stages;"
_AC_CAP = "  const int cap_bytes = occupancy_cap_bytes<hbm_auto_copy_kernel<kBf16>>();"
_AC_LOOP = "  for (long long j = blockIdx.x; j < n_stages; j += gridDim.x) {"
_AC_LOAD = "    for (int u = 0; u < kCopyLoads; ++u) v[u] = load_streamed(x + i + u * kCopyThreads, policy);"
_AC_STORE = ("    for (int u = 0; u < kCopyLoads; ++u) store_streamed(out + i + u * kCopyThreads, add16<kBf16>(v[u], s), "
             "policy);")
# one CTA a block, as the read and stream legs keep: CTA g takes block g's stages, one after another
_AC_A_BLOCK = [(_AC_GRID, "  const long long ctas = blocks;"),
               (_AC_LOOP, "  for (long long j = blockIdx.x * (n_stages / gridDim.x), end = j + n_stages / gridDim.x; "
                          "j < end; ++j) {")]
# each thread's pieces landed in shared memory by cp.async and read back by the same thread, no L2 policy
_AC_SHARED = [(_AC_LOAD, "    __shared__ uint4 landed[kCopyLoads][kCopyThreads];\n"
                         "    for (int u = 0; u < kCopyLoads; ++u) cp_async16(&landed[u][threadIdx.x], x + i + u * kCopyThreads);\n"
                         "    cp_async_commit();\n    cp_async_wait<0>();\n"
                         "    for (int u = 0; u < kCopyLoads; ++u) v[u] = landed[u][threadIdx.x];")]
_AC_REGISTERS = [(_AC_LOAD, "    for (int u = 0; u < kCopyLoads; ++u) v[u] = __ldg(x + i + u * kCopyThreads);")]
_AC_NO_POLICY_STORE = [(_AC_STORE, "    for (int u = 0; u < kCopyLoads; ++u) out[i + u * kCopyThreads] = add16<kBf16>(v[u], s);")]
_AC_NO_CAP = [(_AC_CAP, "  const int cap_bytes = 0;")]
AUTO_COPY_EDITS = {
    "as it is": [],
    # the stores behind a condition on the loaded bytes that the array never meets: no load is dead code
    "loads only": [(_AC_STORE, _AC_STORE.replace("u < kCopyLoads;", "u < kCopyLoads * (v[0].x == 0x7fc00001u && "
                                                                    "v[1].x == 0x7fc00001u);"))],
    "stores only": [(_AC_LOAD, "    for (int u = 0; u < kCopyLoads; ++u) v[u] = make_uint4(static_cast<uint32_t>(j), u, 0u, 0u);")],
    "no levers": _AC_A_BLOCK + _AC_SHARED + _AC_NO_POLICY_STORE + _AC_NO_CAP,
    "+ a CTA a stage": _AC_SHARED + _AC_NO_POLICY_STORE + _AC_NO_CAP,
    "+ registers": _AC_REGISTERS + _AC_NO_POLICY_STORE + _AC_NO_CAP,
    "+ four CTAs an SM": _AC_REGISTERS + _AC_NO_POLICY_STORE,
    # every CTA that fits the card at once, each sweeping stages j, j + CTAs, ... as the two copies' grids do
    "persistent grid": [(_AC_GRID, "  int device = 0, sms = 0, per_sm = 0;\n  cudaGetDevice(&device);\n"
                                   "  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);\n"
                                   "  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, hbm_auto_copy_kernel<kBf16>, "
                                   "kCopyThreads, cap_bytes);\n"
                                   "  const long long ctas = n_stages < sms * per_sm ? n_stages : sms * per_sm;")],
    # 4 KB stages, one load a thread, eight CTAs an SM: as many loads in flight an SM, twice the threads
    "one load a thread": [("constexpr int kCopyLoads = 2;", "constexpr int kCopyLoads = 1;")] + _AC_NO_CAP,
}

ITERS = 20  # calls a timed run
WARM_SECONDS = 2.0  # untimed calls of the first case before the first timed run, for at least this long


def edit_sources(texts: dict, edits: list, name: str) -> dict:
    """``texts`` ({file name: text}) with each (old, new) of ``edits``
    replaced in the one text that holds it; each old text must occur exactly
    once among them all."""
    texts = dict(texts)
    for old, new in edits:
        counts = {file: text.count(old) for file, text in texts.items()}
        if sum(counts.values()) != 1:
            raise ValueError(f"variant {name!r}: the edit's text occurs {sum(counts.values())} times, not once")
        file = next(file for file, count in counts.items() if count)
        texts[file] = texts[file].replace(old, new)
    return texts


def probe_sources(source) -> tuple:
    """A probe's sources as a tuple: one path, or several built together."""
    return source if isinstance(source, tuple) else (source,)


def apply_edits(text: str, edits: list, name: str) -> str:
    """``text`` with each (old, new) of ``edits`` replaced; each old text
    must occur exactly once."""
    return edit_sources({"": text}, edits, name)[""]


def build_variant(texts: dict, name: str) -> Path:
    """The sources ({path: edited text}) built together into one shared
    library; their headers are read from the sources' own directory, so a
    variant of another checkout builds on that checkout's headers."""
    sources = list(texts)
    out_dir = _build.BUILD_DIR / "probes" / f"{sources[0].stem}_{''.join(c if c.isalnum() else '_' for c in name)}"
    out_dir.mkdir(parents=True, exist_ok=True)
    for src, text in texts.items():
        (out_dir / src.name).write_text(text)
    lib = out_dir / "libprobe.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I", str(sources[0].parent), "-o", str(lib),
           *(str(out_dir / src.name) for src in sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(_build._failure(cmd, proc.returncode, proc.stdout, proc.stderr))
    return lib


def _events_ms(fn) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(ITERS):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / ITERS


def _t1_runner(dev):
    """T1's full build at the study's inputs, the weights and pool_t as
    their packed images."""
    from howl_tpu_torch.tools import bench_trunk_kernel_micro as study
    from howl_tpu_torch.tools.trunk_kernels import pack_trunk_pool_image, pack_trunk_w_image

    inp = study.make_inputs(512, 8.0, 0, dev)
    b, pos_pad, ch = inp.x_pm.shape
    out = torch.empty((b, inp.pool_t.shape[0], ch), dtype=torch.float32, device=dev)
    w, pool = pack_trunk_w_image(inp.ws_full), pack_trunk_pool_image(inp.pool_t)
    argtypes = (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P)

    def make(lib):
        fn = getattr(lib, "howl_trunk_proto_forward")
        fn.argtypes, fn.restype = list(argtypes), ctypes.c_int

        def run():
            status = fn(inp.x_pm.data_ptr(), w.data_ptr(), pool.data_ptr(), inp.bn_scale.data_ptr(),
                        inp.bn_shift.data_ptr(), out.data_ptr(), b, inp.geom.pos, pos_pad, inp.pool_t.shape[0], 1,
                        torch.cuda.current_stream(dev).cuda_stream)
            _build.check_launch(status, "probe")
        return [("full build", run)]

    return make


def _m2_runner(dev):
    from howl_tpu_torch.tools import bench_pallas_micro as study
    from howl_tpu_torch.tools.frontend_micro_kernels import OUT_COLS, pack_gemm_w_image

    inp = study.make_inputs(512, 8.0, 0, dev)
    x, w_img = inp.frames, pack_gemm_w_image(inp.w)
    out = torch.empty((x.shape[0], OUT_COLS), dtype=torch.float32, device=dev)
    argtypes = (_P, _P, _P, _I, _F, _I, _I, _P)

    def make(lib):
        fn = getattr(lib, "howl_micro_gemm_forward")
        fn.argtypes, fn.restype = list(argtypes), ctypes.c_int

        def call(n_dots):
            def run():
                status = fn(x.data_ptr(), w_img.data_ptr(), out.data_ptr(), x.shape[0], 0.25, n_dots, 0,
                            torch.cuda.current_stream(dev).cuda_stream)
                _build.check_launch(status, "probe")
            return run
        return [("n_dots 1", call(1)), ("n_dots 3", call(3))]

    return make


def _m3_runner(dev):
    from howl_tpu_torch.tools import bench_pallas_micro as study
    from howl_tpu_torch.tools.frontend_micro_kernels import OUT_COLS, pack_poly_w_image

    inp = study.make_inputs(512, 8.0, 0, dev)
    h, w_img, g = inp.h, pack_poly_w_image(inp.w), inp.geom
    out = torch.empty((g.batch, g.t_pad, OUT_COLS), dtype=torch.float32, device=dev)
    argtypes = (_P, _P, _P, _I, _I, _I, _F, _I, _I, _P)

    def make(lib):
        fn = getattr(lib, "howl_micro_poly_forward")
        fn.argtypes, fn.restype = list(argtypes), ctypes.c_int

        def call(n_dots):
            def run():
                status = fn(h.data_ptr(), w_img.data_ptr(), out.data_ptr(), g.batch, h.shape[1], g.t_pad, 0.25, n_dots,
                            0, torch.cuda.current_stream(dev).cuda_stream)
                _build.check_launch(status, "probe")
            return run
        return [("n_dots 1", call(1)), ("n_dots 3", call(3))]

    return make


def _int8_fused_runner(dev):
    """The fused int8 trunk at the serving batch, bf16 and float32, on the
    engine's calibration and quantization of seeded res8 weights."""
    import numpy as np

    from howl_tpu_torch.bench import CALIBRATION_CLIPS, NUM_LABELS, res8_numpy_variables
    from howl_tpu_torch.compat import res8_variables_to_state_dict
    from howl_tpu_torch.ops import int8_trunk as t8

    gen = torch.Generator(device=dev).manual_seed(0)
    y = torch.relu(torch.randn((512, 213, 10, 45), generator=gen, device=dev))
    state = res8_variables_to_state_dict(res8_numpy_variables(np.random.default_rng(0), NUM_LABELS))
    p = t8.quantize_residual_trunk(state, t8.calibrate_act_scales(y[:CALIBRATION_CLIPS], state), dev)
    imgs = [t8.pack_w_image_wgmma(w) for w in p.w_i8]

    def arrays(kind, values):
        return (kind * t8.N_LAYERS)(*values)

    def make(lib):
        fn = getattr(lib, "howl_int8_trunk_fused_forward")
        fn.argtypes, fn.restype = list(_build.SIGNATURES["howl_int8_trunk_fused_forward"]), ctypes.c_int

        def call(dtype):
            x = y.to(dtype)
            out = torch.empty_like(x)
            args = [arrays(ctypes.c_void_p, (t.data_ptr() for t in ts)) for ts in (imgs, p.w_scale, p.bn_scale, p.bn_shift)]
            scales = [arrays(ctypes.c_float, p.act_scale), arrays(ctypes.c_float, (t8._inv_scale(s) for s in p.act_scale))]

            def run():
                status = fn(x.data_ptr(), *args, *scales, out.data_ptr(), *x.shape, int(dtype == torch.bfloat16),
                            torch.cuda.current_stream(dev).cuda_stream)
                _build.check_launch(status, "probe")
            return run
        return [("bf16", call(torch.bfloat16)), ("float32", call(torch.float32))]

    return make


def _k1_runner(dev, grades: tuple):
    """The tensor-core frontend kernel at the serving batch, one case for
    each of ``grades``, each on its own images (``frontend_bases_tc``)."""
    from howl_tpu_torch.ops.frontend import FrontendConfig
    from howl_tpu_torch.ops.frontend_cuda import TC_TILE, frontend_bases_tc

    cfg = FrontendConfig(n_mels=40)
    audio = torch.randn((512, 128000), generator=torch.Generator(device=dev).manual_seed(0), device=dev) * 0.1
    n_frames = cfg.num_frames(audio.shape[1])
    out = torch.empty((512, n_frames, cfg.n_mels), dtype=torch.bfloat16, device=dev)

    def make(lib):
        fn = getattr(lib, "howl_logmel_tc_forward")
        argtypes = list(_build.SIGNATURES["howl_logmel_tc_forward"])
        tiled = getattr(lib, "takes_frame_tile", True)  # a baseline whose entry has no tile runs its one tile
        fn.argtypes, fn.restype = argtypes if tiled else argtypes[:14] + argtypes[15:], ctypes.c_int

        def call(grade):
            w_img, fb_img, n_halves, n_passes, mel_n = frontend_bases_tc(cfg, grade, dev)

            def run():
                status = fn(audio.data_ptr(), w_img.data_ptr(), fb_img.data_ptr(), out.data_ptr(), 512,
                            audio.shape[1], n_frames, cfg.n_fft, cfg.hop_length, 1, n_halves, n_passes, cfg.n_mels,
                            mel_n, *((TC_TILE,) if tiled else ()), 1, 0, cfg.log_offset, -6.0, 0.25,
                            torch.cuda.current_stream(dev).cuda_stream)
                _build.check_launch(status, "probe")
            return run
        return [(grade, call(grade)) for grade in grades]

    return make


def _hbm_copy_runner(dev):
    """The bandwidth sweep's two copy kernels on its 256 MB float32 array:
    the manual copy at the sweep's first ring (k = 2, cb = 512) and the
    whole-array copy; ``out.copy_(x)`` on the same arrays is timed in the
    same turns."""
    from howl_tpu_torch.tools import bench_hbm_sweep as sweep
    from howl_tpu_torch.tools.hbm_sweep_kernels import DONE_SHAPE

    x = sweep.make_inputs(256, sweep.SEED, dev)[1]
    out, done = torch.empty_like(x), torch.empty(DONE_SHAPE, device=dev)
    k, cb = sweep.MANUAL_KS[0], sweep.MANUAL_CBS[0]

    def make(lib):
        manual, whole = lib.howl_hbm_manual_copy_forward, lib.howl_hbm2hbm_forward
        for fn, name in ((manual, "howl_hbm_manual_copy_forward"), (whole, "howl_hbm2hbm_forward")):
            fn.argtypes, fn.restype = list(_build.SIGNATURES[name]), ctypes.c_int

        def run_manual():
            status = manual(x.data_ptr(), out.data_ptr(), done.data_ptr(), x.shape[0], cb, k, 0, 0.0,
                            torch.cuda.current_stream(dev).cuda_stream)
            _build.check_launch(status, "probe")

        def run_whole():
            status = whole(x.data_ptr(), out.data_ptr(), done.data_ptr(), x.numel() * x.element_size(), 0.0,
                           torch.cuda.current_stream(dev).cuda_stream)
            _build.check_launch(status, "probe")
        return [(f"manual copy k={k} cb={cb}", run_manual), ("hbm2hbm", run_whole)]

    make.library = [("out.copy_(x)", lambda: out.copy_(x))]
    return make


def _auto_copy_runner(dev):
    """The bandwidth sweep's auto copy on its 256 MB array at every leg the
    sweep times (float32 at each block height, bf16 at two); ``x + s`` on
    the same arrays is timed in the same turns."""
    from howl_tpu_torch.tools import bench_hbm_sweep as sweep

    _, x32, x16 = sweep.make_inputs(256, sweep.SEED, dev)
    legs = [(x32, "f32", bn) for bn in sweep.BNS] + [(x16, "bf16", bn) for bn in sweep.BF16_BNS]
    outs = {tag: torch.empty_like(x) for x, tag, _ in legs}

    def make(lib):
        fn = lib.howl_hbm_auto_copy_forward
        fn.argtypes, fn.restype = list(_build.SIGNATURES["howl_hbm_auto_copy_forward"]), ctypes.c_int

        def call(x, tag, bn):
            def run():
                status = fn(x.data_ptr(), outs[tag].data_ptr(), x.shape[0], bn, int(tag == "bf16"), 0.0,
                            torch.cuda.current_stream(dev).cuda_stream)
                _build.check_launch(status, "probe")
            return run
        return [(f"{tag} bn={bn}", call(x, tag, bn)) for x, tag, bn in legs]

    make.library = [("x + s f32", lambda: x32 + 0.0), ("x + s bf16", lambda: x16 + 0.0)]
    return make


PROBES = {
    "t1-wgmma": (_build.CSRC / "trunk_proto.cu", T1_WGMMA_EDITS, _t1_runner),
    "m2-wgmma": (_build.CSRC / "micro_gemm.cu", M2_EDITS, _m2_runner),
    "m3-wgmma": (_build.CSRC / "micro_poly.cu", M3_EDITS, _m3_runner),
    "int8-fused": (_build.CSRC / "int8_trunk_fused.cu", INT8_FUSED_EDITS, _int8_fused_runner),
    "k1-x3": (_build.CSRC / "frontend_tc.cu", K1_X3_EDITS,
              functools.partial(_k1_runner, grades=("bf16", "bf16x2", "bf16x3"))),
    "k1-f32": (_build.CSRC / "frontend_tc.cu", K1_F32_EDITS, functools.partial(_k1_runner, grades=("bf16x3", "f32"))),
    "hbm-copy": ((_build.CSRC / "hbm_manual_copy.cu", _build.CSRC / "hbm2hbm.cu"), HBM_COPY_EDITS, _hbm_copy_runner),
    "auto-copy": (_build.CSRC / "hbm_auto_copy.cu", AUTO_COPY_EDITS, _auto_copy_runner),
}
# the variants a --baseline checkout's copies of a probe's sources are built in (by default only as they are)
BASELINE_EDITS = {"hbm-copy": HBM_COPY_BASELINE_EDITS}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--probe", choices=sorted(PROBES), required=True)
    ap.add_argument("--source", type=Path, nargs="+", default=None)
    ap.add_argument("--baseline", type=Path, default=None,
                    help="another checkout's csrc directory: its copies of the probe's sources join the turns")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_kernel_variants needs a CUDA device")
    default_source, edits, runner = PROBES[args.probe]
    sources = tuple(args.source or probe_sources(default_source))
    variants = {name: (sources, e) for name, e in edits.items()}
    if args.baseline:
        for name, e in BASELINE_EDITS.get(args.probe, {"as it is": []}).items():
            variants[f"baseline, {name}"] = (tuple(args.baseline / src.name for src in sources), e)
    # every edit is checked before anything is built; then the variants build together
    texts = {name: edit_sources({src: src.read_text() for src in srcs}, e, f"{name}, {srcs[0]}")
             for name, (srcs, e) in variants.items()}
    with ThreadPoolExecutor(max_workers=len(texts)) as pool:
        built = {name: pool.submit(build_variant, t, name) for name, t in texts.items()}
        libs = {name: ctypes.CDLL(str(future.result())) for name, future in built.items()}
    for name, lib in libs.items():  # whether K1's entry takes the frame tile (a checkout from before: no)
        lib.takes_frame_tile = any("int frame_tile" in text for text in texts[name].values())
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    make = runner(dev)
    cases = {name: make(lib) for name, lib in libs.items()}
    if getattr(make, "library", None):
        cases["library"] = make.library  # one PyTorch call of the same function, in the same turns
    names = list(cases)
    # every case once, then the first one for WARM_SECONDS: the first timed run finds the card's clocks up
    for name in names:
        for _, fn in cases[name]:
            fn()
    warm_until = time.perf_counter() + WARM_SECONDS
    while time.perf_counter() < warm_until:
        for _ in range(ITERS):
            cases[names[0]][0][1]()
        torch.cuda.synchronize()
    times: dict = {}
    for name in names + names[::-1]:
        for case, fn in cases[name]:
            times.setdefault(f"{name}, {case}", []).append(_events_ms(fn))
    print(f"{args.probe} on {torch.cuda.get_device_name(dev)}, {', '.join(map(str, sources))}, {ITERS} calls a run, "
          "two runs each:")
    for key, ms in times.items():
        print(f"  {key:40s} {ms[0]:.4f} / {ms[1]:.4f} ms")
    print(json.dumps({"probe": args.probe, "ms": times}))
    return times


if __name__ == "__main__":
    main()
