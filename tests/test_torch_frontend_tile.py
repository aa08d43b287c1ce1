"""K1's frame tile (howl_tpu_torch/ops/frontend_cuda.py ``frame_tile``,
the template parameter of ``csrc/frontend_tc.cu`` and ``csrc/frontend.cu``)
on the CPU, against howl_tpu.

The tile is the counterpart of the JAX kernel's ``fb_block``. Here the
plain version takes a tile, checks it as a launch would and gives the same
output at every tile; ``frontend_route``, ``route_and_tile`` and the two
shared-memory reckonings decide which tiles a grade runs at; and a torch
emulation of the "tc" kernel's decomposition tile by tile (each tile's
audio span read once, split as the kernel loads it, against the very
images of W and fb the kernel reads) is held against the plain version and
against ``log_mel_spectrogram_pallas`` at ``fb_block`` 128 and 256 in
interpret mode, at the tolerances of tests/test_torch_frontend_tc.py:
2e-2/std for the bf16 operand grades, 1e-3/std for "bf16x3" and "f32".
On the card, every instance must give the default tile's bits
(tests/test_torch_gpu.py, chip_smoke.py phase 18).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from howl_tpu.ops import frontend as jfe
from howl_tpu.ops.frontend_pallas import log_mel_spectrogram_pallas
from howl_tpu_torch.ops import frontend as tfe
from howl_tpu_torch.ops import frontend_cuda as fc
from tests.test_torch_frontend_tc import W_PASSES, _parts

torch.set_num_threads(1)

CFG = tfe.FrontendConfig(n_mels=40)
TILES = sorted({*fc.FMA_TILES, *(t for ts in fc.TC_TILES.values() for t in ts)})
MEAN, STD = -3.0, 2.5
# the block's shared memory at 512 / 200 and 40 mels by tile and grade, against TC_MAX_SHARED = 232,448 bytes
TC_TABLE = {
    64: {"bf16": 145_064, "bf16x2": 145_064, "bf16x3": 158_984, "f32": 179_464},
    128: {"bf16": 170_664, "bf16x2": 170_664, "bf16x3": 210_184, "f32": 230_664},
    256: {"bf16": 221_864, "bf16x2": 221_864, "bf16x3": 312_584, "f32": 333_064},
    512: {"bf16": 324_264, "bf16x2": 324_264},
}
# the instances that serve each grade at that geometry: every one but "tc" 256 for the split grades, which do not
# fit, and "fma" 64 for "bf16x3", whose two spans and two sets of W's rows do not
SERVED = {(r, t, g) for r, ts in (("tc", fc.TC_TILES[40]), ("fma", fc.FMA_TILES)) for t in ts for g in fc.GRADES
          if not (r == "tc" and t == 256 and g in ("bf16x3", "f32")) and not (r == "fma" and t == 64 and g == "bf16x3")}


@pytest.fixture(scope="module")
def audio():
    # 3 s and an odd length: 301 frames, so every tile has a last tile that is not full
    return (np.random.default_rng(26).standard_normal((2, 48_001)) * 0.1).astype(np.float32)


@pytest.mark.parametrize("grade", fc.GRADES)
@pytest.mark.parametrize("tile", TILES)
def test_plain_output_is_the_default_tiles_at_every_instantiated_tile(audio, grade, tile):
    """Bit for bit the ``frame_tile=None`` output wherever a launch would
    take the tile; where it would not (the block does not fit on the route
    the tile settles on), the plain version raises as the launch would."""
    x = torch.from_numpy(audio)
    want = fc.log_mel_spectrogram_plain(x, CFG, MEAN, STD, precision=grade, layout="tm")
    route = fc.frontend_route(CFG, grade, tile)
    if (route, tile, grade) not in SERVED:
        with pytest.raises(ValueError, match="tile"):
            fc.log_mel_spectrogram_plain(x, CFG, MEAN, STD, precision=grade, layout="tm", frame_tile=tile)
        return
    got = fc.log_mel_spectrogram_plain(x, CFG, MEAN, STD, precision=grade, layout="tm", frame_tile=tile)
    assert torch.equal(got, want)
    assert fc.route_and_tile(CFG, grade, tile) == (route, tile)
    # the CPU wrapper is the plain version, tile and all
    assert torch.equal(fc.log_mel_spectrogram_cuda(x, CFG, MEAN, STD, precision=grade, layout="tm", frame_tile=tile),
                       want)


@pytest.mark.parametrize("tile", [1, 8, 48, 100, 192, 512])
def test_plain_version_raises_on_a_tile_no_route_instantiates(audio, tile):
    with pytest.raises(ValueError, match=f"{tile}-frame tile"):
        fc.log_mel_spectrogram_plain(torch.from_numpy(audio), CFG, precision="bf16", frame_tile=tile)
    assert fc.log_mel_spectrogram_cuda.launches == 0


@pytest.mark.parametrize("tile", sorted(TC_TABLE))
def test_tc_shared_bytes_and_route_reckon_the_tile(tile):
    """The span is the only part of the block that grows with the tile:
    (tile - 1) * hop + n_fft samples, once in bf16 a part of the split
    grades ("f32": once in float32); the ring, fb and the barriers stay."""
    for grade, want in TC_TABLE[tile].items():
        assert fc.tc_shared_bytes(CFG, grade, tile) == want
        fits = want <= fc.TC_MAX_SHARED
        assert (fc.frontend_route(CFG, grade, tile) == "tc") == (fits and tile in fc.TC_TILES[40])
        if tile in fc.TC_TILES[40]:
            assert (("tc", tile, grade) in SERVED) == fits
    assert fc.tc_shared_bytes(CFG, "bf16x3", tile) - fc.tc_shared_bytes(CFG, "bf16x3", 64) == (
        2 * (tile - 64) * CFG.hop_length * 2)


def test_default_tile_keeps_every_route_as_it_was():
    """``frame_tile=None`` is the default tile of the route the geometry
    takes: 128 on "tc", 32 on "fma"; the route is the rule's without a tile."""
    for kw in (dict(n_mels=40), dict(n_mels=80), dict(n_mels=40, hop_length=201), dict(n_fft=400, hop_length=160)):
        cfg = tfe.FrontendConfig(**kw)
        for grade in fc.GRADES:
            route = fc.frontend_route(cfg, grade)
            assert route == fc.frontend_route(cfg, grade, fc.TC_TILE)
            assert fc.route_and_tile(cfg, grade) == (route, fc.TC_TILE if route == "tc" else fc.FMA_TILE)
            assert fc.route_and_tile(cfg, grade, route="fma") == ("fma", fc.FMA_TILE)
            assert fc.tc_shared_bytes(cfg, grade) == fc.tc_shared_bytes(cfg, grade, fc.TC_TILE)


def test_route_and_tile_refuses_before_a_launch():
    with pytest.raises(ValueError, match=r"route='tc'.*256-frame tile does not fit \(312584 bytes"):
        fc.route_and_tile(CFG, "bf16x3", 256, "tc")
    with pytest.raises(ValueError, match=r"route='fma'.*64-frame tile does not fit \(235968 bytes"):
        fc.route_and_tile(CFG, "bf16x3", 64, "fma")
    with pytest.raises(ValueError, match=r"route='tc' cannot serve.*64-frame tile"):
        fc.route_and_tile(tfe.FrontendConfig(n_mels=80), "bf16", 64, "tc")  # 80 mels: 128 only
    with pytest.raises(ValueError, match=r"route='fma' cannot serve.*128-frame tile"):
        fc.route_and_tile(CFG, "bf16", 128, "fma")
    with pytest.raises(ValueError, match="route='tc' cannot serve"):
        fc.route_and_tile(tfe.FrontendConfig(n_mels=40, hop_length=201), "bf16", 64, "tc")  # an odd hop
    # unforced, a tile "tc" cannot hold settles on "fma", which has no such tile either
    assert fc.frontend_route(CFG, "bf16x3", 256) == "fma"
    with pytest.raises(ValueError, match="256-frame tile"):
        fc.route_and_tile(CFG, "bf16x3", 256)
    # the FMA kernel's block: the span, W's staged rows and the power tile (twice the first two for "bf16x3")
    span = 63 * CFG.hop_length + CFG.n_fft
    assert fc.fma_shared_bytes(CFG, "bf16x3", 64) == 4 * (2 * span + 2 * fc.FMA_CHUNK * 2 * 256 + 64 * 256) == 235_968
    assert fc.fma_shared_bytes(CFG, "bf16", 64) == 4 * (span + fc.FMA_CHUNK * 2 * 256 + 64 * 256)
    assert fc.route_and_tile(CFG, "bf16x3", 64) == ("tc", 64)


def _emulate_tiles(audio: torch.Tensor, cfg, grade: str, tile: int) -> torch.Tensor:
    """``csrc/frontend_tc.cu`` tile by tile, "tm" layout, float32 out: each
    tile's span of (tile - 1) * hop + n_fft samples of the padded clip (zeros
    past its end) split into the parts the kernel keeps (its bf16 part, for
    "bf16x3" the remainder, for "f32" hi, mid and lo), the tile's frames
    read from the span, the products of every kept (x part, W pass) against
    the W image's tiles, per 128-bin half the power split and multiplied by
    fb's images, then the epilogue; the tile's frames past the clip's last
    are dropped."""
    cpu = torch.device("cpu")
    w_img, fb_img, n_halves, _, mel_n = fc.frontend_bases_tc(cfg, grade, cpu)  # the same images at every tile
    w_passes, parts = W_PASSES[grade], fc.TC_PARTS[grade]
    w = fc.unpack_w_image(w_img, w_passes, cfg.n_fft, n_halves).float()
    fbs = [fc.unpack_fb_image(img, mel_n).float() for img in fb_img.chunk(parts)]
    groups = [(0, p) for p in range(w_passes)] if parts == 1 else [
        (i, p) for p in range(w_passes) for i in range(parts - p)]
    mel_groups = [(i, j) for j in range(parts) for i in range(parts - j)]
    padded = tfe.center_pad(audio, cfg)
    hop, span = cfg.hop_length, (tile - 1) * cfg.hop_length + cfg.n_fft
    n_frames = cfg.num_frames(audio.shape[-1])
    out = []
    for t0 in range(0, n_frames, tile):
        x = padded[:, t0 * hop : t0 * hop + span]
        x = torch.nn.functional.pad(x, (0, span - x.shape[-1]))
        frames = [p.unfold(-1, cfg.n_fft, hop) for p in _parts(x, parts)]  # (B, tile, n_fft) each
        acc = sum(frames[i] @ w[p] for i, p in groups)
        mel = torch.zeros(acc.shape[:-1] + (mel_n,))
        for h in range(n_halves):
            re, im = acc[..., 256 * h : 256 * h + 128], acc[..., 256 * h + 128 : 256 * h + 256]
            power = _parts(re * re + im * im, parts)
            for i, j in mel_groups:
                mel = mel + power[i] @ fbs[j][128 * h : 128 * h + 128]
        out.append(mel[:, : min(tile, n_frames - t0), : cfg.n_mels])
    m, inv_std = fc._zmuv_scalars(MEAN, STD)
    return (torch.log(torch.cat(out, dim=1) + cfg.log_offset) - m) * inv_std


_PALLAS_PRECISION = {"f32": jax.lax.Precision.HIGHEST, "bf16x3": None, "bf16x2": "bf16x2", "bf16": "bf16"}


@pytest.fixture(scope="module")
def pallas_by_block(audio):
    """The JAX kernel in interpret mode at fb_block 128 and 256, "tm", float32 out: {(grade, fb_block): out}."""
    cache = {}

    def get(grade, fb_block):
        if (grade, fb_block) not in cache:
            out = log_mel_spectrogram_pallas(audio, jfe.FrontendConfig(n_mels=40), MEAN, STD, interpret=True,
                                             precision=_PALLAS_PRECISION[grade], fb_block=fb_block, layout="tm")
            cache[grade, fb_block] = torch.from_numpy(np.array(out.astype(jnp.float32)))
        return cache[grade, fb_block]

    return get


@pytest.mark.parametrize("grade,tile", sorted((g, t) for r, t, g in SERVED if r == "tc"))
def test_tc_tile_emulation_matches_plain_and_pallas_at_both_blocks(audio, pallas_by_block, grade, tile):
    x = torch.from_numpy(audio)
    got = _emulate_tiles(x, CFG, grade, tile)
    plain = fc.log_mel_spectrogram_plain(x, CFG, MEAN, STD, precision=grade, layout="tm")
    atol = (1e-3 if grade in ("f32", "bf16x3") else 2e-2) / STD
    assert got.shape == plain.shape == (2, CFG.num_frames(audio.shape[-1]), 40)
    assert float((got - plain).abs().max()) <= atol
    for fb_block in (128, 256):
        want = pallas_by_block(grade, fb_block)
        assert want.shape == got.shape
        assert float((got - want).abs().max()) <= atol
    # tile by tile or the whole clip at once, the same sums up to the order of float32 additions
    whole = _emulate_tiles(x, CFG, grade, 1 << 12)
    assert float((got - whole).abs().max()) <= 1e-5
