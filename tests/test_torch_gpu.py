"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: they need a CUDA device and nvcc, and skip with a reason
elsewhere. This file imports neither jax nor howl_tpu, so it runs where jax is
not installed; the repo's conftest.py imports jax, so run it without:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -p no:cacheprovider

Shapes are small and cover geometries the main path does not use (80 mels,
n_fft 400 / hop 160, both together, where the three-pass grade still takes
the tensor-core kernel, n_fft 256 with 80 and 64 mels, where the exact grade
takes it at mel width 80, center=False, a ragged last frame tile; batches of 1, 7
and 1025, ragged windows and narrow banks for the noise-bank mix). The
frontend runs through both of its kernels (``route="tc"``, ``"fma"``) and
through the one ``frontend_route`` picks, at frame counts around the
tensor-core kernel's 64-frame warpgroups and 128-frame tiles, and once at the
serving batch of 512 clips of 8 s. The res8 stem runs through both of its
kernels at frame counts whose pooled frames are no multiple of the
tensor-core kernel's 24-frame tile, at batches of 1, 3 and 512, at other
mel and channel counts, and on clips whose output starts off a 16-byte
boundary; the stem fold proto (T2) at row counts whose last 64-row item is
not full; the trunk proto (T1) at batches of 1 to 512, 2 s and 8 s, pos at
pos_pad and inside a frame and a tile, with two weight tensors in turn.
Tolerances are tests/test_torch_frontend.py's and tests/test_torch_stem.py's;
the noise-bank mix is held to its plain version bit for bit. The frontend
cost study's kernels (stream, GEMM, polyphase) run at the study's CPU size
and at its full size, 512 clips of 8 s, with totals and frame counts that
end inside a staging round, a block and a tile (M2: totals of 1, 63, 129
rows and the study's 328,192, one to three products; M3: 1 to 512 clips of 1
to 641 frames, 135 tiles over 132 persistent blocks). The bandwidth sweep's seven
kernels are held to their plain versions bit for bit over the whole output,
in float32 and bf16, at block heights from 8 rows to the whole array and at
row counts whose last ring stage and last bulk-copy chunk are not full; the
manual legs at every ring depth from 2 to 8, with chunks shorter than the
ring, chunks that wrap it many times and bf16 chunks that end inside a stage.
The frontend and stem kernels take 65,536 clips in one launch (the online
bench's largest window batch), held against their plain versions chunk by
chunk; each live engine's bf16 decisions equal its float32 decisions on
streams whose loud half fires; a CNN, an RNN and a sequential model of the
zoo decide on the card as on the CPU. The int8 trunk's layer kernel gives exact s32
sums (at +-127 extremes too) at pooled frame counts around its 25-frame
blocks and at 1, 17 and 64 frequency bins, equals its plain version bit for
bit in float32 and bf16 with each epilogue, and both routes of the trunk
(six layer launches, one fused launch) equal the plain trunk at the serving
batch; the int8 engine on the card matches the CPU's. The fused int8 trunk
(``csrc/int8_trunk_fused.cu``) equals the plain trunk bit for bit in bf16
and float32 at 1 and 3 clips of 1, tile - 1, tile, tile + 1, two tiles +
1 and 213 frames at 8 and 10 bins (around its 43- and 24-frame tiles; the
serving geometry runs its own instance), at 11 and 1 bins in bf16, at
C = 48 and 13, launches once a trunk, packs its weights again after an
in-place change, and reports the shared memory and tiles the host's route
computes.
"""

import functools

import numpy as np
import pytest
import torch

from howl_tpu_torch.ops import augment as aug
from howl_tpu_torch.ops.augment_cuda import mix_noise_bank_cuda, mix_noise_bank_plain
from howl_tpu_torch.ops.frontend import FrontendConfig, round_bf16
from howl_tpu_torch.ops.frontend_cuda import frontend_route, log_mel_spectrogram_cuda, log_mel_spectrogram_plain
from howl_tpu_torch.ops.stem_cuda import res8_stem_cuda, res8_stem_plain, stem_route

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _bf16_ulp(x) -> float:
    return 2.0 ** (np.floor(np.log2(max(float(x.float().abs().max()), 1e-30))) - 7)


def _hold_frontend(cuda, audio, cfg, route, grade, out_dtype, layout, mean=-3.0, std=2.5):
    """One kernel launch held against the plain version. Tolerances: the
    float32 grade 1e-3/std; the bf16 operand grades 2e-2/std (the operands
    are bit-equal, the float32 sums differ in order and the tensor cores do
    not round each partial sum as fmaf does, which can flip one bf16 rounding
    of the power); bf16 output adds one bf16 ulp of its magnitude. The three-pass grade computes the same passes as the plain
    version, so as for the float32 grade only the order of the float32 sums
    differs: 1e-3/std."""
    fn = log_mel_spectrogram_cuda
    args = dict(precision=grade, out_dtype=out_dtype, layout=layout)
    served = frontend_route(cfg, grade)
    if route == "tc" and served != "tc":
        with pytest.raises(ValueError, match="route='tc'"):
            fn(audio, cfg, mean, std, route=route, **args)
        return
    before, before_tc = fn.launches, fn.launches_tc
    got = fn(audio, cfg, mean, std, route=route, **args)
    want = log_mel_spectrogram_plain(audio, cfg, mean, std, **args)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert fn.launches_tc == before_tc + ((route or served) == "tc")
    assert got.shape == want.shape and got.dtype == want.dtype
    atol = (1e-3 if grade in ("f32", "bf16x3") else 2e-2) / std
    if out_dtype == torch.bfloat16:
        atol += _bf16_ulp(want)
    assert bool(torch.isfinite(got.float()).all())
    assert float((got.float() - want.float()).abs().max()) <= atol


@pytest.mark.parametrize(
    "kw,samples",
    [({"n_mels": 40}, 16000), ({"n_mels": 80}, 12345), ({"n_mels": 40, "n_fft": 400, "hop_length": 160}, 9000),
     ({"n_mels": 40, "center": False}, 20000), ({"n_mels": 80, "n_fft": 400, "hop_length": 160}, 9000),
     ({"n_mels": 80, "n_fft": 256, "hop_length": 80}, 12001), ({"n_mels": 64, "n_fft": 256, "hop_length": 128}, 9000)],
)
@pytest.mark.parametrize("grade", ["f32", "bf16x3", "bf16x2", "bf16"])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["tm", "fm"])
@pytest.mark.parametrize("route", [None, "tc", "fma"])
def test_frontend_kernel_matches_plain(cuda, kw, samples, grade, out_dtype, layout, route):
    gen = torch.Generator(device=cuda).manual_seed(samples)
    audio = torch.randn((3, samples), generator=gen, device=cuda) * 0.1
    _hold_frontend(cuda, audio, FrontendConfig(**kw), route, grade, out_dtype, layout)


@pytest.mark.parametrize("n_frames", [1, 2, 63, 64, 65, 128, 129, 641])
@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("route", ["tc", "fma"])
def test_frontend_kernel_across_tile_edges(cuda, n_frames, batch, route):
    """Frame counts around the tensor-core kernel's 64-frame warpgroups and
    128-frame tiles. A clip of two frames (257 samples, one more than the
    reflect padding needs) is shorter than a tile, and both its reflected
    edges fall into one span; a single frame exists only with center=False."""
    cfg = FrontendConfig(n_mels=40, center=n_frames > 1)
    samples = (n_frames - 1) * cfg.hop_length + 57 if cfg.center else 600
    assert cfg.num_frames(samples) == n_frames
    gen = torch.Generator(device=cuda).manual_seed(n_frames)
    audio = torch.randn((batch, samples), generator=gen, device=cuda) * 0.1
    for grade, out_dtype, layout in (("bf16", torch.bfloat16, "tm"), ("bf16x2", torch.float32, "fm"),
                                     ("bf16x3", torch.float32, "tm"), ("bf16x3", torch.bfloat16, "fm"),
                                     ("f32", torch.float32, "fm"), ("f32", torch.bfloat16, "tm")):
        _hold_frontend(cuda, audio, cfg, route, grade, out_dtype, layout)


_TILE_INSTANCES = [("tc", 64), ("tc", 256), ("fma", 16), ("fma", 64)]  # beside the defaults, "tc" 128 and "fma" 32


@pytest.mark.parametrize("n_frames", [1, 2, 63, 64, 65, 129, 255, 256, 257, 641])
@pytest.mark.parametrize("route,tile", _TILE_INSTANCES)
def test_frontend_tile_instances_are_the_default_tile_bit_for_bit(cuda, n_frames, route, tile):
    """Every tile K1 is compiled for at 40 mels gives the route's default
    tile's bits, in every grade it serves, at frame counts around its own and
    the default's tiles (a frame's sums run in the same order whatever tile
    holds it), and launches that instance; a grade it cannot hold raises
    before a launch."""
    from howl_tpu_torch.ops.frontend_cuda import route_and_tile

    cfg = FrontendConfig(n_mels=40, center=n_frames > 1)
    samples = (n_frames - 1) * cfg.hop_length + 57 if cfg.center else 600
    audio = torch.randn((3, samples), generator=torch.Generator(device=cuda).manual_seed(n_frames), device=cuda) * 0.1
    fn = log_mel_spectrogram_cuda
    for grade in ("f32", "bf16x3", "bf16x2", "bf16"):
        for out_dtype, layout in ((torch.float32, "tm"), (torch.bfloat16, "fm")):
            kw = dict(precision=grade, out_dtype=out_dtype, layout=layout, route=route)
            try:
                route_and_tile(cfg, grade, tile, route)
            except ValueError:
                n = fn.launches
                with pytest.raises(ValueError, match="does not fit"):
                    fn(audio, cfg, -3.0, 2.5, frame_tile=tile, **kw)
                assert fn.launches == n
                continue
            want = fn(audio, cfg, -3.0, 2.5, **kw)
            n = fn.launches_by_tile.get((route, tile), 0)
            got = fn(audio, cfg, -3.0, 2.5, frame_tile=tile, **kw)
            torch.cuda.synchronize()
            assert fn.launches_by_tile[route, tile] == n + 1
            assert torch.equal(got, want), (grade, out_dtype, layout)


@pytest.mark.parametrize("route,tile", _TILE_INSTANCES)
def test_frontend_tile_instances_at_the_serving_batch(cuda, route, tile):
    """512 clips of 8 s: bit for bit the default tile and within the
    tolerance of the plain version, in "bf16" and "bf16x2" (every instance
    holds them)."""
    audio = torch.randn((512, 128000), generator=torch.Generator(device=cuda).manual_seed(5), device=cuda) * 0.1
    cfg = FrontendConfig(n_mels=40)
    for grade in ("bf16", "bf16x2"):
        kw = dict(precision=grade, out_dtype=torch.bfloat16, layout="tm")
        got = log_mel_spectrogram_cuda(audio, cfg, -3.0, 2.5, route=route, frame_tile=tile, **kw)
        assert torch.equal(got, log_mel_spectrogram_cuda(audio, cfg, -3.0, 2.5, route=route, **kw))
        want = log_mel_spectrogram_plain(audio, cfg, -3.0, 2.5, **kw)
        assert float((got.float() - want.float()).abs().max()) <= 2e-2 / 2.5 + _bf16_ulp(want)


def test_frontend_tile_that_does_not_fit_raises_before_a_launch(cuda):
    audio = torch.randn((2, 16000), device=cuda)
    cfg = FrontendConfig(n_mels=40)
    fn = log_mel_spectrogram_cuda
    n = fn.launches
    for grade, route, tile in (("bf16x3", "tc", 256), ("f32", "tc", 256), ("bf16x3", "fma", 64)):
        with pytest.raises(ValueError, match=r"does not fit \(\d+ bytes of shared memory"):
            fn(audio, cfg, precision=grade, route=route, frame_tile=tile)
    with pytest.raises(ValueError, match="128-frame tile"):
        fn(audio, cfg, precision="bf16", route="fma", frame_tile=128)
    with pytest.raises(ValueError, match="64-frame tile"):
        fn(audio, FrontendConfig(n_mels=80), precision="bf16", route="tc", frame_tile=64)
    assert fn.launches == n


@pytest.mark.parametrize("route", ["tc", "fma"])
def test_frontend_kernel_at_the_serving_batch(cuda, route):
    gen = torch.Generator(device=cuda).manual_seed(512)
    audio = torch.randn((512, 128000), generator=gen, device=cuda) * 0.1
    _hold_frontend(cuda, audio, FrontendConfig(n_mels=40), route, "bf16", torch.bfloat16, "tm", mean=-6.0, std=4.0)


@pytest.mark.parametrize("route", ["tc", "fma"])
def test_frontend_three_pass_grade_at_the_serving_batch(cuda, route):
    """The JAX kernel's default grade, "bf16x3", at 512 x 8 s: bf16 out,
    "tm", on both kernels, at 1e-3/std plus one bf16 ulp."""
    gen = torch.Generator(device=cuda).manual_seed(513)
    audio = torch.randn((512, 128000), generator=gen, device=cuda) * 0.1
    _hold_frontend(cuda, audio, FrontendConfig(n_mels=40), route, "bf16x3", torch.bfloat16, "tm", mean=-6.0, std=4.0)


@pytest.mark.parametrize("route", ["tc", "fma"])
def test_frontend_exact_grade_at_the_serving_batch(cuda, route):
    """The exact grade, "f32" (the JAX kernel's ``Precision.HIGHEST``), at
    512 x 8 s on both kernels, float32 and bf16 out, "tm" and "fm": the
    "tc" kernel's six products of bf16 parts against the plain float32
    product at 1e-3/std (plus one bf16 ulp for bf16 output)."""
    gen = torch.Generator(device=cuda).manual_seed(514)
    audio = torch.randn((512, 128000), generator=gen, device=cuda) * 0.1
    for out_dtype in (torch.float32, torch.bfloat16):
        for layout in ("tm", "fm"):
            _hold_frontend(cuda, audio, FrontendConfig(n_mels=40), route, "f32", out_dtype, layout, mean=-6.0, std=4.0)


@pytest.mark.parametrize(
    "kw,samples",
    [({"n_mels": 40}, 128000), ({"n_mels": 40, "n_fft": 400, "hop_length": 160}, 20000),
     ({"n_mels": 80, "n_fft": 256, "hop_length": 80}, 12001), ({"n_mels": 64, "n_fft": 256, "hop_length": 128}, 20000)],
)
def test_exact_grade_is_nearer_the_float32_product_than_three_passes(cuda, kw, samples):
    """The "tc" kernel's "f32" (six bf16 passes) against the plain "f32",
    float32 out, is nearer than the same kernel's "bf16x3" (three passes)
    on the same audio: a kernel that dropped a group of products would
    still meet the grade's 1e-3/std, but not this. Both mel widths."""
    cfg = FrontendConfig(**kw)
    assert frontend_route(cfg, "f32") == frontend_route(cfg, "bf16x3") == "tc"
    gen = torch.Generator(device=cuda).manual_seed(samples)
    audio = torch.randn((8, samples), generator=gen, device=cuda) * 0.1
    args = dict(out_dtype=torch.float32, layout="tm")
    want = log_mel_spectrogram_plain(audio, cfg, -6.0, 4.0, precision="f32", **args)
    errs = {g: float((log_mel_spectrogram_cuda(audio, cfg, -6.0, 4.0, precision=g, route="tc", **args) - want).abs().max())
            for g in ("f32", "bf16x3")}
    assert errs["f32"] < errs["bf16x3"], errs


def test_frontend_routes(cuda):
    """An odd clip length leaves the clips' rows unaligned (the tensor-core
    kernel then reads its span sample by sample); a geometry the tensor-core
    kernel does not serve goes to the FMA kernel, and forcing it raises."""
    fn = log_mel_spectrogram_cuda
    gen = torch.Generator(device=cuda).manual_seed(7)
    audio = torch.randn((3, 30001), generator=gen, device=cuda) * 0.1
    _hold_frontend(cuda, audio, FrontendConfig(n_mels=40), "tc", "bf16", torch.float32, "tm")
    odd = FrontendConfig(n_mels=40, hop_length=201)
    _hold_frontend(cuda, audio, odd, None, "bf16", torch.float32, "tm")
    _hold_frontend(cuda, audio, odd, "tc", "bf16", torch.float32, "tm")
    for out_dtype, layout in ((torch.float32, "tm"), (torch.float32, "fm"), (torch.bfloat16, "fm")):
        _hold_frontend(cuda, audio, FrontendConfig(n_mels=40), "tc", "f32", out_dtype, layout)
    before = fn.launches_tc
    fn(audio, odd, precision="bf16")
    fn(audio, FrontendConfig(n_mels=40), precision="f32", route="fma")
    assert fn.launches_tc == before
    fn(audio, FrontendConfig(n_mels=40), precision="bf16")
    assert fn.launches_tc == before + 1
    fn(audio, FrontendConfig(n_mels=40), precision=None)  # the JAX kernel's default grade, "bf16x3"
    assert fn.launches_tc == before + 2
    fn(audio, FrontendConfig(n_mels=40), precision="f32")  # the exact grade: six passes on the tensor-core kernel
    assert fn.launches_tc == before + 3
    fn(audio, FrontendConfig(n_mels=80), precision=None)  # the three-pass block does not fit at 80 mels
    fn(audio, FrontendConfig(n_mels=80), precision="f32")  # nor the six-pass one
    assert fn.launches_tc == before + 3
    for grade in (None, "f32"):
        with pytest.raises(ValueError, match="route='tc'"):
            fn(audio, FrontendConfig(n_mels=80), precision=grade, route="tc")
    with pytest.raises(ValueError, match="route must be"):
        fn(audio, route="wgmma")


@pytest.mark.parametrize("t_frames", [3, 41, 100, 641])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stem_kernel_matches_plain(cuda, t_frames, dtype):
    gen = torch.Generator(device=cuda).manual_seed(t_frames)
    mel = (torch.randn((5, t_frames, 40), generator=gen, device=cuda) * 0.7).to(dtype)
    taps = torch.randn((3, 3, 45), generator=gen, device=cuda) / 3.0
    if dtype == torch.bfloat16:
        taps = round_bf16(taps)
    before = res8_stem_cuda.launches
    got = res8_stem_cuda(mel, taps)
    want = res8_stem_plain(mel, taps)
    torch.cuda.synchronize()
    assert res8_stem_cuda.launches == before + 1
    assert got.shape == want.shape == (5, t_frames // 3, 10, 45) and got.dtype == dtype
    atol = 1e-5 if dtype == torch.float32 else _bf16_ulp(want)
    assert float((got.float() - want.float()).abs().max()) <= atol


def _stem_operands(cuda, b, t_frames, n_mels=40, ch=45, dtype=torch.bfloat16):
    rng = np.random.default_rng(b * 1000 + t_frames + n_mels)
    mel = torch.from_numpy(rng.standard_normal((b, t_frames, n_mels)).astype(np.float32) * 0.7).to(cuda).to(dtype)
    taps = round_bf16(torch.from_numpy(rng.standard_normal((3, 3, ch)).astype(np.float32) / 3.0).to(cuda))
    return mel, taps


@pytest.mark.parametrize("t_frames", [9, 10, 11, 100, 641])
@pytest.mark.parametrize("b", [1, 3, 512])
@pytest.mark.parametrize("route", ["tc", "fma"])
def test_stem_routes_match_plain_bf16_at_ragged_shapes(cuda, route, b, t_frames):
    """T' of 3, 33 and 213 frames: no multiple of the tensor-core kernel's
    24-frame tile; one bf16 ulp of the output's magnitude."""
    mel, taps = _stem_operands(cuda, b, t_frames)
    got, want = res8_stem_cuda(mel, taps, route=route), res8_stem_plain(mel, taps)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (b, t_frames // 3, 10, 45) and got.dtype == torch.bfloat16
    assert bool(torch.isfinite(got.float()).all())
    assert float((got.float() - want.float()).abs().max()) <= _bf16_ulp(want)


@pytest.mark.parametrize("n_mels,ch", [(36, 45), (12, 45), (80, 48), (128, 48), (40, 16), (40, 1)])
def test_stem_tc_kernel_at_other_geometries(cuda, n_mels, ch):
    mel, taps = _stem_operands(cuda, 5, 77, n_mels, ch)
    assert stem_route(mel.dtype, n_mels, ch) == "tc"
    got, want = res8_stem_cuda(mel, taps), res8_stem_plain(mel, taps)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (5, 25, n_mels // 4, ch)
    assert float((got.float() - want.float()).abs().max()) <= _bf16_ulp(want)


def test_stem_tc_kernel_writes_clips_whose_output_is_not_16_byte_aligned(cuda):
    """A clip's output is 191,700 bytes: clip b starts on a 16-byte boundary
    only when b % 4 == 0. Every clip must equal its own plain result, and a
    batch of one clip must equal the same clip inside the batch."""
    mel, taps = _stem_operands(cuda, 7, 641)
    got = res8_stem_cuda(mel, taps, route="tc")
    for b in range(7):
        alone = res8_stem_cuda(mel[b : b + 1].contiguous(), taps, route="tc")
        torch.cuda.synchronize()
        assert torch.equal(alone[0], got[b])
    assert float((got.float() - res8_stem_plain(mel, taps).float()).abs().max()) <= _bf16_ulp(got)


def test_stem_route_counts_its_launches(cuda):
    mel, taps = _stem_operands(cuda, 2, 30)
    n, n_tc = res8_stem_cuda.launches, res8_stem_cuda.launches_tc
    res8_stem_cuda(mel, taps)  # bf16: the tensor-core kernel
    assert (res8_stem_cuda.launches, res8_stem_cuda.launches_tc) == (n + 1, n_tc + 1)
    res8_stem_cuda(mel, taps, route="fma")
    res8_stem_cuda(mel.float(), taps)  # float32: the FMA kernel
    torch.cuda.synchronize()
    assert (res8_stem_cuda.launches, res8_stem_cuda.launches_tc) == (n + 3, n_tc + 1)


def test_stem_forced_route_raises_where_it_cannot_serve(cuda):
    mel, taps = _stem_operands(cuda, 1, 30)
    n, n_tc = res8_stem_cuda.launches, res8_stem_cuda.launches_tc
    with pytest.raises(ValueError, match="route='tc' cannot serve"):
        res8_stem_cuda(mel.float(), taps, route="tc")
    with pytest.raises(ValueError, match="route='tc' cannot serve"):
        res8_stem_cuda(mel, torch.zeros((3, 3, 49), device=cuda), route="tc")
    with pytest.raises(ValueError, match="route='tc' cannot serve"):
        res8_stem_cuda(mel, taps, pool=(3, 2), route="tc")
    with pytest.raises(ValueError, match="route must be"):
        res8_stem_cuda(mel, taps, route="wgmma")
    with pytest.raises(RuntimeError, match="no backward"):
        res8_stem_cuda(mel.float().requires_grad_(), taps, route="tc")
    with pytest.raises(RuntimeError, match="no backward"):
        res8_stem_cuda(mel, taps.clone().requires_grad_())
    assert (res8_stem_cuda.launches, res8_stem_cuda.launches_tc) == (n, n_tc)


def test_stem_tc_kernel_packs_the_taps_again_after_an_in_place_change(cuda):
    mel, taps = _stem_operands(cuda, 2, 30)
    res8_stem_cuda(mel, taps)
    taps.mul_(-1.0)
    got = res8_stem_cuda(mel, taps)
    torch.cuda.synchronize()
    assert float((got.float() - res8_stem_plain(mel, taps).float()).abs().max()) <= _bf16_ulp(got)


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    with pytest.raises(ValueError, match="contiguous"):
        log_mel_spectrogram_cuda(torch.zeros((4000, 2), device=cuda).t())
    with pytest.raises(TypeError, match="float32"):
        log_mel_spectrogram_cuda(torch.zeros((1, 4000), device=cuda, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="taps on"):
        res8_stem_cuda(torch.zeros((1, 9, 40), device=cuda), torch.zeros((3, 3, 45)))


def test_float32_paths_do_not_follow_the_callers_tf32(cuda):
    """ROADMAP F13: a float32 ``StreamingEngine``'s scores, a float32 hop of
    the ``OnlineEngine`` and one of the ``IncrementalOnlineEngine`` are bit
    for bit the same with the caller's global TF32 flags on and off, and the
    flags are the caller's again after each call. The control: the same
    scorer without its TF32 guard differs between the two settings here."""
    from howl_tpu_torch import bench
    from howl_tpu_torch.compat import res8_variables_to_state_dict
    from howl_tpu_torch.inference import StreamingEngine
    from howl_tpu_torch.inference.online import IncrementalOnlineEngine, OnlineEngine
    from howl_tpu_torch.models import create_model

    state = res8_variables_to_state_dict(bench.res8_numpy_variables(np.random.default_rng(13), 4))
    cfg, frontend, n = bench.serving_config(), FrontendConfig(n_mels=40), 16
    audio = torch.randn((n, 32000), generator=torch.Generator(device=cuda).manual_seed(13), device=cuda) * 0.1
    eng = StreamingEngine(create_model("res8", num_labels=4), state, cfg, frontend, -6.0, 4.0, device=cuda)
    live, inc = (kind(create_model("res8", num_labels=4), state, cfg, frontend, -6.0, 4.0, num_streams=n, device=cuda)
                 for kind in (OnlineEngine, IncrementalOnlineEngine))
    unguarded = StreamingEngine._score.__wrapped__.__wrapped__  # under torch.no_grad, without exact_if_float32
    outs = {}
    try:
        for flag in (True, False):
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = flag
            probs = eng.score_batch(audio)["probs"]
            hop = live._step(audio[:, : live.window_samples].contiguous(), live._new_state(), 0.0)[3]
            ring = inc._step(audio[:, : inc.hop_samples].contiguous(), inc.tail, inc.mel_ring, inc.state, 0.0)[1]
            assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == (flag, flag)
            with torch.no_grad():
                raw = unguarded(eng, audio, eng.n_windows(audio.shape[-1]))
            torch.cuda.synchronize()
            outs[flag] = (probs, hop, ring, raw)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    for name, on, off in zip(("scores", "online hop", "incremental ring"), outs[True], outs[False]):
        assert torch.equal(on, off), name
    assert not torch.equal(outs[True][3], outs[False][3]), "the card ignored the TF32 flags: the test sees nothing"


def test_float32_engine_decides_alike_on_both_frontend_kernels(cuda):
    """A float32 engine at the exact grade serves K1 on the tensor-core
    kernel by default (six bf16 passes), and the same engine with K1 forced
    onto the FMA kernel (``route="fma"``) takes one launch a batch of that
    kernel: the same detections, first fires and labels, the posteriors
    within float32's noise of each other."""
    from howl_tpu_torch import bench
    from howl_tpu_torch.compat import res8_variables_to_state_dict
    from howl_tpu_torch.inference import StreamingEngine
    from howl_tpu_torch.models import create_model

    class FmaFrontendEngine(StreamingEngine):
        def _features(self, audio, layout):
            return log_mel_spectrogram_cuda(audio, self.frontend, self.zmuv_mean, self.zmuv_std,
                                            precision=self.frontend_precision, out_dtype=torch.float32, layout=layout,
                                            route="fma")

    state = res8_variables_to_state_dict(bench.res8_numpy_variables(np.random.default_rng(17), 4))
    audio = torch.randn((32, 64000), generator=torch.Generator(device=cuda).manual_seed(17), device=cuda) * 0.1
    out = {}
    for route, cls in (("tc", StreamingEngine), ("fma", FmaFrontendEngine)):
        eng = cls(create_model("res8", num_labels=4), state, bench.serving_config(), FrontendConfig(n_mels=40),
                  -6.0, 4.0, device=cuda)
        assert eng.frontend_precision == "f32"
        before = (log_mel_spectrogram_cuda.launches, log_mel_spectrogram_cuda.launches_tc)
        out[route] = eng.infer_batch(audio)
        torch.cuda.synchronize()
        assert (log_mel_spectrogram_cuda.launches - before[0], log_mel_spectrogram_cuda.launches_tc - before[1]) == (
            1, int(route == "tc"))
    for key in ("detected", "first_fire_step", "labels"):
        assert torch.equal(out["tc"][key], out["fma"][key]), key
    assert float((out["tc"]["probs"] - out["fma"]["probs"]).abs().max()) < 1e-4


def test_engine_on_cuda_matches_cpu(cuda):
    from howl_tpu_torch.inference import EngineConfig, StreamingEngine
    from howl_tpu_torch.models import create_model

    torch.manual_seed(0)
    model = create_model("res8", num_labels=4)
    with torch.no_grad():
        for i in range(1, 7):
            getattr(model, f"bn{i}").running_var.uniform_(0.5, 1.5)
    cfg = EngineConfig(inference_sequence=(0,), negative_label=3, num_labels=4, inference_threshold=0.3)
    frontend = FrontendConfig(n_mels=40)
    audio = np.random.default_rng(0).standard_normal((4, 32000)).astype(np.float32) * 0.1
    outs = [
        StreamingEngine(model, model.state_dict(), cfg, frontend, -6.0, 4.0, frontend_precision="auto", device=d)
        .infer_batch(audio)
        for d in ("cpu", cuda)
    ]
    assert outs[1]["probs"].device.type == "cuda"
    torch.testing.assert_close(outs[1]["probs"].cpu(), outs[0]["probs"], rtol=0, atol=1e-4)


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


@pytest.mark.parametrize(
    "b,n,bank_w",
    [(1, 8000, 10240), (7, 8000, 10240), (1025, 8000, 10240), (5, 16, 10240), (5, 1000, 10240),
     (5, 7919, 10240), (33, 8000, 5000), (9, 7919, 3000)],
    ids=["b1", "b7", "b1025", "n16", "n1000", "n7919", "narrow-bank", "bank-shorter-than-window"],
)
def test_mix_kernel_matches_plain_bitwise(cuda, b, n, bank_w):
    gen = torch.Generator(device=cuda).manual_seed(b * n)
    bank = aug.prepare_noise_bank(torch.randn((8, bank_w), generator=gen, device=cuda) * 0.1, n)
    audio = torch.randn((b, n), generator=gen, device=cuda) * 0.3
    d = aug.draw_mix_noise_bank(gen, b, bank, aug.AugmentConfig(), replace_prob=0.3)
    before = mix_noise_bank_cuda.launches
    got = mix_noise_bank_cuda(audio, bank.extended, d.rows, d.offs, d.alpha)
    want = mix_noise_bank_plain(audio, bank.extended, d.rows, d.offs, d.alpha)
    torch.cuda.synchronize()
    assert mix_noise_bank_cuda.launches == before + 1
    assert torch.equal(_bits(got), _bits(want))


def test_mix_kernel_zero_and_one_alpha_rows_are_exact(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    ext = torch.randn((3, 12000), generator=gen, device=cuda)
    audio = torch.randn((4, 7919), generator=gen, device=cuda)
    audio[0, :9] = -0.0
    audio[3, 100:200] = -0.0
    rows = torch.tensor([0, 1, 2, 2], device=cuda)
    offs = torch.tensor([3, 4000, 17, 0], device=cuda)
    alpha = torch.tensor([0.0, 1.0, 0.13, 0.0], device=cuda)
    got = mix_noise_bank_cuda(audio, ext, rows, offs, alpha)
    torch.cuda.synchronize()
    assert torch.equal(_bits(got[[0, 3]]), _bits(audio[[0, 3]]))  # -0.0 kept
    assert torch.equal(_bits(got[1]), _bits(ext[1, 4000 : 4000 + 7919]))
    assert torch.equal(_bits(got), _bits(mix_noise_bank_plain(audio, ext, rows, offs, alpha)))


def test_mix_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    ext = torch.zeros((2, 3000), device=cuda)
    rows = offs = torch.zeros(4, dtype=torch.long, device=cuda)
    alpha = torch.zeros(4, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        mix_noise_bank_cuda(torch.zeros((1000, 4), device=cuda).t(), ext, rows, offs, alpha)
    with pytest.raises(ValueError, match="int64"):
        mix_noise_bank_cuda(torch.zeros((4, 1000), device=cuda), ext, rows.int(), offs, alpha)
    with pytest.raises(ValueError, match="bank on"):
        mix_noise_bank_cuda(torch.zeros((4, 1000), device=cuda), ext.cpu(), rows, offs, alpha)


def _to(draws, device):
    if isinstance(draws, torch.Tensor):
        return draws.to(device)
    if isinstance(draws, tuple):
        return type(draws)(*(_to(d, device) for d in draws))
    return draws


def test_train_step_on_cuda_launches_the_mix_kernel_and_matches_cpu(cuda):
    from howl_tpu_torch.models import create_model
    from howl_tpu_torch.training.state import create_train_state
    from howl_tpu_torch.training.step import StepConfig, draw_step, make_classification_train_step

    rng = np.random.default_rng(0)
    audio = torch.from_numpy((rng.standard_normal((16, 8000)) * 0.1).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 4, 16))
    bank = (rng.standard_normal((4, 9000)) * 0.05).astype(np.float32)
    cfg = StepConfig(FrontendConfig(n_mels=40), 2.05, 1.0, augment=aug.AugmentConfig(), replace_prob=0.2,
                     negative_label=3, use_deltas=False)
    draws = draw_step(torch.Generator().manual_seed(1), cfg, 16, 8000, aug.prepare_noise_bank(bank, 8000))
    losses = {}
    for dev in ("cpu", cuda):
        model = create_model("res8", num_labels=4)
        state = create_train_state(model, 0.01, generator=torch.Generator().manual_seed(0), device=dev)
        step = make_classification_train_step(model, cfg, torch.from_numpy(bank).to(dev))
        before = mix_noise_bank_cuda.launches
        _, metrics = step(state, audio.to(dev), labels.to(dev), None, 0, draws=_to(draws, dev))
        losses[str(dev)] = float(metrics["loss"])
        assert mix_noise_bank_cuda.launches == before + (dev != "cpu")
    assert abs(losses["cpu"] - losses[str(cuda)]) <= 1e-4 * abs(losses["cpu"])


def _trunk_operands(cuda, b, clip_seconds):
    from howl_tpu_torch.tools import trunk_kernels as tk

    geom = tk.trunk_geometry(clip_seconds)
    rng = np.random.default_rng(b)
    x = torch.from_numpy(rng.standard_normal((b, geom.pos_pad, 48)).astype(np.float32) * 0.5)  # nonzero tail
    ws = torch.from_numpy(rng.standard_normal((6, 432, 48)).astype(np.float32) * 0.05)
    pool_t = torch.from_numpy(tk.build_pool_matrix(geom).T.copy())
    scale = torch.from_numpy(rng.uniform(0.8, 1.0, (8, 48)).astype(np.float32))
    shift = torch.from_numpy(rng.uniform(-0.05, 0.05, (8, 48)).astype(np.float32))
    ops = [t.to(cuda) for t in (x.bfloat16(), ws.bfloat16(), pool_t.bfloat16(), scale, shift)]
    return geom, ops


@pytest.mark.parametrize("full_build", [True, False], ids=["full-build", "gemm-only"])
@pytest.mark.parametrize("clip_seconds", [2.0, 8.0])
@pytest.mark.parametrize("b", [1, 7, 512])
def test_trunk_proto_kernel_matches_plain(cuda, b, clip_seconds, full_build):
    """Within 2e-3 of the output's largest magnitude, the bound of
    tests/test_torch_trunk_micro.py: bf16 x and res after every layer, sums
    in other orders."""
    from howl_tpu_torch.tools.trunk_kernels import trunk_proto_cuda, trunk_proto_plain

    geom, ops = _trunk_operands(cuda, b, clip_seconds)
    before = trunk_proto_cuda.launches
    got = trunk_proto_cuda(*ops, geom.pos, full_build)
    want = trunk_proto_plain(*ops, geom.pos, full_build)
    torch.cuda.synchronize()
    assert trunk_proto_cuda.launches == before + 1
    assert got.shape == want.shape == (b, 128, 48) and got.dtype == torch.float32
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= 2e-3 * float(want.abs().max())


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b", [1, 3, 512])
def test_stem_fold_kernel_matches_plain(cuda, b, out_dtype):
    from howl_tpu_torch.tools.trunk_kernels import stem_fold_cuda, stem_fold_plain, stem_prep

    rng = np.random.default_rng(b)
    mel = torch.from_numpy(rng.standard_normal((b, 641, 40)).astype(np.float32) * 0.5).to(cuda).bfloat16()
    w0fold = torch.from_numpy(rng.standard_normal((120, 2048)).astype(np.float32) * 0.1).to(cuda).bfloat16()
    xpre = stem_prep(mel).contiguous()
    before = stem_fold_cuda.launches
    got = stem_fold_cuda(xpre, w0fold, out_dtype)
    want = stem_fold_plain(xpre, w0fold, out_dtype)
    torch.cuda.synchronize()
    assert stem_fold_cuda.launches == before + 1
    assert got.shape == want.shape == (b, 224, 512) and got.dtype == out_dtype
    top = float(want.float().abs().max())
    tol = 1e-5 * top if out_dtype == torch.float32 else _bf16_ulp(want)
    assert float((got.float() - want.float()).abs().max()) <= tol


@pytest.mark.parametrize("q_rows", [1, 64, 100, 224, 300])
def test_stem_fold_kernel_at_other_row_counts(cuda, q_rows):
    """Items of 64 rows: a last item of 1 to 63 rows, and more items than the
    kernel has blocks."""
    from howl_tpu_torch.tools.trunk_kernels import stem_fold_cuda, stem_fold_plain

    rng = np.random.default_rng(q_rows)
    xpre = torch.from_numpy(rng.standard_normal((3, 3, q_rows, 120)).astype(np.float32) * 0.5).to(cuda).bfloat16()
    w0fold = torch.from_numpy(rng.standard_normal((120, 2048)).astype(np.float32) * 0.1).to(cuda).bfloat16()
    for out_dtype in (torch.bfloat16, torch.float32):
        got, want = stem_fold_cuda(xpre, w0fold, out_dtype), stem_fold_plain(xpre, w0fold, out_dtype)
        torch.cuda.synchronize()
        top = float(want.float().abs().max())
        tol = 1e-5 * top if out_dtype == torch.float32 else _bf16_ulp(want)
        assert got.shape == (3, q_rows, 512) and float((got.float() - want.float()).abs().max()) <= tol


def test_stem_fold_kernel_packs_w_again_after_an_in_place_change(cuda):
    from howl_tpu_torch.tools.trunk_kernels import stem_fold_cuda, stem_fold_plain

    rng = np.random.default_rng(5)
    xpre = torch.from_numpy(rng.standard_normal((2, 3, 224, 120)).astype(np.float32) * 0.5).to(cuda).bfloat16()
    w0fold = torch.from_numpy(rng.standard_normal((120, 2048)).astype(np.float32) * 0.1).to(cuda).bfloat16()
    stem_fold_cuda(xpre, w0fold)
    w0fold[:, :512].mul_(-1.0)
    got, want = stem_fold_cuda(xpre, w0fold, torch.float32), stem_fold_plain(xpre, w0fold, torch.float32)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_trunk_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    from howl_tpu_torch.tools.trunk_kernels import stem_fold_cuda, trunk_proto_cuda

    geom, (x, ws, pool_t, scale, shift) = _trunk_operands(cuda, 2, 2.0)
    with pytest.raises(RuntimeError, match="no backward"):
        trunk_proto_cuda(x, ws.float().requires_grad_().bfloat16(), pool_t, scale, shift, geom.pos)
    with pytest.raises(ValueError, match="bf16 activations"):
        trunk_proto_cuda(x.float(), ws, pool_t, scale, shift, geom.pos)
    with pytest.raises(ValueError, match="pool_t"):
        trunk_proto_cuda(x, ws, pool_t.float(), scale, shift, geom.pos)
    with pytest.raises(ValueError, match="operand on"):
        trunk_proto_cuda(x, ws.cpu(), pool_t, scale, shift, geom.pos)
    with pytest.raises(ValueError, match="contiguous"):
        trunk_proto_cuda(x, ws, pool_t, scale.t().contiguous().t(), shift, geom.pos)
    with pytest.raises(ValueError, match="n_win_pad"):
        trunk_proto_cuda(x, ws, torch.zeros((144, geom.pos_pad), dtype=torch.bfloat16, device=cuda), scale, shift,
                         geom.pos)
    xpre = torch.zeros((1, 3, 224, 120), dtype=torch.bfloat16, device=cuda)
    w0fold = torch.zeros((120, 2048), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(RuntimeError, match="no backward"):
        stem_fold_cuda(xpre.float().requires_grad_().bfloat16(), w0fold)
    with pytest.raises(ValueError, match="w0fold"):
        stem_fold_cuda(xpre, w0fold[:, :1024])
    with pytest.raises(ValueError, match="contiguous"):
        stem_fold_cuda(xpre.transpose(2, 3).contiguous().transpose(2, 3), w0fold)
    with pytest.raises(ValueError, match="16-byte aligned"):
        stem_fold_cuda(torch.zeros(1 * 3 * 224 * 120 + 1, dtype=torch.bfloat16, device=cuda)[1:].view(1, 3, 224, 120),
                       w0fold)


@pytest.mark.parametrize("pos_cut", [0, 37], ids=["pos-is-pos_pad", "pos-below-pos_pad"])
@pytest.mark.parametrize("full_build", [True, False], ids=["full-build", "gemm-only"])
@pytest.mark.parametrize("clip_seconds", [2.0, 8.0])
@pytest.mark.parametrize("b", [1, 3, 512])
def test_trunk_proto_kernel_at_pos_pad_and_below(cuda, b, clip_seconds, full_build, pos_cut):
    """pos = pos_pad (no position masked) and pos 37 below it, inside a
    pooled frame and inside a 44-frame tile, with a nonzero tail."""
    from howl_tpu_torch.tools.trunk_kernels import trunk_proto_cuda, trunk_proto_plain

    geom, ops = _trunk_operands(cuda, b, clip_seconds)
    pos = geom.pos_pad - pos_cut
    before = trunk_proto_cuda.launches
    got, want = trunk_proto_cuda(*ops, pos, full_build), trunk_proto_plain(*ops, pos, full_build)
    torch.cuda.synchronize()
    assert trunk_proto_cuda.launches == before + 1
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= 2e-3 * float(want.abs().max())


def test_trunk_proto_kernel_alternates_weights_and_packs_again_after_a_change(cuda):
    """The study's legs 3 and 4 alternate two weight tensors; each keeps its
    image, and an in-place change to the weights or to pool_t is packed again."""
    from howl_tpu_torch.tools.trunk_kernels import trunk_proto_cuda, trunk_proto_plain

    geom, (x, ws, pool_t, scale, shift) = _trunk_operands(cuda, 3, 2.0)
    ws2 = (ws.float() * -0.5).bfloat16()

    def hold(w, full_build):
        got = trunk_proto_cuda(x, w, pool_t, scale, shift, geom.pos, full_build)
        want = trunk_proto_plain(x, w, pool_t, scale, shift, geom.pos, full_build)
        torch.cuda.synchronize()
        assert float((got - want).abs().max()) <= 2e-3 * float(want.abs().max())

    for w, full_build in ((ws, True), (ws2, False), (ws, True), (ws2, False)):
        hold(w, full_build)
    ws.mul_(-1.0)
    hold(ws, True)
    pool_t[:, :100] = 1.0
    hold(ws2, False)


def test_trunk_proto_kernel_refuses_misaligned_x(cuda):
    from howl_tpu_torch.tools.trunk_kernels import trunk_proto_cuda

    geom, (x, ws, pool_t, scale, shift) = _trunk_operands(cuda, 2, 2.0)
    flat = torch.zeros(x.numel() + 1, dtype=torch.bfloat16, device=cuda)
    before = trunk_proto_cuda.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        trunk_proto_cuda(flat[1:].view(x.shape), ws, pool_t, scale, shift, geom.pos)
    assert trunk_proto_cuda.launches == before


@functools.lru_cache(maxsize=2)
def _micro_operands(cuda, batch, clip_seconds):
    """The study's seeded operands, made once per size (about 1 GB at the full size)."""
    from howl_tpu_torch.tools import bench_pallas_micro as study

    return study.make_inputs(batch, clip_seconds, batch, cuda)


MICRO_S = 0.3125


@pytest.mark.parametrize("cut", [0, 1, 15, 17, 63, 65], ids=lambda c: f"total-minus-{c}")
@pytest.mark.parametrize("batch,clip_seconds", [(4, 2.0), (512, 8.0)], ids=["small", "full"])
def test_micro_stream_kernel_matches_plain_bitwise(cuda, batch, clip_seconds, cut):
    """Totals that end inside a 16-row staging round and inside a block."""
    from howl_tpu_torch.tools.frontend_micro_kernels import stream_cuda, stream_plain

    inp = _micro_operands(cuda, batch, clip_seconds)
    x = inp.frames[: inp.geom.total - cut]
    before = stream_cuda.launches
    got, want = stream_cuda(x, MICRO_S), stream_plain(x, MICRO_S)
    torch.cuda.synchronize()
    assert stream_cuda.launches == before + 1
    assert got.shape == want.shape == (inp.geom.total - cut, 128) and got.dtype == torch.float32
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("n_dots", [1, 3])
@pytest.mark.parametrize("cut", [0, 1, 63, 65], ids=lambda c: f"total-minus-{c}")
@pytest.mark.parametrize("batch,clip_seconds", [(4, 2.0), (512, 8.0)], ids=["small", "full"])
def test_micro_gemm_kernel_matches_plain(cuda, batch, clip_seconds, cut, n_dots):
    """Within 1e-5 of the output's largest magnitude, the bound of
    tests/test_torch_pallas_micro.py: only the order of the float32 sums
    over K = 512 and over the products differs."""
    from howl_tpu_torch.tools.frontend_micro_kernels import gemm_cuda, gemm_plain

    inp = _micro_operands(cuda, batch, clip_seconds)
    x = inp.frames[: inp.geom.total - cut]
    before = gemm_cuda.launches
    got, want = gemm_cuda(x, inp.w, MICRO_S, n_dots), gemm_plain(x, inp.w, MICRO_S, n_dots)
    torch.cuda.synchronize()
    assert gemm_cuda.launches == before + 1
    assert got.shape == want.shape == (inp.geom.total - cut, 128) and got.dtype == torch.float32
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.parametrize("n_dots", [1, 2, 3])
@pytest.mark.parametrize("total", [1, 63, 129, 328192])
def test_micro_gemm_kernel_at_totals_off_the_row_tile(cuda, total, n_dots):
    """The kernel's tiles are 128 rows: a total of one row, a partial tile, a
    tile and one row, and the study's 2,564 tiles."""
    from howl_tpu_torch.tools.frontend_micro_kernels import gemm_cuda, gemm_plain

    inp = _micro_operands(cuda, 512, 8.0)
    x = inp.frames[:total]
    before = gemm_cuda.launches
    got, want = gemm_cuda(x, inp.w, MICRO_S, n_dots), gemm_plain(x, inp.w, MICRO_S, n_dots)
    torch.cuda.synchronize()
    assert gemm_cuda.launches == before + 1
    assert got.shape == want.shape == (total, 128) and bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_micro_gemm_kernel_refuses_misaligned_x_and_packs_w_again_after_a_change(cuda):
    from howl_tpu_torch.tools.frontend_micro_kernels import gemm_cuda, gemm_plain

    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((300, 512)).astype(np.float32)).to(cuda)
    w = torch.from_numpy(rng.standard_normal((512, 512)).astype(np.float32)).to(cuda).bfloat16()
    before = gemm_cuda.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        gemm_cuda(torch.zeros(300 * 512 + 1, device=cuda)[1:].view(300, 512), w, 0.0)
    assert gemm_cuda.launches == before
    gemm_cuda(x, w, MICRO_S)
    w[:, :64].mul_(-2.0)
    got, want = gemm_cuda(x, w, MICRO_S, 2), gemm_plain(x, w, MICRO_S, 2)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.parametrize("n_dots", [1, 3])
@pytest.mark.parametrize("cut", [0, 1, 63, 65, 127], ids=lambda c: f"t_pad-minus-{c}")
@pytest.mark.parametrize("batch,clip_seconds", [(4, 2.0), (512, 8.0)], ids=["small", "full"])
def test_micro_poly_kernel_matches_plain(cuda, batch, clip_seconds, cut, n_dots):
    from howl_tpu_torch.tools.frontend_micro_kernels import poly_cuda, poly_plain

    inp = _micro_operands(cuda, batch, clip_seconds)
    t_pad = inp.geom.t_pad - cut
    before = poly_cuda.launches
    got, want = poly_cuda(inp.h, inp.w, MICRO_S, t_pad, n_dots), poly_plain(inp.h, inp.w, MICRO_S, t_pad, n_dots)
    torch.cuda.synchronize()
    assert poly_cuda.launches == before + 1
    assert got.shape == want.shape == (batch, t_pad, 128) and got.dtype == torch.float32
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_micro_poly_kernel_reads_no_row_past_the_clip(cuda):
    """With exactly t_pad + 2 hop rows a clip's last tile ends at its last
    row, and the rows staged beyond belong to the next clip (or to nobody):
    the kernel zero-fills them and no frame that is stored reads them."""
    from howl_tpu_torch.tools.frontend_micro_kernels import poly_cuda, poly_plain

    inp = _micro_operands(cuda, 3, 2.0)
    t_pad = 100
    h = inp.h[:, : t_pad + 2].contiguous()
    got, want = poly_cuda(h, inp.w, MICRO_S, t_pad), poly_plain(h, inp.w, MICRO_S, t_pad)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.parametrize("n_dots", [1, 2])
@pytest.mark.parametrize("batch,t_pad", [(1, 1), (1, 129), (1, 640), (3, 641), (27, 640), (133, 257), (512, 641)],
                         ids=lambda v: str(v))
def test_micro_poly_kernel_at_tiles_off_the_card_and_the_clip(cuda, batch, t_pad, n_dots):
    """The kernel's tiles are 128 frames and its blocks persistent, one to an
    SM: a clip of one frame, tiles that leave one frame in the last, one
    clip, 135 tiles (a few blocks take two, so the next tile's staging runs
    on some blocks only) and the study's batch at 641 frames."""
    from howl_tpu_torch.tools.frontend_micro_kernels import poly_cuda, poly_plain

    h = _micro_operands(cuda, 512, 8.0).h[:batch]
    w = _micro_operands(cuda, 512, 8.0).w
    before = poly_cuda.launches
    got, want = poly_cuda(h, w, MICRO_S, t_pad, n_dots), poly_plain(h, w, MICRO_S, t_pad, n_dots)
    torch.cuda.synchronize()
    assert poly_cuda.launches == before + 1
    assert got.shape == want.shape == (batch, t_pad, 128) and bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_micro_poly_kernel_ignores_nan_past_the_clip_and_packs_w_again_after_a_change(cuda):
    """Hop rows from t_pad + 2 on hold NaN: the tile reads them, and only
    the frames >= t_pad that are computed and not stored may meet them. W
    changed in place is packed anew."""
    from howl_tpu_torch.tools.frontend_micro_kernels import poly_cuda, poly_plain

    inp = _micro_operands(cuda, 4, 2.0)
    h = inp.h.clone()
    h[:, 102:] = float("nan")
    w = inp.w.clone()
    got, want = poly_cuda(h, w, MICRO_S, 100), poly_plain(h, w, MICRO_S, 100)
    assert bool(torch.isfinite(got).all()) and float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    w[:, :64].mul_(-2.0)
    got, want = poly_cuda(inp.h, w, MICRO_S, 128, 2), poly_plain(inp.h, w, MICRO_S, 128, 2)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_micro_kernels_round_x_plus_s_to_bf16_ties_to_even(cuda):
    """x + s is a float32 add, then one rounding to nearest even: 1 + 2^-8
    and 1 + 3 * 2^-8 lie half-way between two bf16 values. W is the
    identity, so the output shows the rounded operand."""
    from howl_tpu_torch.tools.frontend_micro_kernels import gemm_cuda, gemm_plain, poly_cuda, poly_plain

    w = torch.eye(512, device=cuda).to(torch.bfloat16)
    x = torch.zeros((64, 512), device=cuda)
    x[:, 0], x[:, 1], x[:, 2] = 1.0, 1.0 + 2.0**-7, 0.5
    got = gemm_cuda(x, w, 2.0**-8)
    assert got[5, 0].item() == 1.0 and got[5, 1].item() == 1.0 + 2.0**-6 and got[5, 2].item() == 0.5 + 2.0**-8
    assert torch.equal(got, gemm_plain(x, w, 2.0**-8))
    h = torch.zeros((1, 66, 200), device=cuda)
    h[0, :, 0], h[0, :, 1] = 1.0, 1.0 + 2.0**-7
    got = poly_cuda(h, w, 2.0**-8, 64)
    assert got[0, 7, 0].item() == 1.0 and got[0, 7, 1].item() == 1.0 + 2.0**-6
    assert torch.equal(got, poly_plain(h, w, 2.0**-8, 64))


def test_micro_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    from howl_tpu_torch.tools.frontend_micro_kernels import gemm_cuda, poly_cuda, stream_cuda

    x = torch.zeros((64, 512), device=cuda)
    w = torch.zeros((512, 512), dtype=torch.bfloat16, device=cuda)
    h = torch.zeros((2, 66, 200), device=cuda)
    counts = (stream_cuda.launches, gemm_cuda.launches, poly_cuda.launches)
    with pytest.raises(RuntimeError, match="no backward"):
        stream_cuda(x.clone().requires_grad_(), 0.0)
    with pytest.raises(RuntimeError, match="no backward"):
        gemm_cuda(x.clone().requires_grad_(), w, 0.0)
    with pytest.raises(RuntimeError, match="no backward"):
        poly_cuda(h.clone().requires_grad_(), w, 0.0, 64)
    with pytest.raises(ValueError, match="contiguous"):
        stream_cuda(torch.zeros((512, 64), device=cuda).t(), 0.0)
    with pytest.raises(ValueError, match="contiguous"):
        gemm_cuda(x, w.t(), 0.0)
    with pytest.raises(ValueError, match="contiguous"):
        poly_cuda(torch.zeros((2, 200, 66), device=cuda).transpose(1, 2), w, 0.0, 64)
    with pytest.raises(ValueError, match="16-byte aligned"):
        stream_cuda(torch.zeros(64 * 512 + 1, device=cuda)[1:].view(64, 512), 0.0)
    with pytest.raises(ValueError, match="float32 frames"):
        stream_cuda(x.half(), 0.0)
    with pytest.raises(ValueError, match="float32 frames"):
        gemm_cuda(x.bfloat16(), w, 0.0)
    with pytest.raises(ValueError, match="bf16 w"):
        gemm_cuda(x, w.float(), 0.0)
    with pytest.raises(ValueError, match="float32 hop rows"):
        poly_cuda(h.double(), w, 0.0, 64)
    with pytest.raises(ValueError, match="w on"):
        gemm_cuda(x, w.cpu(), 0.0)
    with pytest.raises(ValueError, match="w on"):
        poly_cuda(h, w.cpu(), 0.0, 64)
    with pytest.raises(ValueError, match="n_fft 512"):
        stream_cuda(torch.zeros((64, 256), device=cuda), 0.0)
    with pytest.raises(ValueError, match="hop 200"):
        poly_cuda(torch.zeros((2, 66, 160), device=cuda), w, 0.0, 62)
    with pytest.raises(ValueError, match="hop rows"):
        poly_cuda(h, w, 0.0, 65)
    with pytest.raises(ValueError, match="n_dots"):
        poly_cuda(h, w, 0.0, 64, 0)
    assert (stream_cuda.launches, gemm_cuda.launches, poly_cuda.launches) == counts  # a refusal launches nothing
    assert stream_cuda(x[:0], 0.0).shape == (0, 128) and poly_cuda(h, w, 0.0, 0).shape == (2, 0, 128)
    assert (stream_cuda.launches, gemm_cuda.launches, poly_cuda.launches) == counts  # nor does an empty call


def test_micro_tools_run_on_the_card(cuda, capsys):
    """Both tools' ``main`` with the default device, at a small size."""
    from howl_tpu_torch.tools import bench_pallas_micro, validate_pallas_precision
    from howl_tpu_torch.tools.frontend_micro_kernels import gemm_cuda, poly_cuda, stream_cuda

    counts = (stream_cuda.launches, gemm_cuda.launches, poly_cuda.launches)
    results = bench_pallas_micro.main(["--batch", "8", "--clip-seconds", "2", "--iters", "2"])
    assert sum(r["route"] == "cuda kernel" for r in results.values()) == 5
    assert all(a > b for a, b in zip((stream_cuda.launches, gemm_cuda.launches, poly_cuda.launches), counts))
    records = validate_pallas_precision.main([])
    f32 = [r for r in records if r["grade"] == "f32"]
    assert len(records) == 8 and all(r["above_floor_max"] < 3e-3 and r["global_max"] < 0.02 for r in f32)
    # the three-pass and exact grades on the tensor-core kernel at 40 mels, within their golden bounds
    assert [r["route"] for r in records if r["grade"] == "bf16x3"] == ["tc", "fma"]
    assert [r["route"] for r in f32] == ["tc", "fma"]
    assert all(validate_pallas_precision.within_golden_bounds(r) for r in records)
    assert "above_floor_max" in capsys.readouterr().out


# ---- the device-memory bandwidth sweep's kernels ----

HBM_S = 0.3  # no bf16 number: the bf16 legs must round it before the add


def _sweep_array(cuda, rows, dtype):
    gen = torch.Generator(device=cuda).manual_seed(rows)
    return torch.randn((rows, 512), generator=gen, device=cuda).to(dtype)


def _same_bits(got, want) -> bool:
    view = torch.int16 if want.dtype == torch.bfloat16 else torch.int32
    return got.shape == want.shape and got.dtype == want.dtype and torch.equal(got.view(view), want.view(view))


# 8 rows: one stage that is not full; 24 x 131: many small blocks; 1048: 65.5 stages of float32; 3144: one CTA
# that wraps the ring many times; 4096 x 2: whole stages only; 33,000 x 8 and the sweep's 131,072 x 4096: many
# times more of the copy's 4 KB stages than the card holds CTAs at once
@pytest.mark.parametrize("rows,bn", [(8, 8), (3144, 24), (3144, 1048), (3144, 3144), (8192, 4096), (8192, 256),
                                     (33000, 8), (131072, 4096)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("leg", ["auto_read", "auto_copy", "stream_repro"])
def test_sweep_block_kernels_match_plain_bitwise(cuda, leg, dtype, rows, bn):
    from howl_tpu_torch.tools import hbm_sweep_kernels as hk

    x = _sweep_array(cuda, rows, dtype)
    kernel = getattr(hk, f"{leg}_cuda")
    before = kernel.launches
    got = kernel(x, bn, HBM_S)
    torch.cuda.synchronize()
    want = {"auto_read": lambda: hk.auto_read_plain(x, bn, HBM_S), "auto_copy": lambda: hk.auto_copy_plain(x, HBM_S),
            "stream_repro": lambda: hk.stream_repro_plain(x, HBM_S)}[leg]()
    assert kernel.launches == before + 1
    assert _same_bits(got, want)
    assert not torch.equal(got.float(), (kernel(x, bn, 0.0)).float())  # s reaches the output


@pytest.mark.parametrize("rows", [8, 16, 3144, 8192, 33000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_hbm2hbm_kernel_copies_every_byte_and_fills_done(cuda, rows, dtype):
    """8 rows of bf16 are a quarter of one chunk; 33,000 rows of float32 are
    2,062.5 chunks, so every CTA of the grid wraps its ring and the last
    chunk is not full."""
    from howl_tpu_torch.tools.hbm_sweep_kernels import hbm2hbm_cuda, hbm2hbm_plain

    x = _sweep_array(cuda, rows, dtype)
    before = hbm2hbm_cuda.launches
    out, done = hbm2hbm_cuda(x, HBM_S)
    torch.cuda.synchronize()
    ref, ref_done = hbm2hbm_plain(x, HBM_S)
    assert hbm2hbm_cuda.launches == before + 1
    assert out.data_ptr() != x.data_ptr() and _same_bits(out, x) and _same_bits(ref, x)
    assert _same_bits(done, ref_done) and done[3, 77].item() == np.float32(HBM_S)


def test_sweep_bf16_add_rounds_the_scalar_first_and_ties_to_even(cuda):
    """s = 0.3 becomes the bf16 number 0.30078125 before the add; 1 + 2^-8
    lies half-way between two bf16 values and goes to the even one."""
    from howl_tpu_torch.tools.hbm_sweep_kernels import auto_copy_cuda

    x = torch.zeros((8, 512), dtype=torch.bfloat16, device=cuda)
    x[:, 1], x[:, 2] = 1.0, 1.0 + 2.0**-7
    assert auto_copy_cuda(x, 8, 0.3)[0, 0].item() == 0.30078125
    got = auto_copy_cuda(x, 8, 2.0**-8)
    assert got[0, 1].item() == 1.0 and got[0, 2].item() == 1.0 + 2.0**-6


def test_sweep_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    from howl_tpu_torch.tools import hbm_sweep_kernels as hk

    block_legs = (hk.auto_read_cuda, hk.auto_copy_cuda, hk.stream_repro_cuda)
    x = torch.zeros((64, 512), device=cuda)
    counts = [fn.launches for fn in (*block_legs, hk.hbm2hbm_cuda)]
    for fn in block_legs:
        with pytest.raises(RuntimeError, match="no backward"):
            fn(x.clone().requires_grad_(), 8, 0.0)
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            fn(x.half(), 8, 0.0)
        with pytest.raises(ValueError, match=r"\(rows, 512\)"):
            fn(torch.zeros((64, 256), device=cuda), 8, 0.0)
        with pytest.raises(ValueError, match="whole number of blocks"):
            fn(x, 24, 0.0)
        with pytest.raises(ValueError, match="multiple of 8"):
            fn(x, 4, 0.0)
        with pytest.raises(ValueError, match="contiguous"):
            fn(torch.zeros((512, 64), device=cuda).t(), 8, 0.0)
        with pytest.raises(ValueError, match="16-byte aligned"):
            fn(torch.zeros(64 * 512 + 1, device=cuda)[1:].view(64, 512), 8, 0.0)
        with pytest.raises(TypeError, match="Python number"):
            fn(x, 8, torch.tensor(0.0))
        assert fn(x[:0], 8, 0.0).shape[0] == 0
    with pytest.raises(RuntimeError, match="no backward"):
        hk.hbm2hbm_cuda(x.clone().requires_grad_(), 0.0)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        hk.hbm2hbm_cuda(x.double(), 0.0)
    with pytest.raises(ValueError, match="contiguous"):
        hk.hbm2hbm_cuda(torch.zeros((512, 64), device=cuda).t(), 0.0)
    with pytest.raises(ValueError, match="16-byte aligned"):
        hk.hbm2hbm_cuda(torch.zeros(64 * 512 + 1, device=cuda)[1:].view(64, 512), 0.0)
    assert [fn.launches for fn in (*block_legs, hk.hbm2hbm_cuda)] == counts  # neither a refusal nor an empty call launches
    out, done = hk.hbm2hbm_cuda(x[:0], 0.5)  # but the whole-array copy of nothing still fills done
    assert out.shape == (0, 512) and bool((done == 0.5).all()) and hk.hbm2hbm_cuda.launches == counts[3] + 1


# 8 rows: one stage, fewer than the ring has slots; cb 24: 131 chunks of 3 float32 stages or 1.5 bf16 stages; cb 1048:
# 131 float32 or 65.5 bf16 stages, many turns of the ring; cb 3144: one CTA; 8192 rows: the sweep's CPU size
@pytest.mark.parametrize("rows,k,cb", [(8, 2, 8), (8, 8, 8), (3144, 2, 24), (3144, 3, 24), (3144, 4, 1048), (3144, 5, 1048),
                                       (3144, 6, 3144), (3144, 7, 8), (8192, 8, 512), (8192, 3, 1024), (8192, 2, 4096)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("leg", ["manual_read", "manual_write", "manual_copy"])
def test_sweep_manual_kernels_match_plain_bitwise(cuda, leg, dtype, rows, k, cb):
    from howl_tpu_torch.tools import hbm_sweep_kernels as hk

    x = _sweep_array(cuda, rows, dtype)
    kernel, plain = getattr(hk, f"{leg}_cuda"), getattr(hk, f"{leg}_plain")
    before = kernel.launches
    got = kernel(x, k, cb, HBM_S)
    torch.cuda.synchronize()
    want = plain(x, k, cb, HBM_S)
    assert kernel.launches == before + 1
    if leg == "manual_read":
        assert _same_bits(got, want) and got.shape == hk.DONE_SHAPE
        assert not torch.equal(got, kernel(x, k, cb, 0.0))  # s reaches the output
    else:
        assert _same_bits(got[0], want[0]) and _same_bits(got[1], want[1])
        assert got[1][5, 100].item() == np.float32(HBM_S) and got[0].data_ptr() != x.data_ptr()
        if leg == "manual_copy":
            assert _same_bits(got[0], x)
        elif rows > cb:
            assert got[0][0, 0].item() != got[0][cb, 0].item()  # the chunk index reaches the array


@pytest.mark.parametrize("leg,k,cb", [("manual_copy", 2, 512), ("manual_copy", 8, 1024), ("manual_copy", 3, 8),
                                      ("hbm2hbm", None, None), ("auto_copy", None, 256)])
def test_sweep_copies_stay_exact_over_many_launches_in_a_row(cuda, leg, k, cb):
    """Twelve launches in a row at the sweep's 256 MB, each on another array,
    all in flight before the first is checked: a wrong mbarrier phase or a
    slot refilled before its store has read it shows only now and then, as
    a stage of one array in another's copy, or a stage left unwritten in an
    output block the allocator hands back. The auto copy (cb: its block
    height) is held against x + s."""
    from howl_tpu_torch.tools import hbm_sweep_kernels as hk

    base = _sweep_array(cuda, 131072, torch.float32)
    arrays = [base.roll(7 * i + 1, 0) for i in range(12)]
    kernel = getattr(hk, f"{leg}_cuda")
    before = kernel.launches
    if leg == "auto_copy":
        outs = [kernel(x, cb, HBM_S) for x in arrays]
    else:
        outs = [kernel(x, k, cb, HBM_S) if k else kernel(x, HBM_S) for x in arrays]
    torch.cuda.synchronize()
    assert kernel.launches == before + len(arrays)
    if leg == "auto_copy":
        assert all(_same_bits(out, hk.auto_copy_plain(x, HBM_S)) for x, out in zip(arrays, outs))
        return
    for x, (out, done) in zip(arrays, outs):
        assert _same_bits(out, x) and bool((done == np.float32(HBM_S)).all())


def test_sweep_manual_read_adds_in_chunk_order_and_write_casts_after_the_add(cuda):
    """The read's float32 sum over 393 chunks equals the plain loop and not
    the same corners added backwards; the bf16 write's chunk 257 holds 258
    (257.3 rounded), not what a bf16 add of a bf16 index gives."""
    from howl_tpu_torch.tools import hbm_sweep_kernels as hk

    x = _sweep_array(cuda, 3144, torch.float32)
    got = hk.manual_read_cuda(x, 3, 8, HBM_S)
    backwards = hk.manual_read_plain(x.view(393, 8, 512).flip(0).reshape(3144, 512).contiguous(), 3, 8, HBM_S)
    assert _same_bits(got, hk.manual_read_plain(x, 3, 8, HBM_S)) and not torch.equal(got, backwards)
    out, _ = hk.manual_write_cuda(x.to(torch.bfloat16), 2, 8, HBM_S)
    assert out[257 * 8, 0].item() == 258.0 and out[300 * 8 + 7, 511].item() == 300.0 and out[0, 0].item() == 0.30078125


def test_sweep_manual_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    from howl_tpu_torch.ops import _build
    from howl_tpu_torch.tools import hbm_sweep_kernels as hk

    legs = (hk.manual_read_cuda, hk.manual_write_cuda, hk.manual_copy_cuda)
    x = torch.zeros((64, 512), device=cuda)
    counts = [fn.launches for fn in legs]
    for fn in legs:
        with pytest.raises(RuntimeError, match="no backward"):
            fn(x.clone().requires_grad_(), 2, 8, 0.0)
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            fn(x.half(), 2, 8, 0.0)
        with pytest.raises(ValueError, match=r"\(rows, 512\)"):
            fn(torch.zeros((64, 256), device=cuda), 2, 8, 0.0)
        with pytest.raises(ValueError, match="whole number of chunks"):
            fn(x, 2, 24, 0.0)
        with pytest.raises(ValueError, match="multiple of 8"):
            fn(x, 2, 4, 0.0)
        with pytest.raises(ValueError, match="at least 2"):
            fn(x, 1, 8, 0.0)
        with pytest.raises(ValueError, match="from 2 to 8"):
            fn(x, 9, 8, 0.0)
        with pytest.raises(ValueError, match="contiguous"):
            fn(torch.zeros((512, 64), device=cuda).t(), 2, 8, 0.0)
        with pytest.raises(ValueError, match="16-byte aligned"):
            fn(torch.zeros(64 * 512 + 1, device=cuda)[1:].view(64, 512), 2, 8, 0.0)
        with pytest.raises(TypeError, match="Python number"):
            fn(x, 2, 8, torch.tensor(0.0))
    assert [fn.launches for fn in legs] == counts  # a refusal launches nothing
    # the C entries refuse an unsupported depth themselves: cudaErrorInvalidValue, no rounding to a depth they have
    lib, stream = _build.kernel_library(), torch.cuda.current_stream(cuda).cuda_stream
    out, done = torch.empty_like(x), torch.empty((8, 128), device=cuda)
    for k in (1, 9):
        assert lib.howl_hbm_manual_copy_forward(x.data_ptr(), out.data_ptr(), done.data_ptr(), 64, 8, k, 0, 0.0, stream) == 1
        assert lib.howl_hbm_manual_write_forward(out.data_ptr(), done.data_ptr(), 64, 8, k, 0, 0.0, stream) == 1
        assert lib.howl_hbm_manual_read_forward(x.data_ptr(), out.data_ptr(), done.data_ptr(), 64, 8, k, 0, 0.0, stream) == 1
    # an empty array still fills the (8, 128) outputs, and counts as a launch
    assert bool((hk.manual_read_cuda(x[:0], 2, 8, 0.5) == 0.5).all())
    for fn in legs[1:]:
        out, done = fn(x[:0], 2, 8, 0.5)
        assert out.shape == (0, 512) and bool((done == 0.5).all())
    assert [fn.launches for fn in legs] == [n + 1 for n in counts]


def test_sweep_ring_depth_sets_the_ctas_that_share_an_sm(cuda):
    """k slots of 16 KB of an SM's 227 KB: fewer CTAs fit as the ring deepens, one at k = 8."""
    from howl_tpu_torch.tools import hbm_sweep_kernels as hk

    for fn in (hk.manual_read_cuda, hk.manual_write_cuda, hk.manual_copy_cuda):
        per_sm = [hk.ring_ctas_per_sm(fn, k, bf16, cuda) for k in range(hk.MIN_K, hk.MAX_K + 1) for bf16 in (False, True)]
        assert per_sm == sorted(per_sm, reverse=True) and per_sm[0] >= 4 and per_sm[-1] == 1
        with pytest.raises(RuntimeError, match="occupancy"):
            hk.ring_ctas_per_sm(fn, 9, False, cuda)


@pytest.mark.parametrize("rows,cb", [(8192, 512), (3144, 24)])
def test_sweep_manual_library_calls_compute_the_manual_legs_functions(cuda, rows, cb):
    """The read's library call is a tree sum, held to 1e-3 of the sequential
    sum of at most 131 unit normals; the write's broadcast copy is exact."""
    from howl_tpu_torch.tools import bench_hbm_sweep as tool
    from howl_tpu_torch.tools import hbm_sweep_kernels as hk

    x = _sweep_array(cuda, rows, torch.float32)
    torch.testing.assert_close(tool.manual_read_library(x, cb, HBM_S), hk.manual_read_plain(x, 2, cb, HBM_S), rtol=0, atol=1e-3)
    got = tool.manual_write_library(torch.empty_like(x), hk.chunk_values(x, cb, HBM_S), cb)
    assert _same_bits(got, hk.manual_write_plain(x, 2, cb, HBM_S)[0])


@pytest.mark.parametrize("rows,bn", [(8192, 256), (3144, 24)])
def test_sweep_read_library_call_matches_plain_bitwise(cuda, rows, bn):
    """The read leg's library leg is one add over a strided view; the plain
    version gathers the corners first. Same function, bit for bit."""
    from howl_tpu_torch.tools.bench_hbm_sweep import auto_read_library
    from howl_tpu_torch.tools.hbm_sweep_kernels import auto_read_plain

    x = _sweep_array(cuda, rows, torch.float32)
    assert _same_bits(auto_read_library(x, bn, HBM_S), auto_read_plain(x, bn, HBM_S))


def test_sweep_tool_runs_on_the_card(cuda, capsys, tmp_path):
    """The tool's ``main`` with the default device at a small size: every
    kernel leg on its kernel, the launch tally equal to the counters."""
    from howl_tpu_torch.tools import bench_hbm_sweep

    for fn in bench_hbm_sweep.KERNELS.values():
        fn.launches = 0
    records, tally = bench_hbm_sweep.run(16, 2, False, 0, cuda)
    assert tally == {key: fn.launches for key, fn in bench_hbm_sweep.KERNELS.items()}
    assert tally == {"auto_read": 7 * 32, "auto_copy": 7 * 32, "stream_repro": 32, "manual_read": 11 * 32,
                     "manual_write": 6 * 32, "manual_copy": 8 * 32, "hbm2hbm": 32}
    assert sum(r["route"] == "cuda kernel" for r in records) == 41 and sum(r["library"] for r in records) == 6
    rings = [r["ring"] for r in records if r["ring"]]
    assert len(rings) == 25 and all(r["ctas_per_sm"] >= 1 for r in rings)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for r in rings:  # the read and the write a CTA a chunk; the copy's sweep every CTA that fits, at most a stage each
        if r["schedule"] == "sweep":
            assert r["ctas"] == min(r["stages"], r["ctas_per_sm"] * sms) and r["stages"] * r["stage_bytes"] == 16 << 20
        else:
            assert r["ctas"] * r["cb"] in (8192, 16384)
    assert all(np.isfinite(r["ms_per_iter"]) and r["ms_per_iter"] > 0 for r in records if r["route"] == "cuda kernel")
    out_file = tmp_path / "sweep.json"
    bench_hbm_sweep.main(["--mb", "16", "--iters", "2", "--quick", "--json", str(out_file)])
    out = capsys.readouterr().out
    assert "not ported" not in out and "CTAs to an SM" in out and out_file.exists()


# ---- the per-window mega-batch scorer and the bench ----


def _tone_clips(batch, samples, seed=0):
    """Loud tones over noise for the first half, quiet noise for the rest:
    clips a random res8 scores far apart, so some fire and some do not."""
    rng = np.random.default_rng(seed)
    t = np.arange(samples) / 16000
    tones = 0.5 * np.sin(2 * np.pi * rng.uniform(200.0, 4000.0, (batch, 1)) * t)
    noise = rng.standard_normal((batch, samples))
    loud = np.arange(batch)[:, None] < batch // 2
    return np.where(loud, tones + 0.05 * noise, 0.002 * noise).astype(np.float32)


@pytest.mark.parametrize("dtype,atol", [(None, 1e-4), (torch.bfloat16, 2e-2)], ids=["f32", "bf16"])
def test_legacy_engine_on_cuda_matches_cpu(cuda, dtype, atol):
    """The per-window scorer on the card (frontend "fm" and stem kernels on
    41-frame windows) against the same engine on the CPU (their plain
    versions): posteriors within the tolerance, decisions equal at a
    threshold midway between the loud and the quiet clips' peaks."""
    from howl_tpu_torch import bench
    from howl_tpu_torch.compat import res8_variables_to_state_dict
    from howl_tpu_torch.inference import EngineConfig, StreamingEngine
    from howl_tpu_torch.models import create_model

    state = res8_variables_to_state_dict(bench.res8_numpy_variables(np.random.default_rng(3), 4))
    audio = _tone_clips(6, 40000)

    def engine(cfg, device):
        return StreamingEngine(create_model("res8", num_labels=4), state, cfg, FrontendConfig(n_mels=40), -6.0, 4.0,
                               compute_dtype=dtype, fused_trunk=False, frontend_precision="auto", device=device)

    base = EngineConfig(inference_sequence=(0,), negative_label=3, num_labels=4)
    probe = engine(base, "cpu").score_batch(audio)["probs"].numpy()
    word = int(np.bincount(probe[:3].argmax(-1).ravel(), minlength=4).argmax())
    peak = probe.max(-1).max(-1)
    cfg = EngineConfig(inference_sequence=(word,), negative_label=(word + 1) % 4, num_labels=4,
                       inference_threshold=float(peak[3:].max() + peak[:3].min()) / 2)
    want, got = engine(cfg, "cpu").infer_batch(audio), engine(cfg, cuda).infer_batch(audio)
    assert got["probs"].device.type == "cuda" and tuple(got["probs"].shape) == (6, 33, 4)
    torch.testing.assert_close(got["probs"].cpu(), want["probs"], rtol=0, atol=atol)
    for key in ("detected", "first_fire_step", "labels"):
        assert torch.equal(got[key].cpu(), want[key]), key
    assert want["detected"].any() and not want["detected"].all()


@pytest.mark.parametrize("name", ["small-cnn", "gru", "seq-lstm"])
def test_family_engine_on_cuda_matches_cpu(cuda, name):
    """One family of each kind (a CNN, an RNN, a sequential model) at its
    registered width, float32 with the exact frontend: the engine on the card
    (K1 "fm"; cuDNN's recurrences) against the same engine on the CPU, on
    the decision gate's weights, clips, word and threshold (picked on the
    CPU): posteriors within 1e-4, decisions equal."""
    from howl_tpu_torch.bench import serving_config
    from howl_tpu_torch.tools.validate_tpu_decisions import family_audio, family_engine, family_setup

    frontend = FrontendConfig(n_mels=40)
    audio = torch.from_numpy(family_audio(8, 32000))
    state, cfg, _ = family_setup(name, serving_config(), frontend, torch.device("cpu"), audio)
    want = family_engine(name, state, cfg, frontend, "cpu", frontend_precision="f32").infer_batch(audio)
    got = family_engine(name, state, cfg, frontend, cuda, frontend_precision="f32").infer_batch(audio)
    assert got["probs"].device.type == "cuda" and got["probs"].shape == want["probs"].shape
    torch.testing.assert_close(got["probs"].cpu(), want["probs"], rtol=0, atol=1e-4)
    for key in ("detected", "first_fire_step", "labels"):
        assert torch.equal(got[key].cpu(), want[key]), key
    assert want["detected"].any() and not want["detected"].all()


@pytest.mark.parametrize("name,kind,carry", [("lstm", "full-window", True), ("gru", "incremental", False)],
                         ids=["lstm-full-window-carry", "gru-incremental"])
def test_family_live_engine_on_cuda_matches_cpu(cuda, name, kind, carry):
    """One family on each live engine at its registered width, float32 with
    the exact frontend: the engine on the card (``OnlineEngine``: K1 "fm";
    cuDNN's recurrences) against the same engine on the CPU, on the weights,
    streams, word and threshold of the live checks (picked on the CPU), hop
    by hop: labels and fire flags equal, posteriors within 1e-4."""
    from howl_tpu_torch.bench import serving_config
    from howl_tpu_torch.tools.validate_tpu_decisions import (
        drive_live, family_audio, family_live_engine, family_live_setup,
    )

    frontend = FrontendConfig(n_mels=40)
    audio = torch.from_numpy(family_audio(8, 8000 + 15 * 1000))
    state, cfg, _ = family_live_setup(name, kind, serving_config(), frontend, torch.device("cpu"), audio, True,
                                      carry_hops=carry)
    runs = [drive_live(family_live_engine(name, kind, state, cfg, frontend, dev, dft_precision="f32", num_streams=8,
                                          carry_hops=carry), audio.to(dev), True) for dev in ("cpu", cuda)]
    (want_fired, want_labels, want_probs), (got_fired, got_labels, got_probs) = runs
    np.testing.assert_allclose(got_probs, want_probs, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got_labels, want_labels)
    np.testing.assert_array_equal(got_fired, want_fired)
    assert want_fired.any(0).any() and not want_fired.any(0).all()


def test_ctc_step_on_cuda_launches_the_mix_kernel_and_matches_cpu(cuda):
    """One CTC step of seq-cnn at its registered width from the same weights,
    draws and dropout mask: the card's loss within 1e-5 relative of the
    CPU's (TF32 off), K3 launched once."""
    from howl_tpu_torch.models import create_model
    from howl_tpu_torch.ops.tf32 import exact_float32
    from howl_tpu_torch.training.state import create_train_state
    from howl_tpu_torch.training.step import StepConfig, draw_step, featurize, make_ctc_train_step

    rng = np.random.default_rng(3)
    b, n = 8, 16000
    audio = torch.from_numpy((rng.standard_normal((b, n)) * 0.1).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 3, (b, 3)).astype(np.int32))
    audio_lengths = torch.from_numpy(rng.integers(12000, n + 1, b).astype(np.int32))
    label_lengths = torch.from_numpy(rng.integers(1, 4, b).astype(np.int32))
    bank = (rng.standard_normal((4, 9000)) * 0.05).astype(np.float32)
    cfg = StepConfig(FrontendConfig(n_mels=40), 2.05, 1.0, augment=aug.AugmentConfig(), negative_label=3,
                     blank_label=4, use_deltas=False)
    template = create_model("seq-cnn", num_labels=5).eval()
    t_out = template(featurize(audio, cfg)).shape[0]
    draws = draw_step(torch.Generator().manual_seed(1), cfg, b, n, aug.prepare_noise_bank(bank, n))
    draws = draws._replace(dropout=[rng.random((t_out, b, 128)) >= 0.1])
    losses = {}
    for dev in ("cpu", cuda):
        model = create_model("seq-cnn", num_labels=5)
        state = create_train_state(model, 0.01, generator=torch.Generator().manual_seed(0), device=dev)
        step = make_ctc_train_step(model, cfg, torch.from_numpy(bank).to(dev))
        before = mix_noise_bank_cuda.launches
        with exact_float32():
            _, metrics = step(state, audio.to(dev), labels.to(dev), audio_lengths.to(dev), label_lengths.to(dev), 0,
                              draws=_to(draws, dev))
        losses[str(dev)] = float(metrics["loss"])
        assert mix_noise_bank_cuda.launches == before + (dev != "cpu")
    assert np.isfinite(losses["cpu"]) and abs(losses["cpu"] - losses[str(cuda)]) <= 1e-5 * abs(losses["cpu"])


@pytest.mark.parametrize("b", [1, 121, 4099])
def test_stem_tc_kernel_on_41_frame_windows(cuda, b):
    """The per-window scorer's stem: 41-frame clips, 13 pooled frames in a
    tile of 24, the 41st frame dropped by the floor; at batch counts that
    are no multiple of anything the launch geometry likes."""
    mel, taps = _stem_operands(cuda, b, 41)
    got = res8_stem_cuda(mel, taps)
    ref = res8_stem_plain(mel, taps)
    assert tuple(got.shape) == (b, 13, 10, 45) and stem_route(mel.dtype, 40, 45) == "tc"
    assert float((got.float() - ref.float()).abs().max()) <= _bf16_ulp(ref)


def test_bench_cpu_sized_run_on_the_card(cuda):
    """``bench.run`` at its CPU sizes on the card: every measured key finite
    and positive, the kernels of both scorers launched once a batch."""
    from howl_tpu_torch import bench

    record = bench.run(cuda, bench.CPU, 2, 0)
    assert record["unit"] == "x_realtime_per_gpu_chip" and record["device"]
    known = bench.peak_bf16_flops(torch.cuda.get_device_name(cuda)) is not None
    for key in ("value", "legacy_realtime_factor", "train_examples_per_sec", "train_noise_examples_per_sec",
                "train_examples_per_sec_f32", *(("mfu", "train_mfu") if known else ())):
        lo, hi = record["spread"][key]
        # the utilizations are rounded to 4 decimals, which at these sizes can read 0.0 on a slow host: hold
        # the unrounded median of the two repeats, the mean of the spread's ends, and the rounding against it
        value = (lo + hi) / 2 if key in ("mfu", "train_mfu") else record[key]
        assert np.isfinite(value) and value > 0, key
        assert 0 < lo <= hi, key
        if key in ("mfu", "train_mfu"):
            assert record[key] == round(value, 4), key
    if not known:
        assert record["mfu"] is None and record["train_mfu"] is None
    for scorer in ("headline", "legacy"):
        rung = record["rungs"][scorer]
        assert rung["frontend"]["route"] == "tc" and rung["frontend"]["launches_per_batch"] == 1
        assert rung["stem"] == {"kernel": "K2", "route": "tc", "launches_per_batch": 1}
    assert record["rungs"]["train"]["noise_bank_mix"]["launches_per_step"] == 1.0
    for key in bench.ONLINE_KEYS:
        assert record[key], key
    online = record["rungs"]["online"]
    assert online["full_window"]["frontend"]["route"] == "tc" and online["full_window"]["frontend"]["launches_per_step"] == 1
    for kind in ("full_window", "incremental"):
        assert online[kind]["stem"] == {"kernel": "K2", "route": "tc", "launches_per_step": 1}


# ---- 65,536 clips a launch, and the live engines ----


@pytest.mark.parametrize("route", ["tc", "fma"])
def test_frontend_kernel_at_65536_clips(cuda, route):
    """65,536 windows of 8,000 samples in one launch ("fm", the "bf16"
    grade, bf16 out), the plain version chunk by chunk."""
    cfg, mean, std = FrontendConfig(n_mels=40), -6.0, 4.0
    audio = torch.randn((65536, 8000), generator=torch.Generator(device=cuda).manual_seed(7), device=cuda) * 0.1
    kw = dict(precision="bf16", out_dtype=torch.bfloat16, layout="fm")
    before = log_mel_spectrogram_cuda.launches
    got = log_mel_spectrogram_cuda(audio, cfg, mean, std, route=route, **kw)
    torch.cuda.synchronize()
    assert log_mel_spectrogram_cuda.launches == before + 1 and tuple(got.shape) == (65536, 40, 41)
    for lo in range(0, 65536, 8192):
        want = log_mel_spectrogram_plain(audio[lo : lo + 8192], cfg, mean, std, **kw)
        part = got[lo : lo + 8192]
        assert bool(torch.isfinite(part.float()).all())
        assert float((part.float() - want.float()).abs().max()) <= 2e-2 / std + _bf16_ulp(want), lo


@pytest.mark.parametrize("route", ["tc", "fma"])
def test_stem_kernel_at_65536_clips(cuda, route):
    """65,536 clips of 41 frames in one launch, the plain version chunk by
    chunk; the last clip's output lands where the first's would."""
    mel, taps = _stem_operands(cuda, 65536, 41)
    before = res8_stem_cuda.launches
    got = res8_stem_cuda(mel, taps, route=route)
    torch.cuda.synchronize()
    assert res8_stem_cuda.launches == before + 1 and tuple(got.shape) == (65536, 13, 10, 45)
    for lo in range(0, 65536, 8192):
        want = res8_stem_plain(mel[lo : lo + 8192], taps)
        assert float((got[lo : lo + 8192].float() - want.float()).abs().max()) <= _bf16_ulp(want), lo
    torch.testing.assert_close(res8_stem_cuda(mel[-1:].contiguous(), taps, route=route), got[-1:], rtol=0, atol=0)


def _live_config(probs: np.ndarray, base):
    """A one-word configuration on float32 per-hop posteriors (T, N, L) that
    fires on the loud half of the streams, every decision 0.01 from
    flipping (``validate_tpu_decisions.margin_word_threshold``)."""
    import dataclasses

    from howl_tpu_torch.tools.validate_tpu_decisions import margin_word_threshold

    pick = margin_word_threshold(probs, 0.01)
    return dataclasses.replace(base, inference_sequence=(pick["word"],), negative_label=(pick["word"] + 1) % 4,
                               inference_threshold=pick["threshold"])


@pytest.mark.parametrize("kind", ["full_window", "incremental", "trunk"])
def test_live_engine_bf16_decisions_equal_float32(cuda, kind):
    """Each live engine on the card, bf16 against float32 on the same
    streams (8 tone streams, 8 quiet, 3 s pushed hop by hop): every hop's
    labels and fire flags equal, some streams fire and some do not."""
    from howl_tpu_torch import bench
    from howl_tpu_torch.compat import res8_variables_to_state_dict

    state = res8_variables_to_state_dict(bench.res8_numpy_variables(np.random.default_rng(5), 4))
    rng = np.random.default_rng(4)
    t = np.arange(48000) / 16000
    tones = 0.5 * np.sin(2 * np.pi * rng.uniform(200.0, 4000.0, (16, 1)) * t) + 0.05 * rng.standard_normal((16, 48000))
    audio = torch.from_numpy(np.where(np.arange(16)[:, None] < 8, tones, 0.002 * rng.standard_normal((16, 48000)))
                             .astype(np.float32)).to(cuda)

    def run(cfg, dtype):
        from howl_tpu_torch.inference.online import IncrementalOnlineEngine, OnlineEngine
        from howl_tpu_torch.inference.streaming_trunk import FusedStreamingOnlineEngine
        from howl_tpu_torch.models import create_model

        cls = {"full_window": OnlineEngine, "incremental": IncrementalOnlineEngine,
               "trunk": FusedStreamingOnlineEngine}[kind]
        eng = cls(create_model("res8", num_labels=4), state, cfg, FrontendConfig(n_mels=40), -6.0, 4.0,
                  num_streams=16, compute_dtype=dtype, device=cuda)
        out = []
        for end in range(eng.hop_samples, 48000 + 1, eng.hop_samples):
            if kind == "full_window":
                eng.ingest(audio[:, max(0, end - eng.window_samples) : end])
            else:
                eng.push(audio[:, end - eng.hop_samples : end])
            probs = eng.last_probs if kind == "trunk" else eng.state.pred_ring[:, -1]
            out.append((eng.last_labels, eng.last_fired, probs.float().cpu().numpy()))
        return [np.stack(x) for x in zip(*out)]

    cfg = _live_config(run(bench.serving_config(), None)[2], bench.serving_config())
    labels, fired, probs = run(cfg, None)
    labels16, fired16, probs16 = run(cfg, torch.bfloat16)
    np.testing.assert_array_equal(labels16, labels)
    np.testing.assert_array_equal(fired16, fired)
    assert float(np.abs(probs16 - probs).max()) <= 2e-2
    assert fired.any(0).any() and not fired.any(0).all()


# ---- the int8 residual trunk's layer kernel (csrc/int8_trunk.cu) ----

INT8_GEOMETRIES = [(1, 213, 10), (3, 7, 10), (2, 26, 10), (2, 5, 1), (1, 9, 17), (2, 9, 64), (2, 1, 10)]


def _int8_params(cuda, seed=0):
    from howl_tpu_torch import bench
    from howl_tpu_torch.compat import res8_variables_to_state_dict
    from howl_tpu_torch.ops.int8_trunk import quantize_residual_trunk

    state = res8_variables_to_state_dict(bench.res8_numpy_variables(np.random.default_rng(seed), 4))
    return quantize_residual_trunk(state, [0.02, 0.03, 0.025, 0.04, 0.035, 0.05], cuda)


@pytest.mark.parametrize("b,t,f", INT8_GEOMETRIES)
@pytest.mark.parametrize("pattern", ["extremes", "uniform"])
def test_int8_layer_kernel_sums_are_exact(cuda, b, t, f, pattern):
    """The s32 sums through the kernel's public interface: float32
    activations that are already s8 values, s_a = 1 (the quantize is the
    identity), w_scale = 1 (dq = 1), no residual and no BN, so the output is
    relu(acc) exactly (|acc| < 2^24); the negated weights give relu(-acc).
    Their difference must equal the int64 sums, at +-127 extremes too."""
    from howl_tpu_torch.ops.int8_trunk import int8_conv_layer_cuda, int8_conv_sums_plain

    rng = np.random.default_rng(b * 1000 + t * 10 + f)
    draw = (lambda s: rng.choice([-127, 127], s)) if pattern == "extremes" else (lambda s: rng.integers(-127, 128, s))
    xq = torch.from_numpy(draw((b, t, f, 45)).astype(np.int8))
    w = torch.from_numpy(draw((3, 3, 45, 45)).astype(np.int8))
    ones = torch.ones(45, device=cuda)
    x = xq.float().to(cuda)
    before = int8_conv_layer_cuda.launches
    pos, _ = int8_conv_layer_cuda(x, w.to(cuda), 1.0, ones)
    neg, _ = int8_conv_layer_cuda(x, (-w).to(cuda), 1.0, ones)
    torch.cuda.synchronize()
    assert int8_conv_layer_cuda.launches == before + 2
    got = (pos - neg).cpu().to(torch.int64)
    assert torch.equal(got, int8_conv_sums_plain(xq, w).to(torch.int64))  # the CPU's direct float32 conv
    assert torch.equal((pos - neg).to(torch.int32), int8_conv_sums_plain(x.to(torch.int8), w.to(cuda)))  # cuDNN off


@pytest.mark.parametrize("b,t,f", INT8_GEOMETRIES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("epilogue", ["full", "residual", "conv_relu_dequant"])
def test_int8_layer_kernel_matches_plain_bitwise(cuda, b, t, f, dtype, epilogue):
    """One layer, kernel against plain version on the same operands: the s32
    sums are exact and every later operation rounds to the compute dtype at
    the same points, so out and pre are equal bit for bit."""
    from howl_tpu_torch.ops.int8_trunk import int8_conv_layer_cuda, int8_conv_layer_plain

    p = _int8_params(cuda)
    gen = torch.Generator(device=cuda).manual_seed(t * f)
    x = (torch.randn((b, t, f, 45), generator=gen, device=cuda) * 1.5).to(dtype)
    res = (torch.randn((b, t, f, 45), generator=gen, device=cuda)).to(dtype)
    kw = {"full": dict(bn_scale=p.bn_scale[1], bn_shift=p.bn_shift[1], residual=res),
          "residual": dict(residual=res), "conv_relu_dequant": {}}[epilogue]
    out, pre = int8_conv_layer_cuda(x, p.w_i8[1], 0.02, p.w_scale[1], keep_pre=True, **kw)
    want_out, want_pre = int8_conv_layer_plain(x, p.w_i8[1], 0.02, p.w_scale[1], **kw)
    torch.cuda.synchronize()
    assert out.dtype == dtype and pre.dtype == dtype and out.shape == x.shape
    assert torch.equal(out, want_out) and torch.equal(pre, want_pre)


@pytest.mark.parametrize("route", ["layer", "fused"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_int8_trunk_kernel_matches_plain_at_the_serving_batch(cuda, dtype, route):
    """At 512 clips of 8 s (213 x 10 pooled frames), six launches of the
    layer kernel or one of the fused kernel: the trunk equals its plain
    version bit for bit."""
    from howl_tpu_torch.ops.int8_trunk import (
        int8_conv_layer_cuda, int8_trunk_fused_cuda, residual_features_int8, residual_features_int8_plain,
    )

    p = _int8_params(cuda)
    gen = torch.Generator(device=cuda).manual_seed(512)
    y = torch.relu(torch.randn((512, 213, 10, 45), generator=gen, device=cuda)).to(dtype)
    before = int8_conv_layer_cuda.launches, int8_trunk_fused_cuda.launches
    got = residual_features_int8(y, p, dtype, route=route)
    torch.cuda.synchronize()
    after = int8_conv_layer_cuda.launches - before[0], int8_trunk_fused_cuda.launches - before[1]
    assert after == ((6, 0) if route == "layer" else (0, 1))
    want = residual_features_int8_plain(y, p, dtype)
    assert bool(torch.isfinite(got.float()).all()) and torch.equal(got, want)


def test_int8_layer_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    from howl_tpu_torch.ops.int8_trunk import int8_conv_layer_cuda

    p = _int8_params(cuda)
    x = torch.zeros((1, 9, 10, 45), device=cuda)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        int8_conv_layer_cuda(x.half(), p.w_i8[0], 0.1, p.w_scale[0])
    with pytest.raises(ValueError, match="int8 weights"):
        int8_conv_layer_cuda(x, p.w_i8[0].float(), 0.1, p.w_scale[0])
    with pytest.raises(ValueError, match="int8 weights"):
        int8_conv_layer_cuda(torch.zeros((1, 9, 10, 44), device=cuda), p.w_i8[0], 0.1, p.w_scale[0])
    with pytest.raises(ValueError, match="go together"):
        int8_conv_layer_cuda(x, p.w_i8[0], 0.1, p.w_scale[0], bn_scale=p.bn_scale[0])
    with pytest.raises(ValueError, match="residual"):
        int8_conv_layer_cuda(x, p.w_i8[0], 0.1, p.w_scale[0], residual=x.bfloat16())
    with pytest.raises(ValueError, match="lies on cpu"):
        int8_conv_layer_cuda(x, p.w_i8[0].cpu(), 0.1, p.w_scale[0])
    with pytest.raises(ValueError, match="contiguous"):
        int8_conv_layer_cuda(torch.zeros((1, 10, 9, 45), device=cuda).transpose(1, 2), p.w_i8[0], 0.1, p.w_scale[0])
    with pytest.raises(ValueError, match="16-byte aligned"):
        int8_conv_layer_cuda(torch.zeros(4051, device=cuda)[1:].view(1, 9, 10, 45), p.w_i8[0], 0.1, p.w_scale[0])
    with pytest.raises(ValueError, match="frequency bins"):
        int8_conv_layer_cuda(torch.zeros((1, 2, 257, 45), device=cuda), p.w_i8[0], 0.1, p.w_scale[0])


def test_int8_weight_image_follows_in_place_changes(cuda):
    """The packed weight image is cached per tensor and packed again when the
    tensor changes in place (ROADMAP F2)."""
    from howl_tpu_torch.ops.int8_trunk import int8_conv_layer_cuda, int8_conv_layer_plain

    p = _int8_params(cuda)
    x = torch.randn((2, 9, 10, 45), device=cuda)
    w = p.w_i8[0].clone()
    first, _ = int8_conv_layer_cuda(x, w, 0.02, p.w_scale[0])
    w.neg_()
    second, _ = int8_conv_layer_cuda(x, w, 0.02, p.w_scale[0])
    assert torch.equal(second, int8_conv_layer_plain(x, w, 0.02, p.w_scale[0])[0]) and not torch.equal(first, second)


@pytest.mark.parametrize("dtype", [None, torch.bfloat16], ids=["f32", "bf16"])
def test_int8_engine_on_cuda_matches_cpu(cuda, dtype):
    """The int8 engine on the card (K1, K2 and one fused int8 launch a batch)
    against the same engine on the CPU: the same calibration (act scales
    within 1e-5 relative) and, with the card's scales, decisions equal and
    posteriors within 2e-2."""
    from howl_tpu_torch import bench
    from howl_tpu_torch.compat import res8_variables_to_state_dict
    from howl_tpu_torch.inference import StreamingEngine
    from howl_tpu_torch.models import create_model
    from howl_tpu_torch.ops.int8_trunk import int8_trunk_fused_cuda, quantize_residual_trunk

    state = res8_variables_to_state_dict(bench.res8_numpy_variables(np.random.default_rng(7), 4))
    audio = (np.random.default_rng(8).standard_normal((8, 32000)) * 0.1).astype(np.float32)
    engines = {d: StreamingEngine(create_model("res8", num_labels=4), state, bench.serving_config(),
                                  FrontendConfig(n_mels=40), compute_dtype=dtype, use_int8_trunk=True,
                                  int8_calibration_audio=audio[:4], device=d) for d in ("cuda", "cpu")}
    np.testing.assert_allclose(engines["cuda"]._int8_params.act_scale, engines["cpu"]._int8_params.act_scale, rtol=1e-5)
    engines["cpu"]._int8_params = quantize_residual_trunk(state, engines["cuda"]._int8_params.act_scale, "cpu")
    before = int8_trunk_fused_cuda.launches
    got = engines["cuda"].infer_batch(audio)
    torch.cuda.synchronize()
    assert int8_trunk_fused_cuda.launches == before + 1  # the serving geometry's route: the fused kernel
    want = engines["cpu"].infer_batch(audio)
    assert float((got["probs"].cpu() - want["probs"]).abs().max()) <= 2e-2
    for key in ("detected", "first_fire_step"):
        assert torch.equal(got[key].cpu(), want[key]), key


# ---- the fused int8 trunk (csrc/int8_trunk_fused.cu) ----


def _fused_geometries():
    from howl_tpu_torch.ops.int8_trunk import FUSED_TILE_FRAMES

    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        tt = FUSED_TILE_FRAMES[dtype]
        for b in (1, 3):
            for t in (1, tt - 1, tt, tt + 1, 2 * tt + 1, 213):
                for f in (10, 8):
                    cases.append((dtype, b, t, f))
    cases += [(torch.bfloat16, 2, 50, 11), (torch.bfloat16, 2, 50, 1)]  # the widest bf16 tile; one bin a frame
    return cases


@pytest.mark.parametrize("dtype,b,t,f", _fused_geometries(), ids=lambda v: str(v).replace("torch.", ""))
def test_int8_fused_trunk_matches_plain_bitwise(cuda, dtype, b, t, f):
    """One launch, bit for bit the plain trunk: tiles at the clip's start and
    end, a clip shorter than a tile, one frame past a tile boundary; inputs
    large enough that some activations saturate at +-127."""
    from howl_tpu_torch.ops.int8_trunk import int8_trunk_fused_cuda, residual_features_int8_plain

    p = _int8_params(cuda)
    gen = torch.Generator(device=cuda).manual_seed(b * 1000 + t * 10 + f)
    y = (torch.randn((b, t, f, 45), generator=gen, device=cuda) * 1.5).to(dtype)
    before = int8_trunk_fused_cuda.launches
    got = int8_trunk_fused_cuda(y, p, dtype)
    torch.cuda.synchronize()
    assert int8_trunk_fused_cuda.launches == before + 1
    assert got.dtype == dtype and torch.equal(got, residual_features_int8_plain(y, p, dtype))


@pytest.mark.parametrize("c", [48, 13])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_int8_fused_trunk_at_other_channel_counts(cuda, dtype, c):
    """The trunk at 48 and 13 channels on the route the table gives (float32
    at 48 channels does not fit the fused kernel's block: the layer kernel),
    bit for bit the plain trunk."""
    from howl_tpu_torch.ops.int8_trunk import (
        int8_trunk_fused_cuda, int8_trunk_route, quantize_residual_trunk, residual_features_int8,
        residual_features_int8_plain,
    )

    rng = np.random.default_rng(c)
    state = {}
    for i in range(1, 7):
        state[f"conv{i}.weight"] = torch.from_numpy(rng.standard_normal((c, c, 3, 3)).astype(np.float32) * 0.1)
        state[f"bn{i}.running_mean"] = torch.from_numpy(rng.standard_normal(c).astype(np.float32) * 0.1)
        state[f"bn{i}.running_var"] = torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32))
    p = quantize_residual_trunk(state, [0.02, 0.03, 0.025, 0.04, 0.035, 0.05], cuda)
    y = torch.relu(torch.from_numpy(rng.standard_normal((2, 50, 10, c)).astype(np.float32))).to(cuda, dtype)
    route = int8_trunk_route(dtype, 10, c)
    assert route == ("layer" if (dtype, c) == (torch.float32, 48) else "fused")
    before = int8_trunk_fused_cuda.launches
    assert torch.equal(residual_features_int8(y, p, dtype), residual_features_int8_plain(y, p, dtype))
    assert int8_trunk_fused_cuda.launches == before + (route == "fused")


def test_int8_fused_trunk_packs_its_weights_again_after_an_in_place_change(cuda):
    """The six weight images are cached per tensor and packed again when one
    changes in place (ROADMAP F2)."""
    from howl_tpu_torch.ops.int8_trunk import int8_trunk_fused_cuda, residual_features_int8_plain

    p = _int8_params(cuda)
    p = p._replace(w_i8=tuple(w.clone() for w in p.w_i8))
    y = torch.relu(torch.randn((2, 50, 10, 45), device=cuda)).bfloat16()
    first = int8_trunk_fused_cuda(y, p, torch.bfloat16)
    p.w_i8[3].neg_()
    second = int8_trunk_fused_cuda(y, p, torch.bfloat16)
    assert not torch.equal(first, second)
    assert torch.equal(second, residual_features_int8_plain(y, p, torch.bfloat16))


def test_int8_fused_trunk_geometry_matches_the_host_route(cuda):
    """The shared memory and tiles the C entry reports are the ones
    ``fused_shared_bytes`` and ``FUSED_TILE_FRAMES`` compute on the host."""
    from howl_tpu_torch.ops import _build
    from howl_tpu_torch.ops.int8_trunk import FUSED_TILE_FRAMES, fused_shared_bytes

    lib = _build.kernel_library()
    for dtype in (torch.bfloat16, torch.float32):
        is_bf16 = int(dtype == torch.bfloat16)
        assert lib.howl_int8_trunk_fused_geometry(10, 45, is_bf16, 1) == FUSED_TILE_FRAMES[dtype]
        for f in range(1, 17):
            for c in (1, 8, 13, 45, 48):
                want = fused_shared_bytes(dtype, f, c)
                assert lib.howl_int8_trunk_fused_geometry(f, c, is_bf16, 0) == (-1 if want is None else want), (f, c)


def test_int8_fused_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    from howl_tpu_torch.ops.int8_trunk import int8_trunk_fused_cuda

    p = _int8_params(cuda)
    x = torch.zeros((1, 9, 10, 45), device=cuda)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        int8_trunk_fused_cuda(x.half(), p, torch.float16)
    with pytest.raises(ValueError, match="int8 weights"):
        int8_trunk_fused_cuda(torch.zeros((1, 9, 10, 44), device=cuda), p)
    with pytest.raises(ValueError, match="frequency bins"):
        int8_trunk_fused_cuda(torch.zeros((1, 9, 12, 45), device=cuda), p)
    with pytest.raises(ValueError, match="16-byte aligned"):
        int8_trunk_fused_cuda(torch.zeros(4051, device=cuda)[1:].view(1, 9, 10, 45), p)
    with pytest.raises(ValueError, match="lies on cpu"):
        int8_trunk_fused_cuda(x, p._replace(w_scale=tuple(w.cpu() for w in p.w_scale)))
    with pytest.raises(RuntimeError, match="no backward"):
        int8_trunk_fused_cuda(x.requires_grad_(), p)


# ---- the live serving surface: the hub's engines, the native mux ----


def _serving_workspace(root, seed=5):
    """A port workspace of seeded res8 weights, 500 ms windows every 62.5 ms,
    40 mels, a one-word sequence."""
    import json

    from howl_tpu_torch import bench
    from howl_tpu_torch.compat import res8_variables_to_state_dict
    from howl_tpu_torch.ops.zmuv import ZmuvTransform
    from howl_tpu_torch.settings import HowlSettings
    from howl_tpu_torch.workspace import Workspace

    settings = HowlSettings()
    settings.load_dict({"audio_transform": {"num_mels": 40}, "inference_engine": {"inference_sequence": [1]},
                        "training": {"vocab": ["hey", "fire", "fox"], "max_window_size_seconds": 0.5,
                                     "eval_stride_size_seconds": 0.0625}})
    ws = Workspace(root, delete_existing=False)
    ws.save_settings(settings)
    ws.save_zmuv(ZmuvTransform(-6.0, 52.0, 1000.0))
    state = res8_variables_to_state_dict(bench.res8_numpy_variables(np.random.default_rng(seed), 4))
    ws.save_model(state, best=True)
    (root / "cmd-args.json").write_text(json.dumps({"model": "res8"}))
    return root, state


@pytest.mark.parametrize("kind", ["online", "incremental", "trunk"])
def test_hub_engines_launch_the_kernels_as_direct_engines(cuda, tmp_path, kind):
    """A hub-built engine on the card launches K1 and K2 as the same engine
    built directly (K1 and K2 once an ``OnlineEngine`` hop, K2 once an
    incremental hop, K2 once in the trunk's prefill) and decides as it does,
    hop for hop, in float32 as the hub builds it."""
    from howl_tpu_torch import hub
    from howl_tpu_torch.inference import EngineConfig, FusedStreamingOnlineEngine, IncrementalOnlineEngine, OnlineEngine
    from howl_tpu_torch.models import create_model
    from howl_tpu_torch.settings import SETTINGS

    ws, state = _serving_workspace(tmp_path)
    flags = {"online": {}, "incremental": {"incremental": True}, "trunk": {"streaming_trunk": True}}[kind]
    cls = {"online": OnlineEngine, "incremental": IncrementalOnlineEngine, "trunk": FusedStreamingOnlineEngine}[kind]
    gen = torch.Generator(device=cuda).manual_seed(3)
    audio = torch.randn((8, 24000), generator=gen, device=cuda) * 0.1
    runs = []
    try:
        for build in ("hub", "direct"):
            for fn in (log_mel_spectrogram_cuda, res8_stem_cuda):
                fn.launches = fn.launches_tc = 0
            if build == "hub":
                eng, ctx = hub.load_workspace_engine(ws, num_streams=8, device=cuda, **flags)
            else:
                eng = cls(create_model("res8", num_labels=4), state, EngineConfig.from_settings(ctx),
                          FrontendConfig.from_settings(), -6.0, 4.0, num_streams=8, device=cuda)
            hop, fired, probs = eng.hop_samples, [], []
            for end in range(eng.window_samples if kind == "online" else hop, 24000 + 1, hop):
                if kind == "online":
                    eng.ingest(audio[:, end - eng.window_samples : end])
                else:
                    eng.push(audio[:, end - hop : end])
                fired.append(eng.last_fired)
                probs.append((eng.last_probs if kind == "trunk" else eng.state.pred_ring[:, -1]).cpu().numpy())
            torch.cuda.synchronize()
            runs.append(((log_mel_spectrogram_cuda.launches, res8_stem_cuda.launches), np.stack(fired),
                         np.stack(probs), len(fired)))
    finally:
        SETTINGS.reset()
    (hub_counts, hub_fired, hub_probs, hops), (direct_counts, direct_fired, direct_probs, _) = runs
    assert hub_counts == direct_counts == {"online": (hops, hops), "incremental": (0, hops), "trunk": (0, 1)}[kind]
    np.testing.assert_array_equal(hub_fired, direct_fired)
    np.testing.assert_array_equal(hub_probs, direct_probs)


def test_native_mux_holds_its_batches_under_producer_threads(cuda):
    """Four producer threads push recognizable audio while the consumer
    gathers: the compiled mux drops nothing with room to spare, and every
    stream's consumed audio is its pushed sequence."""
    import threading

    from howl_tpu_torch.native import NativeStreamMux, available

    assert available(), "the native mux must build on the card's host"
    n_streams, total, hop = 4, 4096, 64
    mux = NativeStreamMux(n_streams, capacity=8192)

    def seq(s, start, n):
        return (s * 1000.0 + start + np.arange(n)).astype(np.float32)

    def producer(s):
        rng = np.random.default_rng(s)
        sent = 0
        while sent < total:
            n = min(int(rng.integers(1, 200)), total - sent)
            mux.push(s, seq(s, sent, n))
            sent += n

    threads = [threading.Thread(target=producer, args=(s,)) for s in range(n_streams)]
    for t in threads:
        t.start()
    consumed = [[] for _ in range(n_streams)]
    for _ in range(10 * total // hop):
        batch, status = mux.gather(hop)
        assert (status != -1).all(), "an overrun with room to spare"
        for s in np.flatnonzero(status == 1):
            consumed[s].append(batch[s])
        if all(not t.is_alive() for t in threads) and all(mux.pending(s) < hop for s in range(n_streams)):
            break
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    for s in range(n_streams):
        got = np.concatenate(consumed[s])
        assert len(got) >= total - hop + 1
        np.testing.assert_array_equal(got, seq(s, 0, len(got)))


# ---- the seed sweep: all seeds' noise mixed in one K3 launch ----


@pytest.mark.parametrize("s,b,n,bank_w", [(2, 16, 8000, 10240), (4, 1024, 8000, 32000), (3, 7, 7919, 5000)],
                         ids=["2x16", "4x1024", "3x7-ragged-narrow"])
def test_mix_kernel_stacked_over_seeds_matches_plain_bitwise(cuda, s, b, n, bank_w):
    """K3 over S x B examples in one launch, as a sweep step makes it, against
    its plain version on the stacked rows and against S launches of B rows."""
    gen = torch.Generator(device=cuda).manual_seed(s * b)
    bank = aug.prepare_noise_bank(torch.randn((8, bank_w), generator=gen, device=cuda) * 0.1, n)
    audio = torch.randn((s, b, n), generator=gen, device=cuda) * 0.3
    draws = [aug.draw_mix_noise_bank(torch.Generator(device=cuda).manual_seed(i), b, bank, aug.AugmentConfig(),
                                     replace_prob=0.3) for i in range(s)]
    rows, offs, alpha = (torch.cat([getattr(d, k) for d in draws]) for k in ("rows", "offs", "alpha"))
    before = mix_noise_bank_cuda.launches
    got = mix_noise_bank_cuda(audio.reshape(s * b, n), bank.extended, rows, offs, alpha)
    torch.cuda.synchronize()
    assert mix_noise_bank_cuda.launches == before + 1
    assert torch.equal(_bits(got), _bits(mix_noise_bank_plain(audio.reshape(s * b, n), bank.extended, rows, offs,
                                                              alpha)))
    for i, d in enumerate(draws):
        alone = mix_noise_bank_cuda(audio[i].contiguous(), bank.extended, d.rows, d.offs, d.alpha)
        assert torch.equal(_bits(got[i * b : (i + 1) * b]), _bits(alone))


def test_seed_sweep_step_on_cuda_mixes_once_and_matches_single_steps(cuda):
    """Two seeds, two sweep steps on the card: one K3 launch a sweep step;
    after the first, each seed's loss within 1e-6 relative of its own
    single-model step at its key (chip_smoke.py's tolerance) and its weights
    within 2 lr (cuDNN's backward may sum in another order between calls,
    and AdamW's first update turns a gradient at float32 noise into +-lr)."""
    from howl_tpu_torch.models import create_model
    from howl_tpu_torch.ops.tf32 import exact_float32
    from howl_tpu_torch.parallel import create_seed_states, make_seed_sweep_step
    from howl_tpu_torch.training.step import StepConfig, make_classification_train_step

    rng = np.random.default_rng(0)
    audio = torch.from_numpy((rng.standard_normal((2, 16, 8000)) * 0.1).astype(np.float32)).to(cuda)
    labels = torch.from_numpy(rng.integers(0, 4, (2, 16))).to(cuda)
    bank = torch.from_numpy((rng.standard_normal((4, 9000)) * 0.05).astype(np.float32)).to(cuda)
    cfg = StepConfig(FrontendConfig(n_mels=40), 2.05, 1.0, augment=aug.AugmentConfig(), replace_prob=0.2,
                     negative_label=3, use_deltas=False)
    opt = dict(learning_rate=0.01, lr_decay=0.99, steps_per_epoch=100)
    states = create_seed_states(create_model("res8", num_labels=4), [0, 1], device=cuda, **opt)
    singles = [create_seed_states(create_model("res8", num_labels=4), [s], device=cuda, **opt)[0] for s in (0, 1)]
    sweep = make_seed_sweep_step(make_classification_train_step(create_model("res8", num_labels=4), cfg, bank))
    single = make_classification_train_step(create_model("res8", num_labels=4), cfg, bank)
    with exact_float32():
        for step in range(2):
            before = mix_noise_bank_cuda.launches
            states, metrics = sweep(states, audio, labels, None, [0, 1])
            torch.cuda.synchronize()
            assert mix_noise_bank_cuda.launches == before + 1
            assert bool(torch.isfinite(metrics["loss"]).all())
            if step == 0:
                for s in (0, 1):
                    singles[s], m = single(singles[s], audio[s], labels[s], None, s)
                    assert abs(float(metrics["loss"][s]) - float(m["loss"])) <= 1e-6 * abs(float(m["loss"]))
                    got, want = states[s].model.state_dict(), singles[s].model.state_dict()
                    assert all(float((got[k].float() - want[k].float()).abs().max()) <= 2 * 0.01 + 1e-6 for k in got)


# ---- GSC pretraining and the dataset pipeline ----

# tests/test_torch_train_run.py's LOSS_RTOL: the card's float32 convolutions sum in another order than the CPU's, and
# AdamW's first update turns a gradient at float32 noise into +-lr, so a few steps' losses drift by up to ~2e-3
TRAIN_LOSS_RTOL = 5e-3


def _train_env(monkeypatch, env: dict) -> None:
    from howl_tpu_torch.settings import SETTINGS

    for k, v in env.items():
        monkeypatch.setenv(k, v)
    SETTINGS.reset()


def _metric(ws, name: str) -> list:
    import json

    return [r["value"] for r in map(json.loads, (ws / "metrics.jsonl").read_text().splitlines()) if r["name"] == name]


def test_gsc_pretraining_on_cuda_matches_cpu(cuda, tmp_path, monkeypatch):
    """``pretrain_gsc --no-augment``, one epoch of 3 steps, on the card and on
    the CPU from the same initial weights (both from the run's seed): losses
    within TRAIN_LOSS_RTOL, dev and test accuracies equal; on the card K1 and
    K3 never launch (plain features, no noise bank) and K2 once an eval batch."""
    from chip_smoke import write_gsc_corpus
    from howl_tpu_torch.settings import SETTINGS
    from howl_tpu_torch.training.run import pretrain_gsc, train

    words = ("yes", "no", "up", "down")
    corpus = write_gsc_corpus(tmp_path / "gsc", words=words, n_per_word=10)
    _train_env(monkeypatch, {"DATASET_PATH": str(corpus), "VOCAB": str(list(words)).replace("'", '"'),
                             "BATCH_SIZE": "8", "LEARNING_RATE": "0.001", "MAX_WINDOW_SIZE_SECONDS": "1.0",
                             "NUM_MELS": "40", "NUM_EPOCHS": "1"})
    out, stats = {}, {}
    try:
        for dev in ("cpu", "cuda"):
            stats[dev] = train.LoopStats()
            k1, k2, k3 = log_mel_spectrogram_cuda.launches, res8_stem_cuda.launches, mix_noise_bank_cuda.launches
            out[dev] = pretrain_gsc.run(["--model", "res8", "--num-labels", "5", "--no-augment", "--workspace",
                                         str(tmp_path / dev), "--device", dev], stats[dev])
            torch.cuda.synchronize()
            launched = (log_mel_spectrogram_cuda.launches - k1, res8_stem_cuda.launches - k2,
                        mix_noise_bank_cuda.launches - k3)
            assert launched == ((0, stats[dev].eval_batches, 0) if dev == "cuda" else (0, 0, 0))
    finally:
        SETTINGS.reset()
    assert stats["cuda"].steps == stats["cpu"].steps == 3 and stats["cuda"].eval_batches == 2
    np.testing.assert_allclose(stats["cuda"].step_losses, stats["cpu"].step_losses, rtol=TRAIN_LOSS_RTOL)
    np.testing.assert_allclose(_metric(tmp_path / "cuda", "Training/Loss"), _metric(tmp_path / "cpu", "Training/Loss"),
                               rtol=TRAIN_LOSS_RTOL)
    assert out["cuda"] == out["cpu"]


def test_etl_stitched_dataset_training_on_cuda_launches_the_mix_kernel_once_a_step(cuda, tmp_path, monkeypatch):
    """``generate_dataset.sh``'s three steps through the port on a Common
    Voice-layout tone corpus, then res8 trained on the card on the positive
    set and its stitched set (``--use-stitched-datasets``) with a noise
    corpus: K3 once a train step, K1 and K2 once an evaluator batch."""
    import random

    from chip_smoke import write_cv_corpus, write_noise_dir
    from howl_tpu_torch.settings import SETTINGS
    from howl_tpu_torch.training.run import attach_alignment, generate_raw_audio_dataset, stitch_vocab_samples, train

    cv = write_cv_corpus(tmp_path / "cv", 36)
    _train_env(monkeypatch, {"VOCAB": '["hey","fire","fox"]', "INFERENCE_SEQUENCE": "[0,1,2]", "BATCH_SIZE": "8",
                             "MAX_WINDOW_SIZE_SECONDS": "0.5", "NUM_MELS": "40", "NUM_EPOCHS": "2",
                             "USE_NOISE_DATASET": "true", "NOISE_DATASET_PATH": str(write_noise_dir(tmp_path / "bg", 4))})
    try:
        generate_raw_audio_dataset.run(["-i", str(cv), "-o", str(tmp_path / "datasets")])
        positive = tmp_path / "datasets" / "hey_fire_fox" / "positive"
        attach_alignment.run(["-i", str(positive), "--alignment-type", "stub"])
        random.seed(0)
        stitch_vocab_samples.run(["-i", str(positive), "--max-num-training-samples", "16", "--max-num-dev-samples", "4",
                                  "--max-num-test-samples", "4", "--disable-detect-keyword"])
        stats = train.LoopStats()
        counters = (mix_noise_bank_cuda, log_mel_spectrogram_cuda, res8_stem_cuda)
        before = [fn.launches for fn in counters]
        results = train.run(["--model", "res8", "--workspace", str(tmp_path / "ws"), "-i", str(positive),
                             "--use-stitched-datasets", "--eval-freq", "0", "--steps-per-epoch", "3", "--device", "cuda"],
                            stats)
        torch.cuda.synchronize()
    finally:
        SETTINGS.reset()
    k3, k1, k2 = (fn.launches - b for fn, b in zip(counters, before))
    assert stats.steps == 6 and k3 == stats.steps
    assert k1 == k2 == stats.eval_batches > 0
    assert np.isfinite(stats.epoch_losses).all() and "test_noisy_pos" in results


# ---- vision pretraining's stem geometry and the streams sharded on one card ----


@pytest.mark.parametrize("b", [1, 32, 512])
@pytest.mark.parametrize("route,dtype", [("fma", torch.float32), ("fma", torch.bfloat16), ("tc", torch.bfloat16)])
def test_stem_kernel_at_32_mel_rows(cuda, b, route, dtype):
    """K2 on (B, 32, 32) images as mels, the geometry of vision pretraining's
    eval step (``training/run/pretrain.py``): "fma" in float32 (the route
    the float32 eval takes) and both routes in bf16, against
    ``res8_stem_plain``."""
    mel, taps = _stem_operands(cuda, b, 32, n_mels=32, dtype=dtype)
    taps = taps if dtype == torch.bfloat16 else taps.float()
    got = res8_stem_cuda(mel, taps, route=route)
    ref = res8_stem_plain(mel, taps)
    assert tuple(got.shape) == (b, 10, 8, 45) and got.dtype == dtype
    assert stem_route(torch.float32, 32, 45) == "fma" and stem_route(torch.bfloat16, 32, 45) == "tc"
    tol = _bf16_ulp(ref) if dtype == torch.bfloat16 else 1e-5
    assert float((got.float() - ref.float()).abs().max()) <= tol


def test_online_engine_sharded_two_ways_on_one_card(cuda):
    """``OnlineEngine.shard_streams(make_mesh(data=2, devices=[cuda:0,
    cuda:0]))``: each shard launches K1 and K2 once a hop, and the decisions
    and smoothing rings are the unsharded engine's."""
    from howl_tpu_torch.inference import EngineConfig
    from howl_tpu_torch.inference.online import OnlineEngine
    from howl_tpu_torch.models import create_model
    from howl_tpu_torch.parallel.mesh import make_mesh

    model = create_model("res8", num_labels=3)
    state_dict = model.init_weights(torch.Generator().manual_seed(0)).state_dict()
    cfg = EngineConfig(inference_sequence=(0, 1), max_window_size_ms=500.0, eval_stride_size_ms=62.5,
                       negative_label=2, num_labels=3)
    make = lambda: OnlineEngine(model, state_dict, cfg, FrontendConfig(n_mels=40), num_streams=64,  # noqa: E731
                                device=cuda)
    base, sharded = make(), make().shard_streams(make_mesh(data=2, devices=[cuda, cuda]))
    rng = np.random.default_rng(5)
    audio = torch.from_numpy((rng.standard_normal((64, 8000 + 1000 * 8)) * 0.1).astype(np.float32)).to(cuda)
    for j in range(9):
        window = audio[:, j * 1000 : j * 1000 + 8000]
        log_mel_spectrogram_cuda.launches = res8_stem_cuda.launches = 0
        fired = sharded.ingest(window)
        torch.cuda.synchronize()
        assert (log_mel_spectrogram_cuda.launches, res8_stem_cuda.launches) == (2, 2)
        assert base.ingest(window) == fired
        np.testing.assert_array_equal(base.last_fired, sharded.last_fired)
        np.testing.assert_array_equal(base.last_labels, sharded.last_labels)
    torch.testing.assert_close(sharded.state.pred_ring, base.state.pred_ring, atol=1e-5, rtol=0)


# ---- F18: profiler sessions in one process; the seed sweep on a (seed, data) grid of one card ----


def test_profiler_two_sessions_after_a_long_one_both_name_k1(cuda, tmp_path):
    """F18: after a profiler session of 60,000 launches in this process (after
    which PyTorch's profiler drops a later session's first device record),
    two ``utils.profiling.trace`` sessions one after the other, each around
    one K1 launch, each record K1's kernel, in ``key_averages`` and in the
    Chrome trace each writes to a file of its own; the primer took the
    loss."""
    from howl_tpu_torch.utils.profiling import PRIMER_LAUNCHES, trace

    audio = torch.randn((8, 16000), generator=torch.Generator(device=cuda).manual_seed(0), device=cuda) * 0.1
    cfg = FrontendConfig(n_mels=40)
    log_mel_spectrogram_cuda(audio, cfg)
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities):
        x = torch.zeros(16, device=cuda)
        for _ in range(60000):
            x.add_(1.0)
        torch.cuda.synchronize()
    paths = []
    for _ in range(2):
        with trace(tmp_path) as prof:
            log_mel_spectrogram_cuda(audio, cfg)
        names = [e.key for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
        assert any("logmel" in n for n in names), names
        assert "logmel" in prof.trace_path.read_text()
        assert 0 <= prof.lost_at_start < PRIMER_LAUNCHES
        paths.append(prof.trace_path)
    assert paths[0] != paths[1]


def test_seed_grid_on_one_card_matches_the_one_process_sweep(cuda):
    """One augmented sweep step of two seeds on a (seed 2, data 2) grid of
    four ranks sharing the card over gloo: each rank launches K3 once over
    its rows, and each seed's loss is the one-process sweep's on the card
    within 1e-5 relative, its weights within ``tests/test_torch_scaleout.py``'s
    tolerances (its ``_assert_state_close``, which this file cannot import)."""
    import sys
    from pathlib import Path

    from howl_tpu_torch.compat import numpy_variables
    from howl_tpu_torch.training.step import StepConfig

    # the spawned ranks import the helper by this name, from the path the parent's interpreter holds (another
    # installed package may be named ``tests``)
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import torch_scaleout as helpers

    rng = np.random.default_rng(5)
    variables = [numpy_variables("res8", 4, np.random.default_rng(s)) for s in (31, 32)]
    audio = (rng.standard_normal((2, 8, 8000)) * 0.1).astype(np.float32)
    labels = rng.integers(0, 4, (2, 8)).astype(np.int32)
    bank = (rng.standard_normal((3, 9000)) * 0.05).astype(np.float32)
    cfg = StepConfig(FrontendConfig(n_mels=40), 2.05, 1.0, augment=aug.AugmentConfig(), negative_label=3,
                     use_deltas=False, replace_prob=0.3)
    case = (cfg, audio, labels, bank, None)
    before = mix_noise_bank_cuda.launches
    one_losses, one_after = helpers.sweep_step(variables, *case, device=cuda)
    assert mix_noise_bank_cuda.launches == before + 1  # both seeds' rows in one launch
    grid = helpers.spawn_ranks(helpers.card_grid_rank, 4, variables, case)
    for rank, ((losses, after), launches) in grid.items():
        s = rank // 2
        assert launches == 1
        np.testing.assert_allclose(losses[0], one_losses[s], rtol=1e-5)
        for k, want in one_after[s].items():
            if k.endswith("num_batches_tracked"):
                continue
            tol = dict(rtol=2e-4, atol=1e-6) if k.startswith("bn") else dict(rtol=1e-3, atol=1e-5)
            np.testing.assert_allclose(after[0][k], want, err_msg=k, **tol)
