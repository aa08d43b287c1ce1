"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: they need a CUDA device and nvcc, and skip with a reason
elsewhere. This file imports neither jax nor howl_tpu, so it runs where jax is
not installed; the repo's conftest.py imports jax, so run it without:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -p no:cacheprovider

Shapes are small and cover geometries the main path does not use (80 mels,
n_fft 400 / hop 160, center=False, a ragged last frame tile). Tolerances are
tests/test_torch_frontend.py's and tests/test_torch_stem.py's.
"""

import numpy as np
import pytest
import torch

from howl_tpu_torch.ops.frontend import FrontendConfig, round_bf16
from howl_tpu_torch.ops.frontend_cuda import log_mel_spectrogram_cuda, log_mel_spectrogram_plain
from howl_tpu_torch.ops.stem_cuda import res8_stem_cuda, res8_stem_plain

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


@pytest.mark.parametrize(
    "kw,samples",
    [({"n_mels": 40}, 16000), ({"n_mels": 80}, 12345), ({"n_mels": 40, "n_fft": 400, "hop_length": 160}, 9000),
     ({"n_mels": 40, "center": False}, 20000)],
)
@pytest.mark.parametrize("grade", ["f32", "bf16x2", "bf16"])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["tm", "fm"])
def test_frontend_kernel_matches_plain(cuda, kw, samples, grade, out_dtype, layout):
    gen = torch.Generator(device=cuda).manual_seed(samples)
    audio = torch.randn((3, samples), generator=gen, device=cuda) * 0.1
    cfg = FrontendConfig(**kw)
    mean, std = -3.0, 2.5
    args = dict(precision=grade, out_dtype=out_dtype, layout=layout)
    before = log_mel_spectrogram_cuda.launches
    got = log_mel_spectrogram_cuda(audio, cfg, mean, std, **args)
    want = log_mel_spectrogram_plain(audio, cfg, mean, std, **args)
    torch.cuda.synchronize()
    assert log_mel_spectrogram_cuda.launches == before + 1
    assert got.shape == want.shape and got.dtype == want.dtype
    atol = (1e-3 if grade == "f32" else 2e-2) / std
    if out_dtype == torch.bfloat16:
        atol += _bf16_ulp(want)
    assert float((got.float() - want.float()).abs().max()) <= atol


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


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    with pytest.raises(ValueError, match="contiguous"):
        log_mel_spectrogram_cuda(torch.zeros((4000, 2), device=cuda).t())
    with pytest.raises(TypeError, match="float32"):
        log_mel_spectrogram_cuda(torch.zeros((1, 4000), device=cuda, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="taps on"):
        res8_stem_cuda(torch.zeros((1, 9, 40), device=cuda), torch.zeros((3, 3, 45)))


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
