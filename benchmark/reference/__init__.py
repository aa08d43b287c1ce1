"""The plain reference that decides a cell's ``correct``.

float32 PyTorch with TF32 off, written from the published descriptions
(howl's Res8 and MobileNetV2, torchaudio's HTK mel spectrogram, howl's
smoothing and sequence FSM), with each departure noted where it is made. It
imports nothing of the program under test and nothing of JAX: it reads the
weights and the audio that the benchmark made and hands to both sides.

``lower`` holds the controls: the same reference one precision step below the
configuration's (fp8 for a bf16 path, int4 for an int8 trunk).
"""

import contextlib

import torch


@contextlib.contextmanager
def exact_float32():
    """float32 products and convolutions without TF32, whatever the caller set."""
    matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = matmul, cudnn
