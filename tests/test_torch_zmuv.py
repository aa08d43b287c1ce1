"""The train step's featurizer in the port vs howl_tpu: the VTLP filterbank
and log-mel chain, deltas, ZMUV (howl_tpu_torch/ops/{frontend,zmuv}.py).

Tolerances: the VTLP filterbank 1e-5 (both sides build it in float32 from
the same breakpoint algebra; only the order of float32 operations differs);
log-mel and delta features 1e-3, tests/test_torch_frontend.py's float32
bound; ZMUV's float64 host sums are exact on equal features, and its fit
over each package's own features agrees to 1e-5 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from howl_tpu.ops import frontend as jfe
from howl_tpu.ops.zmuv import ZmuvTransform as JaxZmuv
from howl_tpu.ops.zmuv import fit_zmuv as jax_fit_zmuv
from howl_tpu_torch.ops import frontend as tfe
from howl_tpu_torch.ops.zmuv import ZmuvTransform, fit_zmuv
from tests.test_golden_frontend import GOLDEN, _assert_matches_golden

torch.set_num_threads(1)


def _audio(seed, shape, scale=0.1):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("alpha", [0.9, 1.0, 1.07, 1.1])
@pytest.mark.parametrize("n_mels", [40, 80])
def test_vtlp_filterbank_matches_jax(alpha, n_mels):
    want = np.asarray(jfe.vtlp_filterbank(257, n_mels, 16000, alpha))
    got = tfe.vtlp_filterbank(257, n_mels, 16000, torch.tensor(alpha))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    assert torch.equal(got, tfe.vtlp_filterbank(257, n_mels, 16000, alpha))  # a float warp too


@pytest.mark.parametrize("alpha", [0.93, 1.0, 1.08])
@pytest.mark.parametrize("stacked", [False, True])
def test_log_mel_spectrogram_vtlp_matches_jax(alpha, stacked):
    audio = _audio(int(alpha * 100), (2, 8000))
    cfg_j, cfg_t = jfe.FrontendConfig(n_mels=40), tfe.FrontendConfig(n_mels=40)
    want = np.asarray(jfe.log_mel_spectrogram_vtlp(jnp.asarray(audio), alpha, cfg_j, stacked=stacked))
    got = tfe.log_mel_spectrogram_vtlp(torch.from_numpy(audio), torch.tensor(alpha), cfg_t, stacked=stacked)
    assert tuple(got.shape) == want.shape == ((2, 3, 40, 41) if stacked else (2, 40, 41))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3, rtol=0)


def test_stacked_log_mels_match_jax_and_the_torchaudio_golden():
    audio = np.load(GOLDEN / "frontend_input.npy")
    want = np.asarray(jfe.log_mel_spectrogram(jnp.asarray(audio), jfe.FrontendConfig(n_mels=40), stacked=True))
    got = tfe.log_mel_spectrogram(torch.from_numpy(audio), tfe.FrontendConfig(n_mels=40), stacked=True).numpy()
    # the golden clips hold near-silent stretches, where the log amplifies
    # float32 rounding: 1e-3 holds above the floor, as in the golden tests
    _assert_matches_golden(got[:, 0], want[:, 0], atol_loud=1e-3)
    gold = np.load(GOLDEN / "frontend_stacked_40.npy")
    _assert_matches_golden(got[:, 0], gold[:, 0])
    assert np.abs(got[:, 1:] - gold[:, 1:]).max() < 0.02


@pytest.mark.parametrize("t", [1, 2, 7, 41])
def test_compute_deltas_matches_jax(t):
    x = np.random.default_rng(t).standard_normal((2, 5, t)).astype(np.float32)
    want = np.asarray(jfe.compute_deltas(jnp.asarray(x)))
    got = tfe.compute_deltas(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(
        tfe.stack_deltas(torch.from_numpy(x)).numpy(), np.asarray(jfe.stack_deltas(jnp.asarray(x))), atol=1e-6
    )


def test_zmuv_update_equals_jax_exactly():
    feats = np.random.default_rng(1).standard_normal((3, 3, 40, 41)).astype(np.float32) * 4 - 6
    mask = (np.random.default_rng(2).random((3, 3, 40, 41)) < 0.7).astype(np.float32)
    ours, theirs = ZmuvTransform(), JaxZmuv()
    for f, m in ((feats, None), (feats[:2] * 0.5, mask[:2])):
        ours.update(torch.from_numpy(f), None if m is None else torch.from_numpy(m))
        theirs.update(f, m)
        assert ours.state_dict() == theirs.state_dict()
    assert ours.std == theirs.std
    x = feats[0]
    np.testing.assert_array_equal(ours(torch.from_numpy(x)).numpy(), np.asarray(theirs(jnp.asarray(x))))
    assert ZmuvTransform.from_state_dict(ours.state_dict()).state_dict() == ours.state_dict()


def test_fit_zmuv_matches_jax():
    batches = [_audio(s, (2, 8000), scale=0.2) for s in range(3)]
    ours = fit_zmuv([torch.from_numpy(b) for b in batches], tfe.FrontendConfig(n_mels=40), max_batches=2)
    theirs = jax_fit_zmuv([jnp.asarray(b) for b in batches], jfe.FrontendConfig(n_mels=40), max_batches=2)
    assert ours.total == theirs.total == 2 * 2 * 3 * 40 * 41
    np.testing.assert_allclose([ours.mean, ours.std], [theirs.mean, theirs.std], rtol=1e-5)
