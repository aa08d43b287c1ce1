"""The port's host-side modules against their howl_tpu originals on the
fixtures: settings, utils (hashing, wav I/O, resampling, TensorBoard
events, worker pools), the data model (vocab, tokenizer, metadata, labeler,
searcher, context), datasets and loaders, the batchifier, the noise-bank
sampler, ``ConfusionMatrix`` and both ``from_settings`` constructors.

These modules are numpy and stdlib, restated in ``howl_tpu_torch`` so the
port imports nothing of the JAX package. Every comparison is exact: equal
values, equal arrays bit for bit, equal bytes.
"""

import dataclasses
import json
import random
import struct

import numpy as np
import pytest

import howl_tpu.data.common.metadata as j_meta
import howl_tpu.data.common.phone as j_phone
import howl_tpu.data.common.vocab as j_vocab
import howl_tpu.data.noise_bank as j_noise
import howl_tpu.data.transform.batchifier as j_batch
import howl_tpu.utils.args_utils as j_args
import howl_tpu.utils.audio_utils as j_audio
import howl_tpu.utils.hash_utils as j_hash
import howl_tpu.utils.parallel as j_parallel
import howl_tpu.utils.tb_events as j_tb
import howl_tpu_torch.data.common.labeler as t_labeler
import howl_tpu_torch.data.common.metadata as t_meta
import howl_tpu_torch.data.common.phone as t_phone
import howl_tpu_torch.data.common.vocab as t_vocab
import howl_tpu_torch.data.noise_bank as t_noise
import howl_tpu_torch.data.transform.batchifier as t_batch
import howl_tpu_torch.utils.args_utils as t_args
import howl_tpu_torch.utils.audio_utils as t_audio
import howl_tpu_torch.utils.hash_utils as t_hash
import howl_tpu_torch.utils.parallel as t_parallel
import howl_tpu_torch.utils.tb_events as t_tb
from howl_tpu.context import InferenceContext as JContext
from howl_tpu.data.dataset.dataset_loader import RecursiveNoiseDatasetLoader as JNoiseLoader
from howl_tpu.data.dataset.dataset_loader import WakeWordDatasetLoader as JLoader
from howl_tpu.inference.config import EngineConfig as JEngineConfig
from howl_tpu.models.metric import ConfusionMatrix as JConf
from howl_tpu.ops.frontend import FrontendConfig as JFrontendConfig
from howl_tpu.settings import SETTINGS as J_SETTINGS
from howl_tpu_torch.context import InferenceContext as TContext
from howl_tpu_torch.data.dataset.dataset_loader import RecursiveNoiseDatasetLoader as TNoiseLoader
from howl_tpu_torch.data.dataset.dataset_loader import WakeWordDatasetLoader as TLoader
from howl_tpu_torch.inference.config import EngineConfig as TEngineConfig
from howl_tpu_torch.models.metric import ConfusionMatrix as TConf
from howl_tpu_torch.ops.frontend import FrontendConfig as TFrontendConfig
from howl_tpu_torch.settings import SETTINGS as T_SETTINGS
from howl_tpu_torch.utils.random_utils import set_random_seed
from tests.fixtures import make_noise_dir, make_wakeword_corpus

RECIPE = {  # envs/res8.env with the noise corpus on
    "WEIGHT_DECAY": "0.00001", "NUM_EPOCHS": "70", "LEARNING_RATE": "0.01", "LR_DECAY": "0.955",
    "BATCH_SIZE": "16", "MAX_WINDOW_SIZE_SECONDS": "0.5", "USE_NOISE_DATASET": "True", "NUM_MELS": "40",
    "INFERENCE_SEQUENCE": "[0,1,2]", "VOCAB": '["hey","fire","fox"]',
}
PHONES = "hey HH EY1\nfire F AY1 ER0\nfox F AA1 K S\nsomething S AH1 M TH IH0 NG\nelse EH1 L S\nentirely EH0 N T AY1 ER0 L IY0\n"


@pytest.fixture(autouse=True)
def _reset_port_settings():
    T_SETTINGS.reset()
    yield
    T_SETTINGS.reset()


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("host")
    return make_wakeword_corpus(root / "ww", n_positive=8, n_negative=8), make_noise_dir(root / "noise", n=6)


def _set_env(monkeypatch, env: dict):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    J_SETTINGS.reset()
    T_SETTINGS.reset()


# ---- settings ----


@pytest.mark.parametrize("env", [{}, RECIPE, {"DEVICE": "cpu", "USE_MEYDA_SPECTROGRAM": "yes", "VOCAB": "hey,fire"}],
                         ids=["defaults", "res8-recipe", "cpu-meyda-bare-list"])
def test_settings_read_the_same_environment(monkeypatch, env):
    _set_env(monkeypatch, env)
    want, got = J_SETTINGS.to_dict(), T_SETTINGS.to_dict()
    # the one default that differs: the device the package trains on
    if "DEVICE" not in env:
        assert (want["training"].pop("device"), got["training"].pop("device")) == ("tpu", "cuda")
    assert got == want


def test_settings_scoped_reset_and_load_dict(monkeypatch):
    _set_env(monkeypatch, RECIPE)
    with T_SETTINGS.scoped(training={"seed": 3, "num_epochs": 2}):
        assert (T_SETTINGS.training.seed, T_SETTINGS.training.num_epochs, T_SETTINGS.training.batch_size) == (3, 2, 16)
    assert (T_SETTINGS.training.seed, T_SETTINGS.training.num_epochs) == (0, 70)
    with pytest.raises(KeyError):
        with T_SETTINGS.scoped(nope={}):
            pass
    snapshot = T_SETTINGS.to_dict()
    monkeypatch.setenv("NUM_MELS", "80")
    T_SETTINGS.reset()
    assert T_SETTINGS.audio_transform.num_mels == 80
    T_SETTINGS.load_dict(snapshot)
    assert T_SETTINGS.to_dict() == snapshot and T_SETTINGS.audio_transform.num_mels == 40


# ---- utils ----


def test_hash_splits_equal():
    paths = [f"audio/clip_{i:04d}.wav" for i in range(500)]
    assert [t_hash.sha256_int(p) for p in paths] == [j_hash.sha256_int(p) for p in paths]
    for pct in (0, 20, 50, 80, 100):
        meta = [t_meta.AudioClipMetadata(path=p) for p in paths]
        assert [t_hash.Sha256Splitter(pct)(m) for m in meta] == [j_hash.Sha256Splitter(pct)(m) for m in meta]


@pytest.mark.parametrize("channels", [1, 2])
def test_wav_write_read_resample_equal(tmp_path, channels):
    rng = np.random.default_rng(channels)
    audio = (0.3 * rng.standard_normal((channels, 12345))).astype(np.float32)
    t_audio.write_wav(tmp_path / "t.wav", audio[0] if channels == 1 else audio, 16000)
    j_audio.write_wav(tmp_path / "j.wav", audio[0] if channels == 1 else audio, 16000)
    assert (tmp_path / "t.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()
    got, sr = t_audio.read_wav(tmp_path / "t.wav")
    want, _ = j_audio.read_wav(tmp_path / "t.wav")
    assert sr == 16000 and np.array_equal(got, want) and got.shape == (channels, 12345)
    for target in (8000, 16000, 22050):
        assert np.array_equal(t_audio.resample(got, 16000, target), j_audio.resample(got, 16000, target))
        assert t_audio.wav_num_samples(tmp_path / "t.wav", target) == j_audio.wav_num_samples(tmp_path / "t.wav", target)
        for mono in (True, False):
            assert np.array_equal(t_audio.silent_load(tmp_path / "t.wav", target, mono),
                                  j_audio.silent_load(tmp_path / "t.wav", target, mono))
    assert t_audio.silent_load(tmp_path / "missing.wav", 16000).shape == (0,)
    trimmed = np.concatenate([np.zeros(4000, np.float32), audio[0], np.zeros(3000, np.float32)])
    assert np.array_equal(t_audio.trim_silence(trimmed), j_audio.trim_silence(trimmed))
    assert all(np.array_equal(a, b) for a, b in zip(t_audio.stride(audio[0], 500, 62.5, 16000),
                                                     j_audio.stride(audio[0], 500, 62.5, 16000), strict=True))
    assert t_audio.frame_count(12345, 512, 200) == j_audio.frame_count(12345, 512, 200)


def test_tensorboard_events_cross_read(tmp_path):
    assert t_tb.crc32c(b"howl") == j_tb.crc32c(b"howl")
    writer = t_tb.EventFileWriter(tmp_path / "logs")
    for step, value in enumerate((1.5, -2.25, 3.0e-4)):
        writer.add_scalar("Training/Loss", value, step)
    writer.close()
    (path,) = (tmp_path / "logs").iterdir()
    got = j_tb.read_scalars(path)
    assert got == t_tb.read_scalars(path)
    assert [(s, tag) for s, tag, _ in got] == [(0, "Training/Loss"), (1, "Training/Loss"), (2, "Training/Loss")]
    assert [v for _, _, v in got] == [struct.unpack("<f", struct.pack("<f", v))[0] for v in (1.5, -2.25, 3.0e-4)]


def test_args_registry_and_parallel_map():
    for s in ("y", "Yes", "on", "1", "n", "OFF", "0", "False"):
        assert t_args.strtobool(s) == j_args.strtobool(s)
    with pytest.raises(ValueError):
        t_args.strtobool("maybe")
    parser = t_args.ArgumentParserBuilder().add_options(t_args.opt("--x", type=int, default=3)).build()
    assert parser.parse_args(["--x", "5"]).x == 5
    import howl_tpu.data.dataset.common_voice_loader  # noqa: F401  (each loader module registers its names)
    import howl_tpu.data.dataset.hey_snips_loader  # noqa: F401
    import howl_tpu_torch.data.dataset.common_voice_loader  # noqa: F401
    import howl_tpu_torch.data.dataset.hey_snips_loader  # noqa: F401
    from howl_tpu.data.dataset.dataset_loader import RegisteredPathDatasetLoader as JRegistered
    from howl_tpu_torch.data.dataset.dataset_loader import RegisteredPathDatasetLoader, WakeWordDatasetLoader

    assert RegisteredPathDatasetLoader.find_registered_class("wake-word") is WakeWordDatasetLoader
    assert RegisteredPathDatasetLoader.registered_names() == JRegistered.registered_names() == [
        "clip", "gsc", "hey-snips", "mozilla-cv", "mozilla-kw", "mozilla-ww", "wake-word"]
    items = list(range(37))
    for workers in (1, 4):
        assert t_parallel.parallel_map(lambda x: x * x, items, num_workers=workers) == \
            j_parallel.parallel_map(lambda x: x * x, items, num_workers=workers)
    with pytest.raises(ValueError):
        t_parallel.parallel_map(abs, items, num_workers=2, mode="fork")


# ---- data model: vocab, tokenizer, metadata, labeler, searcher, context ----


def test_vocab_phone_and_metadata_equal(tmp_path):
    words = ["hey", "fire", "fox"]
    tv, jv = t_vocab.Vocab(words, oov_token_id=3), j_vocab.Vocab(words, oov_token_id=3)
    for item in ("hey", "FIRE", "nope", 0, 2, 7):
        assert tv[item] == jv[item]
    for word in ("fireman", "fox", "he", "heyfox"):
        assert tv.trie.max_split(word) == jv.trie.max_split(word)
    (tmp_path / "dict.txt").write_text(";; comment\n" + PHONES)
    td = t_phone.PronunciationDictionary.from_file(tmp_path / "dict.txt")
    jd = j_phone.PronunciationDictionary.from_file(tmp_path / "dict.txt")
    assert {w: [str(p) for p in v] for w, v in td.word2phone.items()} == \
        {w: [str(p) for p in v] for w, v in jd.word2phone.items()}
    phrase = "sil hh ey sp f ay er f aa k s sil"
    tp, jp = t_phone.PhonePhrase.from_string(phrase), j_phone.PhonePhrase.from_string(phrase)
    query = t_phone.PhonePhrase.from_string("f aa k s")
    assert tp.audible_index(query) == jp.audible_index(j_phone.PhonePhrase.from_string("f aa k s")) == 5
    assert [tp.audible_idx_to_all_idx(i) for i in range(8)] == [jp.audible_idx_to_all_idx(i) for i in range(8)]
    line = json.dumps({"path": "a/b.wav", "transcription": "hey fire", "end_timestamps": [1.0, 2.0], "speaker": "x"})
    tm, jm = t_meta.AudioClipMetadata.from_json(line), j_meta.AudioClipMetadata.from_json(line)
    assert tm.to_json() == jm.to_json() and tm.audio_id == jm.audio_id == "b" and tm.extra == {"speaker": "x"}


@pytest.mark.parametrize("token_type", ["word", "phone"])
def test_context_labels_and_searcher_equal(tmp_path, corpus, token_type):
    ww, _ = corpus
    (tmp_path / "dict.txt").write_text(PHONES)
    kw = dict(vocab=["hey", "fire", "fox"], token_type=token_type,
              phone_dictionary_path=str(tmp_path / "dict.txt") if token_type == "phone" else None)
    tc, jc = TContext(**kw), JContext(**kw)
    assert (tc.num_labels, tc.negative_label, tc.blank_label, tc.adjusted_vocab, tc.wake_word) == \
        (jc.num_labels, jc.negative_label, jc.blank_label, jc.adjusted_vocab, jc.wake_word)
    if token_type == "phone":
        assert tc.coloring.color_map == jc.coloring.color_map
    transcripts = ["hey fire fox", "fire hey fox", "hey hey fire fox fox", "something else entirely", "hey fire",
                   "sil hh ey1 f ay1 er0 f aa1 k s sil", "f aa1 k s hh ey1"]
    assert [tc.searcher.search(t) for t in transcripts] == [jc.searcher.search(t) for t in transcripts]
    assert [tc.searcher.contains_any(t) for t in transcripts] == [jc.searcher.contains_any(t) for t in transcripts]
    for split in ("training", "dev", "test"):
        for line in (ww / f"aligned-metadata-{split}.jsonl").read_text().splitlines():
            got = tc.labeler.compute_frame_labels(t_meta.AudioClipMetadata.from_json(line))
            want = jc.labeler.compute_frame_labels(j_meta.AudioClipMetadata.from_json(line))
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
    if token_type == "word":
        bad = t_meta.AudioClipMetadata(path="x.wav", transcription="hey fire", end_timestamps=[1.0])
        with pytest.raises(ValueError, match="end_timestamps"):
            t_labeler.WordFrameLabeler(tc.vocab).compute_frame_labels(bad)


# ---- datasets, the batchifier, the noise bank ----


def _splits(loader, ctx, ww):
    kwargs = dict(sample_rate=16000, mono=True, frame_labeler=ctx.labeler)
    return loader.load_splits(ww, **kwargs)


def test_dataset_splits_in_order(corpus):
    ww, noise = corpus
    tc, jc = TContext(vocab=["hey", "fire", "fox"]), JContext(vocab=["hey", "fire", "fox"])
    for got, want in zip(_splits(TLoader(), tc, ww), _splits(JLoader(), jc, ww), strict=True):
        assert [m.to_json() for m in got.metadata_list] == [m.to_json() for m in want.metadata_list]
        assert got.dataset_split.value == want.dataset_split.value
        for clone in (True, False):
            pos = got.filter(lambda m: tc.searcher.search(m.transcription), clone=True)
            jpos = want.filter(lambda m: jc.searcher.search(m.transcription), clone=True)
            assert [m.path for m in pos.metadata_list] == [m.path for m in jpos.metadata_list]
        for i in range(len(got)):
            a, b = got[i], want[i]
            assert np.array_equal(a.audio_data, b.audio_data)
            assert dataclasses.asdict(a.label_data) == dataclasses.asdict(b.label_data)
    tn, jn = TNoiseLoader().load(noise, sample_rate=16000, mono=True), JNoiseLoader().load(noise, sample_rate=16000, mono=True)
    assert [m.path for m in tn.metadata_list] == [m.path for m in jn.metadata_list]
    for pct in (50, 80):
        for a, b in zip(tn.split(t_hash.Sha256Splitter(pct)), jn.split(j_hash.Sha256Splitter(pct)), strict=True):
            assert [m.path for m in a.metadata_list] == [m.path for m in b.metadata_list]
    with pytest.raises(FileNotFoundError):
        TLoader().load_splits(ww, prefix="stitched-")


@pytest.mark.parametrize("context_samples", [0, 4000])
def test_batchifier_windows_and_labels_equal_under_one_seed(corpus, context_samples):
    ww, _ = corpus
    tc, jc = TContext(vocab=["hey", "fire", "fox"]), JContext(vocab=["hey", "fire", "fox"])
    train_t, train_j = _splits(TLoader(), tc, ww)[0], _splits(JLoader(), jc, ww)[0]
    samples_t = [train_t[i] for i in range(len(train_t))] * 3
    samples_j = [train_j[i] for i in range(len(train_j))] * 3
    out = []
    for module, ctx, samples in ((t_batch, tc, samples_t), (j_batch, jc, samples_j)):
        set_random_seed(7)
        b = module.WakeWordFrameBatchifier(ctx.negative_label, window_size_ms=500, context_samples=context_samples)
        out.append([b(samples[i : i + 8]) for i in range(0, len(samples), 8)] + [random.random()])
    (*got, tail_t), (*want, tail_j) = out
    assert tail_t == tail_j  # both drew the same count from Python's random
    for g, w in zip(got, want, strict=True):
        assert np.array_equal(g.audio_data, w.audio_data) and g.audio_data.shape[1] == 8000 + 2 * context_samples
        assert np.array_equal(g.labels, w.labels) and np.array_equal(g.lengths, w.lengths)
    labels = np.concatenate([g.labels for g in got])
    assert set(labels) > {tc.negative_label}  # windows of both kinds were cut


def test_sequence_batchifier_and_classification_sampler_equal(corpus):
    """The batchifier file's other two samplers: CTC's full-utterance batches
    and the shuffled classification batches."""
    from howl_tpu.data.common.tokenizer import WakeWordTokenizer as JTok
    from howl_tpu.data.dataset.dataset import AudioClassificationDataset as JCls
    from howl_tpu_torch.data.common.tokenizer import WakeWordTokenizer as TTok
    from howl_tpu_torch.data.dataset.dataset import AudioClassificationDataset as TCls

    ww, _ = corpus
    tc, jc = TContext(vocab=["hey", "fire", "fox"]), JContext(vocab=["hey", "fire", "fox"])
    train_t, train_j = _splits(TLoader(), tc, ww)[0], _splits(JLoader(), jc, ww)[0]
    for max_audio, max_labels in ((None, 64), (20000, 2)):
        got = t_batch.AudioSequenceBatchifier(tc.negative_label, TTok(tc.vocab, ignore_oov=False), max_audio_samples=max_audio,
                                              max_label_length=max_labels)([train_t[i] for i in range(len(train_t))])
        want = j_batch.AudioSequenceBatchifier(jc.negative_label, JTok(jc.vocab, ignore_oov=False), max_audio_samples=max_audio,
                                               max_label_length=max_labels)([train_j[i] for i in range(len(train_j))])
        for field in ("audio_data", "labels", "audio_lengths", "label_lengths"):
            assert np.array_equal(getattr(got, field), getattr(want, field)), field
    label_map = {"hey fire fox": 0, "__default__": 1}
    kw = dict(sample_rate=16000, mono=True, label_map=label_map, silence_proportion=0.25)
    tds = TCls([m for m in train_t.metadata_list], **kw)
    jds = JCls([m for m in train_j.metadata_list], **kw)
    for drop_last in (True, False):
        got = list(t_batch.ClassificationBatchSampler(tds, 3, 16000, drop_last=drop_last, seed=4))
        want = list(j_batch.ClassificationBatchSampler(jds, 3, 16000, drop_last=drop_last, seed=4))
        assert len(got) == len(want) == len(t_batch.ClassificationBatchSampler(tds, 3, 16000, drop_last=drop_last))
        for g, w in zip(got, want, strict=True):
            assert np.array_equal(g.audio_data, w.audio_data) and np.array_equal(g.labels, w.labels)
            assert np.array_equal(g.lengths, w.lengths) and g.valid == w.valid


def test_noise_bank_draws_bit_for_bit(corpus):
    _, noise = corpus
    tn, jn = TNoiseLoader().load(noise, sample_rate=16000, mono=True), JNoiseLoader().load(noise, sample_rate=16000, mono=True)
    assert t_noise.windows_for_budget(16.0, 8000) == j_noise.windows_for_budget(16.0, 8000) == 524
    for window, n in ((8000, 40), (64000, 5)):  # 64,000 samples is longer than each 3 s clip: rows tile
        ts, js = t_noise.NoiseBankSampler(tn, window, n, seed=3), j_noise.NoiseBankSampler(jn, window, n, seed=3)
        for refresh in (0, 1, 5):
            got, want = ts.sample(refresh), js.sample(refresh)
            assert got.dtype == np.float32 and np.array_equal(got.view(np.uint32), want.view(np.uint32))
    prefetcher = t_noise.NoiseBankPrefetcher(t_noise.NoiseBankSampler(tn, 8000, 12, seed=1))
    prefetcher.start(2)
    with pytest.raises(RuntimeError):
        prefetcher.start(3)
    assert np.array_equal(prefetcher.get(), j_noise.NoiseBankSampler(jn, 8000, 12, seed=1).sample(2))
    with pytest.raises(ValueError):
        t_noise.NoiseBankSampler(tn.filter(lambda m: False, clone=True), 8000, 4)


# ---- metrics and the configs from settings ----


def test_confusion_matrix_equal():
    rng = np.random.default_rng(0)
    preds, labels = rng.random(101) < 0.4, rng.random(101) < 0.5
    got, want = TConf(), JConf()
    got.increment_array(preds, labels)
    want.increment_array(preds, labels)
    for p, lab in zip(preds[:9], labels[:9]):
        got.increment(bool(p), bool(lab))
        want.increment(bool(p), bool(lab))
    assert vars(got) == vars(want) and str(got) == str(want)
    assert (got.mcc, got.tp_rate, got.fp_rate, got.fp_per_hour(3.6e6), got.fn_per_hour(1.8e6)) == \
        (want.mcc, want.tp_rate, want.fp_rate, want.fp_per_hour(3.6e6), want.fn_per_hour(1.8e6))
    assert TConf().mcc == 0.0 and TConf().fp_per_hour(0.0) == 0.0


@pytest.mark.parametrize("env", [RECIPE, {**RECIPE, "USE_MEYDA_SPECTROGRAM": "1", "INFERENCE_WEIGHTS": "[1.0,2.0]",
                                          "INFERENCE_THRESHOLD": "0.5", "EVAL_STRIDE_SIZE_SECONDS": "0.1"}],
                         ids=["res8-recipe", "meyda-weights"])
@pytest.mark.parametrize("token_type", ["word", "phone"])
def test_configs_from_settings_equal(monkeypatch, tmp_path, env, token_type):
    (tmp_path / "dict.txt").write_text(PHONES)
    _set_env(monkeypatch, {**env, "TOKEN_TYPE": token_type, "PHONE_DICTIONARY": str(tmp_path / "dict.txt")})
    assert dataclasses.asdict(TFrontendConfig.from_settings()) == dataclasses.asdict(JFrontendConfig.from_settings())
    kw = dict(vocab=T_SETTINGS.training.vocab, token_type=token_type)
    overrides = {"num_labels": 9} if token_type == "word" else {}
    got = TEngineConfig.from_settings(TContext(**kw), **overrides)
    want = JEngineConfig.from_settings(JContext(**kw), **overrides)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(TEngineConfig.from_settings()) == dataclasses.asdict(JEngineConfig.from_settings())
