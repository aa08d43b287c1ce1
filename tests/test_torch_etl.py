"""The port's dataset pipeline (``howl_tpu_torch/etl``, ``align``, the
dataset writer, factory and constants, the Common Voice, Hey Snips and
Speech Commands loaders, ``utils/keyword_detector.py`` and the three entry
points of ``generate_dataset.sh``) against howl_tpu's, on the CPU.

* ``generate_dataset.sh``'s three steps (raw mining of positives and
  negatives, stub alignment of both, stitching of the positives after the
  same ``random.seed``) through each package's entry points on
  ``tests/torch_etl.py``'s Common Voice corpus: every ``.jsonl``, ``.wav``
  and ``.lab`` file the port writes is byte for byte JAX's, sequentially and
  with ``--num-workers 2``, with the keyword validator off and on.
* MFA attachment from TextGrids the test writes (a malformed one among
  them): ``aligned-metadata-*.jsonl`` byte for byte JAX's, sequentially and
  with two worker processes.
* ``TextGrid``, ``MfaTextGridConverter`` (words, phones, one-character
  words), ``StubAligner``, ``LeftRightVadAligner`` and the energy keyword
  validator equal JAX's on tests/test_etl.py's inputs.
* ``mozilla-cv``, ``mozilla-kw``, ``mozilla-ww`` (speaker and sound splits,
  verified and rejected), ``hey-snips`` (with and without a transcriber)
  and the factory's loaders give JAX's splits; the registries hold JAX's
  names.
* The port's ``WakeWordDatasetLoader`` reads the port's stitched set, each
  sample with all three word labels; the entry points' ``--help`` runs
  without jax.
"""

import json
import random
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from howl_tpu.settings import SETTINGS as J_SETTINGS
from howl_tpu_torch.settings import SETTINGS as T_SETTINGS
from tests.fixtures import SR, tone
from tests.torch_etl import STITCH_SEED, VOCAB_ENV, make_cv_corpus, run_pipeline, tree_bytes, write_textgrid_dataset

REPO = Path(__file__).resolve().parent.parent
PACKAGES = ("howl_tpu", "howl_tpu_torch")
GRID_TEXT = '''File type = "ooTextFile"
Object class = "TextGrid"

xmin = 0
xmax = 2.0
tiers? <exists>
size = 2
item []:
    item [1]:
        class = "IntervalTier"
        name = "words"
        xmin = 0
        xmax = 2.0
        intervals: size = 4
        intervals [1]:
            xmin = 0
            xmax = 0.5
            text = ""
        intervals [2]:
            xmin = 0.5
            xmax = 1.0
            text = "hey"
        intervals [3]:
            xmin = 1.0
            xmax = 1.6
            text = "fire"
        intervals [4]:
            xmin = 1.6
            xmax = 1.7
            text = "a"
    item [2]:
        class = "IntervalTier"
        name = "phones"
        xmin = 0
        xmax = 2.0
        intervals: size = 2
        intervals [1]:
            xmin = 0.5
            xmax = 0.75
            text = "HH"
        intervals [2]:
            xmin = 0.75
            xmax = 1.0
            text = "EY1"
'''


def _mod(package: str, name: str):
    import importlib

    return importlib.import_module(f"{package}.{name}")


@pytest.fixture(autouse=True)
def _vocab_settings(monkeypatch):
    for k, v in VOCAB_ENV.items():
        monkeypatch.setenv(k, v)
    J_SETTINGS.reset()
    T_SETTINGS.reset()
    yield
    J_SETTINGS.reset()
    T_SETTINGS.reset()


@pytest.fixture(scope="module")
def cv_corpus(tmp_path_factory):
    return make_cv_corpus(tmp_path_factory.mktemp("cv") / "cv")


# ---- the whole pipeline ----


@pytest.mark.parametrize("workers,validate", [(None, False), (2, False), (None, True)],
                         ids=["sequential", "two-workers", "validated"])
def test_pipeline_writes_jaxs_bytes(cv_corpus, tmp_path, monkeypatch, workers, validate):
    if validate:  # the energy validator reads each stitched clip back and keeps it if its bursts fit the phrase
        import howl_tpu.training.run.stitch_vocab_samples as jstitch
        import howl_tpu_torch.training.run.stitch_vocab_samples as tstitch

        for mod in (jstitch, tstitch):
            real = mod.run
            monkeypatch.setattr(mod, "run", lambda argv, real=real: real([a for a in argv if a != "--disable-detect-keyword"]))
    trees = {}
    for package in PACKAGES:
        ds = run_pipeline(package, cv_corpus, tmp_path / package, num_workers=workers)
        trees[package] = tree_bytes(ds)
    jax_tree, port_tree = trees.values()
    assert sorted(port_tree) == sorted(jax_tree)
    assert [name for name in jax_tree if port_tree[name] != jax_tree[name]] == []
    kinds = {Path(name).suffix for name in port_tree}
    assert kinds == {".jsonl", ".wav", ".lab"}
    stitched = [json.loads(line) for line in port_tree["positive/stitched-metadata-training.jsonl"].decode().splitlines()]
    assert stitched and (validate or len(stitched) == 4)
    assert all(r["transcription"] == "hey fire fox" and len(r["end_timestamps"]) == len("hey fire fox") for r in stitched)
    for name in ("a1", "a3", "a4", "b1", "c1"):  # positives: any word of the vocabulary
        assert f"positive/audio/{name}.wav" in port_tree
    for name in ("a2", "a3", "a4", "b2", "c2"):  # negatives: not the whole phrase
        assert f"negative/audio/{name}.wav" in port_tree


def test_stitched_set_reads_with_all_three_word_labels(cv_corpus, tmp_path):
    from howl_tpu_torch.context import InferenceContext
    from howl_tpu_torch.data.dataset.dataset_loader import WakeWordDatasetLoader

    ds = run_pipeline("howl_tpu_torch", cv_corpus, tmp_path)
    ctx = InferenceContext(vocab=["hey", "fire", "fox"], token_type="word")
    loader = WakeWordDatasetLoader()
    train, _, _ = loader.load_splits(ds / "positive", frame_labeler=ctx.labeler)
    assert len(train) > 0 and train[0].audio_data.shape[-1] > 0
    splits = loader.load_splits(ds / "positive", prefix="stitched-", frame_labeler=ctx.labeler)
    assert [len(s) for s in splits] == [4, 2, 2]
    for split in splits:
        for i in range(len(split)):
            assert sorted(split[i].label_data.timestamp_label_map.values()) == [0, 1, 2]


def test_stitcher_draws_only_from_the_global_random(cv_corpus, tmp_path):
    """Seeded alike, the stitcher repeats itself; seeded otherwise, it picks otherwise."""
    ds = run_pipeline("howl_tpu_torch", cv_corpus, tmp_path / "a")
    again = run_pipeline("howl_tpu_torch", cv_corpus, tmp_path / "b")
    assert tree_bytes(ds) == tree_bytes(again)
    from howl_tpu_torch.training.run.stitch_vocab_samples import run as stitch

    random.seed(STITCH_SEED + 1)
    stitch(["-i", str(again / "positive"), "--max-num-training-samples", "4", "--disable-detect-keyword"])
    assert tree_bytes(ds) != tree_bytes(again)


# ---- MFA attachment ----


@pytest.mark.parametrize("workers", [None, 2], ids=["sequential", "two-processes"])
def test_mfa_attachment_writes_jaxs_metadata(tmp_path, workers):
    raw, grids = write_textgrid_dataset(tmp_path / "src")
    out = {}
    for package in PACKAGES:
        ds = tmp_path / package
        shutil.copytree(raw, ds)
        args = ["-i", str(ds), "--alignment-type", "mfa", "--alignments-path", str(grids)]
        _mod(package, "training.run.attach_alignment").run(args + ([] if workers is None else ["--num-workers", str(workers)]))
        out[package] = {f"aligned-metadata-{s}.jsonl": (ds / f"aligned-metadata-{s}.jsonl").read_bytes()
                        for s in ("training", "dev", "test")}
    assert out["howl_tpu_torch"] == out["howl_tpu"]
    recs = [json.loads(line) for line in out["howl_tpu_torch"]["aligned-metadata-training.jsonl"].decode().splitlines()]
    assert [r["transcription"] for r in recs] == ["hey fire", "hey fire"]
    assert recs[0]["end_timestamps"][2] == pytest.approx(400.0) and recs[0]["end_timestamps"][-1] == pytest.approx(900.0)


def test_textgrids_convert_in_spawned_processes_as_in_one(tmp_path):
    from howl_tpu_torch.data.common.tokenizer import TokenType
    from howl_tpu_torch.etl.aligned_generator import AlignedAudioDatasetGenerator

    _, grids = write_textgrid_dataset(tmp_path)
    one = AlignedAudioDatasetGenerator._load_mfa_alignments(grids, TokenType.WORD, num_workers=1)
    two = AlignedAudioDatasetGenerator._load_mfa_alignments(grids, TokenType.WORD, num_workers=2)
    assert sorted(one) == sorted(two) == ["clip0", "clip1"]
    assert all(one[k] == two[k] for k in one)


# ---- aligners, TextGrids, the keyword validator ----


def _aligner_outputs(package: str) -> dict:
    tg = _mod(package, "align.textgrid")
    mfa = _mod(package, "align.mfa")
    grid = tg.TextGrid.parse(GRID_TEXT)
    sample_mod, meta_mod = _mod(package, "data.common.sample"), _mod(package, "data.common.metadata")
    audio = np.concatenate([np.zeros(8000, np.float32), tone(500, 1.0, noise=0.0), np.zeros(8000, np.float32)])
    sample = sample_mod.Sample(meta_mod.AudioClipMetadata(path="x.wav", transcription="Hello There"), audio, SR)
    return {
        "tiers": {name: [(i.xmin, i.xmax, i.text) for i in grid[name]] for name in ("words", "phones")},
        "words": mfa.MfaTextGridConverter().convert(grid),
        "phones": mfa.MfaTextGridConverter(use_phones=True).convert(grid),
        "stub": _mod(package, "align.stub").StubAligner().align(sample),
        "stub_duration": _mod(package, "align.stub").StubAligner.from_duration("Hey Fire", 1234.5),
        "vad": _mod(package, "align.vad").LeftRightVadAligner().align(sample),
        "vad_silence": _mod(package, "align.vad").LeftRightVadAligner().align(
            sample_mod.Sample(meta_mod.AudioClipMetadata(path="y.wav", transcription="quiet"), np.zeros(8000, np.float32), SR)),
    }


@pytest.mark.parametrize("part", ["tiers", "words", "phones", "stub", "stub_duration", "vad", "vad_silence"])
def test_aligners_equal_jax(part):
    jax_out, port_out = _aligner_outputs("howl_tpu")[part], _aligner_outputs("howl_tpu_torch")[part]
    if part == "tiers":
        assert port_out == jax_out
        return
    assert port_out.transcription == jax_out.transcription
    assert port_out.end_timestamps == jax_out.end_timestamps
    assert len(port_out.end_timestamps) == len(port_out.transcription)


def test_mfa_converter_refuses_word_level_timestamps_as_jax():
    for package in PACKAGES:
        with pytest.raises(NotImplementedError):
            _mod(package, "align.mfa").MfaTextGridConverter(split_by_char=False)


def test_keyword_validator_equals_jax(tmp_path):
    from howl_tpu.utils import keyword_detector as jkd
    from howl_tpu.utils.audio_utils import write_wav
    from howl_tpu_torch.utils import keyword_detector as tkd

    rng = np.random.default_rng(3)
    gap = np.zeros(4000, np.float32)
    clips = {
        "three_bursts": np.concatenate([tone(400, 0.3, rng=rng), gap, tone(600, 0.3, rng=rng), gap, tone(800, 0.3, rng=rng)]),
        "silence": np.zeros(16000, np.float32),
        "noise": (0.2 * rng.standard_normal(16000)).astype(np.float32),
        "many": np.concatenate([np.concatenate([tone(500, 0.06, rng=rng), np.zeros(1200, np.float32)]) for _ in range(12)]),
    }
    for name, audio in clips.items():
        assert tkd.count_voiced_bursts(audio, SR) == jkd.count_voiced_bursts(audio, SR)
        write_wav(tmp_path / f"{name}.wav", audio, SR)
        for wakeword in ("hey fire fox", "hey"):
            assert tkd.energy_keyword_validator(tmp_path / f"{name}.wav", wakeword) == \
                jkd.energy_keyword_validator(tmp_path / f"{name}.wav", wakeword)
    assert tkd.default_keyword_validator()(tmp_path / "three_bursts.wav", "hey fire fox")
    assert not tkd.default_keyword_validator()(tmp_path / "silence.wav", "hey fire fox")


# ---- corpus loaders ----


def _splits(splits) -> list:
    return [[(str(m.path), m.transcription) for m in ds.metadata_list] for ds in splits]


def _write_kw(root: Path) -> Path:
    from howl_tpu.utils.audio_utils import write_wav

    (root / "clips").mkdir(parents=True)
    lines = ["client_id\tpath\tsentence"]
    for i in range(30):
        write_wav(root / "clips" / f"k{i}.wav", tone(440, 0.2), SR)
        lines.append(f"client{i % 11}\tk{i}.wav\tsome words {i}")
    (root / "validated.tsv").write_text("\n".join(lines) + "\n")
    return root


def _write_ww(root: Path) -> Path:
    """verified/<speaker>/<sound_id>.wav + .txt, rejected/<speaker>/<id>.wav."""
    from howl_tpu.utils.audio_utils import write_wav

    for s in range(8):
        d = root / "verified" / f"spk{s:02d}"
        d.mkdir(parents=True)
        for j in range(4):
            write_wav(d / f"clip_{s:02d}_{j}.wav", tone(300 + 40 * s, 0.2), SR)
            (d / f"clip_{s:02d}_{j}.txt").write_text("hey firefox")
    d = root / "rejected" / "spk99"
    d.mkdir(parents=True)
    for j in range(3):
        write_wav(d / f"bad_{j}.wav", tone(900, 0.2), SR)
    return root


def _write_snips(root: Path) -> Path:
    from howl_tpu.utils.audio_utils import write_wav

    (root / "audio").mkdir(parents=True)
    for i in range(4):
        write_wav(root / "audio" / f"s{i}.wav", tone(440, 0.2), SR)
    meta = [{"audio_file_path": f"audio/s{i}.wav", "is_hotword": int(i % 2 == 0)} for i in range(4)]
    for f in ("train.json", "dev.json", "test.json"):
        (root / f).write_text(json.dumps(meta))
    return root


LOADERS = {
    "mozilla-cv": ("common_voice_loader", "MozillaCommonVoiceLoader", {}, None),
    "mozilla-kw": ("common_voice_loader", "MozillaKeywordLoader", {}, _write_kw),
    "mozilla-ww-speaker": ("common_voice_loader", "SpeakerSplitMozillaWakeWordLoader", {}, _write_ww),
    "mozilla-ww-sound": ("common_voice_loader", "SoundIdSplitMozillaWakeWordLoader", {}, _write_ww),
    "mozilla-ww-rejected": ("common_voice_loader", "MozillaWakeWordLoader", {"split": "rejected"}, _write_ww),
    "hey-snips": ("hey_snips_loader", "HeySnipsWakeWordLoader", {}, _write_snips),
    "hey-snips-transcribed": ("hey_snips_loader", "HeySnipsWakeWordLoader",
                              {"transcriber": lambda p: "" if p.stem == "s3" else f"words of {p.stem}"}, _write_snips),
}


@pytest.mark.parametrize("name", sorted(LOADERS))
def test_corpus_loaders_give_jaxs_splits(name, cv_corpus, tmp_path):
    module, cls, kwargs, write = LOADERS[name]
    root = cv_corpus if write is None else write(tmp_path / name)
    out = [_splits(getattr(_mod(p, f"data.dataset.{module}"), cls)(**kwargs).load_splits(root, sample_rate=SR, mono=True))
           for p in PACKAGES]
    assert out[1] == out[0]
    assert sum(len(s) for s in out[1]) > 0


def test_registries_and_the_factory_are_jaxs(cv_corpus, tmp_path):
    import howl_tpu.data.dataset.common_voice_loader  # noqa: F401
    import howl_tpu.data.dataset.gsc_loader  # noqa: F401
    import howl_tpu.data.dataset.hey_snips_loader  # noqa: F401
    import howl_tpu_torch.data.dataset.common_voice_loader  # noqa: F401
    import howl_tpu_torch.data.dataset.gsc_loader  # noqa: F401
    import howl_tpu_torch.data.dataset.hey_snips_loader  # noqa: F401

    names = [_mod(p, "data.dataset.dataset_loader").RegisteredPathDatasetLoader.registered_names() for p in PACKAGES]
    assert names[1] == names[0]
    assert {"gsc", "mozilla-cv", "mozilla-kw", "mozilla-ww", "hey-snips", "wake-word", "clip"} <= set(names[1])
    ds = run_pipeline("howl_tpu_torch", cv_corpus, tmp_path / "datasets", stitch=False) / "positive"
    for dataset_type, path in (("common-voice", cv_corpus), ("raw", ds), ("aligned", ds)):
        out = []
        for package in PACKAGES:
            factory, constants = _mod(package, "data.dataset.factory"), _mod(package, "data.dataset.constants")
            loader = factory.get_dataset_loader(constants.AudioDatasetType(dataset_type), path)
            out.append((loader.name, _splits(loader.load_splits(sample_rate=SR, mono=True))))
            if dataset_type != "common-voice":
                split = _mod(package, "data.dataset.dataset").DatasetSplit.DEV
                out[-1] += (_splits([loader.load_split(split, sample_rate=SR, mono=True)]),)
        assert out[1] == out[0]
    with pytest.raises(FileNotFoundError):
        _mod("howl_tpu_torch", "data.dataset.factory").HowlAudioDatasetLoader(
            _mod("howl_tpu_torch", "data.dataset.constants").AudioDatasetType.RAW, tmp_path / "missing")


@pytest.mark.parametrize("entry,flags", [
    ("generate_raw_audio_dataset", ("--dataset-type", "--positive-pct", "--negative-pct", "--num-workers")),
    ("attach_alignment", ("--alignment-type", "--alignments-path", "--token-type")),
    ("stitch_vocab_samples", ("--max-num-training-samples", "--disable-detect-keyword")),
])
def test_help_runs_without_jax(entry, flags):
    code = (
        "import runpy, sys\n"
        "class Refuse:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'flax', 'howl_tpu'):\n"
        "            raise ImportError(name)\n"
        "sys.meta_path.insert(0, Refuse())\n"
        f"sys.argv = ['{entry}', '--help']\n"
        f"runpy.run_module('howl_tpu_torch.training.run.{entry}', run_name='__main__')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    for flag in flags:
        assert flag in proc.stdout
