"""Corpora and runners of the dataset pipeline tests (tests/test_torch_etl.py),
shared by the JAX package and its port.

``make_cv_corpus`` is tests/test_etl.py's mini Common Voice corpus with a
tone and a speaker that follow each clip's index instead of ``hash(name)``,
which changes with ``PYTHONHASHSEED``: both packages, in any process, read
the same bytes. ``run_pipeline`` runs ``generate_dataset.sh``'s three steps
(raw mining, stub alignment of both sets, stitching of the positives) through
one package's entry points.
"""

from __future__ import annotations

import importlib
import json
import random
from pathlib import Path

import numpy as np

from howl_tpu.utils.audio_utils import write_wav
from tests.fixtures import SR, tone

VOCAB_ENV = {"VOCAB": '["hey","fire","fox"]', "INFERENCE_SEQUENCE": "[0,1,2]"}
CV_ROWS = {
    "train.tsv": [
        ("a1.wav", "hey fire fox is cool"),
        ("a2.wav", "nothing to see here"),
        ("a3.wav", "the fire is warm"),
        ("a4.wav", "hey you there"),
    ],
    "dev.tsv": [("b1.wav", "hey fire fox"), ("b2.wav", "unrelated words")],
    "test.tsv": [("c1.wav", "fox says hey fire fox"), ("c2.wav", "silence speaks")],
}
STITCH_SEED = 1234  # the stitcher draws from Python's global random; both packages are seeded alike before it
STITCH_COUNTS = {"--max-num-training-samples": "4", "--max-num-dev-samples": "2", "--max-num-test-samples": "2"}
TEXTGRID = (
    'item [1]:\n    class = "IntervalTier"\n    name = "words"\n'
    "    intervals: size = 2\n"
    "    intervals [1]:\n        xmin = {a}\n        xmax = {b}\n        text = \"hey\"\n"
    "    intervals [2]:\n        xmin = {c}\n        xmax = {d}\n        text = \"fire\"\n"
)


def make_cv_corpus(root: Path, rows=None, seconds: float = 1.2) -> Path:
    """clips/ + train/dev/test.tsv with client_id, path and sentence; clip i
    (in file order) is a tone of 300 + 100 (i % 5) Hz spoken by client i % 3."""
    rows = CV_ROWS if rows is None else rows
    rng = np.random.default_rng(0)
    root = Path(root)
    (root / "clips").mkdir(parents=True)
    index = 0
    for tsv, entries in rows.items():
        lines = ["client_id\tpath\tsentence"]
        for name, sentence in entries:
            write_wav(root / "clips" / name, tone(300 + 100 * (index % 5), seconds, rng=rng), SR)
            lines.append(f"client{index % 3}\t{name}\t{sentence}")
            index += 1
        (root / tsv).write_text("\n".join(lines) + "\n")
    return root


def run_pipeline(package: str, cv: Path, out: Path, num_workers: int = None, stitch: bool = True) -> Path:
    """``generate_dataset.sh`` through ``package``'s entry points (``howl_tpu``
    or ``howl_tpu_torch``), SETTINGS read from the environment: returns the
    wake word's dataset directory (``positive/`` and ``negative/``)."""
    run = lambda tool, argv: importlib.import_module(f"{package}.training.run.{tool}").run(argv)  # noqa: E731
    workers = [] if num_workers is None else ["--num-workers", str(num_workers)]
    run("generate_raw_audio_dataset", ["-i", str(cv), "--dataset-type", "common-voice", "-o", str(out), *workers])
    ds = Path(out) / "hey_fire_fox"
    for kind in ("positive", "negative"):
        run("attach_alignment", ["-i", str(ds / kind), "--alignment-type", "stub", *workers])
    if stitch:
        random.seed(STITCH_SEED)
        run("stitch_vocab_samples", ["-i", str(ds / "positive"), *sum(map(list, STITCH_COUNTS.items()), []),
                                     "--disable-detect-keyword"])
    return ds


def tree_bytes(root: Path) -> dict:
    """{path relative to ``root``: bytes} of every file under it."""
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(Path(root).rglob("*")) if p.is_file()}


def write_textgrid_dataset(root: Path) -> tuple[Path, Path]:
    """A raw dataset of two clips and their TextGrids (one more that is not a
    TextGrid at all): returns (dataset, grids)."""
    ds, grids = Path(root) / "raw", Path(root) / "grids"
    (ds / "audio").mkdir(parents=True)
    grids.mkdir(parents=True)
    records = []
    for i, times in enumerate(((0.1, 0.4, 0.5, 0.9), (0.05, 0.3, 0.35, 0.8))):
        write_wav(ds / "audio" / f"clip{i}.wav", tone(500 + 100 * i, 1.0), SR)
        records.append(json.dumps({"path": f"clip{i}.wav", "transcription": "hey fire"}))
        (grids / f"clip{i}.TextGrid").write_text(TEXTGRID.format(a=times[0], b=times[1], c=times[2], d=times[3]))
    (grids / "broken.TextGrid").write_text("not a textgrid at all")
    (ds / "metadata-training.jsonl").write_text("\n".join(records) + "\n")
    (ds / "metadata-dev.jsonl").write_text("")
    (ds / "metadata-test.jsonl").write_text("")
    return ds, grids
