"""Dataset writers: jsonl metadata + 16 kHz WAV re-encode + .lab sidecars.

(ref: howl/data/dataset/dataset_writer.py:19-131 — same on-disk layout:
``audio/<audio_id>.wav``, ``<prefix>metadata-{split}.jsonl``, and a ``.lab``
transcription sidecar per clip for the MFA binary.)
"""

from __future__ import annotations

import copy
from pathlib import Path

from howl_tpu_torch.data.common.metadata import AudioClipMetadata
from howl_tpu_torch.data.dataset.constants import DIR_AUDIO, METADATA_FILE_NAME_TEMPLATES, AudioDatasetType
from howl_tpu_torch.data.dataset.dataset import AudioDataset, DatasetSplit
from howl_tpu_torch.utils import audio_utils
from howl_tpu_torch.utils.logger import Logger


class AudioDatasetMetadataWriter:
    """Writes jsonl metadata plus .lab transcription sidecars."""

    def __init__(self, dataset_path: Path, audio_dataset_type: AudioDatasetType, dataset_split: DatasetSplit):
        name = METADATA_FILE_NAME_TEMPLATES[audio_dataset_type].format(dataset_split=dataset_split.value)
        self.metadata_json_file_path = Path(dataset_path) / name
        self.metadata_json_file = None

    def __enter__(self):
        self.metadata_json_file = self.metadata_json_file_path.open("w")
        return self

    def write(self, metadata: AudioClipMetadata):
        metadata = copy.deepcopy(metadata)
        metadata.path.with_suffix(".lab").write_text(f"{metadata.transcription}\n")
        metadata.path = Path(metadata.path.name)
        self.metadata_json_file.write(metadata.to_json() + "\n")

    def __exit__(self, *args):
        self.metadata_json_file.close()


class AudioDatasetWriter:
    """Re-encodes each clip to 16 kHz mono WAV under audio/ and writes metadata."""

    def __init__(self, dataset: AudioDataset, audio_dataset_type: AudioDatasetType):
        self.dataset = dataset
        self.audio_dataset_type = audio_dataset_type

    def _save_audio_file(self, metadata: AudioClipMetadata, audio_dir: Path):
        new_path = (audio_dir / metadata.audio_id).with_suffix(".wav")
        try:
            audio = audio_utils.silent_load(metadata.path, self.dataset.sample_rate, self.dataset.mono)
            if audio.shape[-1] == 0:
                raise ValueError("empty audio (decode failed)")
            audio_utils.write_wav(new_path, audio, self.dataset.sample_rate)
        except Exception as e:  # noqa: BLE001 — parity: bad clips dropped, not fatal
            Logger.warning(f"failed to load/write {metadata.path}; skipping: {e}")
            return None
        metadata = copy.deepcopy(metadata)
        metadata.path = new_path
        return metadata

    def write(self, dataset_path: Path, num_workers: int = None):
        """Re-encode every clip, ``num_workers`` at a time (None ->
        SETTINGS.resource.cpu_count; the reference pools this step too, ref
        dataset_writer.py:97-100). Each clip writes a distinct file and the
        surviving metadata keeps input order, so the jsonl output is
        bit-identical to a sequential run."""
        dataset_path = Path(dataset_path)
        Logger.info(f"writing flat dataset to {dataset_path}")
        dataset_path.mkdir(parents=True, exist_ok=True)
        audio_dir = dataset_path / DIR_AUDIO
        audio_dir.mkdir(exist_ok=True)

        from howl_tpu_torch.utils.parallel import parallel_map

        results = parallel_map(
            lambda metadata: self._save_audio_file(metadata, audio_dir),
            self.dataset.metadata_list,
            num_workers=num_workers,
        )
        self.dataset.metadata_list = written = [m for m in results if m is not None]

        split = self.dataset.dataset_split
        if not isinstance(split, DatasetSplit):
            split = DatasetSplit.UNSPECIFIED
        with AudioDatasetMetadataWriter(dataset_path, self.audio_dataset_type, split) as writer:
            for metadata in written:
                writer.write(metadata)
