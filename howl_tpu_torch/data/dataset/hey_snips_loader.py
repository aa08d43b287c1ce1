"""Hey Snips corpus loader (ref: howl/data/dataset/hey_snips_dataset_loader.py:29-80).

The reference transcribes negative clips with PocketSphinx (a native C
library). That dependency is replaced with a pluggable ``transcriber``
callable: pass your own STT (any callable path -> str). Without one, negatives
keep the UNKNOWN transcription, which is sufficient for wakeword training where
negatives only need to *not* contain the wakeword.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Callable, Optional, Tuple

from howl_tpu_torch.data.common.metadata import UNKNOWN_TRANSCRIPTION, AudioClipMetadata
from howl_tpu_torch.data.dataset.dataset import AudioClipDataset, DatasetType
from howl_tpu_torch.data.dataset.dataset_loader import RegisteredPathDatasetLoader
from howl_tpu_torch.utils.logger import Logger


class HeySnipsWakeWordLoader(RegisteredPathDatasetLoader, name="hey-snips"):
    def __init__(self, transcriber: Optional[Callable[[Path], str]] = None):
        self.transcriber = transcriber

    def load_splits(self, path: Path, **dataset_kwargs) -> Tuple[AudioClipDataset, ...]:
        path = Path(path)
        if not path.exists():
            raise FileNotFoundError(f"dataset path doesn't exist: {path}")
        filenames = ("train.json", "dev.json", "test.json")
        if not all((path / x).exists() for x in filenames):
            raise FileNotFoundError(f"dataset missing metadata json under {path}")

        def load(filename, set_type):
            Logger.info(f"loading split {filename}")
            raw_list = json.loads((path / filename).read_text())
            # negatives get STT'd on a worker pool (the reference pools
            # PocketSphinx the same way, ref hey_snips_dataset_loader.py:19,33);
            # ordered results keep the metadata order identical to sequential
            negative_paths = [
                (path / raw["audio_file_path"]).absolute() for raw in raw_list if raw["is_hotword"] == 0
            ]
            transcriptions = {}
            if self.transcriber is not None and negative_paths:
                from howl_tpu_torch.utils.parallel import parallel_map

                results = parallel_map(self.transcriber, negative_paths)
                transcriptions = dict(zip(negative_paths, results))
            metadata_list = []
            fail_count = 0
            for raw in raw_list:
                clip_path = (path / raw["audio_file_path"]).absolute()
                if raw["is_hotword"] == 0:
                    if self.transcriber is not None:
                        transcription = transcriptions[clip_path]
                        if transcription == "":
                            fail_count += 1
                            continue
                    else:
                        transcription = UNKNOWN_TRANSCRIPTION
                else:
                    transcription = "hey snips"
                metadata_list.append(AudioClipMetadata(path=clip_path, transcription=transcription))
            if self.transcriber is not None and fail_count:
                Logger.info(f"{fail_count}/{len(raw_list)} samples had empty transcription")
            return AudioClipDataset(metadata_list=metadata_list, set_type=set_type, **dataset_kwargs)

        return (
            load("train.json", DatasetType.TRAINING),
            load("dev.json", DatasetType.DEV),
            load("test.json", DatasetType.TEST),
        )
