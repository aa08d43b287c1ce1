"""InferenceContext: builds the label space from vocab + token type.

(ref: howl/context.py:14-130) Word mode: labels = vocab words + [OOV] negative.
Phone mode: vocab words expand to phones via a pronunciation dictionary, with a
LabelColoring grouping phone labels back into word colors. CTC adds [BLANK].
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional

from howl_tpu_torch.data.common.labeler import PhoneticFrameLabeler, WordFrameLabeler
from howl_tpu_torch.data.common.phone import PhonePhrase, PronunciationDictionary
from howl_tpu_torch.data.common.searcher import LabelColoring, PhoneticTranscriptSearcher, WordTranscriptSearcher
from howl_tpu_torch.data.common.tokenizer import TokenType
from howl_tpu_torch.data.common.vocab import Vocab
from howl_tpu_torch.utils.logger import Logger


class InferenceContext:
    def __init__(
        self,
        vocab: List[str],
        sequence: Optional[List[int]] = None,
        token_type: str = TokenType.WORD,
        phone_dictionary_path: Optional[str] = None,
        seed: int = 0,
        use_blank: bool = False,
    ):
        self.seed = seed
        self.sequence = list(sequence) if sequence is not None else list(range(len(vocab)))
        self.token_type = TokenType(token_type)
        self.coloring: Optional[LabelColoring] = None
        self.adjusted_vocab: List[str] = []
        self.num_labels = 0
        self.pronounce_dict: Optional[PronunciationDictionary] = None

        if self.token_type == TokenType.PHONE:
            if phone_dictionary_path is None:
                from howl_tpu_torch.settings import SETTINGS

                phone_dictionary_path = SETTINGS.training.phone_dictionary
            if phone_dictionary_path is None:
                raise ValueError("phone token type requires a pronunciation dictionary path")
            self.pronounce_dict = PronunciationDictionary.from_file(Path(phone_dictionary_path))
            self.coloring = LabelColoring()
            phone_phrases = []
            for word in vocab:
                phone_phrase = self.pronounce_dict.encode(word)[0]
                Logger.debug(f"word {word} has phonemes {phone_phrase}")
                phone_phrases.append(phone_phrase)
                self.add_vocab([str(phone) for phone in phone_phrase.phones])
        else:
            self.add_vocab(list(vocab))

        self.negative_label = len(self.adjusted_vocab)
        self.vocab = Vocab(
            {word: idx for idx, word in enumerate(self.adjusted_vocab)}, oov_token_id=self.negative_label
        )

        if self.token_type == TokenType.PHONE:
            phrases = [PhonePhrase.from_string(x) for x in self.adjusted_vocab]
            self.labeler = PhoneticFrameLabeler(phrases, self.pronounce_dict)
        else:
            self.labeler = WordFrameLabeler(self.vocab)

        self.add_vocab(["[OOV]"])

        if self.token_type == TokenType.PHONE:
            self.searcher = PhoneticTranscriptSearcher(phrases, self.coloring, inference_sequence=self.sequence)
        else:
            self.searcher = WordTranscriptSearcher(self.vocab, inference_sequence=self.sequence)

        self.blank_label = -1
        if use_blank:
            self.blank_label = len(self.adjusted_vocab)
            self.add_vocab(["[BLANK]"])

    def add_vocab(self, vocabs: List[str]):
        self.adjusted_vocab.extend(vocabs)
        if self.coloring:
            self.coloring.extend_sequence(len(vocabs))
        self.num_labels += len(vocabs)

    @property
    def wake_word(self) -> str:
        return self.vocab.wakeword(self.sequence)

    @staticmethod
    def load_from_config(config) -> "InferenceContext":
        return InferenceContext(
            vocab=config.vocab,
            sequence=config.sequence,
            token_type=config.token_type,
            phone_dictionary_path=config.phone_dictionary_path,
            seed=config.seed,
        )
