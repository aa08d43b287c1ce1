"""Vocabulary with longest-prefix trie matching (ref: howl/data/common/vocab.py:6,64)."""

from __future__ import annotations

from typing import List, Mapping, Tuple, Union


class VocabTrie:
    """Character trie over vocab words; supports longest-prefix splitting."""

    class Node:
        __slots__ = ("terminal", "children")

        def __init__(self, terminal: bool = False):
            self.terminal = terminal
            self.children: dict = {}

    def __init__(self):
        self.root = VocabTrie.Node()

    def add_word(self, word: str):
        node = self.root
        for ch in word.lower():
            node = node.children.setdefault(ch, VocabTrie.Node())
        node.terminal = True

    def max_split(self, tokens: str) -> Tuple[str, str]:
        """Split ``tokens`` at the longest vocab word prefix.

        Returns ``(matched, rest)`` where ``matched`` is the longest prefix of
        ``tokens`` that walks the trie; if the walk does not end at a terminal
        node the match is empty (ref vocab.py:50-62 semantics).
        """
        node = self.root
        counter = 0
        for ch in tokens.lower():
            nxt = node.children.get(ch)
            if nxt is None:
                break
            node = nxt
            counter += 1
        if not node.terminal:
            counter = 0
        return tokens[:counter], tokens[counter:]


class Vocab:
    """Word <-> index mapping with OOV handling (ref: vocab.py:64)."""

    def __init__(
        self,
        word2idx: Union[Mapping[str, int], List[str]],
        oov_token_id: int = None,
        oov_word_repr: str = "[OOV]",
    ):
        if isinstance(word2idx, list):
            word2idx = {word: idx for idx, word in enumerate(word2idx)}
        self.word2idx = {k.lower(): v for k, v in word2idx.items()}
        self.idx2word = {v: k for k, v in word2idx.items()}
        self.oov_token_id = oov_token_id
        self.oov_word_repr = oov_word_repr
        self.trie = VocabTrie()
        for word in self.word2idx:
            self.trie.add_word(word)

    def __len__(self):
        return len(self.word2idx)

    def __getitem__(self, item: Union[str, int]) -> Union[str, int]:
        if isinstance(item, str):
            ret = self.word2idx.get(item.lower(), self.oov_token_id)
        else:
            ret = self.idx2word.get(item, self.oov_word_repr)
        if ret is None:
            raise ValueError(f"couldn't find token for {item}")
        return ret

    def wakeword(self, sequence: List[int], separator: str = " ") -> str:
        return separator.join(str(self[i]) for i in sequence)

    def __repr__(self):
        return str(self.idx2word)
