"""WordPiece tokenizer (a copy of the JAX package's `nlp/tokenization.py`,
which the port may not import; the role of the reference's vendored
xcompression/transformer/tokenization.py): basic whitespace/punctuation
splitting + greedy longest-match-first WordPiece, reading a standard
BERT vocab.txt. No network access; `build_vocab_from_texts` makes a
small whole-word vocab for synthetic corpora."""

from __future__ import annotations

import collections
import unicodedata
from typing import Dict, List, Optional


def load_vocab(path: str) -> Dict[str, int]:
    vocab = collections.OrderedDict()
    with open(path, encoding="utf-8") as f:
        for i, line in enumerate(f):
            vocab[line.rstrip("\n")] = i
    return vocab


def build_vocab_from_texts(texts, max_size: int = 5000) -> Dict[str, int]:
    """Tiny whole-word vocab for synthetic/offline runs."""
    counter = collections.Counter()
    for t in texts:
        counter.update(_basic_tokenize(t, lowercase=True))
    vocab = {"[PAD]": 0, "[UNK]": 1, "[CLS]": 2, "[SEP]": 3, "[MASK]": 4}
    for w, _ in counter.most_common(max_size - len(vocab)):
        vocab[w] = len(vocab)
    return vocab


NEVER_SPLIT = ("[UNK]", "[SEP]", "[PAD]", "[CLS]", "[MASK]")


def _is_punct(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False  # treated as whitespace
    return unicodedata.category(ch).startswith("C")


def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_cjk(cp: int) -> bool:
    """CJK Unified Ideograph blocks (reference tokenization.py
    _is_chinese_char)."""
    return ((0x4E00 <= cp <= 0x9FFF) or (0x3400 <= cp <= 0x4DBF)
            or (0x20000 <= cp <= 0x2A6DF) or (0x2A700 <= cp <= 0x2B73F)
            or (0x2B740 <= cp <= 0x2B81F) or (0x2B820 <= cp <= 0x2CEAF)
            or (0xF900 <= cp <= 0xFAFF) or (0x2F800 <= cp <= 0x2FA1F))


def _clean_text(text: str) -> str:
    """Drop control chars / NUL / replacement chars, normalize whitespace
    (reference BasicTokenizer._clean_text)."""
    out = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD or _is_control(ch):
            continue
        out.append(" " if _is_whitespace(ch) else ch)
    return "".join(out)


def _space_cjk(text: str) -> str:
    """Surround CJK ideographs with spaces so each becomes its own token
    (reference BasicTokenizer._tokenize_chinese_chars)."""
    out = []
    for ch in text:
        if _is_cjk(ord(ch)):
            out.append(f" {ch} ")
        else:
            out.append(ch)
    return "".join(out)


def _strip_accents(text: str) -> str:
    """NFD-decompose and drop combining marks (reference
    BasicTokenizer._run_strip_accents)."""
    return "".join(ch for ch in unicodedata.normalize("NFD", text)
                   if unicodedata.category(ch) != "Mn")


def _split_word(word: str) -> List[str]:
    """Split one whitespace token on punctuation."""
    out, buf = [], []
    for ch in word:
        if _is_punct(ch):
            if buf:
                out.append("".join(buf)); buf = []
            out.append(ch)
        else:
            buf.append(ch)
    if buf:
        out.append("".join(buf))
    return out


def _basic_tokenize(text: str, lowercase: bool = False,
                    never_split=NEVER_SPLIT) -> List[str]:
    """Reference BasicTokenizer.tokenize semantics (tokenization.py:189-208):
    clean -> CJK spacing -> whitespace split -> per-token lower +
    accent-strip (skipping never_split specials) -> punctuation split."""
    text = _space_cjk(_clean_text(text))
    out = []
    for token in text.split():
        if token in never_split:
            out.append(token)
            continue
        if lowercase:
            token = _strip_accents(token.lower())
        out.extend(_split_word(token))
    return out


class WordPieceTokenizer:
    def __init__(self, vocab: Dict[str, int], lowercase: bool = True,
                 max_chars_per_word: int = 100):
        self.vocab = vocab
        self.inv_vocab = {v: k for k, v in vocab.items()}
        self.lowercase = lowercase
        self.max_chars = max_chars_per_word
        self.unk = "[UNK]"

    @classmethod
    def from_file(cls, path: str, **kw):
        return cls(load_vocab(path), **kw)

    def tokenize(self, text: str) -> List[str]:
        out = []
        for word in _basic_tokenize(text, lowercase=self.lowercase):
            if word in NEVER_SPLIT:
                out.append(word)
                continue
            if len(word) > self.max_chars:
                out.append(self.unk)
                continue
            # greedy longest-match-first wordpiece
            start = 0
            pieces = []
            bad = False
            while start < len(word):
                end = len(word)
                cur = None
                while start < end:
                    sub = word[start:end]
                    if start > 0:
                        sub = "##" + sub
                    if sub in self.vocab:
                        cur = sub
                        break
                    end -= 1
                if cur is None:
                    bad = True
                    break
                pieces.append(cur)
                start = end
            out.extend([self.unk] if bad else pieces)
        return out

    def convert_tokens_to_ids(self, tokens: List[str]) -> List[int]:
        unk = self.vocab[self.unk]
        return [self.vocab.get(t, unk) for t in tokens]

    def encode_pair(self, text_a: str, text_b: Optional[str], max_len: int):
        """BERT-style [CLS] a [SEP] (b [SEP]) with truncation and padding.
        Returns (input_ids, attention_mask, token_type_ids)."""
        ta = self.tokenize(text_a)
        tb = self.tokenize(text_b) if text_b else None
        if tb is not None:
            while len(ta) + len(tb) > max_len - 3:
                (ta if len(ta) > len(tb) else tb).pop()
        else:
            ta = ta[: max_len - 2]
        tokens = ["[CLS]"] + ta + ["[SEP]"]
        types = [0] * len(tokens)
        if tb is not None:
            tokens += tb + ["[SEP]"]
            types += [1] * (len(tb) + 1)
        ids = self.convert_tokens_to_ids(tokens)
        mask = [1] * len(ids)
        pad = max_len - len(ids)
        ids += [self.vocab["[PAD]"]] * pad
        mask += [0] * pad
        types += [0] * pad
        return ids, mask, types
