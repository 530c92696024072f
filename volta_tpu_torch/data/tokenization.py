"""Self-contained BERT WordPiece tokenizer.

The reference tokenises through pytorch_transformers' BertTokenizer
(reference: volta/task_utils.py:291-294). This image has no pretrained
tokenizer cache and no network, so the framework carries a standalone
implementation of BERT basic + WordPiece tokenisation that loads any
``vocab.txt``; when a HuggingFace tokenizer object is available it can be
passed anywhere a tokenizer is expected (same duck-typed surface:
``encode``/``tokenize``/``convert_tokens_to_ids`` and the special-token
attributes).

The port's copy of ``volta_tpu/data/tokenization.py``, which uses numpy
and the standard library only; the port keeps its own so that it imports
nothing of the JAX package.
"""

from __future__ import annotations

import collections
import os
import unicodedata
from typing import Dict, List, Optional


def load_vocab(vocab_file: str) -> Dict[str, int]:
    vocab = collections.OrderedDict()
    with open(vocab_file, "r", encoding="utf-8") as f:
        for i, line in enumerate(f):
            tok = line.rstrip("\n")
            if tok:
                vocab[tok] = i
    return vocab


def _is_whitespace(ch):
    return ch in " \t\n\r" or unicodedata.category(ch) == "Zs"


def _is_control(ch):
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punct(ch):
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or \
            (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


class BasicTokenizer:
    def __init__(self, do_lower_case: bool = True):
        self.do_lower_case = do_lower_case

    def tokenize(self, text: str) -> List[str]:
        text = self._clean(text)
        text = self._tokenize_chinese(text)
        tokens = text.strip().split()
        out = []
        for tok in tokens:
            if self.do_lower_case:
                tok = tok.lower()
                tok = self._strip_accents(tok)
            out.extend(self._split_punct(tok))
        return " ".join(out).strip().split()

    @staticmethod
    def _clean(text):
        return "".join(
            " " if _is_whitespace(c) else c
            for c in text if ord(c) != 0 and ord(c) != 0xFFFD
            and not _is_control(c))

    @staticmethod
    def _strip_accents(text):
        return "".join(c for c in unicodedata.normalize("NFD", text)
                       if unicodedata.category(c) != "Mn")

    @staticmethod
    def _split_punct(tok):
        out, cur = [], []
        for c in tok:
            if _is_punct(c):
                if cur:
                    out.append("".join(cur))
                    cur = []
                out.append(c)
            else:
                cur.append(c)
        if cur:
            out.append("".join(cur))
        return out

    @staticmethod
    def _tokenize_chinese(text):
        out = []
        for c in text:
            cp = ord(c)
            if (0x4E00 <= cp <= 0x9FFF) or (0x3400 <= cp <= 0x4DBF) or \
                    (0xF900 <= cp <= 0xFAFF) or (0x20000 <= cp <= 0x2A6DF):
                out.extend([" ", c, " "])
            else:
                out.append(c)
        return "".join(out)


class WordpieceTokenizer:
    def __init__(self, vocab, unk_token="[UNK]", max_chars=100):
        self.vocab = vocab
        self.unk_token = unk_token
        self.max_chars = max_chars

    def tokenize(self, token: str) -> List[str]:
        if len(token) > self.max_chars:
            return [self.unk_token]
        out = []
        start = 0
        while start < len(token):
            end = len(token)
            cur = None
            while start < end:
                sub = token[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = sub
                    break
                end -= 1
            if cur is None:
                return [self.unk_token]
            out.append(cur)
            start = end
        return out


class BertTokenizer:
    """BERT-uncased style tokenizer over a local vocab file."""

    def __init__(self, vocab_file: str, do_lower_case: bool = True):
        self.vocab = load_vocab(vocab_file)
        self.ids_to_tokens = {i: t for t, i in self.vocab.items()}
        self.basic = BasicTokenizer(do_lower_case)
        self.wordpiece = WordpieceTokenizer(self.vocab)
        self.cls_token, self.sep_token = "[CLS]", "[SEP]"
        self.mask_token, self.pad_token = "[MASK]", "[PAD]"
        self.unk_token = "[UNK]"

    @classmethod
    def from_pretrained(cls, name_or_path: str, do_lower_case: bool = True):
        """Resolve a vocab file: a direct path, a directory with vocab.txt,
        or $VOLTA_VOCAB_DIR/<name>/vocab.txt."""
        candidates = [name_or_path,
                      os.path.join(name_or_path, "vocab.txt")]
        root = os.environ.get("VOLTA_VOCAB_DIR")
        if root:
            candidates.append(os.path.join(root, name_or_path, "vocab.txt"))
            candidates.append(os.path.join(root, "vocab.txt"))
        for c in candidates:
            if os.path.isfile(c):
                return cls(c, do_lower_case)
        # last resort: HF hub cache (offline)
        try:
            import transformers
            return transformers.BertTokenizer.from_pretrained(
                name_or_path, do_lower_case=do_lower_case,
                local_files_only=True)
        except Exception as e:
            raise FileNotFoundError(
                f"no vocab found for {name_or_path!r}; set VOLTA_VOCAB_DIR "
                "or pass a vocab.txt path") from e

    # ------------------------------------------------------------- API
    def tokenize(self, text: str) -> List[str]:
        out = []
        for tok in self.basic.tokenize(text):
            out.extend(self.wordpiece.tokenize(tok))
        return out

    def convert_tokens_to_ids(self, tokens) -> List[int]:
        unk = self.vocab[self.unk_token]
        if isinstance(tokens, str):
            return self.vocab.get(tokens, unk)
        return [self.vocab.get(t, unk) for t in tokens]

    def convert_ids_to_tokens(self, ids) -> List[str]:
        return [self.ids_to_tokens.get(i, self.unk_token) for i in ids]

    def encode(self, text: str, text_pair: Optional[str] = None,
               add_special_tokens: bool = True) -> List[int]:
        ids = self.convert_tokens_to_ids(self.tokenize(text))
        if not add_special_tokens:
            return ids
        out = [self.vocab[self.cls_token]] + ids + [self.vocab[self.sep_token]]
        if text_pair is not None:
            out += self.convert_tokens_to_ids(self.tokenize(text_pair)) + \
                [self.vocab[self.sep_token]]
        return out

    # convenient special ids
    @property
    def cls_id(self):
        return self.vocab[self.cls_token]

    @property
    def sep_id(self):
        return self.vocab[self.sep_token]

    @property
    def mask_id(self):
        return self.vocab[self.mask_token]

    @property
    def pad_id(self):
        return self.vocab[self.pad_token]

    def __len__(self):
        return len(self.vocab)


def write_tiny_vocab(path: str, words: List[str]) -> None:
    """Test helper: build a vocab.txt with the BERT special tokens first."""
    specials = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    with open(path, "w", encoding="utf-8") as f:
        for t in specials + list(words):
            f.write(t + "\n")
