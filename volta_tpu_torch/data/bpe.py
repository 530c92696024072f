"""Self-contained byte-level BPE tokenizer (RoBERTa/GPT-2 style).

Completes the RoBERTa text path (reference: volta/task_utils.py:291-292
uses pytorch_transformers RobertaTokenizer) without network or the
``tokenizers`` package: loads a local ``vocab.json`` + ``merges.txt``.
Duck-types the same surface as tokenization.BertTokenizer.

The port's copy of ``volta_tpu/data/bpe.py``, which uses numpy and the
standard library only; the port keeps its own so that it imports nothing
of the JAX package.
"""

from __future__ import annotations

import json
import os
import re
from functools import lru_cache
from typing import Dict, List


@lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte <-> unicode mapping."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


_PAT = re.compile(
    r"'s|'t|'re|'ve|'m|'ll|'d| ?[^\s\d\W]+| ?\d+| ?[^\s\w]+|\s+(?!\S)|\s+",
    re.UNICODE)


class RobertaTokenizer:
    def __init__(self, vocab_file: str, merges_file: str):
        with open(vocab_file, encoding="utf-8") as f:
            self.encoder: Dict[str, int] = json.load(f)
        self.decoder = {v: k for k, v in self.encoder.items()}
        with open(merges_file, encoding="utf-8") as f:
            merges = [tuple(line.split()) for line in
                      f.read().split("\n")[1:] if line and not
                      line.startswith("#version")]
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self._cache: Dict[str, str] = {}
        self.cls_token, self.sep_token = "<s>", "</s>"
        self.pad_token, self.unk_token = "<pad>", "<unk>"
        self.mask_token = "<mask>"

    @classmethod
    def from_pretrained(cls, name_or_path: str, **_):
        for base in (name_or_path,
                     os.path.join(os.environ.get("VOLTA_VOCAB_DIR", ""),
                                  name_or_path)):
            v = os.path.join(base, "vocab.json")
            m = os.path.join(base, "merges.txt")
            if os.path.isfile(v) and os.path.isfile(m):
                return cls(v, m)
        raise FileNotFoundError(
            f"no vocab.json/merges.txt under {name_or_path!r}")

    # --------------------------------------------------------------- BPE
    def _bpe(self, token: str) -> str:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token)
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, 1 << 30))
            if best not in self.bpe_ranks:
                break
            first, second = best
            out: List[str] = []
            i = 0
            while i < len(word):
                if (i < len(word) - 1 and word[i] == first
                        and word[i + 1] == second):
                    out.append(first + second)
                    i += 2
                else:
                    out.append(word[i])
                    i += 1
            word = tuple(out)
        result = " ".join(word)
        self._cache[token] = result
        return result

    # --------------------------------------------------------------- API
    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for tok in _PAT.findall(text):
            mapped = "".join(self.byte_encoder[b]
                             for b in tok.encode("utf-8"))
            out.extend(self._bpe(mapped).split(" "))
        return out

    def convert_tokens_to_ids(self, tokens) -> List[int]:
        unk = self.encoder.get(self.unk_token, 3)
        if isinstance(tokens, str):
            return self.encoder.get(tokens, unk)
        return [self.encoder.get(t, unk) for t in tokens]

    def convert_ids_to_tokens(self, ids) -> List[str]:
        return [self.decoder.get(i, self.unk_token) for i in ids]

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        ids = self.convert_tokens_to_ids(self.tokenize(text))
        if not add_special_tokens:
            return ids
        return [self.cls_id] + ids + [self.sep_id]

    @property
    def cls_id(self):
        return self.encoder[self.cls_token]

    @property
    def sep_id(self):
        return self.encoder[self.sep_token]

    @property
    def mask_id(self):
        return self.encoder.get(self.mask_token, 0)

    @property
    def pad_id(self):
        return self.encoder.get(self.pad_token, 1)

    def __len__(self):
        return len(self.encoder)
