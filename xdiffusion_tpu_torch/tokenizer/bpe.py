"""GPT-2-style byte-level BPE tokenizer.

Counterpart of xdiffusion_tpu/tokenizer/bpe.py, with its own byte-identical
copy of the gzipped GPT-2 vocabulary (`encoder.json.gz`, `vocab.bpe.gz`)
beside this module, so prompts tokenize to the JAX package's ids. The loader
honours $XDIFFUSION_DATA_DIR/tokenizer overrides and falls back to a
byte-level vocabulary if the assets are removed. The encoder is loaded once
per process.
"""

from __future__ import annotations

import gzip
import json
import os
import re
from functools import lru_cache
from typing import Dict, List, Optional, Tuple

import numpy as np

# GPT-2 vocab size; the fallback encoder reserves the same id space so
# configs with token_vocabulary_size: 50257 work with either vocabulary.
GPT2_VOCAB_SIZE = 50257

# GPT-2's pattern with regex-module classes \p{L}/\p{N}, written with the
# stdlib-re equivalents [^\W\d_] / \d.
_WORD_RE = re.compile(
    r"'s|'t|'re|'ve|'m|'ll|'d| ?[^\W\d_]+| ?\d+| ?[^\s\w]+|\s+(?!\S)|\s+",
    re.UNICODE,
)


@lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """Reversible byte -> printable-unicode map (standard byte-BPE trick)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word: Tuple[str, ...]):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


class Encoder:
    """Byte-BPE encoder; with no merge ranks it degrades to byte-level."""

    def __init__(
        self,
        encoder: Dict[str, int],
        bpe_merges: List[Tuple[str, str]],
        end_token: Optional[int] = None,
    ):
        self.encoder = encoder
        self.decoder = {v: k for k, v in encoder.items()}
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.bpe_ranks = dict(zip(bpe_merges, range(len(bpe_merges))))
        self._cache: Dict[str, str] = {}
        # The end token is the last vocab id (<|endoftext|> = 50256 for
        # GPT-2); tokenize() pads with 0s.
        self.end_token = (
            end_token if end_token is not None else len(encoder) - 1
        )

    @property
    def n_vocab(self) -> int:
        return len(self.encoder)

    @property
    def vocab_size(self) -> int:
        return max(GPT2_VOCAB_SIZE, len(self.encoder))

    def padded_tokens_and_mask(
        self, tokens: List[int], text_ctx: int
    ) -> Tuple[List[int], List[bool]]:
        """Pads with end_token; the boolean mask marks the prompt's tokens."""
        tokens = tokens[:text_ctx]
        padding = text_ctx - len(tokens)
        return (
            tokens + [self.end_token] * padding,
            [True] * len(tokens) + [False] * padding,
        )

    def _bpe(self, token: str) -> str:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token)
        if not self.bpe_ranks:
            out = " ".join(word)
            self._cache[token] = out
            return out
        pairs = _get_pairs(word)
        while pairs:
            bigram = min(
                pairs, key=lambda p: self.bpe_ranks.get(p, float("inf"))
            )
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self._cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        # Prompts are lowercased before encoding.
        text = text.lower()
        ids: List[int] = []
        for token in _WORD_RE.findall(text):
            token_bytes = "".join(
                self.byte_encoder[b] for b in token.encode("utf-8")
            )
            for sub in self._bpe(token_bytes).split(" "):
                if sub in self.encoder:
                    ids.append(self.encoder[sub])
        return ids

    def decode(self, ids: List[int]) -> str:
        text = "".join(self.decoder.get(i, "") for i in ids)
        data = bytearray(self.byte_decoder.get(c, 0) for c in text)
        return data.decode("utf-8", errors="replace")

    def tokenize(
        self,
        texts: List[str],
        context_length: int = 128,
        truncate_text: bool = True,
    ) -> np.ndarray:
        """(B, context_length) int32 ids, zero-padded."""
        out = np.zeros((len(texts), context_length), dtype=np.int32)
        for i, text in enumerate(texts):
            ids = self.encode(text)
            if len(ids) > context_length:
                if not truncate_text:
                    raise ValueError(
                        f"prompt too long ({len(ids)} > {context_length})"
                    )
                ids = ids[:context_length]
            out[i, : len(ids)] = ids
        return out


def _byte_level_encoder() -> Encoder:
    """Fallback vocabulary: one token per mapped byte (no merges)."""
    b2u = bytes_to_unicode()
    encoder = {ch: b + 1 for b, ch in b2u.items()}  # 0 reserved for pad
    return Encoder(encoder=encoder, bpe_merges=[], end_token=0)


def _find_asset(base: str, name: str) -> Optional[str]:
    for suffix in ("", ".gz"):
        p = os.path.join(base, name + suffix)
        if os.path.exists(p):
            return p
    return None


@lru_cache(maxsize=1)
def get_encoder() -> Encoder:
    """GPT-2 vocab (shipped with the package, or $XDIFFUSION_DATA_DIR
    override); byte-level fallback if the assets are removed."""
    from xdiffusion_tpu_torch.datasets.mnist import data_root

    enc_path = bpe_path = None
    for base in (
        os.path.join(data_root(), "tokenizer"),
        os.path.dirname(os.path.abspath(__file__)),
    ):
        enc_path = _find_asset(base, "encoder.json")
        bpe_path = _find_asset(base, "vocab.bpe")
        if enc_path and bpe_path:
            break
    if enc_path and bpe_path:
        opener = lambda p: gzip.open(p, "rt") if p.endswith(".gz") else open(p)
        with opener(enc_path) as f:
            encoder = json.load(f)
        with opener(bpe_path) as f:
            lines = f.read().split("\n")
        merges = [
            tuple(line.split()) for line in lines[1:] if len(line.split()) == 2
        ]
        return Encoder(encoder=encoder, bpe_merges=merges)
    return _byte_level_encoder()
