"""CLIP BPE tokenizer (pure Python, loads HF vocab.json + merges.txt).

A copy of `mvedit_tpu/models/diffusion/tokenizer.py`: the port cannot
import it, because importing `mvedit_tpu` pulls in JAX.

The reference relies on transformers' CLIPTokenizer; here the byte-level BPE
is implemented directly so the framework has no tokenizer dependency. When no
vocab assets are available (e.g. clean container), `HashTokenizer` provides a
deterministic stand-in with the same contract (ids in [0, vocab), bos/eos,
fixed 77-length padding) so pipelines and tests run end-to-end.
"""
import gzip
import html
import json
import re
from functools import lru_cache

import numpy as np

__all__ = ["CLIPTokenizer", "HashTokenizer"]


@lru_cache()
def _bytes_to_unicode():
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word):
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


def _clean(text):
    text = html.unescape(html.unescape(text))
    text = re.sub(r"\s+", " ", text)
    return text.strip().lower()


class CLIPTokenizer:
    """Standard CLIP byte-level BPE. vocab: token->id json; merges: txt."""

    PAT = re.compile(
        r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"
        r"[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+"
        if False else
        r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"
        r"[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+", re.IGNORECASE)

    def __init__(self, vocab_path, merges_path, max_length=77):
        with open(vocab_path) as f:
            self.encoder = json.load(f)
        opener = gzip.open if str(merges_path).endswith(".gz") else open
        with opener(merges_path, "rt") as f:
            merges = f.read().split("\n")
        if merges and merges[0].startswith("#"):
            merges = merges[1:]
        merges = [tuple(m.split()) for m in merges if m and len(m.split()) == 2]
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.byte_encoder = _bytes_to_unicode()
        self.max_length = max_length
        self.bos = self.encoder.get("<|startoftext|>", 49406)
        self.eos = self.encoder.get("<|endoftext|>", 49407)
        self.cache = {}

    def _bpe(self, token):
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, 1e10))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                    new_word.extend(word[i:j])
                    i = j
                except ValueError:
                    new_word.extend(word[i:])
                    break
                if i < len(word) - 1 and word[i] == first \
                        and word[i + 1] == second:
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
        self.cache[token] = out
        return out

    def encode(self, text):
        ids = []
        for token in re.findall(self.PAT, _clean(text)):
            token = "".join(self.byte_encoder[b]
                            for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(token).split(" "))
        return ids

    def __call__(self, texts, max_length=None):
        """list[str] -> (B, L) int32, bos/eos, eos-padded (SD convention)."""
        if isinstance(texts, str):
            texts = [texts]
        L = max_length or self.max_length
        out = np.full((len(texts), L), self.eos, np.int32)
        for i, t in enumerate(texts):
            ids = [self.bos] + self.encode(t)[: L - 2] + [self.eos]
            out[i, :len(ids)] = ids
        return out


class HashTokenizer:
    """Deterministic stand-in when vocab assets are absent: hashes words into
    the CLIP id space. NOT semantically meaningful — for shape/flow testing
    and random-weight benchmarking only."""

    def __init__(self, vocab_size=49408, max_length=77):
        self.vocab_size = vocab_size
        self.max_length = max_length
        self.bos = vocab_size - 2
        self.eos = vocab_size - 1

    def __call__(self, texts, max_length=None):
        if isinstance(texts, str):
            texts = [texts]
        L = max_length or self.max_length
        out = np.full((len(texts), L), self.eos, np.int32)
        for i, t in enumerate(texts):
            words = _clean(t).split()[: L - 2]
            ids = [self.bos] + [hash(w) % (self.vocab_size - 2)
                                for w in words] + [self.eos]
            out[i, :len(ids)] = ids
        return out
