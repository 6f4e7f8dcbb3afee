"""The JAX package's `HashTokenizer` with the port's word ids.

The JAX stand-in tokenizer hashes each word with Python's `hash()`, which
is salted per process; the port's hashes it with crc32. A parity test that
lets both runners tokenize a prompt hands the JAX runner this subclass, so
that both encode the same ids in every process.
"""
import zlib

import numpy as np

from mvedit_tpu.models.diffusion.tokenizer import HashTokenizer, _clean

__all__ = ["StableHashTokenizer"]


class StableHashTokenizer(HashTokenizer):
    """`HashTokenizer`'s id layout (bos, the words' ids, eos, eos padding)
    with `crc32(word) % (vocab_size - 2)` as each word's id."""

    def __call__(self, texts, max_length=None):
        if isinstance(texts, str):
            texts = [texts]
        L = max_length or self.max_length
        out = np.full((len(texts), L), self.eos, np.int32)
        for i, t in enumerate(texts):
            words = _clean(t).split()[: L - 2]
            ids = [self.bos] + [zlib.crc32(w.encode()) % (self.vocab_size - 2)
                                for w in words] + [self.eos]
            out[i, :len(ids)] = ids
        return out
