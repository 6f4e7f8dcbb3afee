"""The port's stand-in tokenizer gives one id sequence per prompt in every
process: each word's id is its crc32 (`torch_tokenizer.StableHashTokenizer`
is the JAX-side subclass with the same ids). The JAX package's
`HashTokenizer` hashes words with Python's per-process salted `hash()`, a
reference behaviour pinned here: two processes with other hash seeds give
it other ids."""
import json
import os
import subprocess
import sys

import numpy as np

from mvedit_tpu_torch.models.diffusion.tokenizer import HashTokenizer

from torch_tokenizer import StableHashTokenizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROMPTS = ["a red car", "A wooden vase, high quality, best quality",
           "", "  spaced   words\tand tabs ", "é accents ü"]


def _ids_in_process(path, hashseed):
    """The ids of PROMPTS from the tokenizer file at `path`, loaded alone
    (stdlib and numpy only) in a fresh process."""
    code = (
        "import importlib.util, json, sys\n"
        f"spec = importlib.util.spec_from_file_location('tok', {path!r})\n"
        "mod = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(mod)\n"
        f"print(json.dumps(mod.HashTokenizer()({PROMPTS!r}).tolist()))\n")
    env = dict(os.environ, PYTHONHASHSEED=str(hashseed))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    return np.asarray(json.loads(res.stdout.strip().splitlines()[-1]))


def test_port_ids_are_the_crc32_ids():
    ids = HashTokenizer()(PROMPTS)
    assert ids.shape == (len(PROMPTS), 77) and ids.dtype == np.int32
    np.testing.assert_array_equal(ids, StableHashTokenizer()(PROMPTS))
    assert ids[0, 0] == 49406 and ids[0, 4] == 49407 == ids[0, -1]
    assert (ids[2, 1:] == 49407).all()       # "" -> bos, eos padding
    short = HashTokenizer()(["a red car"], max_length=8)
    np.testing.assert_array_equal(short[0], ids[0, :8])


def test_port_ids_are_the_same_in_every_process():
    path = os.path.join(REPO, "mvedit_tpu_torch", "models", "diffusion",
                        "tokenizer.py")
    a, b = _ids_in_process(path, 1), _ids_in_process(path, 2)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, HashTokenizer()(PROMPTS))


def test_jax_ids_change_with_the_hash_seed():
    path = os.path.join(REPO, "mvedit_tpu", "models", "diffusion",
                        "tokenizer.py")
    a, b = _ids_in_process(path, 1), _ids_in_process(path, 2)
    assert (a != b).any()
