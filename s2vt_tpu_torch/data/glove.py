"""GloVe embedding warm start for the caption embedding table.

Counterpart of ``s2vt_tpu/data/glove.py`` (the reference's
``load_glove_weights``, S2VTModel.py:112-147): parse ``glove.6B.{dim}d.txt``,
cache the vocab-filtered vectors as ``word2embed.json`` next to the file,
initialise every row Xavier-uniform from ``np.random.default_rng(seed)``,
and overwrite the rows of words found in GloVe. The table is the JAX
package's bit for bit; ``warm_start_embedding`` writes it into a model's
embedding weight.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn


def parse_glove_file(glove_path: str, vocab: Dict[str, int]) -> Dict[str, list]:
    """Read a GloVe text file, keeping only words in ``vocab``."""
    found: Dict[str, list] = {}
    with open(glove_path, encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip().split(" ")
            if parts[0] in vocab:
                found[parts[0]] = [float(v) for v in parts[1:]]
    return found


def load_glove_embeddings(glove_path: str, word2ix: Dict[str, int], dim_embed: int,
                          cache_path: Optional[str] = None, seed: int = 0) -> np.ndarray:
    """The warm-started embedding table [len(word2ix), dim_embed] float32.

    The reference's behaviour: cache ``word2embed`` JSON next to the GloVe
    file (S2VTModel.py:117-128), Xavier-uniform init for all rows
    (S2VTModel.py:133), overwrite rows found in GloVe (S2VTModel.py:135-141).
    Raises ``ValueError`` when a GloVe vector is not ``dim_embed`` wide."""
    if cache_path is None:
        cache_path = os.path.join(os.path.dirname(os.path.abspath(glove_path)),
                                  "word2embed.json")
    if os.path.exists(cache_path):
        with open(cache_path, encoding="utf-8") as f:
            word2embed = json.load(f)
    else:
        word2embed = parse_glove_file(glove_path, word2ix)
        with open(cache_path, "w", encoding="utf-8") as f:
            json.dump(word2embed, f)

    V = len(word2ix)
    rng = np.random.default_rng(seed)
    # Xavier-uniform over [V, dim]: bound = sqrt(6 / (fan_in + fan_out)).
    bound = np.sqrt(6.0 / (V + dim_embed))
    table = rng.uniform(-bound, bound, (V, dim_embed)).astype(np.float32)
    for word, vec in word2embed.items():
        ix = word2ix.get(word)
        if ix is None:
            continue
        v = np.asarray(vec, np.float32)
        if v.shape[0] != dim_embed:
            raise ValueError(f"GloVe dim {v.shape[0]} != dim_embed {dim_embed}; use the "
                             f"matching glove.6B.{dim_embed}d.txt file")
        table[ix] = v
    return table


def warm_start_embedding(model: nn.Module, glove_path: str, word2ix: Dict[str, int],
                         cache_path: Optional[str] = None, seed: int = 0) -> np.ndarray:
    """Write the warm-started table into ``model.embedding.weight``'s first
    ``len(word2ix)`` rows; the rows of a padded vocabulary keep their init.
    Returns the table."""
    weight = model.embedding.weight
    table = load_glove_embeddings(glove_path, word2ix, int(weight.shape[1]), cache_path, seed)
    with torch.no_grad():
        weight[:table.shape[0]] = torch.from_numpy(table).to(weight.device, weight.dtype)
    return table
