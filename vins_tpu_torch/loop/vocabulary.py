"""Hierarchical binary bag-of-words vocabulary (port of
vins_tpu/loop/vocabulary.py).

Centroids are stored as [k**(l+1), 8] int32 tensors holding the bit
patterns of the JAX package's uint32 words. `transform` descends each
descriptor through the complete k-ary tree by Hamming argmin over the k
children per level and scatters tf-idf weights into a dense L1-normalized
[n_words] BoW vector; `score_database` is DBoW2's L1 score
(1 - ½‖v - w‖₁) of a query against every database row. Training
(`train_vocabulary`, hierarchical k-medians with bit-majority centroids)
runs in numpy on the host, as in the JAX package. The shipped
pre-trained trees are the port's own copies under
vins_tpu_torch/assets/.
"""
from __future__ import annotations

import os
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..ops.brief import popcount32

BRIEF_WORDS = 8
ASSETS_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets")


class Vocabulary(NamedTuple):
    """Complete k-ary tree of depth L, level-major: levels[l] is
    [k**(l+1), 8] int32; children of node j at level l are rows
    j*k .. j*k+k-1 of levels[l]. weights: [k**L] idf (0 = unused)."""

    levels: Tuple[torch.Tensor, ...]
    weights: torch.Tensor

    @property
    def k(self) -> int:
        return self.levels[0].shape[0]

    @property
    def depth(self) -> int:
        return len(self.levels)

    @property
    def n_words(self) -> int:
        return self.levels[-1].shape[0]


def _words_i32(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, np.uint32).view(np.int32)


# ---------------------------------------------------------------------------
# Training (numpy, on the host)
# ---------------------------------------------------------------------------

_POPCNT = np.array([bin(i).count("1") for i in range(256)], np.uint16)


def _np_bytes(desc: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(desc, np.uint32).view(np.uint8).reshape(
        desc.shape[0], 32)


def _np_hamming(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """[N, 8] x [M, 8] packed uint32 -> [N, M] int32 Hamming distances."""
    x = _np_bytes(a)[:, None, :] ^ _np_bytes(b)[None, :, :]
    return _POPCNT[x].sum(-1).astype(np.int32)


def _np_bit_majority(desc: np.ndarray, assign: np.ndarray,
                     k: int) -> np.ndarray:
    """Per-cluster bit-majority centroids (ties round down)."""
    bits = np.unpackbits(_np_bytes(desc), axis=1, bitorder="little")
    counts = np.zeros((k, 256), np.int64)
    np.add.at(counts, assign, bits)
    total = np.bincount(assign, minlength=k)
    maj = (counts * 2 > total[:, None]).astype(np.uint8)
    return np.packbits(maj, axis=1, bitorder="little").view(
        np.uint32).reshape(k, 8)


def _kmedians(desc: np.ndarray, k: int, rng: np.random.Generator,
              iters: int = 8) -> Tuple[np.ndarray, np.ndarray]:
    """One k-medians run over a descriptor subset: greedy farthest-point
    seeding, Lloyd iterations, empty clusters reseeded from the
    worst-served descriptors. Returns (centers [k, 8] uint32, assign)."""
    n = desc.shape[0]
    if n == 0:
        return np.zeros((k, 8), np.uint32), np.zeros((0,), np.int32)
    centers = np.zeros((k, 8), np.uint32)
    centers[0] = desc[rng.integers(n)]
    d_min = None
    for i in range(1, k):
        d = _np_hamming(desc, centers[i - 1:i])[:, 0]
        d_min = d if d_min is None else np.minimum(d_min, d)
        centers[i] = desc[int(np.argmax(d_min))]

    for _ in range(iters):
        assign = np.argmin(_np_hamming(desc, centers), axis=1).astype(
            np.int32)
        new = _np_bit_majority(desc, assign, k)
        counts = np.bincount(assign, minlength=k)
        empty = np.where(counts == 0)[0]
        if len(empty):
            d_best = _np_hamming(desc, new)[np.arange(n), assign]
            m = min(len(empty), n)
            far = np.argsort(-d_best)[:m]
            new[empty[:m]] = desc[far]
        if np.array_equal(new, centers):
            break
        centers = new
    assign = np.argmin(_np_hamming(desc, centers), axis=1).astype(np.int32)
    return centers, assign


def train_vocabulary(desc: np.ndarray, k: int = 10, levels: int = 3,
                     seed: int = 0, iters: int = 8,
                     image_ids: Optional[np.ndarray] = None,
                     device="cpu") -> Vocabulary:
    """Build the tree from a descriptor pool desc [M, 8] (uint32 or int32
    words, invalid rows removed). image_ids: optional [M] source image of
    each descriptor, for DBoW2's image document frequency in the idf."""
    desc = np.ascontiguousarray(desc).view(np.uint32)
    rng = np.random.default_rng(seed)
    n_words = k ** levels
    level_arrays = []
    subsets = [np.arange(desc.shape[0])]
    for _ in range(levels):
        centers_lvl = np.zeros((len(subsets) * k, 8), np.uint32)
        next_subsets = []
        for j, idx in enumerate(subsets):
            if len(idx) == 0:
                parent = (level_arrays[-1][j]
                          if level_arrays else np.zeros(8, np.uint32))
                centers_lvl[j * k:(j + 1) * k] = parent
                next_subsets.extend([idx] * k)
                continue
            c, a = _kmedians(desc[idx], k, rng, iters)
            centers_lvl[j * k:(j + 1) * k] = c
            next_subsets.extend([idx[a == ci] for ci in range(k)])
        level_arrays.append(centers_lvl)
        subsets = next_subsets

    word_of = np.zeros(desc.shape[0], np.int64)
    for j, idx in enumerate(subsets):
        word_of[idx] = j
    if image_ids is not None:
        n_docs = len(np.unique(image_ids))
        df = np.zeros(n_words, np.int64)
        for w in range(n_words):
            df[w] = len(np.unique(image_ids[word_of == w]))
    else:
        n_docs = desc.shape[0]
        df = np.bincount(word_of, minlength=n_words)
    ratio = np.maximum(n_docs / np.maximum(df, 1), 1.0)
    weights = np.where(df > 0, np.log(ratio), 0.0).astype(np.float32)
    if weights.max() <= 0:
        weights = (df > 0).astype(np.float32)
    return _to_vocab([_words_i32(a) for a in level_arrays], weights, device)


def _to_vocab(levels, weights, device) -> Vocabulary:
    return Vocabulary(
        levels=tuple(torch.as_tensor(a, device=device) for a in levels),
        weights=torch.as_tensor(weights, device=device))


# ---------------------------------------------------------------------------
# Transform + scoring
# ---------------------------------------------------------------------------


def transform(vocab: Vocabulary, desc: torch.Tensor, valid: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(word_id [N] int32, bow [n_words]) of descriptors desc [N, 8]."""
    k = vocab.k
    dev = desc.device
    node = torch.zeros(desc.shape[0], dtype=torch.int64, device=dev)
    arange_k = torch.arange(k, device=dev)
    for lvl in vocab.levels:
        child0 = node * k
        cand = lvl[child0[:, None] + arange_k[None, :]]           # [N, k, 8]
        d = torch.sum(popcount32(torch.bitwise_xor(desc[:, None, :], cand)),
                      -1)
        node = child0 + torch.argmin(d, dim=1)
    tf = torch.zeros(vocab.n_words, dtype=torch.float32, device=dev)
    tf = tf.index_add(0, node, valid.to(torch.float32))
    bow = tf * vocab.weights
    bow = bow / torch.clamp(torch.sum(bow), min=1e-12)
    return node.to(torch.int32), bow


def score_database(bow_db: torch.Tensor, bow_q: torch.Tensor
                   ) -> torch.Tensor:
    """L1 similarity [K] of a query bow [n_words] against every row of
    bow_db [K, n_words]; empty rows score 0."""
    l1 = torch.sum(torch.abs(bow_db - bow_q[None, :]), 1)
    score = 1.0 - 0.5 * l1
    nonempty = torch.sum(bow_db, 1) > 0
    return torch.where(nonempty, score, 0.0)


# ---------------------------------------------------------------------------
# Persistence
# ---------------------------------------------------------------------------


def save_vocabulary(path: str, vocab: Vocabulary) -> None:
    arrs = {f"level_{i}": a.cpu().numpy().view(np.uint32)
            for i, a in enumerate(vocab.levels)}
    arrs["weights"] = vocab.weights.cpu().numpy()
    np.savez_compressed(path, **arrs)


def load_vocabulary(path: str, device="cpu") -> Vocabulary:
    with np.load(path) as z:
        n_levels = sum(1 for f in z.files if f.startswith("level_"))
        levels = [_words_i32(z[f"level_{i}"]) for i in range(n_levels)]
        weights = z["weights"]
    return _to_vocab(levels, weights, device)


_default_cache = {}


def default_vocabulary(device="cpu") -> Optional[Vocabulary]:
    """The shipped pre-trained tree (the deepest present: brief_k10L4,
    10⁴ words, else brief_k10L3) on `device`, or None if absent."""
    for name in ("brief_k10L4.npz", "brief_k10L3.npz"):
        path = os.path.join(ASSETS_DIR, name)
        if os.path.exists(path):
            break
    else:
        return None
    key = (path, str(torch.device(device)))
    if key not in _default_cache:
        _default_cache[key] = load_vocabulary(path, device)
    return _default_cache[key]
