"""IVF-flat nearest-neighbor search over embedding rows (numpy only).

Counterpart of ``ntxent_tpu/retrieval/ivf.py``.

The classic inverted-file layout the DLRM embedding-bag analysis
(PAPERS.md) assumes underneath its lookup traffic: k-means centroids
partition the vector set into lists, a query scores only the ``nprobe``
nearest lists, and within a list the scan is exact ("flat" — no
product quantization, embeddings here are small enough that the win is
list pruning, not code compression). Scores are INNER PRODUCT: the
fleet serves L2-normalized SimCLR/CLIP embeddings, so dot == cosine
and "largest score" is "nearest neighbor".

Two properties the index tier builds on:

* ``search`` WIDENS to every list when the probed lists hold fewer
  than ``k`` candidates, so a query never comes back short while the
  index has rows to give;
* everything is deterministic under a fixed seed (k-means++ init off a
  ``RandomState``), so a recall@10 measurement is reproducible.
"""

from __future__ import annotations

import numpy as np

__all__ = ["kmeans", "brute_force_topk", "IVFIndex"]


def _as2d(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.float32)
    return x[None] if x.ndim == 1 else x


def brute_force_topk(queries: np.ndarray, ids: np.ndarray,
                     vectors: np.ndarray,
                     k: int) -> tuple[np.ndarray, np.ndarray]:
    """Exact inner-product top-k: ``(ids [Q,k], scores [Q,k])``,
    score-descending, padded with id -1 / score -inf when fewer than
    ``k`` rows exist."""
    q = _as2d(queries)
    nq, n = q.shape[0], int(vectors.shape[0])
    kk = min(k, n)
    out_ids = np.full((nq, k), -1, np.int64)
    out_scores = np.full((nq, k), -np.inf, np.float32)
    if n == 0 or kk == 0:
        return out_ids, out_scores
    scores = q @ np.asarray(vectors, np.float32).T  # [Q, n]
    top = np.argpartition(scores, -kk, axis=1)[:, -kk:]
    row = np.arange(nq)[:, None]
    order = np.argsort(scores[row, top], axis=1)[:, ::-1]
    top = top[row, order]
    out_ids[:, :kk] = np.asarray(ids, np.int64)[top]
    out_scores[:, :kk] = scores[row, top]
    return out_ids, out_scores


def kmeans(vectors: np.ndarray, k: int, iters: int = 10,
           seed: int = 0) -> np.ndarray:
    """Lloyd's k-means with k-means++ seeding; returns ``[k, dim]``
    centroids. Deterministic for a fixed seed; an empty cluster is
    re-seeded from the point farthest from its centroid."""
    x = _as2d(vectors)
    n = x.shape[0]
    k = max(1, min(int(k), n))
    rng = np.random.RandomState(seed)
    # k-means++: spread the initial centroids by D^2 sampling.
    centroids = np.empty((k, x.shape[1]), np.float32)
    centroids[0] = x[rng.randint(n)]
    d2 = np.full(n, np.inf, np.float64)
    for i in range(1, k):
        diff = x - centroids[i - 1]
        d2 = np.minimum(d2, np.einsum("nd,nd->n", diff, diff))
        total = float(d2.sum())
        if total <= 0.0:
            centroids[i:] = x[rng.randint(n, size=k - i)]
            break
        centroids[i] = x[rng.choice(n, p=d2 / total)]
    for _ in range(max(1, int(iters))):
        assign = _nearest(x, centroids)
        for c in range(k):
            members = x[assign == c]
            if members.shape[0]:
                centroids[c] = members.mean(axis=0)
            else:
                far = int(np.argmin((x @ centroids[c])))
                centroids[c] = x[far]
    return centroids


def _nearest(x: np.ndarray, centroids: np.ndarray) -> np.ndarray:
    """Index of the max-inner-product centroid per row."""
    return np.argmax(x @ centroids.T, axis=1)


class IVFIndex:
    """Inverted lists over trained centroids; grows incrementally.

    Each list is a ``segments.MutableSegment`` — ONE implementation of
    the geometric-growth parallel buffers and the lock-free
    count-before-buffers ``view()`` discipline, shared with the store's
    insert tail (a per-list duplicate of that subtle code would drift).
    Appends amortize to O(1)/row; the worst single append stall is one
    1.5x copy of THIS list, never a whole-index consolidation (which
    measured as a 100 ms search p99 spike when lists were block-chains
    consolidated in bulk)."""

    def __init__(self, centroids: np.ndarray):
        from .segments import MutableSegment

        self.centroids = np.asarray(centroids, np.float32)
        dim = self.centroids.shape[1]
        # chunk_rows=64: a barely-populated list must not pre-allocate
        # the store tail's 1024-row default times n_lists.
        self._lists = [MutableSegment(dim, chunk_rows=64)
                       for _ in range(self.centroids.shape[0])]

    @property
    def n_lists(self) -> int:
        return self.centroids.shape[0]

    def add(self, ids: np.ndarray, vectors: np.ndarray) -> None:
        ids = np.asarray(ids, np.int64)
        vecs = _as2d(vectors)
        assign = _nearest(vecs, self.centroids)
        for c in np.unique(assign):
            mask = assign == c
            self._lists[c].append(ids[mask], vecs[mask])

    def _list(self, c: int) -> tuple[np.ndarray, np.ndarray]:
        return self._lists[c].view()

    def search(self, queries: np.ndarray, k: int,
               nprobe: int) -> tuple[np.ndarray, np.ndarray]:
        """ANN top-k over the ``nprobe`` nearest lists per query.

        Scores are computed PER LIST (one small matmul each) and only
        the score/id arrays are merged — candidate VECTORS are never
        copied out of their lists, which is what keeps a probe cheaper
        than the brute-force scan it prunes."""
        q = _as2d(queries)
        nprobe = max(1, min(int(nprobe), self.n_lists))
        cs = q @ self.centroids.T  # [Q, k_lists]
        probe = np.argpartition(cs, -nprobe, axis=1)[:, -nprobe:]
        out_ids = np.full((q.shape[0], k), -1, np.int64)
        out_scores = np.full((q.shape[0], k), -np.inf, np.float32)
        for i in range(q.shape[0]):
            lists = [self._list(int(c)) for c in probe[i]]
            cand_n = sum(ids.shape[0] for ids, _ in lists)
            if cand_n < k and nprobe < self.n_lists:
                # Short lists must not short the answer: widen to the
                # full index (still exact within what exists).
                lists = [self._list(c) for c in range(self.n_lists)]
            cand_ids = [ids for ids, _ in lists if ids.shape[0]]
            cand_scores = [v @ q[i] for ids, v in lists
                           if ids.shape[0]]
            if not cand_ids:
                continue
            ids_cat = np.concatenate(cand_ids)
            scores_cat = np.concatenate(cand_scores)
            kk = min(k, ids_cat.shape[0])
            top = np.argpartition(scores_cat, -kk)[-kk:]
            top = top[np.argsort(scores_cat[top])[::-1]]
            out_ids[i, :kk] = ids_cat[top]
            out_scores[i, :kk] = scores_cat[top]
        return out_ids, out_scores
