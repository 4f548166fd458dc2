"""Product quantization: compact codes + ADC search tables.

Counterpart of ``ntxent_tpu/retrieval/pq.py``: the same codes, snapshots
and wire format.

The DLRM embedding-bag analysis (PAPERS.md) puts large-scale retrieval
in the memory-bandwidth-bound regime: the scan cost is bytes touched
per row, not FLOPs. PQ attacks the bytes. A trained ``PQCodec`` splits
the embedding into ``m`` subspaces and quantizes each against its own
``ksub``-entry codebook, so a ``dim``-float row (4*dim bytes) becomes
``m`` uint8 codes — a 4*dim/m memory cut (32x at dim=64, m=8).

Search never decodes. **ADC** (asymmetric distance computation)
precomputes, per query, the inner product of each query subvector with
every codebook entry — an ``[m, ksub]`` lookup table — and a row's
approximate score is ``sum_j table[j, code[j]]``: m byte-gathers plus
m adds per row, the gather+scan loop scan.py fuses across queries.
Because the approximation only has to RANK candidates (the top
``rerank`` survivors are re-scored exactly from the raw mmap'd
vectors), modest codebooks keep recall@10 >= 0.95.

Optional **OPQ**: an orthonormal rotation learned by alternating
codebook refits with a Procrustes solve, so the subspace split aligns
with the data's principal structure instead of the arbitrary
coordinate order. Rotation is transparent to callers — ``encode``
rotates in, ``decode`` rotates back, ``adc_tables`` rotates the query
— and scores stay inner products (dot(q, R^T y) == dot(Rq, y)).

Training state (codebooks + rotation) persists per index version via
the same stage-fsync-rename idiom as the segments, so a restart
reopens a trained codec instead of re-clustering.

Numpy + stdlib only: the router and shard processes load no torch.
"""

from __future__ import annotations

import json
import os
import uuid
from pathlib import Path

import numpy as np

from .segments import _fsync_path

__all__ = ["PQCodec", "kmeans_l2"]

_META = "codec.json"
_BOOKS = "codebooks.f32"
_ROT = "rotation.f32"


def kmeans_l2(x: np.ndarray, k: int, iters: int = 12,
              seed: int = 0) -> np.ndarray:
    """Euclidean Lloyd's k-means with D^2 (k-means++) seeding.

    The IVF tier's ``kmeans`` assigns by max inner product (right for
    unit-norm embeddings); PQ subvectors are NOT unit-norm — slices of
    a unit vector — so codebook training must minimize actual L2
    reconstruction error or the ADC ranking degrades. Deterministic
    under a fixed seed; an empty cluster is re-seeded from the point
    farthest from its own centroid (same repair as the IVF trainer).
    """
    x = np.asarray(x, np.float32)
    if x.ndim == 1:
        x = x[None]
    n = x.shape[0]
    k = max(1, min(int(k), n))
    rng = np.random.RandomState(seed)
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
    xsq = np.einsum("nd,nd->n", x, x)
    for _ in range(max(1, int(iters))):
        assign = _assign_l2(x, centroids, xsq)
        for c in range(k):
            members = x[assign == c]
            if members.shape[0]:
                centroids[c] = members.mean(axis=0)
            else:
                diff = x - centroids[c]
                far = int(np.argmax(np.einsum("nd,nd->n", diff, diff)))
                centroids[c] = x[far]
    return centroids


def _assign_l2(x: np.ndarray, centroids: np.ndarray,
               xsq: np.ndarray | None = None) -> np.ndarray:
    """argmin_c ||x - c||^2 via the expanded form (never materializes
    per-pair difference tensors)."""
    # ||x||^2 is constant per row for the argmin — only needed by
    # callers that want true distances; the assignment drops it.
    d = -2.0 * (x @ centroids.T)
    d += np.einsum("kd,kd->k", centroids, centroids)[None, :]
    return np.argmin(d, axis=1)


class PQCodec:
    """Product quantizer over ``dim`` floats: ``m`` subspaces of
    ``dsub = dim/m`` floats, each coded against ``ksub`` centroids.

    ``m`` is clamped to the largest divisor of ``dim`` not exceeding
    the request — subspaces must tile the vector exactly. ``gen``
    counts trainings: sealed segments stamp the generation their codes
    were produced under, so a retrain invalidates stale codes instead
    of silently mixing codebooks.
    """

    def __init__(self, dim: int, m: int = 8, ksub: int = 256,
                 seed: int = 0):
        self.dim = int(dim)
        m = max(1, min(int(m), self.dim))
        while self.dim % m:
            m -= 1
        self.m = m
        self.dsub = self.dim // self.m
        self.ksub = max(2, min(int(ksub), 256))  # codes are uint8
        self.seed = int(seed)
        self.gen = 0
        # [m, ksub, dsub] once trained.
        self.codebooks: np.ndarray | None = None
        # Optional OPQ rotation [dim, dim] (orthonormal); None = identity.
        self.rotation: np.ndarray | None = None

    # -- training ------------------------------------------------------------
    @property
    def trained(self) -> bool:
        return self.codebooks is not None

    @property
    def bytes_per_row(self) -> int:
        """Code bytes the scan touches per stored row."""
        return self.m

    def train(self, x: np.ndarray, kmeans_iters: int = 12,
              opq_iters: int = 0) -> "PQCodec":
        """Fit codebooks (and, with ``opq_iters > 0``, the OPQ
        rotation) on a sample of rows. Deterministic per seed."""
        x = np.asarray(x, np.float32)
        if x.ndim == 1:
            x = x[None]
        if x.shape[1] != self.dim:
            raise ValueError(f"expected dim {self.dim}, got {x.shape[1]}")
        rot = None
        xr = x
        for it in range(max(0, int(opq_iters))):
            books = self._fit_books(xr, kmeans_iters)
            recon = self._decode_rotated(self._encode_rotated(xr, books),
                                         books)
            # Procrustes: the orthonormal R minimizing ||xR - recon||_F
            # is U @ Vt of x^T recon.
            u, _, vt = np.linalg.svd(x.T @ recon)
            rot = np.ascontiguousarray((u @ vt), np.float32)
            xr = x @ rot
        self.codebooks = self._fit_books(xr, kmeans_iters)
        self.rotation = rot
        self.gen += 1
        return self

    def _fit_books(self, xr: np.ndarray, iters: int) -> np.ndarray:
        books = np.zeros((self.m, self.ksub, self.dsub), np.float32)
        for j in range(self.m):
            sub = xr[:, j * self.dsub:(j + 1) * self.dsub]
            got = kmeans_l2(sub, self.ksub, iters=iters,
                            seed=self.seed + j)
            books[j, : got.shape[0]] = got
            if got.shape[0] < self.ksub:
                # Fewer training rows than codes: duplicate the fitted
                # entries so unused code slots never win an argmin by
                # sitting at the origin.
                books[j, got.shape[0]:] = got[
                    np.arange(self.ksub - got.shape[0]) % got.shape[0]]
        return books

    # -- coding --------------------------------------------------------------
    def _rotate(self, x: np.ndarray) -> np.ndarray:
        return x if self.rotation is None else x @ self.rotation

    def _encode_rotated(self, xr: np.ndarray,
                        books: np.ndarray) -> np.ndarray:
        n = xr.shape[0]
        codes = np.empty((n, self.m), np.uint8)
        for j in range(books.shape[0]):
            sub = xr[:, j * self.dsub:(j + 1) * self.dsub]
            codes[:, j] = _assign_l2(sub, books[j]).astype(np.uint8)
        return codes

    def _decode_rotated(self, codes: np.ndarray,
                        books: np.ndarray) -> np.ndarray:
        out = np.empty((codes.shape[0], self.dim), np.float32)
        for j in range(books.shape[0]):
            out[:, j * self.dsub:(j + 1) * self.dsub] = \
                books[j][codes[:, j]]
        return out

    def encode(self, x: np.ndarray) -> np.ndarray:
        """Rows -> uint8 codes ``[n, m]``."""
        if self.codebooks is None:
            raise RuntimeError("codec not trained")
        x = np.asarray(x, np.float32)
        if x.ndim == 1:
            x = x[None]
        return self._encode_rotated(self._rotate(x), self.codebooks)

    def decode(self, codes: np.ndarray) -> np.ndarray:
        """Codes -> approximate rows ``[n, dim]`` (rotated back)."""
        if self.codebooks is None:
            raise RuntimeError("codec not trained")
        codes = np.asarray(codes, np.uint8)
        if codes.ndim == 1:
            codes = codes[None]
        out = self._decode_rotated(codes, self.codebooks)
        return out if self.rotation is None else out @ self.rotation.T

    def adc_tables(self, queries: np.ndarray) -> np.ndarray:
        """Per-query ADC lookup tables ``[Q, m, ksub]``: entry
        ``[q, j, c]`` is the inner product of query q's j-th subvector
        with codebook entry c — a coded row's approximate score is the
        sum of m table lookups, never a decode."""
        if self.codebooks is None:
            raise RuntimeError("codec not trained")
        q = np.asarray(queries, np.float32)
        if q.ndim == 1:
            q = q[None]
        qr = self._rotate(q)
        # [Q, m, dsub] x [m, ksub, dsub] -> [Q, m, ksub]
        qs = qr.reshape(q.shape[0], self.m, self.dsub)
        return np.einsum("qjd,jkd->qjk", qs, self.codebooks,
                         optimize=True).astype(np.float32, copy=False)

    # -- wire ----------------------------------------------------------------
    def to_wire(self) -> dict:
        """JSON-safe codec state (base64 blobs) — the shard plane
        pushes a centrally trained codec to its workers over HTTP."""
        if self.codebooks is None:
            raise RuntimeError("codec not trained")
        import base64

        wire = {"dim": self.dim, "m": self.m, "ksub": self.ksub,
                "seed": self.seed, "gen": self.gen,
                "books": base64.b64encode(
                    np.ascontiguousarray(self.codebooks)
                    .tobytes()).decode("ascii")}
        if self.rotation is not None:
            wire["rotation"] = base64.b64encode(
                np.ascontiguousarray(self.rotation)
                .tobytes()).decode("ascii")
        return wire

    @classmethod
    def from_wire(cls, wire: dict) -> "PQCodec":
        import base64

        codec = cls(int(wire["dim"]), m=int(wire["m"]),
                    ksub=int(wire["ksub"]),
                    seed=int(wire.get("seed", 0)))
        codec.codebooks = np.frombuffer(
            base64.b64decode(wire["books"]), np.float32).reshape(
                codec.m, codec.ksub, codec.dsub).copy()
        if wire.get("rotation"):
            codec.rotation = np.frombuffer(
                base64.b64decode(wire["rotation"]),
                np.float32).reshape(codec.dim, codec.dim).copy()
        codec.gen = int(wire.get("gen", 1))
        return codec

    # -- durability ----------------------------------------------------------
    def save(self, parent) -> Path:
        """Persist codebooks+rotation under ``parent/codec`` with the
        segment tier's stage-fsync-rename idiom (a crash leaves either
        the old codec or the new one, never a torn mix)."""
        if self.codebooks is None:
            raise RuntimeError("codec not trained")
        parent = Path(parent)
        parent.mkdir(parents=True, exist_ok=True)
        tmp = parent / f".tmp-codec-{uuid.uuid4().hex[:8]}"
        tmp.mkdir(parents=True)
        blobs = [(_BOOKS, np.ascontiguousarray(self.codebooks))]
        if self.rotation is not None:
            blobs.append((_ROT, np.ascontiguousarray(self.rotation)))
        for fname, arr in blobs:
            with open(tmp / fname, "wb") as f:
                f.write(arr.tobytes())
                f.flush()
                os.fsync(f.fileno())
        meta = {"dim": self.dim, "m": self.m, "ksub": self.ksub,
                "seed": self.seed, "gen": self.gen,
                "rotated": self.rotation is not None}
        with open(tmp / _META, "w") as f:
            json.dump(meta, f)
            f.flush()
            os.fsync(f.fileno())
        _fsync_path(tmp)
        final = parent / "codec"
        if final.exists():
            # rename() cannot replace a non-empty directory: retire the
            # old codec aside first (same two-step the checkpoint tier
            # uses); readers hold arrays, not paths, so this is safe.
            import shutil
            old = parent / f".old-codec-{uuid.uuid4().hex[:8]}"
            os.rename(final, old)
            os.rename(tmp, final)
            shutil.rmtree(old, ignore_errors=True)
        else:
            os.rename(tmp, final)
        _fsync_path(parent)
        return final

    @classmethod
    def load(cls, parent) -> "PQCodec | None":
        """Reopen a persisted codec; None when absent or unreadable
        (an unreadable snapshot falls back to retraining — never an
        exception out of an index open)."""
        path = Path(parent) / "codec"
        try:
            meta = json.loads((path / _META).read_text())
            codec = cls(int(meta["dim"]), m=int(meta["m"]),
                        ksub=int(meta["ksub"]),
                        seed=int(meta.get("seed", 0)))
            if codec.m != int(meta["m"]):
                return None
            raw = np.fromfile(path / _BOOKS, dtype=np.float32)
            codec.codebooks = raw.reshape(codec.m, codec.ksub,
                                          codec.dsub).copy()
            if meta.get("rotated"):
                rot = np.fromfile(path / _ROT, dtype=np.float32)
                codec.rotation = rot.reshape(codec.dim,
                                             codec.dim).copy()
            codec.gen = int(meta.get("gen", 1))
            return codec
        except (OSError, ValueError, KeyError, TypeError):
            return None
