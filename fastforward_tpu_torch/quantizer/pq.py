"""Product quantization (PQ / OPQ) with a torch k-means trainer.

The port of ``fastforward_tpu/quantizer/pq.py``.  Codebooks are trained with
Lloyd's k-means for all ``M`` subspaces at once (the subspace is a batch
dimension) on the quantizer's device: the card unless the caller passes
``device="cpu"``.  Centroids start from the same random rows as in
``fastforward_tpu`` (``np.random.default_rng(seed)``), so both packages
begin from identical codebooks.  The nearest-centroid products run in full
fp32 whatever the process's TF32 setting, so codes never depend on it.

Serialized state uses the reference nanopq schema (``M``, ``Ks``, ``Ds``,
``metric``, ``verbose``; ``codewords`` and, for OPQ, the rotation ``R``)
and the same class names as ``fastforward_tpu``, so triples load in either
package.  The device is not part of the state.
"""

import logging
from typing import Any

import numpy as np
import torch

from fastforward_tpu_torch.device import fp32_matmul, resolve_device
from fastforward_tpu_torch.quantizer.base import (
    Quantizer,
    QuantizerAttributes,
    QuantizerData,
)

LOGGER = logging.getLogger(__name__)

#: Lloyd iterations per fit (as ``fastforward_tpu``)
KMEANS_ITERS = 20

#: bound on the ``(M, rows, Ks)`` distance block per step (elements)
_DIST_ELEMS = 1 << 27


def _nearest_center(vecs: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """Index of the L2-nearest centroid per subspace and vector.

    :param vecs: ``(M, n, Ds)`` fp32.
    :param centers: ``(M, Ks, Ds)`` fp32.
    :return: ``(M, n)`` int64.
    """
    m, n, _ = vecs.shape
    ks = centers.shape[1]
    # ||x - c||^2 = ||x||^2 - 2 x.c + ||c||^2; ||x||^2 is constant in argmin
    c_sq = (centers * centers).sum(-1)[:, None, :]
    step = max(1, _DIST_ELEMS // (m * ks))
    out = torch.empty((m, n), dtype=torch.int64, device=vecs.device)
    with fp32_matmul(vecs.device):
        for lo in range(0, n, step):
            dots = torch.bmm(vecs[:, lo : lo + step], centers.transpose(1, 2))
            out[:, lo : lo + step] = torch.argmin(c_sq - 2.0 * dots, dim=-1)
    return out


def _train_codebooks(subvecs: torch.Tensor, centers: torch.Tensor, iters: int) -> torch.Tensor:
    """Lloyd's k-means for all subspaces at once.

    :param subvecs: Training data split by subspace, ``(M, n, Ds)`` fp32.
    :param centers: Initial centroids, ``(M, Ks, Ds)`` fp32.
    :param iters: Number of Lloyd iterations.
    :return: Trained codebooks, ``(M, Ks, Ds)``.
    """
    m, _, ds = subvecs.shape
    ks = centers.shape[1]
    offsets = torch.arange(m, device=subvecs.device)[:, None] * ks
    flat_vecs = subvecs.reshape(-1, ds)
    for _ in range(iters):
        flat = (_nearest_center(subvecs, centers) + offsets).reshape(-1)
        sums = torch.zeros((m * ks, ds), dtype=torch.float32, device=subvecs.device)
        sums.index_add_(0, flat, flat_vecs)
        counts = torch.bincount(flat, minlength=m * ks).to(torch.float32)[:, None]
        # empty clusters keep their previous centroid
        centers = torch.where(
            counts > 0, sums / counts.clamp(min=1.0), centers.reshape(-1, ds)
        ).view(m, ks, ds)
    return centers


class PQ(Quantizer):
    """Product quantizer: M subspaces x Ks codewords, trained on a device."""

    # serialized state matches the reference's nanopq schema exactly, so
    # emit its class names (as fastforward_tpu does)
    _compat_name = ("fast_forward.quantizer.nanopq", "NanoPQ")

    #: rows per device batch when encoding
    _ENCODE_BATCH = 2**15

    def __init__(
        self,
        M: int,
        Ks: int,
        metric: str = "dot",
        verbose: bool = False,
        seed: int = 42,
        device: "str | torch.device | None" = None,
    ) -> None:
        """Create a product quantizer.

        :param M: Number of subspaces.
        :param Ks: Number of codewords per subspace (<= 2^32).
        :param metric: Kept for reference-format compatibility (scoring is
            always inner-product ADC).
        :param verbose: Enable verbose logging.
        :param seed: Seed of the centroid initialization.
        :param device: Torch device of the k-means and the encoder; ``None``
            means ``"cuda"`` (resolved when ``fit``/``encode`` run).
        """
        assert 0 < Ks <= 2**32
        self.M = M
        self.Ks = Ks
        self.Ds: int | None = None
        self.metric = metric
        self.verbose = verbose
        self._seed = seed
        self.device = device
        self.codewords: np.ndarray | None = None  # (M, Ks, Ds) float32

    def _torch_device(self) -> torch.device:
        return resolve_device(self.device)

    def _code_dtype(self) -> np.dtype:
        if self.Ks <= 2**8:
            return np.dtype(np.uint8)
        if self.Ks <= 2**16:
            return np.dtype(np.uint16)
        return np.dtype(np.uint32)

    def _split(self, vectors: np.ndarray, device: torch.device) -> torch.Tensor:
        """``(n, D)`` host vectors -> per-subspace ``(M, n, Ds)`` on device."""
        x = torch.from_numpy(np.ascontiguousarray(vectors, dtype=np.float32)).to(device)
        n, d = x.shape
        return x.view(n, self.M, d // self.M).transpose(0, 1).contiguous()

    def _init_centers(self, subvecs: torch.Tensor) -> torch.Tensor:
        """Random-row initialization, the same rows as ``fastforward_tpu``."""
        m, n, _ = subvecs.shape
        rng = np.random.default_rng(self._seed)
        # a distinct random sample of rows per subspace
        idx = np.stack([rng.choice(n, size=self.Ks, replace=self.Ks > n) for _ in range(m)])
        idx_t = torch.from_numpy(idx).to(subvecs.device)
        return subvecs[torch.arange(m, device=subvecs.device)[:, None], idx_t]

    def _fit(self, vectors: np.ndarray, **kwargs: Any) -> None:
        n, d = vectors.shape
        if d % self.M != 0:
            raise ValueError(f"Vector dimension ({d}) must be divisible by M ({self.M}).")
        if self.Ks > n:
            raise ValueError(f"Need at least Ks ({self.Ks}) training vectors, got {n}.")
        self.Ds = d // self.M
        subvecs = self._split(vectors, self._torch_device())
        codebooks = _train_codebooks(subvecs, self._init_centers(subvecs), KMEANS_ITERS)
        self.codewords = codebooks.cpu().numpy()
        if self.verbose:
            LOGGER.info("trained PQ: M=%s Ks=%s Ds=%s", self.M, self.Ks, self.Ds)

    def _get_dtype(self) -> np.dtype:
        return self._code_dtype()

    def _get_dims(self) -> tuple[int | None, int | None]:
        if self.Ds is None:
            return None, self.M
        return self.Ds * self.M, self.M

    def _encode(self, vectors: np.ndarray) -> np.ndarray:
        assert self.codewords is not None
        device = self._torch_device()
        codebooks = torch.from_numpy(np.array(self.codewords, dtype=np.float32)).to(device)
        out = np.empty((vectors.shape[0], self.M), dtype=self._code_dtype())
        for i in range(0, vectors.shape[0], self._ENCODE_BATCH):
            batch = vectors[i : i + self._ENCODE_BATCH]
            codes = _nearest_center(self._split(batch, device), codebooks)
            out[i : i + batch.shape[0]] = codes.T.cpu().numpy()
        return out

    def _decode(self, codes: np.ndarray) -> np.ndarray:
        assert self.codewords is not None
        n = codes.shape[0]
        # (n, M, Ds): codeword lookup per subspace, then flatten
        out = self.codewords[np.arange(self.M)[None, :], codes.astype(np.int64)]
        return out.reshape(n, -1)

    def _get_state(self) -> tuple[QuantizerAttributes, QuantizerData]:
        attributes = {
            "M": self.M,
            "Ks": self.Ks,
            "Ds": self.Ds,
            "metric": self.metric,
            "verbose": self.verbose,
        }
        data = {}
        if self.codewords is not None:
            data["codewords"] = self.codewords
        return attributes, data

    @classmethod
    def _from_state(cls, attributes: QuantizerAttributes, data: QuantizerData) -> "PQ":
        quantizer = cls(
            M=int(attributes["M"]),
            Ks=int(attributes["Ks"]),
            metric=str(attributes["metric"]),
            verbose=bool(attributes["verbose"]),
        )
        if attributes.get("Ds") is not None:
            quantizer.Ds = int(attributes["Ds"])
        if "codewords" in data:
            quantizer.codewords = np.asarray(data["codewords"])
        return quantizer


class OPQ(PQ):
    """Optimized product quantizer: PQ after a learned rotation.

    The rotation is trained by alternating minimization (project, quantize,
    orthogonal Procrustes update, in numpy).  At query time the rotation is
    applied to the *query* vectors, so stored codes and the ADC scoring path
    are identical to plain PQ: ``q . (dec @ R^T) == (q @ R) . dec``.
    """

    _compat_name = ("fast_forward.quantizer.nanopq", "NanoOPQ")

    def __init__(
        self,
        M: int,
        Ks: int,
        metric: str = "dot",
        verbose: bool = False,
        seed: int = 42,
        opq_iters: int = 10,
        device: "str | torch.device | None" = None,
    ) -> None:
        """Create an optimized product quantizer.

        :param M: Number of subspaces.
        :param Ks: Number of codewords per subspace.
        :param metric: Kept for reference-format compatibility.
        :param verbose: Enable verbose logging.
        :param seed: Seed of the centroid initialization.
        :param opq_iters: Alternating-minimization iterations for R.
        :param device: As for :class:`PQ`.
        """
        super().__init__(M, Ks, metric=metric, verbose=verbose, seed=seed, device=device)
        self._opq_iters = opq_iters
        self.R: np.ndarray | None = None  # (D, D) float32

    def _fit(self, vectors: np.ndarray, **kwargs: Any) -> None:
        x = np.asarray(vectors, dtype=np.float32)
        _, d = x.shape
        r = np.eye(d, dtype=np.float32)
        for i in range(self._opq_iters):
            super()._fit(x @ r)
            reconstructed = super()._decode(super()._encode(x @ r))
            u, _, vt = np.linalg.svd(x.T @ reconstructed)
            r = (u @ vt).astype(np.float32)
            if self.verbose:
                LOGGER.info("OPQ iteration %s/%s", i + 1, self._opq_iters)
        self.R = r
        super()._fit(x @ r)

    def rotate(self, vectors: np.ndarray) -> np.ndarray:
        """Apply the learned rotation (for queries at scoring time)."""
        assert self.R is not None
        return np.asarray(vectors, dtype=np.float32) @ self.R

    def _encode(self, vectors: np.ndarray) -> np.ndarray:
        return super()._encode(self.rotate(vectors))

    def _decode(self, codes: np.ndarray) -> np.ndarray:
        assert self.R is not None
        return super()._decode(codes) @ self.R.T

    def _get_state(self) -> tuple[QuantizerAttributes, QuantizerData]:
        attributes, data = super()._get_state()
        if self.R is not None:
            data = dict(data)
            data["R"] = self.R
        return attributes, data

    @classmethod
    def _from_state(cls, attributes: QuantizerAttributes, data: QuantizerData) -> "OPQ":
        quantizer = super()._from_state(attributes, data)
        if "R" in data:
            quantizer.R = np.asarray(data["R"])
        return quantizer


# drop-in aliases matching the reference class names
NanoPQ = PQ
NanoOPQ = OPQ
