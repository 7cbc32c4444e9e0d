"""Online triplet mining (counterpart of ``mer_tpu/mining/triplet.py``).

The reference mines with pandas ``.sample()`` rejection loops and one model
call per candidate (audio_mel/dataset.py:182-413). As in ``mer_tpu``:

- index sampling is host numpy, class-uniform over a per-class index table
  (the distribution of the reference's ``random.choice(emotions)`` +
  ``df.sample()``), from ``np.random.default_rng(seed)``: the same seed
  draws the same pools as ``mer_tpu``;
- the model-dependent selection (hard mining over an embedded pool,
  semi-hard filtering) is tensor code on the pool's device: cdist, masks,
  argmax/argmin and top-k.

Mining returns row indices into the dataset; :meth:`TripletMiner.
mine_hard_rows_device` leaves them on the device, so a hard-mining step
never waits on the host for them.
"""

from __future__ import annotations

import numpy as np
import torch


def cdist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Pairwise Euclidean distances [N, M] in the exact difference form
    (the x^2 + y^2 - 2xy expansion loses ~1e-3 near 0, enough to flip
    argmin/argmax on near-ties)."""
    diff = x[:, None, :] - y[None, :, :]
    return torch.sqrt((diff * diff).sum(-1))


def hard_triplets_from_pool(embeddings: torch.Tensor, labels: torch.Tensor, batch_size: int) -> torch.Tensor:
    """Hard mining over an embedded pool (reference mine_hard_triplets,
    audio_mel/dataset.py:298-391): positive[i] the farthest same-class j != i,
    negative[i] the closest other-class j, and the ``batch_size`` anchors of
    largest d(i, p) - d(i, n). Returns [3, batch_size] int32 pool rows
    (anchor, positive, negative)."""
    d = cdist(embeddings, embeddings)
    labels = labels.to(embeddings.device)
    same = labels[:, None] == labels[None, :]
    eye = torch.eye(labels.shape[0], dtype=torch.bool, device=embeddings.device)
    positive_idx = torch.argmax(d * (same & ~eye).to(d.dtype), dim=1)  # reference :336-342
    negative_idx = torch.argmin(d + torch.where(same | eye, torch.inf, 0.0), dim=1)  # :344-352
    rows = torch.arange(labels.shape[0], device=embeddings.device)
    losses = d[rows, positive_idx] - d[rows, negative_idx]
    anchor_idx = torch.topk(losses, batch_size).indices
    return torch.stack([anchor_idx, positive_idx[anchor_idx], negative_idx[anchor_idx]]).to(torch.int32)


def semihard_mask(anchor_emb: torch.Tensor, positive_emb: torch.Tensor, negative_emb: torch.Tensor,
                  margin: float) -> torch.Tensor:
    """True where d(a, p) < d(a, n) < d(a, p) + margin (reference
    audio_mel/dataset.py:283)."""
    d_ap = torch.linalg.vector_norm(anchor_emb - positive_emb, dim=-1)
    d_an = torch.linalg.vector_norm(anchor_emb - negative_emb, dim=-1)
    return (d_ap < d_an) & (d_an < d_ap + margin)


class TripletIndexSampler:
    """Class-uniform host-side index sampling (the reference's
    ``random.choice(list(emotion_labels.values()))`` + ``df.sample()``)."""

    def __init__(self, labels: np.ndarray, num_classes: int = 7, seed: int = 0):
        self.labels = np.asarray(labels)
        self.num_classes = num_classes
        self._rng = np.random.default_rng(seed)
        self._by_class = [np.flatnonzero(self.labels == c) for c in range(num_classes)]
        self._nonempty = [c for c in range(num_classes) if len(self._by_class[c]) > 0]
        if not self._nonempty:
            raise ValueError("no labeled samples to mine from")

    def sample_class_uniform(self, n: int) -> np.ndarray:
        """n indices, the class drawn uniformly first (reference :309-310)."""
        classes = self._rng.choice(self._nonempty, size=n)
        return np.array([self._rng.choice(self._by_class[c]) for c in classes], dtype=np.int64)

    def sample_random_triplets(self, batch_size: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Random mining (reference :201-239): anchor class-uniform, positive
        of its class and not itself, negative of any other class."""
        anchors = np.empty(batch_size, np.int64)
        positives = np.empty(batch_size, np.int64)
        negatives = np.empty(batch_size, np.int64)
        for i in range(batch_size):
            c = self._rng.choice(self._nonempty)
            pool = self._by_class[c]
            anchors[i] = self._rng.choice(pool)
            if len(pool) > 1:
                while True:
                    p = self._rng.choice(pool)
                    if p != anchors[i]:
                        break
            else:
                p = anchors[i]
            positives[i] = p
            other = [oc for oc in self._nonempty if oc != c]
            negatives[i] = self._rng.choice(self._by_class[self._rng.choice(other)]) if other else anchors[i]
        return anchors, positives, negatives


class TripletMiner:
    """Mining bound to a dataset's labels and an embedding function.

    Args:
        labels: [N] class labels of the dataset rows.
        embed_fn: (row indices, an ndarray) -> [n, D] embeddings tensor.
        len_triplet_picking: the hard-mining pool size (config
            ``solver.len_triplet_picking``, reference default 100).
    """

    def __init__(self, labels: np.ndarray, embed_fn, *, len_triplet_picking: int = 100, num_classes: int = 7,
                 seed: int = 0):
        self.sampler = TripletIndexSampler(labels, num_classes=num_classes, seed=seed)
        self.embed_fn = embed_fn
        self.labels = np.asarray(labels)
        self.len_triplet_picking = len_triplet_picking
        # how often semi-hard mining fell back to random triplets (see _mine_semihard)
        self.stats = {"semihard_accepted": 0, "semihard_fallback": 0, "semihard_rounds": 0}

    def mine(self, batch_size: int, mining_type: str = "hard", margin: float = 1.0):
        if mining_type == "random":
            return self.sampler.sample_random_triplets(batch_size)
        if mining_type == "semi-hard":
            return self._mine_semihard(batch_size, margin)
        if mining_type == "hard":
            return self._mine_hard(batch_size)
        raise ValueError("mining_type must be 'hard', 'semi-hard' or 'random'")

    def _hard_pool_apn(self, batch_size: int) -> tuple[np.ndarray, torch.Tensor]:
        """Sample the class-uniform pool (rounded down to a multiple of
        ``batch_size``, reference :305), embed it and select: (host pool rows,
        [3, B] apn on the embeddings' device)."""
        pool_size = max((self.len_triplet_picking // batch_size) * batch_size, batch_size)
        pool = self.sampler.sample_class_uniform(pool_size)
        emb = self.embed_fn(pool)
        return pool, hard_triplets_from_pool(emb, torch.from_numpy(self.labels[pool]), batch_size)

    def _mine_hard(self, batch_size: int):
        pool, apn = self._hard_pool_apn(batch_size)
        apn = apn.cpu().numpy()  # one fetch for the three index rows
        return pool[apn[0]], pool[apn[1]], pool[apn[2]]

    def mine_hard_rows_device(self, batch_size: int) -> torch.Tensor:
        """Hard mining with the chosen rows left on the device: a flat
        [3 * batch_size] int64 tensor, anchors ++ positives ++ negatives."""
        pool, apn = self._hard_pool_apn(batch_size)
        return torch.from_numpy(pool).to(apn.device)[apn.reshape(-1).long()]

    def _mine_semihard(self, batch_size: int, margin: float, max_rounds: int = 50, oversample: int = 4):
        """Batched rejection sampling: ``oversample * need`` candidates a
        round, keep the semi-hard ones (the rule of reference :242-296). The
        reference spins until it has enough; after ``max_rounds`` this fills
        the rest with random triplets and counts them in ``stats``."""
        kept_a, kept_p, kept_n = [], [], []
        need = batch_size
        for _ in range(max_rounds):
            a, p, n = self.sampler.sample_random_triplets(need * oversample)
            uniq = np.unique(np.concatenate([a, p, n]))
            emb = self.embed_fn(uniq)
            lookup = {int(r): i for i, r in enumerate(uniq)}
            ea, ep, en = (emb[torch.as_tensor([lookup[int(i)] for i in rows], device=emb.device)] for rows in (a, p, n))
            ok = semihard_mask(ea, ep, en, margin).cpu().numpy()
            take = min(int(ok.sum()), need)
            sel = np.flatnonzero(ok)[:take]
            kept_a.append(a[sel])
            kept_p.append(p[sel])
            kept_n.append(n[sel])
            need -= take
            self.stats["semihard_rounds"] += 1
            self.stats["semihard_accepted"] += take
            if need == 0:
                break
        else:
            a, p, n = self.sampler.sample_random_triplets(need)
            kept_a.append(a)
            kept_p.append(p)
            kept_n.append(n)
            self.stats["semihard_fallback"] += need
        return np.concatenate(kept_a), np.concatenate(kept_p), np.concatenate(kept_n)
