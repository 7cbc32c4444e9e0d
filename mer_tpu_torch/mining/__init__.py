"""Online triplet mining for the mel feature extractor."""

from mer_tpu_torch.mining.triplet import (
    TripletIndexSampler,
    TripletMiner,
    cdist,
    hard_triplets_from_pool,
    semihard_mask,
)

__all__ = ["TripletIndexSampler", "TripletMiner", "cdist", "hard_triplets_from_pool", "semihard_mask"]
