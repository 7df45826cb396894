"""Data-parallel sharding of the batched pairing over torch.distributed."""
